// Whole LYNXNet residual layer (strong_cond) for Hopper (sm_90a), hand-written with WMMA (bf16 in,
// f32 accumulate). Two kernels of one function:
//
//   K5 lynx_layer_v2 replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:lynx_layer_fused
//   K7 lynx_layer_v3 replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:lynx_layer_fused_v3
//
//   res = bf16(x + cond_proj);  h = res + step[b] (f32)
//   out = bf16(res + b2 + PReLU(dwconv(mask(SwiGLU(bf16(LN(h)) @ w_in + b_in))) + dw_bias) @ w2)
//
// Bound on an H100: operations. At the main-path shape (B=4, T=2048, dim 1024, inner 2048, k 31)
// the products are 103 GFLOP against ~63 MB of compulsory traffic: 0.104 ms at 989 TFLOP/s.
//
// Design: one launch per layer, no [rows, inner] intermediate in device memory. A block owns a
// tile of 16 output rows of one sequence and keeps the LayerNorm'd rows of its 48-row window
// (the tile and its conv halo) in shared memory. It walks inner in 64-column chunks: the out and
// gate columns of the chunk for all 48 rows (WMMA, 8 warps: one 16-column fragment each, 3 row
// fragments), SwiGLU and the sequence mask, the depthwise conv for the 16 tile rows, PReLU, and
// at once acc[16, dim] += act x w2[chunk rows] into an f32 accumulator held in registers (see
// lynx_tile.cuh). x, cond and the step are read by index, the halo and the sequence edges are
// index arithmetic, and the residual is added in the epilogue. Halo cost: the first product runs
// on 48 rows for 16 outputs, x 3 on 2/3 of the FLOPs (x 2.3 in all); 32-row tiles would cut it to
// x 2, at twice the accumulator registers.
//
// K5 runs one block per tile and reads the B fragments of both products straight from device
// memory (w_in 8 MB and w2 4 MB stay in L2). Shared memory at dim 1024: 124 KB, one block an SM.
//
// K7 is K5's arithmetic on a pipelined schedule, Hopper's counterpart of v3's staging across
// grid steps: a persistent grid (at most one or two blocks an SM) whose blocks loop over work
// items, each a run of consecutive tiles of one sequence. Consecutive tiles share 32 of their 48
// window rows, so the LayerNorm'd rows live in a ring of four 16-row slots: tile p reads slots
// p, p+1, p+2 while cp.async brings slot p+3's raw x and cond rows, in pieces issued with each
// chunk, into the free slot and a staging buffer; slot p+3 is normalised in place once tile p is
// done (each row is normalised once, not three times). The w_in out/gate columns of the first
// product stream through two 32-row shared buffers by cp.async, alternating by parity: slice
// s + 1 loads while slice s computes. w2 fragments come from L2 as in K5. Shared memory at dim
// 1024: 205 KB. Warp specialisation with TMA and wgmma is later work.
//
// Widths: dim % 64 == 0, dim <= 1024; inner % 64 == 0; k <= 33.

#include <algorithm>

#include "lynx_tile.cuh"

namespace {

using namespace lynx;

constexpr int kLdH = 2 * kNC + 4;  // f32 [kWin][out | gate] of a chunk
constexpr int kKS = 32;            // K7: rows of w_in a pipeline slice holds
constexpr int kLdW = 2 * kNC + 8;  // bf16 [kKS][out | gate]
constexpr int kSlots = 4;          // K7: ring slots of kTM rows

__device__ __forceinline__ float layer_input(const __nv_bfloat16* x, const __nv_bfloat16* cond,
                                             const float* step, int i) {
  const float res = __bfloat162float(
      __float2bfloat16(__bfloat162float(x[i]) + __bfloat162float(cond[i])));
  return res + step[i];
}

// LayerNorm (f32, two passes) of h = bf16(x + cond) + step for one sequence row, written as bf16
// to dst. x and cond may point at shared or device memory; one warp per row.
__device__ __forceinline__ void layer_norm_row(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                               const __nv_bfloat16* cond, const float* step,
                                               const float* __restrict__ ln_scale,
                                               const float* __restrict__ ln_bias, int dim,
                                               int lane) {
  float s = 0.f;
  for (int i = lane; i < dim; i += 32) s += layer_input(x, cond, step, i);
  const float mean = warp_sum(s) / dim;
  float v = 0.f;
  for (int i = lane; i < dim; i += 32) {
    const float d = layer_input(x, cond, step, i) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / dim + 1e-5f);
  for (int i = lane; i < dim; i += 32) {
    const float xn = (layer_input(x, cond, step, i) - mean) * rstd;
    dst[i] = __float2bfloat16(xn * ln_scale[i] + ln_bias[i]);
  }
}

// Rows [0, n) starting at sequence row t_first, from device memory into dst (row stride ldx);
// rows outside the sequence are zero (they are masked after SwiGLU).
__device__ __forceinline__ void layer_norm_rows(__nv_bfloat16* dst, int ldx,
                                                const __nv_bfloat16* xb,
                                                const __nv_bfloat16* cb, const float* step,
                                                const float* ln_scale, const float* ln_bias,
                                                int t_first, int n, int T, int dim) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += kWarps) {
    const int t = t_first + r;
    __nv_bfloat16* d = dst + r * ldx;
    if (t < 0 || t >= T) {
      for (int i = lane; i < dim; i += 32) d[i] = __float2bfloat16(0.f);
      continue;
    }
    layer_norm_row(d, xb + (size_t)t * dim, cb + (size_t)t * dim, step, ln_scale, ln_bias, dim,
                   lane);
  }
}

// SwiGLU of the chunk's out and gate columns (sH[:, 0:kNC] and sH[:, kNC:2kNC]) into sH[:, 0:kNC],
// zero for window rows outside the sequence: the conv's zero padding acts on these rows.
__device__ __forceinline__ void swiglu_mask(float* sH, const float* __restrict__ b_in, int inner,
                                            int c0, int t_first, int T) {
  for (int i = threadIdx.x; i < kWin * kNC; i += kThreads) {
    const int r = i / kNC, j = i % kNC;
    const int t = t_first + r;
    float u = 0.f;
    if (t >= 0 && t < T) {
      const float o = sH[r * kLdH + j] + b_in[c0 + j];
      const float g = sH[r * kLdH + kNC + j] + b_in[inner + c0 + j];
      u = o * (g * (1.f / (1.f + expf(-g))));
    }
    sH[r * kLdH + j] = u;
  }
}

// Column fragment of the first product that warp w computes: out columns c0 + 16w for w < 4,
// gate columns inner + c0 + 16(w - 4) otherwise; it lands in sH column 16w either way.
__device__ __forceinline__ int w_in_col(int warp, int inner, int c0) {
  return warp < kWarps / 2 ? c0 + warp * 16 : inner + c0 + (warp - kWarps / 2) * 16;
}

__device__ __forceinline__ void store_h(float* sH, FragAcc (&h)[3], int warp) {
#pragma unroll
  for (int rf = 0; rf < 3; ++rf)
    wmma::store_matrix_sync(sH + rf * 16 * kLdH + warp * 16, h[rf], kLdH, wmma::mem_row_major);
}

// The rest of a chunk once its first product is in sH: SwiGLU + mask, conv + PReLU, pw_out.
template <int kFr>
__device__ __forceinline__ void finish_chunk(FragAcc (&acc)[kFr], float* sH,
                                             __nv_bfloat16* sAct, const float* b_in,
                                             const float* dw, const float* dw_bias,
                                             const float* alpha, const __nv_bfloat16* w2,
                                             int dim, int inner, int k, int c0, int t_first,
                                             int T, int warp) {
  __syncthreads();
  swiglu_mask(sH, b_in, inner, c0, t_first, T);
  __syncthreads();
  conv_prelu_chunk(sH, kLdH, dw, dw_bias, alpha, inner, c0, k, sAct);
  __syncthreads();
  pw_out_chunk<kFr>(acc, sAct, w2, dim, c0, warp);
}

struct LayerArgs {
  const __nv_bfloat16* x;     // [B, T, dim]
  const __nv_bfloat16* cond;  // [B, T, dim]
  const float* step;          // [B, dim]
  const float* ln_scale;      // [dim]
  const float* ln_bias;       // [dim]
  const __nv_bfloat16* w_in;  // [dim, 2 * inner], columns [out | gate]
  const float* b_in;          // [2 * inner]
  const float* dw;            // [k, inner]
  const float* dw_bias;       // [inner]
  const float* alpha;         // [inner]
  const __nv_bfloat16* w2;    // [inner, dim]
  const float* b2;            // [dim]
  __nv_bfloat16* out;         // [B, T, dim]
  int T, dim, inner, k, pad_l;
};

// ---- K5: one block per (tile, sequence) -------------------------------------------------------

template <int kFr>
__global__ void __launch_bounds__(kThreads) lynx_layer_v2_kernel(LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.dim + 8;
  __nv_bfloat16* sXn = reinterpret_cast<__nv_bfloat16*>(smem);          // [kWin][ldx]
  float* sH = reinterpret_cast<float*>(smem + kWin * ldx * 2);           // [kWin][kLdH]
  __nv_bfloat16* sAct = reinterpret_cast<__nv_bfloat16*>(sH + kWin * kLdH);  // [kTM][kLdAct]

  const int t0 = blockIdx.x * kTM;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dim = a.dim, inner = a.inner;
  const size_t base = (size_t)b * a.T * dim;
  const int t_first = t0 - a.pad_l;  // sequence row of window row 0

  layer_norm_rows(sXn, ldx, a.x + base, a.cond + base, a.step + (size_t)b * dim, a.ln_scale,
                  a.ln_bias, t_first, kWin, a.T, dim);
  __syncthreads();

  FragAcc acc[kFr];
  zero_acc(acc);
  for (int c0 = 0; c0 < inner; c0 += kNC) {
    FragAcc h[3];
#pragma unroll
    for (int rf = 0; rf < 3; ++rf) wmma::fill_fragment(h[rf], 0.f);
    const __nv_bfloat16* wcol = a.w_in + w_in_col(warp, inner, c0);
#pragma unroll 4
    for (int kk = 0; kk < dim; kk += 16) {
      FragB fb;
      wmma::load_matrix_sync(fb, wcol + (size_t)kk * 2 * inner, 2 * inner);
#pragma unroll
      for (int rf = 0; rf < 3; ++rf) {
        FragA fa;
        wmma::load_matrix_sync(fa, sXn + rf * 16 * ldx + kk, ldx);
        wmma::mma_sync(h[rf], fa, fb, h[rf]);
      }
    }
    store_h(sH, h, warp);
    finish_chunk<kFr>(acc, sH, sAct, a.b_in, a.dw, a.dw_bias, a.alpha, a.w2, dim, inner, a.k, c0,
                      t_first, a.T, warp);
    __syncthreads();  // sH and sAct are rewritten by the next chunk
  }
  store_rows<kFr>(acc, sH + warp * 256, a.b2, a.x + base + (size_t)t0 * dim,
                  a.cond + base + (size_t)t0 * dim, a.out + base + (size_t)t0 * dim,
                  min(kTM, a.T - t0), dim, warp, lane);
}

// ---- K7: persistent blocks, a ring of normalised rows, cp.async double buffering ----------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One pipeline slice: w_in rows ks*kKS .. +kKS of the chunk's out and gate columns -> sW buffer.
__device__ __forceinline__ void load_w_slice(__nv_bfloat16* sWbuf, const __nv_bfloat16* w_in,
                                             int inner, int c0, int ks) {
  constexpr int kPieces = kKS * (2 * kNC / 8);  // 16-byte pieces
  for (int v = threadIdx.x; v < kPieces; v += kThreads) {
    const int kr = v / (2 * kNC / 8);
    const int cp = (v % (2 * kNC / 8)) * 8;
    const int col = cp < kNC ? c0 + cp : inner + c0 + cp - kNC;
    cp_async16(sWbuf + kr * kLdW + cp, w_in + (size_t)(ks * kKS + kr) * 2 * inner + col);
  }
}

// Pieces [q_begin, q_end) of the raw rows of one ring slot: 16 rows of x into the slot itself and
// 16 rows of cond into the staging buffer; rows outside the sequence are zero-filled.
__device__ __forceinline__ void load_slot_pieces(__nv_bfloat16* slot, __nv_bfloat16* sCond,
                                                 int ldx, const __nv_bfloat16* xb,
                                                 const __nv_bfloat16* cb, int t_first, int T,
                                                 int dim, int q_begin, int q_end) {
  const int per_row = dim / 8;
  const int per_array = kTM * per_row;
  for (int q = q_begin + threadIdx.x; q < q_end; q += kThreads) {
    const int which = q / per_array;
    const int rem = q % per_array;
    const int r = rem / per_row;
    const int col = (rem % per_row) * 8;
    __nv_bfloat16* dst = (which == 0 ? slot : sCond) + r * ldx + col;
    const int t = t_first + r;
    if (t >= 0 && t < T) {
      cp_async16(dst, (which == 0 ? xb : cb) + (size_t)t * dim + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int kFr>
__global__ void __launch_bounds__(kThreads) lynx_layer_v3_kernel(LayerArgs a, int tiles_per_item,
                                                                 int items_per_seq, int n_items) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim = a.dim, inner = a.inner;
  const int ldx = dim + 8;
  __nv_bfloat16* sRing = reinterpret_cast<__nv_bfloat16*>(smem);       // [kSlots][kTM][ldx]
  __nv_bfloat16* sCond = sRing + kSlots * kTM * ldx;                    // [kTM][ldx]
  float* sH = reinterpret_cast<float*>(sCond + kTM * ldx);              // [kWin][kLdH]
  __nv_bfloat16* sAct = reinterpret_cast<__nv_bfloat16*>(sH + kWin * kLdH);  // [kTM][kLdAct]
  __nv_bfloat16* sW = sAct + kTM * kLdAct;                              // [2][kKS][kLdW]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (a.T + kTM - 1) / kTM;
  const int n_chunks = inner / kNC;
  const int n_ks = dim / kKS;
  const int slot_pieces = 2 * kTM * (dim / 8);
  const int pieces_per_chunk = (slot_pieces + n_chunks - 1) / n_chunks;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / items_per_seq;
    const int p_begin = (item % items_per_seq) * tiles_per_item;
    const int p_end = min(p_begin + tiles_per_item, n_tiles);
    const size_t base = (size_t)b * a.T * dim;
    const __nv_bfloat16* xb = a.x + base;
    const __nv_bfloat16* cb = a.cond + base;
    const float* step = a.step + (size_t)b * dim;

    // Fill: the first tile's three slots, normalised straight from device memory. Slot q holds
    // sequence rows q * kTM - pad_l .. + kTM - 1, in ring position q % kSlots.
    __syncthreads();
    for (int q = p_begin; q < p_begin + 3; ++q)
      layer_norm_rows(sRing + (q % kSlots) * kTM * ldx, ldx, xb, cb, step, a.ln_scale,
                      a.ln_bias, q * kTM - a.pad_l, kTM, a.T, dim);
    __syncthreads();

    for (int p = p_begin; p < p_end; ++p) {
      const bool prefetch = p + 1 < p_end;  // the next tile needs slot p + 3
      __nv_bfloat16* next_slot = sRing + ((p + 3) % kSlots) * kTM * ldx;
      const int next_first = (p + 3) * kTM - a.pad_l;
      const int t_first = p * kTM - a.pad_l;

      FragAcc acc[kFr];
      zero_acc(acc);
      load_w_slice(sW, a.w_in, inner, 0, 0);
      if (prefetch)
        load_slot_pieces(next_slot, sCond, ldx, xb, cb, next_first, a.T, dim, 0,
                         min(pieces_per_chunk, slot_pieces));
      cp_async_commit();
      int s = 0;  // slice counter of this tile: buffer s % 2
      for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * kNC;
        FragAcc h[3];
#pragma unroll
        for (int rf = 0; rf < 3; ++rf) wmma::fill_fragment(h[rf], 0.f);
        for (int ks = 0; ks < n_ks; ++ks, ++s) {
          const bool last = c == n_chunks - 1 && ks == n_ks - 1;
          if (!last) {
            const int nc = ks + 1 < n_ks ? c : c + 1;
            const int nks = ks + 1 < n_ks ? ks + 1 : 0;
            load_w_slice(sW + ((s + 1) % 2) * kKS * kLdW, a.w_in, inner, nc * kNC, nks);
            if (prefetch && nks == 0) {
              const int q0 = nc * pieces_per_chunk;
              load_slot_pieces(next_slot, sCond, ldx, xb, cb, next_first, a.T, dim, q0,
                               min(q0 + pieces_per_chunk, slot_pieces));
            }
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const __nv_bfloat16* wbuf = sW + (s % 2) * kKS * kLdW + warp * 16;
#pragma unroll
          for (int kk = 0; kk < kKS; kk += 16) {
            FragB fb;
            wmma::load_matrix_sync(fb, wbuf + kk * kLdW, kLdW);
#pragma unroll
            for (int rf = 0; rf < 3; ++rf) {
              FragA fa;
              wmma::load_matrix_sync(
                  fa, sRing + ((p + rf) % kSlots) * kTM * ldx + ks * kKS + kk, ldx);
              wmma::mma_sync(h[rf], fa, fb, h[rf]);
            }
          }
          __syncthreads();  // the buffer is refilled two slices on
        }
        store_h(sH, h, warp);
        finish_chunk<kFr>(acc, sH, sAct, a.b_in, a.dw, a.dw_bias, a.alpha, a.w2, dim, inner,
                          a.k, c0, t_first, a.T, warp);
        __syncthreads();
      }
      store_rows<kFr>(acc, sH + warp * 256, a.b2, xb + (size_t)p * kTM * dim,
                      cb + (size_t)p * kTM * dim, a.out + base + (size_t)p * kTM * dim,
                      min(kTM, a.T - p * kTM), dim, warp, lane);
      if (prefetch) {
        // slot p + 3 arrived with the last slice; normalise it in place (rows outside the
        // sequence were zero-filled and stay so)
        for (int r = warp; r < kTM; r += kWarps) {
          const int t = next_first + r;
          if (t >= 0 && t < a.T)
            layer_norm_row(next_slot + r * ldx, next_slot + r * ldx, sCond + r * ldx, step,
                           a.ln_scale, a.ln_bias, dim, lane);
        }
      }
      __syncthreads();
    }
  }
}

size_t v2_smem(int dim) {
  return (size_t)kWin * (dim + 8) * 2 + (size_t)kWin * kLdH * 4 + (size_t)kTM * kLdAct * 2;
}

size_t v3_smem(int dim) {
  return (size_t)(kSlots + 1) * kTM * (dim + 8) * 2 + (size_t)kWin * kLdH * 4 +
         (size_t)kTM * kLdAct * 2 + (size_t)2 * kKS * kLdW * 2;
}

template <int kFr>
int launch(bool v3, const LayerArgs& a, int B, cudaStream_t s) {
  const int n_tiles = (a.T + kTM - 1) / kTM;
  if (!v3) {
    const size_t smem = v2_smem(a.dim);
    cudaError_t e = cudaFuncSetAttribute(lynx_layer_v2_kernel<kFr>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    lynx_layer_v2_kernel<kFr><<<dim3(n_tiles, B), kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = v3_smem(a.dim);
  cudaError_t e = cudaFuncSetAttribute(lynx_layer_v3_kernel<kFr>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lynx_layer_v3_kernel<kFr>,
                                                         kThreads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int slots = sms * std::min(per_sm, 2);
  // work items: runs of consecutive tiles of one sequence, about one per resident block
  const int total = B * n_tiles;
  const int tiles_per_item = std::max(1, (total + slots - 1) / slots);
  const int items_per_seq = (n_tiles + tiles_per_item - 1) / tiles_per_item;
  const int n_items = B * items_per_seq;
  lynx_layer_v3_kernel<kFr><<<std::min(n_items, slots), kThreads, smem, s>>>(
      a, tiles_per_item, items_per_seq, n_items);
  return (int)cudaGetLastError();
}

int launch_any(bool v3, const void* x, const void* cond, const void* step, const void* ln_scale,
               const void* ln_bias, const void* w_in, const void* b_in, const void* dw,
               const void* dw_bias, const void* alpha, const void* w2, const void* b2, void* out,
               int B, int T, int dim, int inner, int k, int pad_l, void* stream) {
  if (dim % 64 != 0 || dim < 64 || dim > kMaxFr * kWarps * 16 || inner % kNC != 0 ||
      inner < kNC || k < 1 || k - 1 > kWin - kTM || pad_l < 0 || pad_l > k - 1 || B < 1 ||
      B > 65535 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  LayerArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(cond),
              static_cast<const float*>(step), static_cast<const float*>(ln_scale),
              static_cast<const float*>(ln_bias), static_cast<const __nv_bfloat16*>(w_in),
              static_cast<const float*>(b_in), static_cast<const float*>(dw),
              static_cast<const float*>(dw_bias), static_cast<const float*>(alpha),
              static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
              static_cast<__nv_bfloat16*>(out), T, dim, inner, k, pad_l};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((dim / 16 + kWarps - 1) / kWarps) {
    case 1: return launch<1>(v3, a, B, s);
    case 2: return launch<2>(v3, a, B, s);
    case 3: return launch<3>(v3, a, B, s);
    case 4: return launch<4>(v3, a, B, s);
    case 5: return launch<5>(v3, a, B, s);
    case 6: return launch<6>(v3, a, B, s);
    case 7: return launch<7>(v3, a, B, s);
    default: return launch<8>(v3, a, B, s);
  }
}

}  // namespace

extern "C" int lynx_layer_v2_launch(const void* x, const void* cond, const void* step,
                                    const void* ln_scale, const void* ln_bias, const void* w_in,
                                    const void* b_in, const void* dw, const void* dw_bias,
                                    const void* alpha, const void* w2, const void* b2, void* out,
                                    int B, int T, int dim, int inner, int k, int pad_l,
                                    void* stream) {
  return launch_any(false, x, cond, step, ln_scale, ln_bias, w_in, b_in, dw, dw_bias, alpha, w2,
                    b2, out, B, T, dim, inner, k, pad_l, stream);
}

extern "C" int lynx_layer_v3_launch(const void* x, const void* cond, const void* step,
                                    const void* ln_scale, const void* ln_bias, const void* w_in,
                                    const void* b_in, const void* dw, const void* dw_bias,
                                    const void* alpha, const void* w2, const void* b2, void* out,
                                    int B, int T, int dim, int inner, int k, int pad_l,
                                    void* stream) {
  return launch_any(true, x, cond, step, ln_scale, ln_bias, w_in, b_in, dw, dw_bias, alpha, w2,
                    b2, out, B, T, dim, inner, k, pad_l, stream);
}
