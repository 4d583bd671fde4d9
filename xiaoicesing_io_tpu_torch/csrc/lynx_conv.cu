// LYNXNet conv module for Hopper (sm_90a), hand-written with WMMA (bf16 in, f32 accumulate).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:lynx_conv_module (TPU kernel _kernel:33):
//
//     LayerNorm(f32) -> [dim -> inner] out and gate products -> SwiGLU -> zero rows outside the
//     sequence -> depthwise conv over time (k taps, f32) + bias -> PReLU -> [inner -> dim] product + bias
//
// Bound on an H100: compute. At the main-path shape (rows = B*T = 8192, dim 1024, inner 2048)
// the three products are 103 GFLOP against ~46 MB of compulsory traffic, far above the card's
// ~295 FLOP/byte ridge, so the tensor cores are the limit: 0.104 ms at 989 TFLOP/s. The 1 GFLOP
// f32 depthwise conv (0.016 ms on the CUDA cores) can overlap the products and does not add.
//
// Design. A [rows, dim] f32 accumulator for the last product does not fit in one block beside the
// [rows, inner] intermediate, so the module runs as two launches:
//   1. head: one block per (sequence, 96-row tile, 64 inner columns). It recomputes the LayerNorm
//      statistics of its 96 + 32 halo rows, streams the 1024-wide reduction for the out and gate
//      column chunks through shared memory, applies SwiGLU and the row mask, runs the depthwise
//      conv on the chunk in shared memory and writes PReLU(conv) as bf16 [rows, inner] -- the
//      point where the TPU kernel also rounds to bf16 before its last product.
//   2. tail: a tiled [rows, inner] x [inner, dim] product + bias, written as bf16.
// Widths: dim % 64 == 0 (the head's reduction chunk; the tail's last 128-column tile is guarded),
// inner % 64 == 0, k <= 33.
// The split costs one bf16 [rows, inner] write and read (2 * 33.5 MB at the main-path shape) and
// recomputes the first product on 32 halo rows per 96-row tile (x 4/3 on that product).
// Double buffering, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps

// ---- head ------------------------------------------------------------------
constexpr int kHeadRows = 128;                 // inner rows computed per block (tile + halo)
constexpr int kHalo = 32;                      // >= k - 1
constexpr int kTile = kHeadRows - kHalo;       // 96 output rows per block
constexpr int kNC = 64;                        // inner columns per block
constexpr int kKC = 64;                        // reduction chunk over dim
constexpr int kMaxTaps = kHalo + 1;
constexpr int kLdA = kKC + 8;                  // bf16 elements
constexpr int kLdB = kNC + 8;                  // bf16 elements
constexpr int kLdC = kNC + 4;                  // f32 elements

constexpr int kOffA = 0;
constexpr int kOffBo = kOffA + kHeadRows * kLdA * 2;
constexpr int kOffBg = kOffBo + kKC * kLdB * 2;
constexpr int kOffMean = kOffBg + kKC * kLdB * 2;
constexpr int kOffRstd = kOffMean + kHeadRows * 4;
constexpr int kOffDw = kOffRstd + kHeadRows * 4;
constexpr int kOffCo = kOffDw + kMaxTaps * kNC * 4;
constexpr int kOffCg = kOffCo + kHeadRows * kLdC * 4;
constexpr int kHeadSmem = kOffCg + kHeadRows * kLdC * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) lynx_head_kernel(
    const __nv_bfloat16* __restrict__ x,      // [B, T, dim]
    const float* __restrict__ ln_scale,       // [dim]
    const float* __restrict__ ln_bias,        // [dim]
    const __nv_bfloat16* __restrict__ w_in,   // [dim, 2 * inner], columns [out | gate]
    const float* __restrict__ b_in,           // [2 * inner]
    const float* __restrict__ dw,             // [k, inner]
    const float* __restrict__ dw_bias,        // [inner]
    const float* __restrict__ alpha,          // [inner]
    __nv_bfloat16* __restrict__ act,          // [B, T, inner]
    int T, int dim, int inner, int k, int pad_l) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + kOffA);
  __nv_bfloat16* sBo = reinterpret_cast<__nv_bfloat16*>(smem + kOffBo);
  __nv_bfloat16* sBg = reinterpret_cast<__nv_bfloat16*>(smem + kOffBg);
  float* sMean = reinterpret_cast<float*>(smem + kOffMean);
  float* sRstd = reinterpret_cast<float*>(smem + kOffRstd);
  float* sDw = reinterpret_cast<float*>(smem + kOffDw);
  float* sCo = reinterpret_cast<float*>(smem + kOffCo);
  float* sCg = reinterpret_cast<float*>(smem + kOffCg);

  const int c0 = blockIdx.x * kNC;
  const int t0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const __nv_bfloat16* xb = x + (size_t)b * T * dim;
  const int row0 = t0 - pad_l;  // sequence row of head row 0

  for (int i = tid; i < k * kNC; i += kThreads) {
    sDw[i] = dw[(size_t)(i / kNC) * inner + c0 + (i % kNC)];
  }

  // LayerNorm statistics per row, f32, two passes as the reference does.
  for (int r = warp; r < kHeadRows; r += kThreads / 32) {
    const int t = row0 + r;
    float mean = 0.f, rstd = 0.f;
    if (t >= 0 && t < T) {
      const __nv_bfloat16* xr = xb + (size_t)t * dim;
      float s = 0.f;
      for (int i = lane; i < dim; i += 32) s += __bfloat162float(xr[i]);
      mean = warp_sum(s) / dim;
      float v = 0.f;
      for (int i = lane; i < dim; i += 32) {
        const float d = __bfloat162float(xr[i]) - mean;
        v += d * d;
      }
      rstd = rsqrtf(warp_sum(v) / dim + 1e-5f);
    }
    if (lane == 0) {
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[kNC / 16], acc_g[kNC / 16];
#pragma unroll
  for (int j = 0; j < kNC / 16; ++j) {
    wmma::fill_fragment(acc_o[j], 0.f);
    wmma::fill_fragment(acc_g[j], 0.f);
  }

  for (int k0 = 0; k0 < dim; k0 += kKC) {
    // A: normalised rows, 8 bf16 per thread per step. Rows outside the sequence are zero
    // (they are masked after SwiGLU, so their value does not matter).
    for (int v = tid; v < kHeadRows * (kKC / 8); v += kThreads) {
      const int r = v / (kKC / 8);
      const int kk = (v % (kKC / 8)) * 8;
      const int t = row0 + r;
      __align__(16) __nv_bfloat16 vals[8];
      if (t >= 0 && t < T) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)t * dim + k0 + kk);
        const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
        const float m = sMean[r], rs = sRstd[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xn = (__bfloat162float(xv[e]) - m) * rs;
          vals[e] = __float2bfloat16(xn * ln_scale[k0 + kk + e] + ln_bias[k0 + kk + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(sA + r * kLdA + kk) = *reinterpret_cast<const uint4*>(vals);
    }
    // B: the out and gate column chunks of w_in.
    for (int v = tid; v < kKC * (kNC / 8); v += kThreads) {
      const int kk = v / (kNC / 8);
      const int j = (v % (kNC / 8)) * 8;
      const __nv_bfloat16* wr = w_in + (size_t)(k0 + kk) * 2 * inner;
      *reinterpret_cast<uint4*>(sBo + kk * kLdB + j) =
          *reinterpret_cast<const uint4*>(wr + c0 + j);
      *reinterpret_cast<uint4*>(sBg + kk * kLdB + j) =
          *reinterpret_cast<const uint4*>(wr + inner + c0 + j);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + warp * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kNC / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sBo + kk * kLdB + j * 16, kLdB);
        wmma::mma_sync(acc_o[j], fa, fb, acc_o[j]);
        wmma::load_matrix_sync(fb, sBg + kk * kLdB + j * 16, kLdB);
        wmma::mma_sync(acc_g[j], fa, fb, acc_g[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kNC / 16; ++j) {
    wmma::store_matrix_sync(sCo + warp * 16 * kLdC + j * 16, acc_o[j], kLdC, wmma::mem_row_major);
    wmma::store_matrix_sync(sCg + warp * 16 * kLdC + j * 16, acc_g[j], kLdC, wmma::mem_row_major);
  }
  __syncthreads();

  // SwiGLU, then zero every row outside the sequence: the conv's SAME zero padding acts on the
  // inner activations, not on x.
  for (int i = tid; i < kHeadRows * kNC; i += kThreads) {
    const int r = i / kNC, j = i % kNC;
    const int t = row0 + r;
    float u = 0.f;
    if (t >= 0 && t < T) {
      const float g = sCg[r * kLdC + j] + b_in[inner + c0 + j];
      const float o = sCo[r * kLdC + j] + b_in[c0 + j];
      u = o * (g * (1.f / (1.f + expf(-g))));
    }
    sCo[r * kLdC + j] = u;
  }
  __syncthreads();

  // Depthwise conv over time on the chunk, + bias, PReLU, bf16 out.
  const int j = tid % kNC;
  const int group = tid / kNC;
  constexpr int kRowsPerThread = kTile / (kThreads / kNC);
  const float bias = dw_bias[c0 + j];
  const float a = alpha[c0 + j];
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int r = group * kRowsPerThread + rr;
    const int t = t0 + r;
    if (t >= T) break;
    float acc = 0.f;
    for (int tap = 0; tap < k; ++tap) acc += sCo[(r + tap) * kLdC + j] * sDw[tap * kNC + j];
    acc += bias;
    acc = acc >= 0.f ? acc : a * acc;
    act[((size_t)b * T + t) * inner + c0 + j] = __float2bfloat16(acc);
  }
}

// ---- tail: out = act @ w2 + b2 ---------------------------------------------
constexpr int kTM = 128, kTN = 128, kTK = 32;
constexpr int kLdTA = kTK + 8;
constexpr int kLdTB = kTN + 8;

__global__ void __launch_bounds__(kThreads) lynx_tail_kernel(
    const __nv_bfloat16* __restrict__ act,  // [rows, inner]
    const __nv_bfloat16* __restrict__ w2,   // [inner, dim]
    const float* __restrict__ b2,           // [dim]
    __nv_bfloat16* __restrict__ out,        // [rows, dim]
    int rows, int inner, int dim) {
  __shared__ __align__(128) __nv_bfloat16 sA[kTM * kLdTA];
  __shared__ __align__(128) __nv_bfloat16 sB[kTK * kLdTB];
  __shared__ __align__(128) float sStage[kThreads / 32][16 * 16];

  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * kTM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 4 x 32 rows
  const int wn = warp & 1;   // 2 x 64 columns

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < inner; k0 += kTK) {
    for (int v = tid; v < kTM * (kTK / 8); v += kThreads) {
      const int r = v / (kTK / 8);
      const int kk = (v % (kTK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < rows) val = *reinterpret_cast<const uint4*>(act + (size_t)(m0 + r) * inner + k0 + kk);
      *reinterpret_cast<uint4*>(sA + r * kLdTA + kk) = val;
    }
    for (int v = tid; v < kTK * (kTN / 8); v += kThreads) {
      const int kk = v / (kTN / 8);
      const int n = (v % (kTN / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n0 + n < dim) val = *reinterpret_cast<const uint4*>(w2 + (size_t)(k0 + kk) * dim + n0 + n);
      *reinterpret_cast<uint4*>(sB + kk * kLdTB + n) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * kLdTA + kk, kLdTA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + kk * kLdTB + wn * 64 + j * 16, kLdTB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* stage = sStage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + wm * 32 + i * 16 + e / 16;
        const int n = n0 + wn * 64 + j * 16 + e % 16;
        if (r < rows && n < dim) out[(size_t)r * dim + n] = __float2bfloat16(stage[e] + b2[n]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int lynx_conv_module_launch(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w_in, const void* b_in,
    const void* dw, const void* dw_bias, const void* alpha, const void* w2, const void* b2,
    void* act, void* out, int B, int T, int dim, int inner, int k, int pad_l, void* stream) {
  if (dim % kKC != 0 || inner % kNC != 0 || inner % kTK != 0 || k < 1 ||
      k - 1 > kHalo || pad_l < 0 || pad_l > k - 1 || B < 1 || T < 1 || (T + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(lynx_head_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kHeadSmem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 g1(inner / kNC, (T + kTile - 1) / kTile, B);
  lynx_head_kernel<<<g1, kThreads, kHeadSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const __nv_bfloat16*>(w_in),
      static_cast<const float*>(b_in), static_cast<const float*>(dw),
      static_cast<const float*>(dw_bias), static_cast<const float*>(alpha),
      static_cast<__nv_bfloat16*>(act), T, dim, inner, k, pad_l);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = B * T;
  dim3 g2((dim + kTN - 1) / kTN, (rows + kTM - 1) / kTM);
  lynx_tail_kernel<<<g2, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(act), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), rows, inner, dim);
  return (int)cudaGetLastError();
}
