// NSF-HiFiGAN ResBlock1 unit for Hopper (sm_90a), hand-written with WMMA (bf16 in, f32 accumulate).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:resblock_unit (TPU kernel _kernel:45):
// one unit of raw dilated taps or of time-folded taps (models/vocoders/nsf_fast.py),
//
//     t  = bf16(lrelu(h));   z1 = sum_taps t x w1 + b1 (f32), zero on rows outside [0, T)
//     t2 = bf16(lrelu(z1));  z2 = sum_taps t2 x w2 + b2 (f32)
//     out = bf16(f32(h) + z2)
//
// with SAME zero padding per sequence (pad_l given, the right pad is (k - 1) * d - pad_l, so folded
// taps may pad asymmetrically). The residual is added in f32 and rounded once.
//
// Bound on an H100: compute. A unit at the main-path shape does k1 + k2 tap products of
// [rows, L] x [L, L] (stage 2 of the folded vocoder at B=4, T=2048: 524288 rows, L=128, up to
// 27 + 7 taps: 0.58 TFLOP) against 268 MB of compulsory traffic (bf16 in and out): ~2000 FLOP/byte,
// far above the card's ~295, so tensor-core time bounds it.
//
// Design. A block owns UT = M1 - 16 output rows of one sequence (the second conv reaches at most
// 16 rows). It stages bf16 lrelu(h) for M1 + (k1 - 1) * d1 rows in shared memory, halos read by
// index (no gap-flattened copy as on the TPU); runs the first conv over M1 rows; masks, adds the
// bias and activates into shared memory as bf16 (over the staged rows, which are dead by then);
// runs the second conv over UT rows; and adds bias and residual in an f32 epilogue. Unlike K2's
// per-unit launch (csrc/hifigan_stage.cu), which reads its WMMA B fragments from L2, the tap
// weights stream through shared memory: chunks of KC input channels x L output columns of one
// tap, double-buffered with cp.async, one barrier per chunk, and the first chunk of the second conv
// arrives while the first conv's epilogue runs. The warps tile the output 2-D: WR row groups (row
// fragments dealt round-robin) x ceil(L/16 / CF) column groups of CF fragments, so each A fragment
// from shared memory feeds CF products and each B fragment up to ceil(M1/16 / WR).
//
// Widths: any L % 16 == 0 up to 512. L <= 128: M1 = 144 (UT 128), two row groups, KC = 64, at
// most 105 KB of shared memory and 128 registers (launch bounds), so two blocks share an SM: one
// block's warps compute while the other's wait at a chunk barrier (on an H100 this cut the 27
// folded units of stages 2-4 from 73 to 49 ms against 166 registers and one block, at the cost of
// a few spilled bytes). L <= 256: M1 = 80 (UT 64), KC = 32; L <= 512: M1 = 64 (UT 48), four
// fragments a warp, KC = 32; both one block an SM. Reaches: (k1 - 1) * d1 <= 64, (k2 - 1) * d2 <= 16,
// which covers the shipped vocoder's raw taps (50 and 10) and folded taps (26 and 6). Every tap is
// computed, also the all-zero blocks that folding leaves in a dilated conv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHalo2 = 16;      // rows of the first conv beyond the output rows: (k2 - 1) * d2 <= 16
constexpr int kMaxReach1 = 64;  // (k1 - 1) * d1
constexpr int kMaxL = 512;
constexpr int kMaxSmem = 232448;

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.1f * v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One conv's products for the weight chunk in sw (KC input channels from ci0, every output
// column): acc[j][n] += A rows (m * 16 + off ..) x sw, row fragment m = wr + j * WR < nrf.
template <int CF, int WR, int RF, int KC>
__device__ __forceinline__ void chunk_products(FragAcc (&acc)[RF][CF], const __nv_bfloat16* sa,
                                               const __nv_bfloat16* sw, int ld, int kn, int nrf,
                                               int wr, const int (&col)[CF]) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    if (kk >= kn) break;  // a partial last chunk of input channels
    FragB fb[CF];
#pragma unroll
    for (int n = 0; n < CF; ++n) wmma::load_matrix_sync(fb[n], sw + (size_t)kk * ld + col[n], ld);
#pragma unroll
    for (int j = 0; j < RF; ++j) {
      const int m = wr + j * WR;
      if (m < nrf) {  // warp-uniform
        FragA fa;
        wmma::load_matrix_sync(fa, sa + (size_t)m * 16 * ld + kk, ld);
#pragma unroll
        for (int n = 0; n < CF; ++n) wmma::mma_sync(acc[j][n], fa, fb[n], acc[j][n]);
      }
    }
  }
}

template <int CF, int WR, int M1, int KC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) resblock_unit_kernel(
    const __nv_bfloat16* __restrict__ x,   // [B, T, L] unit input (the residual stream)
    const __nv_bfloat16* __restrict__ w1,  // [k1, L, L] taps, [tap][c_in][c_out]
    const float* __restrict__ b1,          // [L]
    const __nv_bfloat16* __restrict__ w2,  // [k2, L, L]
    const float* __restrict__ b2,          // [L]
    __nv_bfloat16* __restrict__ out,       // [B, T, L]
    int T, int L, int k1, int d1, int p1, int k2, int d2, int p2) {
  constexpr int UT = M1 - kHalo2;      // output rows per block
  constexpr int NRF1 = M1 / 16;        // row fragments of the first conv
  constexpr int NRF2 = UT / 16;        // and of the second
  constexpr int RF = (NRF1 + WR - 1) / WR;
  const int ld = L + 16;               // bf16 row stride: every row 32-byte aligned for WMMA
  const int nf = L / 16;
  const int ngroups = (nf + CF - 1) / CF;  // column groups; the host keeps ngroups * WR <= 8
  const int na = M1 + (k1 - 1) * d1;   // staged rows of lrelu(h)
  const int nkc = (L + KC - 1) / KC;   // weight chunks per tap
  const int n1 = k1 * nkc, n_all = (k1 + k2) * nkc;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // na x ld, then M1 x ld of t2
  __nv_bfloat16* sW = sA + (size_t)na * ld;                     // 2 x KC x ld
  float* sStage = reinterpret_cast<float*>(sW + (size_t)2 * KC * ld) + (threadIdx.x >> 5) * 256;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * UT;
  const size_t seq = (size_t)blockIdx.y * T * L;
  const int s0 = t0 - p2;   // sequence row of first-conv output row 0
  const int a0 = s0 - p1;   // sequence row of staged row 0
  const int v8 = L / 8;     // 16-byte vectors per row

  // Weight chunk c (the first conv's k1 * nkc chunks, then the second's) -> buffer c & 1.
  auto issue = [&](int c) {
    const bool first = c < n1;
    const int cc = first ? c : c - n1;
    const int tap = cc / nkc;
    const int ci0 = (cc - tap * nkc) * KC;
    const int rows = min(KC, L - ci0);
    const __nv_bfloat16* src = (first ? w1 : w2) + ((size_t)tap * L + ci0) * L;
    __nv_bfloat16* dst = sW + (size_t)(c & 1) * KC * ld;
    for (int v = tid; v < rows * v8; v += kThreads) {
      const int r = v / v8;
      const int e = (v - r * v8) * 8;
      cp_async16(dst + (size_t)r * ld + e, src + (size_t)r * L + e);
    }
    cp_async_commit();
  };
  issue(0);

  // Stage bf16(lrelu(h)); rows outside the sequence are zero.
  for (int v = tid; v < na * v8; v += kThreads) {
    const int r = v / v8;
    const int e = (v - r * v8) * 8;
    const int t = a0 + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < T) q = *reinterpret_cast<const uint4*>(x + seq + (size_t)t * L + e);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(lrelu(f.x), lrelu(f.y));
    }
    *reinterpret_cast<uint4*>(sA + (size_t)r * ld + e) = q;
  }

  // This warp's tile: row group wr, column group wg. A column fragment past the last one
  // recomputes the last and is not stored, which keeps the product loops free of branches.
  const int wg = warp % ngroups;
  const int wr = warp / ngroups;
  const bool active = wr < WR;
  int col[CF];
  bool keep[CF];
#pragma unroll
  for (int n = 0; n < CF; ++n) {
    const int f = wg * CF + n;
    keep[n] = f < nf;
    col[n] = (keep[n] ? f : nf - 1) * 16;
  }

  FragAcc acc[RF][CF];
#pragma unroll
  for (int j = 0; j < RF; ++j)
#pragma unroll
    for (int n = 0; n < CF; ++n) wmma::fill_fragment(acc[j][n], 0.f);

  // First conv over M1 rows. The barrier at the top of chunk c makes chunk c (and, at c = 0, the
  // staged rows) visible and retires chunk c - 1's buffer, which chunk c + 1 then refills.
  for (int c = 0; c < n1; ++c) {
    cp_async_wait_all();
    __syncthreads();
    issue(c + 1);  // k2 >= 1, so chunk c + 1 exists
    if (active) {
      const int tap = c / nkc;
      const int ci0 = (c - tap * nkc) * KC;
      chunk_products<CF, WR, RF, KC>(acc, sA + (size_t)tap * d1 * ld + ci0,
                                 sW + (size_t)(c & 1) * KC * ld, ld, min(KC, L - ci0), NRF1, wr,
                                 col);
    }
  }
  __syncthreads();  // every warp is done with the staged rows: t2 overwrites them

  // + bias, zero outside the sequence, lrelu, bf16: the second conv's input, M1 rows.
  __nv_bfloat16* sT = sA;
  if (active) {
#pragma unroll
    for (int j = 0; j < RF; ++j) {
      const int m = wr + j * WR;
#pragma unroll
      for (int n = 0; n < CF; ++n) {
        if (m >= NRF1 || !keep[n]) continue;  // warp-uniform
        wmma::store_matrix_sync(sStage, acc[j][n], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          const int co = col[n] + e % 16;
          const int t = s0 + r;
          const float v = (t >= 0 && t < T) ? sStage[e] + b1[co] : 0.f;
          sT[(size_t)r * ld + co] = __float2bfloat16(lrelu(v));
        }
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RF; ++j)
#pragma unroll
    for (int n = 0; n < CF; ++n) wmma::fill_fragment(acc[j][n], 0.f);

  // Second conv over UT rows.
  for (int c = n1; c < n_all; ++c) {
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_all) issue(c + 1);
    if (active) {
      const int tap = (c - n1) / nkc;
      const int ci0 = (c - n1 - tap * nkc) * KC;
      chunk_products<CF, WR, RF, KC>(acc, sT + (size_t)tap * d2 * ld + ci0,
                                 sW + (size_t)(c & 1) * KC * ld, ld, min(KC, L - ci0), NRF2, wr,
                                 col);
    }
  }
  if (!active) return;

  // Epilogue: out = bf16(h + (z2 + b2)) in f32.
#pragma unroll
  for (int j = 0; j < RF; ++j) {
    const int m = wr + j * WR;
#pragma unroll
    for (int n = 0; n < CF; ++n) {
      if (m >= NRF2 || !keep[n]) continue;  // warp-uniform
      wmma::store_matrix_sync(sStage, acc[j][n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = t0 + m * 16 + e / 16;
        if (t >= T) continue;
        const int co = col[n] + e % 16;
        const size_t i = seq + (size_t)t * L + co;
        out[i] = __float2bfloat16(__bfloat162float(x[i]) + (sStage[e] + b2[co]));
      }
      __syncwarp();
    }
  }
}

size_t unit_smem(int m1, int kc, int L, int reach1) {
  return ((size_t)(m1 + reach1) + 2 * (size_t)kc) * (L + 16) * 2 + (size_t)kWarps * 256 * 4;
}

template <int CF, int WR, int M1, int KC, int MINB>
int launch_unit(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* out, int B, int T, int L, int k1, int d1, int p1, int k2, int d2, int p2,
                cudaStream_t s) {
  constexpr int UT = M1 - kHalo2;
  const size_t smem = unit_smem(M1, KC, L, (k1 - 1) * d1);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(resblock_unit_kernel<CF, WR, M1, KC, MINB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + UT - 1) / UT, B);
  resblock_unit_kernel<CF, WR, M1, KC, MINB><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), T, L, k1, d1, p1, k2, d2,
      p2);
  return (int)cudaGetLastError();
}

}  // namespace

// One ResBlock1 unit: x, out bf16 [B, T, L]; w1 [k1, L, L], w2 [k2, L, L] bf16 taps; b1, b2 f32
// [L]; p1, p2 the left pads. All pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int hifigan_resblock_unit_launch(const void* x, const void* w1, const void* b1,
                                            const void* w2, const void* b2, void* out, int B,
                                            int T, int L, int k1, int d1, int p1, int k2, int d2,
                                            int p2, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || L < 16 || L % 16 != 0 || L > kMaxL || k1 < 1 || d1 < 1 ||
      k2 < 1 || d2 < 1 || (k1 - 1) * d1 > kMaxReach1 || (k2 - 1) * d2 > kHalo2 || p1 < 0 ||
      p1 > (k1 - 1) * d1 || p2 < 0 || p2 > (k2 - 1) * d2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nf = L / 16;
#define UNIT(CF, WR, M1, KC, MINB) \
  launch_unit<CF, WR, M1, KC, MINB>(x, w1, b1, w2, b2, out, B, T, L, k1, d1, p1, k2, d2, p2, s)
  if (nf <= 4) return UNIT(1, 2, 144, 64, 2);   // nf column groups x 2 row groups
  if (nf <= 8) return UNIT(2, 2, 144, 64, 2);   // <= 4 x 2
  if (nf <= 16) return UNIT(2, 1, 80, 32, 1);   // <= 8 x 1
  return UNIT(4, 1, 64, 32, 1);                 // <= 8 x 1
#undef UNIT
}
