// NSF-HiFiGAN resblock stage for Hopper (sm_90a), hand-written with WMMA (bf16 in, f32 accumulate).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:fused_resblock_stage (TPU kernel
// _kernel:59): the mean over num_k ResBlock1 branches, each a chain of units
//
//     h <- h + conv_{k,1}(lrelu(mask(conv_{k,d}(lrelu(h)) + b1))) + b2      (masked at the edges)
//
// with every product on bf16 inputs accumulated in f32, the residual stream and the branch sum
// in f32, and the output rounded to bf16.
//
// Bound on an H100: compute. A stage at the main-path shape does 126 tap products of
// [rows, L] x [L, L] (1.08 TFLOP at L=256 over 65536 rows, 2.16 TFLOP at L=128 over 524288
// rows) against 67-268 MB of compulsory traffic: ~16000 FLOP/byte, so tensor-core time bounds it.
//
// Design. A whole stage in one block does not fit shared memory at L=256 with its 120-row
// receptive halo, so each ResBlock1 unit is one launch (9 per stage at the 3 x 3 default):
// a block owns UT = M1 - 16 output rows of one sequence. conv_{k,d} runs on M1 rows of bf16
// lrelu(h) (plus its dilated halo) staged in shared memory, with the tap weights read as WMMA
// fragments straight from the stacked [L, k*L] layout (L2-resident); its masked, activated output
// stays in shared memory as bf16 for conv_{k,1}; the epilogue adds bias, the residual and, at the
// last unit of a branch, the f32 branch sum. Each unit re-reads its f32 residual from device
// memory: 8 extra f32 round trips of the stage tensor per stage against the one-launch design.
//
// Any width L that is a multiple of 16, up to 512, is taken: warp w owns the CF column fragments
// w*CF .. w*CF + CF-1 of the L/16 (CF = ceil(L/128)). Where L/16 is not a multiple of 8, a
// fragment past the last one recomputes a valid fragment and is not stored, which keeps the MMA
// loops free of branches; a warp with no valid fragment sits out. M1 is 128 rows (UT 112)
// where CF <= 2 and the staged rows fit shared memory, else 64 rows (UT 48), which keeps the
// accumulators of CF = 3 or 4 in registers and the staged rows of L = 512 in shared memory. The
// main path's widths, 256 and 128, take M1 = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps; warps split the output columns
constexpr int kWarps = kThreads / 32;
constexpr int kHalo2 = 16;     // rows of the first conv beyond the output rows: (k2 - 1) * d2 <= 16
constexpr int kMaxL = 512;
constexpr int kMaxSmem = 232448;

enum : int { kWriteH = 1, kReadAcc = 2, kWriteAcc = 4, kWriteOut = 8 };

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.1f * v; }

template <int CF, int M1>
__global__ void __launch_bounds__(kThreads) resblock_unit_kernel(
    const void* __restrict__ h_in, int h_is_bf16,   // [B, T, L] residual stream in
    const __nv_bfloat16* __restrict__ w1,           // [L, k1 * L] stacked taps
    const float* __restrict__ b1,                   // [L]
    const __nv_bfloat16* __restrict__ w2,           // [L, k2 * L]
    const float* __restrict__ b2,                   // [L]
    float* __restrict__ h_out,                      // [B, T, L] (kWriteH)
    float* __restrict__ acc,                        // [B, T, L] branch sum (kReadAcc / kWriteAcc)
    __nv_bfloat16* __restrict__ out,                // [B, T, L] stage output (kWriteOut)
    int T, int L, int k1, int d1, int p1, int k2, int d2, int p2, int mode, float num_k) {
  constexpr int UT = M1 - kHalo2;            // output rows per block
  const int ld = L + 16;                     // bf16 row stride: keeps every row 32-byte aligned
  const int nf = L / 16;                     // column fragments; warp w owns w*CF .. w*CF+CF-1
  extern __shared__ __align__(128) unsigned char smem[];
  const int na = M1 + (k1 - 1) * d1;         // staged input rows
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sT = sA + (size_t)na * ld;
  float* sStage = reinterpret_cast<float*>(sT + (size_t)M1 * ld) + (threadIdx.x >> 5) * 256;

  const int t0 = blockIdx.x * UT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t seq = (size_t)b * T * L;
  const int a0 = t0 - p2 - p1;               // sequence row of staged row 0
  const int s0 = t0 - p2;                    // sequence row of first-conv output row 0

  // Stage bf16(lrelu(h)); rows outside the sequence are zero.
  const int l4 = L / 4;
  for (int v = tid; v < na * l4; v += kThreads) {
    const int r = v / l4;
    const int c = (v - r * l4) * 4;
    const int t = a0 + r;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < T) {
      if (h_is_bf16) {
        const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(h_in) + seq + (size_t)t * L + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = __bfloat162float(p[e]);
      } else {
        const float4 q = *reinterpret_cast<const float4*>(static_cast<const float*>(h_in) + seq +
                                                          (size_t)t * L + c);
        f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sA[r * ld + c + e] = __float2bfloat16(lrelu(f[e]));
  }
  __syncthreads();

  // This warp's columns; a fragment past the last one recomputes a valid one (see above).
  int col[CF];
#pragma unroll
  for (int n = 0; n < CF; ++n) {
    const int f = warp * CF + n;
    col[n] = (f < nf ? f : f - nf) * 16;
  }
  const bool active = warp * CF < nf;

  // conv_{k1,d1}: M1 rows x this warp's column fragments.
  if (active) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[M1 / 16][CF];
#pragma unroll
    for (int m = 0; m < M1 / 16; ++m)
#pragma unroll
      for (int n = 0; n < CF; ++n) wmma::fill_fragment(c[m][n], 0.f);
    for (int tap = 0; tap < k1; ++tap) {
      for (int ci = 0; ci < L; ci += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[CF];
#pragma unroll
        for (int n = 0; n < CF; ++n)
          wmma::load_matrix_sync(fb[n], w1 + (size_t)ci * k1 * L + tap * L + col[n], k1 * L);
#pragma unroll
        for (int m = 0; m < M1 / 16; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, sA + (size_t)(m * 16 + tap * d1) * ld + ci, ld);
#pragma unroll
          for (int n = 0; n < CF; ++n) wmma::mma_sync(c[m][n], fa, fb[n], c[m][n]);
        }
      }
    }
    // + bias, zero outside the sequence, lrelu, bf16: the second conv's input.
#pragma unroll
    for (int m = 0; m < M1 / 16; ++m) {
#pragma unroll
      for (int n = 0; n < CF; ++n) {
        if (warp * CF + n >= nf) continue;
        wmma::store_matrix_sync(sStage, c[m][n], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m * 16 + e / 16;
          const int co = col[n] + e % 16;
          const int t = s0 + r;
          const float v = (t >= 0 && t < T) ? sStage[e] + b1[co] : 0.f;
          sT[r * ld + co] = __float2bfloat16(lrelu(v));
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  if (!active) return;

  // conv_{k2,d2}: UT rows.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c2[UT / 16][CF];
#pragma unroll
  for (int m = 0; m < UT / 16; ++m)
#pragma unroll
    for (int n = 0; n < CF; ++n) wmma::fill_fragment(c2[m][n], 0.f);
  for (int tap = 0; tap < k2; ++tap) {
    for (int ci = 0; ci < L; ci += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[CF];
#pragma unroll
      for (int n = 0; n < CF; ++n)
        wmma::load_matrix_sync(fb[n], w2 + (size_t)ci * k2 * L + tap * L + col[n], k2 * L);
#pragma unroll
      for (int m = 0; m < UT / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sT + (size_t)(m * 16 + tap * d2) * ld + ci, ld);
#pragma unroll
        for (int n = 0; n < CF; ++n) wmma::mma_sync(c2[m][n], fa, fb[n], c2[m][n]);
      }
    }
  }

  // Epilogue: + bias + residual (f32), then the branch bookkeeping.
#pragma unroll
  for (int m = 0; m < UT / 16; ++m) {
#pragma unroll
    for (int n = 0; n < CF; ++n) {
      if (warp * CF + n >= nf) continue;
      wmma::store_matrix_sync(sStage, c2[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int t = t0 + m * 16 + e / 16;
        if (t >= T) continue;
        const int co = col[n] + e % 16;
        const size_t idx = seq + (size_t)t * L + co;
        const float res = h_is_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(h_in)[idx])
            : static_cast<const float*>(h_in)[idx];
        float h = res + (sStage[e] + b2[co]);
        if (mode & kWriteH) h_out[idx] = h;
        if (mode & kReadAcc) h = acc[idx] + h;
        if (mode & kWriteAcc) acc[idx] = h;
        if (mode & kWriteOut) out[idx] = __float2bfloat16(h / num_k);
      }
      __syncwarp();
    }
  }
}

size_t unit_smem(int m1, int L, int k1, int d1) {
  return (size_t)(2 * m1 + (k1 - 1) * d1) * (L + 16) * 2 + (size_t)kWarps * 256 * 4;
}

template <int CF, int M1>
int launch_unit(const void* h_in, int h_is_bf16, const void* w1, const void* b1, const void* w2,
                const void* b2, void* h_out, void* acc, void* out, int B, int T, int L, int k1,
                int d1, int p1, int k2, int d2, int p2, int mode, float num_k, cudaStream_t s) {
  constexpr int UT = M1 - kHalo2;
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(resblock_unit_kernel<CF, M1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + UT - 1) / UT, B);
  resblock_unit_kernel<CF, M1><<<grid, kThreads, unit_smem(M1, L, k1, d1), s>>>(
      h_in, h_is_bf16, static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(h_out), static_cast<float*>(acc), static_cast<__nv_bfloat16*>(out), T,
      L, k1, d1, p1, k2, d2, p2, mode, num_k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resblock_unit_launch(const void* h_in, int h_is_bf16, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* h_out, void* acc,
                                    void* out, int B, int T, int L, int k1, int d1, int p1, int k2,
                                    int d2, int p2, int mode, float num_k, void* stream) {
  if (B < 1 || T < 1 || k1 < 1 || d1 < 1 || k2 < 1 || d2 < 1 || (k2 - 1) * d2 > kHalo2 ||
      p1 < 0 || p1 > (k1 - 1) * d1 || p2 < 0 || p2 > (k2 - 1) * d2 || B > 65535 || L < 16 ||
      L % 16 != 0 || L > kMaxL) {
    return (int)cudaErrorInvalidValue;
  }
  const int cf = (L / 16 + kWarps - 1) / kWarps;
  const bool tall = cf <= 2 && unit_smem(128, L, k1, d1) <= (size_t)kMaxSmem;
  if (!tall && unit_smem(64, L, k1, d1) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define UNIT(CF, M1)                                                                              \
  launch_unit<CF, M1>(h_in, h_is_bf16, w1, b1, w2, b2, h_out, acc, out, B, T, L, k1, d1, p1, k2, \
                      d2, p2, mode, num_k, s)
  switch (cf) {
    case 1: return tall ? UNIT(1, 128) : UNIT(1, 64);
    case 2: return tall ? UNIT(2, 128) : UNIT(2, 64);
    case 3: return UNIT(3, 64);
    default: return UNIT(4, 64);
  }
#undef UNIT
}
