// Device pieces of the hybrid conv tail (lynx_hybrid.cu: K8), hand-written with WMMA. The tail
// works on tiles of kTM = 16 output rows of one sequence and walks the conv module's inner width
// in chunks of kNC = 64 columns:
//
//   u [kWin window rows, kNC] f32  -> depthwise conv (k <= 33 taps) + bias -> PReLU -> bf16
//   act [kTM, kNC]                  -> acc[kTM, dim] += act x w2[chunk rows, :]   (f32, registers)
//
// so the [rows, inner] activation never leaves the SM. Window row r of a tile starting at
// sequence row t0 is sequence row t0 - pad_l + r; output row i reads window rows i .. i + k - 1.
// The [kTM, dim] f32 accumulator lives in WMMA fragments: fragment f of warp w holds columns
// (f * kWarps + w) * 16 .. + 15, so dim <= 1024 (kFr <= 8 fragments, 64 registers a thread).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace lynx {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 16;        // output rows per tile
constexpr int kWin = 48;       // window rows per tile: kTM + up to 32 halo rows (k <= 33)
constexpr int kNC = 64;        // inner columns per chunk
constexpr int kLdAct = kNC + 8;  // bf16 elements; a multiple of 8 for WMMA, 16-byte rows
constexpr int kMaxFr = 8;      // accumulator fragments per warp at dim = 1024

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// Depthwise conv over time of one chunk, + bias, PReLU, rounded to bf16 (the TPU kernels round
// here too, before the last product). sU holds the chunk's kWin window rows, f32, row stride ldu,
// rows outside the sequence already zero.
__device__ __forceinline__ void conv_prelu_chunk(const float* sU, int ldu,
                                                 const float* __restrict__ dw,
                                                 const float* __restrict__ dw_bias,
                                                 const float* __restrict__ alpha, int inner,
                                                 int c0, int k, __nv_bfloat16* sAct) {
  constexpr int kRows = kTM / (kThreads / kNC);  // 4 output rows a thread
  const int j = threadIdx.x % kNC;
  const int r0 = (threadIdx.x / kNC) * kRows;
  float acc[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
  for (int tap = 0; tap < k; ++tap) {
    const float w = dw[(size_t)tap * inner + c0 + j];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] += sU[(r0 + rr + tap) * ldu + j] * w;
  }
  const float bias = dw_bias[c0 + j];
  const float a = alpha[c0 + j];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    float v = acc[rr] + bias;
    v = v >= 0.f ? v : a * v;
    sAct[(r0 + rr) * kLdAct + j] = __float2bfloat16(v);
  }
}

template <int kFr>
__device__ __forceinline__ void zero_acc(FragAcc (&acc)[kFr]) {
#pragma unroll
  for (int f = 0; f < kFr; ++f) wmma::fill_fragment(acc[f], 0.f);
}

// acc += act [kTM, kNC] x w2[c0 .. c0 + kNC, :]. The w2 fragments are read straight from device
// memory (4 MB at the main-path width: it stays in L2).
template <int kFr>
__device__ __forceinline__ void pw_out_chunk(FragAcc (&acc)[kFr], const __nv_bfloat16* sAct,
                                             const __nv_bfloat16* __restrict__ w2, int dim,
                                             int c0, int warp) {
#pragma unroll
  for (int kk = 0; kk < kNC; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, sAct + kk, kLdAct);
#pragma unroll
    for (int f = 0; f < kFr; ++f) {
      const int col = (f * kWarps + warp) * 16;
      if (col < dim) {  // warp-uniform
        FragB b;
        wmma::load_matrix_sync(b, w2 + (size_t)(c0 + kk) * dim + col, dim);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
}

// out[r, :] = bf16(acc[r, :] + b2) for the tile's first `rows` rows. out points at the tile's
// first row; stage is this warp's 256 floats of shared memory (32-byte aligned).
template <int kFr>
__device__ __forceinline__ void store_rows(FragAcc (&acc)[kFr], float* stage,
                                           const float* __restrict__ b2,
                                           __nv_bfloat16* __restrict__ out, int rows, int dim,
                                           int warp, int lane) {
#pragma unroll
  for (int f = 0; f < kFr; ++f) {
    const int col = (f * kWarps + warp) * 16;
    if (col >= dim) continue;  // warp-uniform
    wmma::store_matrix_sync(stage, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16;
      const int n = col + e % 16;
      if (r < rows) out[(size_t)r * dim + n] = __float2bfloat16(stage[e] + b2[n]);
    }
    __syncwarp();
  }
}

}  // namespace lynx
