// WaveNet residual block for Hopper (sm_90a), hand-written with WMMA (bf16 in, f32 accumulate).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:wavenet_block (TPU kernel _kernel:33).
// Per row t of each sequence, with y = x + step projection (added by the caller):
//
//     z   = y[t - d] @ W0 + y[t] @ W1 + y[t + d] @ W2 + b_conv + cond_proj[t]   (f32; rows outside
//           the sequence read as zero: the dilated conv's SAME padding of y)
//     g   = sigmoid(z[:, :C]) * tanh(z[:, C:])                                 (rounded to bf16)
//     out = g @ Wo + b_o                                                        (bf16 [residual | skip])
//
// W0..W2 and Wo are [C, 2C] bf16, the biases f32, cond_proj bf16 [B, T, 2C].
//
// Bound on an H100: compute. At the main-path shape (B=4, T=2048, C=512) the four products are
// 34.4 GFLOP against ~46 MB of compulsory traffic (y, cond_proj, out, weights), ~750 FLOP/byte,
// above the card's ~295 FLOP/byte ridge: 0.0347 ms at 989 TFLOP/s.
//
// Design. One launch per layer; a block owns 64 rows of one sequence and never reads another
// sequence's rows: it stages its 64 + 2d rows of y by sequence index, zero outside [0, T) (the TPU
// kernel gathered windows with zero gap rows instead). The [64, 2C] pre-activation and the
// [64, C] gated activations never leave the block:
//   phase 1, for each 64-column chunk j of C: gate columns j and filter columns C + j accumulate
//     together over the 3 taps and all C input channels (weights streamed through shared memory
//     32 rows at a time), then each warp adds bias and cond_proj to its own fragments, gates the
//     pair and writes g as bf16 into a [64, C] shared tile;
//   phase 2, for each 128-column chunk of 2C: g @ Wo, + bias, written as bf16.
// 8 warps split the 64 rows in two and each chunk's columns in four. Every row stride is a
// multiple of 32 bytes (WMMA's alignment) at any tap offset. Shared memory is
// (64 + 2d) rows of y + 64 rows of g, each (C + 16) bf16, + 27,648 bytes of weight staging:
// 196,608 bytes at C = 512, d = 16, so one block per SM. Widths: C % 64 == 0, 64 <= C <= 512, and any d >= 1 whose staged rows
// fit (d <= 32 at C = 512, d <= 124 at C = 256). The weights are re-read from L2 by every block
// (4 MB per block) and the staging is not pipelined: cp.async double buffering, wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int kRows = 64;      // output rows per block
constexpr int kNC = 64;        // gate (and filter) columns per phase-1 chunk
constexpr int kNO = 128;       // output columns per phase-2 chunk
constexpr int kKC = 32;        // weight rows staged per step
constexpr int kMaxC = 512;
constexpr int kMaxSmem = 232448;
constexpr int kLdW1 = 2 * kNC + 16;            // bf16: [gate 64 | filter 64] of one tap row
constexpr int kLdW2 = kNO + 16;
constexpr int kW1Bytes = 3 * kKC * kLdW1 * 2;  // phase-1 weight staging
constexpr int kW2Bytes = kKC * kLdW2 * 2;      // phase-2 weight staging
constexpr int kFrag = 256;                     // f32 per 16 x 16 fragment
// The staging region also holds each warp's f32 epilogue fragments: two per warp in phase 1
// (after the weights of the chunk are consumed), one per warp beside the weights in phase 2.
static_assert(kThreads / 32 * 2 * kFrag * 4 <= kW1Bytes, "phase-1 epilogue staging");
static_assert(kW2Bytes + kThreads / 32 * kFrag * 4 <= kW1Bytes, "phase-2 epilogue staging");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

size_t smem_bytes(int C, int d) { return (size_t)(2 * kRows + 2 * d) * (C + 16) * 2 + kW1Bytes; }

__global__ void __launch_bounds__(kThreads) wavenet_block_kernel(
    const __nv_bfloat16* __restrict__ y,     // [B, T, C]
    const __nv_bfloat16* __restrict__ cond,  // [B, T, 2C]
    const __nv_bfloat16* __restrict__ wc,    // [3, C, 2C], taps at t - d, t, t + d
    const float* __restrict__ bc,            // [2C]
    const __nv_bfloat16* __restrict__ wo,    // [C, 2C]
    const float* __restrict__ bo,            // [2C]
    __nv_bfloat16* __restrict__ out,         // [B, T, 2C]
    int T, int C, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = C + 16;  // bf16 row stride of y and g: 32-byte aligned rows
  const int ny = kRows + 2 * d;
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sY + (size_t)ny * ld;
  unsigned char* sU = reinterpret_cast<unsigned char*>(sG + (size_t)kRows * ld);
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(sU);

  const int t0 = blockIdx.x * kRows;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;  // rows wr * 32 .. + 32
  const int wq = warp & 3;   // a quarter of each chunk's columns
  const int C2 = 2 * C;

  // Stage y rows t0 - d .. t0 + 64 + d of this sequence, zero outside [0, T).
  const int c8 = C / 8;
  const __nv_bfloat16* yb = y + (size_t)b * T * C;
  for (int v = tid; v < ny * c8; v += kThreads) {
    const int r = v / c8;
    const int c = (v - r * c8) * 8;
    const int t = t0 - d + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T) val = *reinterpret_cast<const uint4*>(yb + (size_t)t * C + c);
    *reinterpret_cast<uint4*>(sY + (size_t)r * ld + c) = val;
  }

  // Phase 1: z for gate columns j.. and filter columns C + j.., gated into sG.
  float* st1 = reinterpret_cast<float*>(sU) + warp * 2 * kFrag;
  for (int j = 0; j < C; j += kNC) {
    FragC zg[2], zf[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      wmma::fill_fragment(zg[m], 0.f);
      wmma::fill_fragment(zf[m], 0.f);
    }
    for (int k0 = 0; k0 < C; k0 += kKC) {
      // 3 taps x kKC rows x [64 gate | 64 filter] columns, 16 x 16 bytes per tap row.
      for (int v = tid; v < 3 * kKC * 16; v += kThreads) {
        const int q = v & 15;
        const int row = v >> 4;  // tap * kKC + kk
        const int tap = row / kKC;
        const int kk = row - tap * kKC;
        const int col = q < 8 ? j + q * 8 : C + j + (q - 8) * 8;
        *reinterpret_cast<uint4*>(sW + (size_t)row * kLdW1 + q * 8) =
            *reinterpret_cast<const uint4*>(wc + ((size_t)tap * C + k0 + kk) * C2 + col);
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          FragB fg, ff;
          const __nv_bfloat16* w = sW + (size_t)(tap * kKC + kk) * kLdW1 + wq * 16;
          wmma::load_matrix_sync(fg, w, kLdW1);
          wmma::load_matrix_sync(ff, w + kNC, kLdW1);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            FragA fa;
            wmma::load_matrix_sync(fa, sY + (size_t)(wr * 32 + m * 16 + tap * d) * ld + k0 + kk, ld);
            wmma::mma_sync(zg[m], fa, fg, zg[m]);
            wmma::mma_sync(zf[m], fa, ff, zf[m]);
          }
        }
      }
      __syncthreads();
    }
    // + bias + cond_proj, gate, bf16 into sG: each warp on its own fragments.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      wmma::store_matrix_sync(st1, zg[m], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st1 + kFrag, zf[m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kFrag; e += 32) {
        const int r = wr * 32 + m * 16 + e / 16;
        const int c = j + wq * 16 + e % 16;
        const int t = t0 + r;
        float g = 0.f;
        if (t < T) {
          const __nv_bfloat16* cp = cond + ((size_t)b * T + t) * C2;
          const float zgate = st1[e] + (bc[c] + __bfloat162float(cp[c]));
          const float zfilt = st1[kFrag + e] + (bc[C + c] + __bfloat162float(cp[C + c]));
          g = tanhf(zfilt) / (1.f + expf(-zgate));
        }
        sG[(size_t)r * ld + c] = __float2bfloat16(g);
      }
      __syncwarp();
    }
    __syncthreads();  // the next chunk's weights overwrite the epilogue staging
  }

  // Phase 2: out = g @ Wo + b_o, 128 columns at a time.
  __nv_bfloat16* sW2 = sW;
  float* st2 = reinterpret_cast<float*>(sU + kW2Bytes) + warp * kFrag;
  __nv_bfloat16* ob = out + (size_t)b * T * C2;
  for (int n0 = 0; n0 < C2; n0 += kNO) {
    FragC acc[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.f);
    for (int k0 = 0; k0 < C; k0 += kKC) {
      for (int v = tid; v < kKC * (kNO / 8); v += kThreads) {
        const int kk = v / (kNO / 8);
        const int n = (v % (kNO / 8)) * 8;
        *reinterpret_cast<uint4*>(sW2 + (size_t)kk * kLdW2 + n) =
            *reinterpret_cast<const uint4*>(wo + (size_t)(k0 + kk) * C2 + n0 + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wmma::load_matrix_sync(fa[m], sG + (size_t)(wr * 32 + m * 16) * ld + k0 + kk, ld);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          FragB fb;
          wmma::load_matrix_sync(fb, sW2 + (size_t)kk * kLdW2 + wq * 32 + n * 16, kLdW2);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::store_matrix_sync(st2, acc[m][n], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < kFrag; e += 32) {
          const int t = t0 + wr * 32 + m * 16 + e / 16;
          const int c = n0 + wq * 32 + n * 16 + e % 16;
          if (t < T) ob[(size_t)t * C2 + c] = __float2bfloat16(st2[e] + bo[c]);
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" int wavenet_block_launch(const void* y, const void* cond, const void* wc, const void* bc,
                                    const void* wo, const void* bo, void* out, int B, int T, int C,
                                    int d, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || C < 64 || C % 64 != 0 || C > kMaxC || d < 1 ||
      d > kMaxSmem || smem_bytes(C, d) > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(C, d);
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(wavenet_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kRows - 1) / kRows, B);
  wavenet_block_kernel<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(cond),
      static_cast<const __nv_bfloat16*>(wc), static_cast<const float*>(bc),
      static_cast<const __nv_bfloat16*>(wo), static_cast<const float*>(bo),
      static_cast<__nv_bfloat16*>(out), T, C, d);
  return (int)cudaGetLastError();
}
