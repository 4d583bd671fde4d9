// The tap convolution of the NSF-HiFiGAN resblock kernels, K2 (csrc/hifigan_stage.cu) and K6
// (csrc/hifigan_resblock.cu), on the Hopper GEMM core (sm90_gemm.cuh), sm_90a.
//
// A ResBlock1 unit is two convs over the rows of each sequence, each
//
//     z[b, t, :] = sum over the conv's taps j of  a[b, t + j * d - pad_l, :] @ W[j]   (f32)
//
// with zero rows outside [0, T). That is the core's product with one tap-table row per tap: A is
// a [B, T, L] bf16 activation read through a 3-D tensor map, tap j's 128-row box starts at row
// t0 + j * d - pad_l of the same sequence (grid z), and TMA's zero fill outside [0, T) is the
// per-sequence padding, at any reach, with no halo staged. The host drops the taps whose weights
// are all zero (the time-folded convs of models/vocoders/nsf_fast.py have such taps) together
// with their rows, and hands the core a K-major copy of the kept taps, [L, kept * a_k] with
// a_k = L rounded up to 64 and zero weights past L (A's columns past L read as zero).
//
// What both kernels share: the leaky-ReLU pass that makes a unit's first A, and the first conv,
// whose epilogue writes the second conv's A, t2 = bf16(lrelu(z1 + b1)) over rows [0, T) (the
// second conv reads rows outside them as zeros: the Pallas kernels' masking of the gap rows).
// Only the second conv's epilogue differs between K2 and K6.

#pragma once

#include "sm90_gemm.cuh"

namespace tapconv {
namespace {

constexpr float kSlope = 0.1f;  // the vocoder's leaky-ReLU slope

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// a = bf16(lrelu(f32(x))), eight values a thread in 16-byte pieces.
__global__ void __launch_bounds__(256) lrelu_kernel(const uint4* __restrict__ x,
                                                    uint4* __restrict__ a, long long n8) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  uint4 q = x[i];
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    p[e] = __floats2bfloat162_rn(lrelu(f.x), lrelu(f.y));
  }
  a[i] = q;
}

// x, a: 16-byte aligned bf16, n values, n % 8 == 0.
inline cudaError_t lrelu_pass(const void* x, void* a, long long n, cudaStream_t s) {
  const long long n8 = n / 8;
  const long long blocks = (n8 + 255) / 256;
  if (n % 8 || blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  lrelu_kernel<<<(unsigned)blocks, 256, 0, s>>>(static_cast<const uint4*>(x),
                                                static_cast<uint4*>(a), n8);
  return cudaGetLastError();
}

// The first conv's epilogue: t2[b, t, n] = bf16(lrelu(z1 + b1[n])).
struct BiasLreluBf16 {
  using Out = __nv_bfloat16;
  using Pair = __nv_bfloat162;
  const float* bias;
  __nv_bfloat16* out;
  int rows;
  int cols;
  __device__ __forceinline__ Pair value(int, int, int n, float v0, float v1) const {
    const float2 bn = *reinterpret_cast<const float2*>(bias + n);
    return __floats2bfloat162_rn(lrelu(v0 + bn.x), lrelu(v1 + bn.y));
  }
  __device__ __forceinline__ Out* row(int b, int r) const {
    return out + ((size_t)b * rows + r) * cols;
  }
};

// One conv's operands from the host: the tensor map of its kept taps' K-major copy (box rows
// bn), the kept taps' indices, the dilation and the left pad.
struct Conv {
  const void* map_w;
  const int* kept;
  int n_kept;
  int d;
  int pad_l;
};

// z = conv(A) over batch sequences of rows x L, handed to epi. map_a: A [batch, rows, L], box
// rows 128; bn: the N tile (128 or 256), the box rows of c.map_w.
template <class Epi>
cudaError_t conv(const void* map_a, const Conv& c, int batch, int rows, int L, int bn,
                 const Epi& epi, cudaStream_t s) {
  if (c.n_kept < 1 || c.n_kept > sm90::kMaxTaps || L < 16 || L % 16) return cudaErrorInvalidValue;
  sm90::Args args{};
  args.rows = rows;
  args.cols = L;
  args.a_k = (L + sm90::kBK - 1) / sm90::kBK * sm90::kBK;
  args.taps = c.n_kept;
  for (int j = 0; j < c.n_kept; ++j) {
    const long long shift = (long long)c.kept[j] * c.d - c.pad_l;
    if (shift < -(1LL << 30) || shift > (1LL << 30)) return cudaErrorInvalidValue;
    args.tap_row[j] = (int)shift;
  }
  if (bn == 256) return sm90::launch<256, false>(map_a, c.map_w, args, batch, epi, s);
  if (bn == 128) return sm90::launch<128, false>(map_a, c.map_w, args, batch, epi, s);
  return cudaErrorInvalidValue;
}

// The first conv of a unit: t2 = bf16(lrelu(conv(a) + b1)), [batch, rows, L].
inline cudaError_t first_conv(const void* map_a, const Conv& c, const void* b1, void* t2,
                              int batch, int rows, int L, int bn, cudaStream_t s) {
  const BiasLreluBf16 epi{static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(t2), rows,
                          L};
  return conv(map_a, c, batch, rows, L, bn, epi, s);
}

}  // namespace
}  // namespace tapconv
