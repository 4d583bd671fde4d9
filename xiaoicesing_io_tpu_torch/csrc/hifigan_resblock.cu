// NSF-HiFiGAN ResBlock1 unit for Hopper (sm_90a): a leaky-ReLU pass and two tap convs on the TMA +
// wgmma GEMM core (hifigan_tapconv.cuh, sm90_gemm.cuh).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:resblock_unit (TPU kernel _kernel:45):
// one unit of raw dilated taps or of time-folded taps (models/vocoders/nsf_fast.py),
//
//     t  = bf16(lrelu(h));   z1 = sum_taps t x w1 + b1 (f32), zero on rows outside [0, T)
//     t2 = bf16(lrelu(z1));  z2 = sum_taps t2 x w2 + b2 (f32)
//     out = bf16(f32(h) + z2)
//
// with zero padding per sequence (pad_l given, the right pad is (k - 1) * d - pad_l, so folded
// taps may pad asymmetrically). The residual is added in f32 and rounded once.
//
// Bound on an H100: compute. A unit at the main-path shape does one [rows, L] x [L, L] product
// per tap that is not all zero (stage 2 of the folded vocoder at B=4, T=2048: 524288 rows, L=128,
// 17 + 7 such taps: 0.41 TFLOP) against 268 MB of compulsory traffic (bf16 in and out): ~1500
// FLOP/byte, far above the card's ~295, so tensor-core time bounds it.
//
// Design. Three launches in one stream:
//   1. a = bf16(lrelu(x)), [B, T, L] (an elementwise pass: the products read a once per tap);
//   2. the first conv on the core, A = a, the kept taps of w1 at rows tap * d1 - p1, its epilogue
//      t2 = bf16(lrelu(z1 + b1)) over rows [0, T);
//   3. the second conv, A = t2 (rows outside [0, T) read as zeros), the kept taps of w2, its
//      epilogue of the rows kind (ResidualBf16 below): out = bf16(f32(x) + (z2 + b2)), reading x
//      and writing out four columns a thread, neighbouring threads on neighbouring columns.
// The bf16 round trips of a and t2 cost 4 x 134 MB at stage 2 (~0.16 ms of HBM a unit); every
// tap reads its 128-row box of A again (from L2), and the all-zero taps of a folded conv are
// never loaded. Widths: L % 16 == 0, 16 <= L <= 512; any reach (k - 1) * d, up to 64 kept taps.

#include "hifigan_tapconv.cuh"

namespace {

constexpr int kMaxL = 512;

// out = bf16(f32(x) + (z2 + b2)), four columns of one row.
struct ResidualBf16 {
  struct In {
    uint2 x;
    float4 bias;
  };
  static constexpr int kBatch = 8;
  const __nv_bfloat16* x;
  const float* bias;
  __nv_bfloat16* out;
  int rows;
  int cols;
  __device__ __forceinline__ In load4(int b, int r, int n) const {
    return In{*reinterpret_cast<const uint2*>(x + ((size_t)b * rows + r) * cols + n),
              *reinterpret_cast<const float4*>(bias + n)};
  }
  __device__ __forceinline__ void store4(int b, int r, int n, float4 z, const In& in) const {
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.x.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.x.y));
    const float4 bn = in.bias;
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(x01.x + (z.x + bn.x), x01.y + (z.y + bn.y));
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(x23.x + (z.z + bn.z), x23.y + (z.w + bn.w));
    uint2 o;
    o.x = *reinterpret_cast<const unsigned*>(&o01);
    o.y = *reinterpret_cast<const unsigned*>(&o23);
    *reinterpret_cast<uint2*>(out + ((size_t)b * rows + r) * cols + n) = o;
  }
};

}  // namespace

// One ResBlock1 unit. x, out bf16 [B, T, L]; a, t2 bf16 [B, T, L] scratch, whose tensor maps are
// map_a and map_t2 (box rows 128); map_w1, map_w2: the K-major kept taps of each conv [L, n * a_k]
// (box rows bn); kept1, kept2: the kept taps' indices (host arrays); b1, b2 f32 [L]; p1, p2 the
// left pads. All pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int hifigan_resblock_unit_launch(
    const void* map_a, const void* map_t2, const void* map_w1, const int* kept1, int n1, int d1,
    int p1, const void* map_w2, const int* kept2, int n2, int d2, int p2, const void* x,
    const void* b1, const void* b2, void* a, void* t2, void* out, int B, int T, int L, int bn,
    void* stream) {
  if (B < 1 || B > 65535 || T < 1 || L < 16 || L % 16 != 0 || L > kMaxL || d1 < 1 || d2 < 1 ||
      p1 < 0 || p2 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = tapconv::lrelu_pass(x, a, (long long)B * T * L, s);
  if (e != cudaSuccess) return (int)e;
  e = tapconv::first_conv(map_a, tapconv::Conv{map_w1, kept1, n1, d1, p1}, b1, t2, B, T, L, bn, s);
  if (e != cudaSuccess) return (int)e;
  const ResidualBf16 residual{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b2),
                              static_cast<__nv_bfloat16*>(out), T, L};
  return (int)tapconv::conv(map_t2, tapconv::Conv{map_w2, kept2, n2, d2, p2}, B, T, L, bn,
                            residual, s);
}
