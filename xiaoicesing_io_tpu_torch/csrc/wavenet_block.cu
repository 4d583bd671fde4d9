// WaveNet residual block for Hopper (sm_90a) on the TMA + wgmma GEMM core (sm90_gemm.cuh).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:wavenet_block (TPU kernel _kernel:33).
// Per row t of each sequence, with y = x + step projection (added by the caller):
//
//     z   = y[t - d] @ W0 + y[t] @ W1 + y[t + d] @ W2 + b_conv + cond_proj[t]   (f32; rows outside
//           the sequence read as zero: the dilated conv's SAME padding of y)
//     g   = sigmoid(z[:, :C]) * tanh(z[:, C:])                                 (rounded to bf16)
//     out = g @ Wo + b_o                                                        (bf16 [residual | skip])
//
// W0..W2 and Wo are [C, 2C] in the JAX layout; the wrapper hands the kernel K-major copies, the
// conv's column-paired (ops/cuda/sm90.py). Biases f32, cond_proj bf16 [B, T, 2C].
//
// Bound on an H100: compute. At the main-path shape (B=4, T=2048, C=512) the four products are
// 34.4 GFLOP against ~46 MB of compulsory traffic (y, cond_proj, out, weights), ~750 FLOP/byte,
// above the card's ~295 FLOP/byte ridge: 0.0347 ms at 989 TFLOP/s.
//
// Design. Two launches of the GEMM core, 128-row output tiles:
//   1. z and the gate: A is y through a 3-D tensor map [B, T, C], K = 3C as three taps that load
//      rows t0 - d, t0, t0 + d of the same sequence (grid z = the sequence, so a tap never reaches
//      the neighbouring one); TMA fills rows outside [0, T) with zeros, the conv's SAME padding,
//      so there is no halo staging and no bound on d. Each N tile of 2P columns (P = 128 where
//      C % 128 == 0, else 64) pairs P gate columns j.. with the P filter columns C + j.., so the
//      epilogue holds both in one thread: it adds b_conv + cond_proj[t] in f32, gates and writes
//      g as bf16 [B, T, C].
//   2. out = g @ Wo + b_o as bf16 [B*T, 2C].
// The bf16 g round trip costs 2 x 8 MB at the main shape, ~5 us of HBM. z stays f32 up to the
// gate, where the plain version rounds the conv output to bf16.
// Widths: C % 64 == 0, 64 <= C <= 512, any d >= 1.
//
// sm90_gemm_bf16_launch is the bare core (out = A @ B^T + bias), for the card tests only.

#include "sm90_gemm.cuh"

namespace {

constexpr int kMaxC = 512;

// sigmoid(zg) * tanh(zf) through the fast exponential and division (tanh(x) = 1 - 2 / (1 +
// e^2x)): the gate is on the first product's critical path, and its error (a few f32 ulp, more
// in relative terms only where |zf| is tiny and g is too) is far below g's bf16 rounding.
__device__ __forceinline__ float gate(float zg, float zf) {
  const float th = 1.f - __fdividef(2.f, 1.f + __expf(2.f * zf));
  return __fdividef(th, 1.f + __expf(-zg));
}

struct GateEpi {
  using Out = __nv_bfloat16;
  using Pair = __nv_bfloat162;
  const float* bc;            // [2C]
  const __nv_bfloat16* cond;  // [B, T, 2C]
  __nv_bfloat16* g;           // [B, T, C]
  int T;
  int C;
  __device__ __forceinline__ Pair value(int b, int t, int j, float zg0, float zg1, float zf0,
                                        float zf1) const {
    const __nv_bfloat16* cp = cond + ((size_t)b * T + t) * 2 * C;
    const float2 cg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cp + j));
    const float2 cf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cp + C + j));
    const float2 bg = *reinterpret_cast<const float2*>(bc + j);
    const float2 bf = *reinterpret_cast<const float2*>(bc + C + j);
    return __floats2bfloat162_rn(gate(zg0 + bg.x + cg.x, zf0 + bf.x + cf.x),
                                 gate(zg1 + bg.y + cg.y, zf1 + bf.y + cf.y));
  }
  __device__ __forceinline__ __nv_bfloat16* row(int b, int t) const {
    return g + ((size_t)b * T + t) * C;
  }
};

cudaError_t launch_plain(int bn, const void* map_a, const void* map_b, const sm90::Args& args,
                         const sm90::StoreBiasBf16& epi, cudaStream_t s) {
  if (bn == 256) return sm90::launch<256, false>(map_a, map_b, args, 1, epi, s);
  if (bn == 128) return sm90::launch<128, false>(map_a, map_b, args, 1, epi, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// map_y: y [B, T, C] (box rows 128); map_wc: the paired K-major conv weights [2C, 3C] (box rows
// bn_gate: pairs of bn_gate / 2 columns); map_g: g [1, B*T, C] (box rows 128); map_wo: Wo^T
// [2C, C] (box rows bn_out).
extern "C" int wavenet_block_launch(const void* map_y, const void* map_wc, const void* map_g,
                                    const void* map_wo, const void* cond, const void* bc,
                                    const void* bo, void* g, void* out, int B, int T, int C, int d,
                                    int bn_gate, int bn_out, void* stream) {
  if (B < 1 || T < 1 || C < 64 || C % 64 != 0 || C > kMaxC || d < 1 || d > (1 << 30) ||
      T > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const GateEpi gate{static_cast<const float*>(bc), static_cast<const __nv_bfloat16*>(cond),
                     static_cast<__nv_bfloat16*>(g), T, C};
  const sm90::Args conv{T, 2 * C, C, 3, {-d, 0, d}};  // taps at t - d, t, t + d
  cudaError_t e = bn_gate == 256 ? sm90::launch<256, true>(map_y, map_wc, conv, B, gate, s)
                  : bn_gate == 128 ? sm90::launch<128, true>(map_y, map_wc, conv, B, gate, s)
                                   : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const sm90::StoreBiasBf16 store{static_cast<const float*>(bo), static_cast<__nv_bfloat16*>(out),
                                  B * T, 2 * C};
  return (int)launch_plain(bn_out, map_g, map_wo, sm90::Args{B * T, 2 * C, C, 1, {0}}, store, s);
}

// out [M, N] bf16 = A [M, K] @ B^T + bias, B K-major [N, K], through maps with box rows 128 (A)
// and bn (B).
extern "C" int sm90_gemm_bf16_launch(const void* map_a, const void* map_b, const void* bias,
                                     void* out, int M, int N, int K, int bn, void* stream) {
  const sm90::StoreBiasBf16 store{static_cast<const float*>(bias),
                                  static_cast<__nv_bfloat16*>(out), M, N};
  return (int)launch_plain(bn, map_a, map_b, sm90::Args{M, N, K, 1, {0}}, store,
                           reinterpret_cast<cudaStream_t>(stream));
}
