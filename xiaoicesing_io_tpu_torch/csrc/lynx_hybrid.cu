// LYNXNet conv module tail for Hopper (sm_90a): K1's conv pass and its output product on the TMA +
// wgmma GEMM core (sm90_gemm.cuh).
//
// Replaces the TPU kernel of xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:lynx_conv_module_hybrid
// (_tail_kernel:32): on the bf16 `inner` activations that the head (LayerNorm -> pw_in -> SwiGLU,
// plain PyTorch) wrote,
//
//     out = bf16(bf16(PReLU(dwconv(inner) + dw_bias)) @ w2 + b2)      (residual not added)
//
// with f32 taps and zero rows outside each sequence (the head's rows are exact, so no mask).
//
// Bound on an H100: operations. At the sweep's shape (B=4, T=2048, dim 1024, inner 2048, k 31)
// the [inner -> dim] product is 34.4 GFLOP (0.035 ms at 989 TFLOP/s) against ~55 MB of compulsory
// traffic (0.016 ms); the 1.0 GFLOP f32 conv (0.016 ms on the CUDA cores) can overlap it.
//
// Design. Two launches in one stream, both shared with K1 (lynx_passes.cuh, lynx_conv.cu):
//   1. dwconv_prelu_kernel<__nv_bfloat16>: the depthwise conv, bias and PReLU over the bf16 inner
//      rows, read as 16-byte loads of 8 values and staged as f32 (64 rows and their k - 1 halo rows
//      a block, so the halo is read (64 + 30) / 64 ~ 1.5 times at k 31), written as bf16 act
//      [rows, inner], the wrapper's scratch: 32 MB read and 32 MB written at the sweep's shape.
//   2. act @ w2 + b2 on the GEMM core (128 x BN tiles, BN 256 where it divides dim, a TMA ring,
//      wgmma), StoreBiasBf16 epilogue: K1's output product at the same shape.
// The conv is not fused into the product's producer: a block cannot hold a whole [128, dim] f32
// accumulator at dim 1024, so a fused producer would redo the conv once for each N tile, 4 times at
// BN 256 (~4.2 GFLOP of f32, ~62 us even at the CUDA cores' peak), to save act's round trip, 64 MB,
// ~19 us at the HBM rate.
// Widths: K1's, dim % 64 == 0 and inner % 64 == 0 with no cap on dim, k <= 33.

#include "lynx_passes.cuh"

// map_act: act [1, B*T, inner] (box rows 128); map_w2: w2^T [dim, inner] (box rows bn_out). act is
// the wrapper's scratch.
extern "C" int lynx_conv_tail_launch(const void* map_act, const void* map_w2, const void* inner_act,
                                     const void* dw, const void* dw_bias, const void* alpha,
                                     const void* b2, void* act, void* out, int B, int T, int dim,
                                     int inner, int k, int pad_l, int bn_out, void* stream) {
  // the tail has no SwiGLU product: its N tile stands in for both
  if (!lynx_passes::widths_ok(B, T, dim, inner, k, pad_l, bn_out, bn_out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * T;
  cudaError_t e = lynx_passes::dwconv_prelu<__nv_bfloat16>(inner_act, dw, dw_bias, alpha, act, B,
                                                           T, inner, k, pad_l, s);
  if (e != cudaSuccess) return (int)e;

  const sm90::StoreBiasBf16 store{static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
                                  rows, dim};
  const sm90::Args tail{rows, dim, inner, 1, {0}};
  e = bn_out == 256 ? sm90::launch<256, false>(map_act, map_w2, tail, 1, store, s)
                    : sm90::launch<128, false>(map_act, map_w2, tail, 1, store, s);
  return (int)e;
}
