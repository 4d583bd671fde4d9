// LYNXNet conv module for Hopper (sm_90a): two products on the TMA + wgmma GEMM core
// (sm90_gemm.cuh) and two memory-bound passes.
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
// Design. Four passes in one stream; ~285 MB of traffic in all at the main shape (~0.09 ms):
//   1. LayerNorm, one warp a row, f32 two-pass, written as bf16 xn [rows, dim] (the TPU kernel
//      rounds the normalised rows to bf16 before its first product too).
//   2. xn @ w_in on the GEMM core. The wrapper pairs w_in's out column j and gate column inner + j
//      in one N tile (P out and P gate columns, P = 128 where inner % 128 == 0, else 64), so the
//      epilogue adds b_in and applies SwiGLU in registers and writes u in f32 [rows, inner]: the
//      TPU kernel keeps u in f32 up to the depthwise conv.
//   3. Depthwise conv (k <= 33) + bias + PReLU over f32 u, rows outside [0, T) read as zero (this
//      replaces the row mask); written as bf16 act. A block stages 64 rows + the halo of 64
//      channels; a thread owns one channel and 32 rows and keeps the taps (zero past k) and its 32
//      sums in registers, so each staged value is read once per thread instead of once per tap.
//   4. act @ w2 + b2 on the GEMM core, written as bf16.
// Neither the conv nor the LayerNorm is fused into a product's producer: the card has not shown
// that it pays (the two memory-bound passes move ~170 MB, ~0.05 ms at the HBM rate).
// Passes 1 and 3 and the SwiGLU epilogue are shared with K5 and K7 (lynx_passes.cuh).
// Widths: dim % 64 == 0, inner % 64 == 0, k <= 33.

#include "lynx_passes.cuh"

// map_xn: xn [1, B*T, dim] (box rows 128); map_w_in: w_in K-major and column-paired [2 inner, dim]
// (box rows bn_in: pairs of bn_in / 2 columns); map_act: act [1, B*T, inner] (box rows 128);
// map_w2: w2^T [dim, inner] (box rows bn_out). xn, u (f32) and act are the wrapper's scratch.
extern "C" int lynx_conv_module_launch(
    const void* map_xn, const void* map_w_in, const void* map_act, const void* map_w2,
    const void* x, const void* ln_scale, const void* ln_bias, const void* b_in, const void* dw,
    const void* dw_bias, const void* alpha, const void* b2, void* xn, void* u, void* act, void* out,
    int B, int T, int dim, int inner, int k, int pad_l, int bn_in, int bn_out, void* stream) {
  if (!lynx_passes::widths_ok(B, T, dim, inner, k, pad_l, bn_in, bn_out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * T;
  const lynx_passes::Bf16Rows h{static_cast<const __nv_bfloat16*>(x), dim};
  cudaError_t e = lynx_passes::layer_norm(h, ln_scale, ln_bias, xn, rows, dim, s);
  if (e != cudaSuccess) return (int)e;

  const lynx_passes::SwigluEpi swiglu{static_cast<const float*>(b_in), static_cast<float*>(u),
                                      inner};
  const sm90::Args head{rows, 2 * inner, dim, 1, {0}};
  e = bn_in == 256 ? sm90::launch<256, true>(map_xn, map_w_in, head, 1, swiglu, s)
                   : sm90::launch<128, true>(map_xn, map_w_in, head, 1, swiglu, s);
  if (e != cudaSuccess) return (int)e;

  e = lynx_passes::dwconv_prelu(u, dw, dw_bias, alpha, act, B, T, inner, k, pad_l, s);
  if (e != cudaSuccess) return (int)e;

  const sm90::StoreBiasBf16 store{static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
                                  rows, dim};
  const sm90::Args tail{rows, dim, inner, 1, {0}};
  e = bn_out == 256 ? sm90::launch<256, false>(map_act, map_w2, tail, 1, store, s)
                    : sm90::launch<128, false>(map_act, map_w2, tail, 1, store, s);
  return (int)e;
}
