// Whole LYNXNet residual layer (strong_cond) for Hopper (sm_90a): K1's passes (lynx_passes.cuh)
// with the layer's prologue and epilogue, both products on the TMA + wgmma GEMM core
// (sm90_gemm.cuh). Two kernels of one function:
//
//   K5 replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:lynx_layer_fused
//   K7 replaces xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:lynx_layer_fused_v3
//
//   res = bf16(x + cond_proj);  h = res + step[b] (f32)
//   out = bf16((PReLU(dwconv(SwiGLU(bf16(LN(h)) @ w_in + b_in)) + dw_bias) @ w2 + b2) + res)
//
// Bound on an H100: operations. At the main-path shape (B=4, T=2048, dim 1024, inner 2048, k 31)
// the products are 103 GFLOP against ~63 MB of compulsory traffic: 0.104 ms at 989 TFLOP/s.
//
// Design: four launches, as K1's (lynx_conv.cu):
//   1. LayerNorm of h, one warp a row, f32 two passes over h = bf16(x + cond) + step[b], formed
//      from x, cond and the step as it is read (h is never rounded), written as bf16 xn;
//   2. xn @ w_in with the paired SwiGLU epilogue, f32 u;
//   3. the depthwise conv + bias + PReLU, bf16 act;
//   4. act @ w2 with an epilogue of the rows kind (LayerOut): out = bf16((acc + b2) + res) in f32,
//      res recomputed from x and cond (the same bytes as a stored res, without its 16 MB write),
//      a batch of pieces loaded before any is stored.
// K5 runs the products on the core's one-tile-a-block launch; K7 on launch_persistent, one block
// an SM walking the tiles with TMA stores of u and out, so that a tile's epilogue overlaps the
// next tile's loads and the stores drain under the next tile's products.
// Widths: dim % 64 == 0, inner % 64 == 0, k <= 33.

#include "lynx_passes.cuh"

namespace {

// out = bf16((z + b2) + bf16(x + cond)) for four columns of one row.
struct LayerOut {
  using Out = __nv_bfloat16;
  using Out4 = uint2;
  // bf16 x 4: res is exactly bf16. K7 holds a batch of these beside its 128 accumulators, which
  // spill at BN 256: b2 (4 KB, in L1 after the first tile) is read in value4 instead, which cut
  // that kernel's spills and its output product's time (PERF.md).
  struct In {
    uint2 res;
  };
  // K7 holds its accumulators through the epilogue and loads sm90::kPersistentBatch at a time
  static constexpr int kBatch = 4;
  const __nv_bfloat16* x;
  const __nv_bfloat16* cond;
  const float* b2;
  __nv_bfloat16* out;
  int cols;

  __device__ __forceinline__ In load4(int, int r, int n) const {
    const size_t i = (size_t)r * cols + n;
    const uint2 xr = *reinterpret_cast<const uint2*>(x + i);
    const uint2 cr = *reinterpret_cast<const uint2*>(cond + i);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    const float2 c01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cr.x));
    const float2 c23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cr.y));
    const __nv_bfloat162 r01 = __floats2bfloat162_rn(x01.x + c01.x, x01.y + c01.y);
    const __nv_bfloat162 r23 = __floats2bfloat162_rn(x23.x + c23.x, x23.y + c23.y);
    In in;
    in.res.x = *reinterpret_cast<const unsigned*>(&r01);
    in.res.y = *reinterpret_cast<const unsigned*>(&r23);
    return in;
  }

  __device__ __forceinline__ uint2 value4(int, int, int n, float4 z, const In& in) const {
    const float4 bias = *reinterpret_cast<const float4*>(b2 + n);
    const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.res.x));
    const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.res.y));
    const __nv_bfloat162 o01 = __floats2bfloat162_rn((z.x + bias.x) + r01.x,
                                                     (z.y + bias.y) + r01.y);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn((z.z + bias.z) + r23.x,
                                                     (z.w + bias.w) + r23.y);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&o01);
    q.y = *reinterpret_cast<const unsigned*>(&o23);
    return q;
  }

  __device__ __forceinline__ void store4(int b, int r, int n, float4 z, const In& in) const {
    *reinterpret_cast<uint2*>(out + (size_t)r * cols + n) = value4(b, r, n, z, in);
  }
};

}  // namespace

// persistent: 0 for K5, 1 for K7. map_xn: xn [1, B*T, dim] (box rows
// 128); map_w_in: w_in K-major and column-paired [2 inner, dim] (box rows bn_in); map_act: act
// [1, B*T, inner] (box rows 128); map_w2: w2^T [dim, inner] (box rows bn_out); map_u_store,
// map_out_store (K7 only, else null): the store maps of u [1, B*T, inner] f32 and out [1, B*T,
// dim] bf16. x, cond: bf16 [B, T, dim], 16-byte aligned; step f32 [B, dim]. xn, u (f32) and act
// are the wrapper's scratch. Returns a cudaError_t.
extern "C" int lynx_layer_launch(
    int persistent, const void* map_xn, const void* map_w_in, const void* map_act,
    const void* map_w2, const void* map_u_store, const void* map_out_store, const void* x,
    const void* cond, const void* step, const void* ln_scale, const void* ln_bias,
    const void* b_in, const void* dw, const void* dw_bias, const void* alpha, const void* b2,
    void* xn, void* u, void* act, void* out, int B, int T, int dim, int inner, int k, int pad_l,
    int bn_in, int bn_out, void* stream) {
  if (!lynx_passes::widths_ok(B, T, dim, inner, k, pad_l, bn_in, bn_out) ||
      (persistent && (map_u_store == nullptr || map_out_store == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * T;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cb = static_cast<const __nv_bfloat16*>(cond);
  const lynx_passes::LayerRows h{xb, cb, static_cast<const float*>(step), T, dim};
  cudaError_t e = lynx_passes::layer_norm(h, ln_scale, ln_bias, xn, rows, dim, s);
  if (e != cudaSuccess) return (int)e;

  const lynx_passes::SwigluEpi swiglu{static_cast<const float*>(b_in), static_cast<float*>(u),
                                      inner};
  const sm90::Args head{rows, 2 * inner, dim, 1, {0}};
  if (!persistent) {
    e = bn_in == 256 ? sm90::launch<256, true>(map_xn, map_w_in, head, 1, swiglu, s)
                     : sm90::launch<128, true>(map_xn, map_w_in, head, 1, swiglu, s);
  } else if (bn_in == 256) {
    e = sm90::launch_persistent<256, true>(map_xn, map_w_in, map_u_store, head, 1, swiglu, s);
  } else {
    e = sm90::launch_persistent<128, true>(map_xn, map_w_in, map_u_store, head, 1, swiglu, s);
  }
  if (e != cudaSuccess) return (int)e;

  e = lynx_passes::dwconv_prelu(u, dw, dw_bias, alpha, act, B, T, inner, k, pad_l, s);
  if (e != cudaSuccess) return (int)e;

  const LayerOut epi{xb, cb, static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
                     dim};
  const sm90::Args tail{rows, dim, inner, 1, {0}};
  if (!persistent) {
    e = bn_out == 256 ? sm90::launch<256, false>(map_act, map_w2, tail, 1, epi, s)
                      : sm90::launch<128, false>(map_act, map_w2, tail, 1, epi, s);
  } else if (bn_out == 256) {
    e = sm90::launch_persistent<256, false>(map_act, map_w2, map_out_store, tail, 1, epi, s);
  } else {
    e = sm90::launch_persistent<128, false>(map_act, map_w2, map_out_store, tail, 1, epi, s);
  }
  return (int)e;
}

namespace {

// The bare persistent entry's test epilogues: out = acc + bias (pairs kind) and out = acc + bias
// + res (rows kind), bf16 [M, N].
struct TestPairs {
  using Out = __nv_bfloat16;
  using Pair = __nv_bfloat162;
  const float* bias;
  __device__ __forceinline__ Pair value(int, int, int n, float v0, float v1) const {
    return __floats2bfloat162_rn(v0 + bias[n], v1 + bias[n + 1]);
  }
};

struct TestRows {
  using Out = __nv_bfloat16;
  using Out4 = uint2;
  struct In {
    uint2 res;  // bf16 x 4
  };
  static constexpr int kBatch = 4;
  const float* bias;
  const __nv_bfloat16* res;
  int cols;
  __device__ __forceinline__ In load4(int, int r, int n) const {
    return In{*reinterpret_cast<const uint2*>(res + (size_t)r * cols + n)};
  }
  __device__ __forceinline__ uint2 value4(int, int, int n, float4 z, const In& in) const {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.res.x));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in.res.y));
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(z.x + bias[n] + a.x, z.y + bias[n + 1] + a.y);
    const __nv_bfloat162 o23 =
        __floats2bfloat162_rn(z.z + bias[n + 2] + c.x, z.w + bias[n + 3] + c.y);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&o01);
    q.y = *reinterpret_cast<const unsigned*>(&o23);
    return q;
  }
};

template <int BN>
cudaError_t test_gemm(const void* map_a, const void* map_b, const void* map_out,
                      const sm90::Args& args, const float* bias, const void* res,
                      cudaStream_t s) {
  if (res == nullptr) {
    return sm90::launch_persistent<BN, false>(map_a, map_b, map_out, args, 1, TestPairs{bias},
                                              s);
  }
  return sm90::launch_persistent<BN, false>(
      map_a, map_b, map_out, args, 1,
      TestRows{bias, static_cast<const __nv_bfloat16*>(res), args.cols}, s);
}

}  // namespace

// The bare persistent entry, for the card tests only: out = A @ B^T + bias (+ res when res is not
// null: the rows kind) as bf16 [M, N]; map_out is out's store map. Returns a cudaError_t.
extern "C" int sm90_gemm_persistent_launch(const void* map_a, const void* map_b,
                                           const void* map_out, const void* bias,
                                           const void* res, int M, int N, int K, int bn,
                                           void* stream) {
  if (K % sm90::kBK || (bn != 128 && bn != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const sm90::Args args{M, N, K, 1, {0}};
  const float* b = static_cast<const float*>(bias);
  const cudaError_t e = bn == 256 ? test_gemm<256>(map_a, map_b, map_out, args, b, res, s)
                                   : test_gemm<128>(map_a, map_b, map_out, args, b, res, s);
  return (int)e;
}
