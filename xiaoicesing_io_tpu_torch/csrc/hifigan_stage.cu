// NSF-HiFiGAN resblock stage for Hopper (sm_90a): a leaky-ReLU pass and two tap convs a unit on
// the TMA + wgmma GEMM core (hifigan_tapconv.cuh, sm90_gemm.cuh).
//
// Replaces xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:fused_resblock_stage (TPU kernel
// _kernel:59): the mean over num_k ResBlock1 branches, each a chain of units
//
//     h <- h + conv_2(lrelu(mask(conv_1(lrelu(h)) + b1))) + b2      (masked at the edges)
//
// with every product on bf16 inputs accumulated in f32, the residual stream and the branch sum
// in f32, and the output rounded to bf16. conv_1 and conv_2 are any convs over the rows of each
// sequence (raw dilated taps, or the time-folded vocoder's taps with their asymmetric pads).
//
// Bound on an H100: compute. A stage at the main-path shape does 126 tap products of
// [rows, L] x [L, L] (1.08 TFLOP at L=256 over 65536 rows, 2.16 TFLOP at L=128 over 524288
// rows) against 67-268 MB of compulsory traffic: ~16000 FLOP/byte, so tensor-core time bounds it.
//
// Design. The wrapper's launch plan (ops/cuda/hifigan_stage.py:launch_plan): one leaky-ReLU pass
// a0 = bf16(lrelu(x)), shared by the first unit of every branch, then two launches of the core a
// unit. conv_1 takes A = a0 (a branch's first unit) or a1 (the others) and writes
// t2 = bf16(lrelu(z1 + b1)) (hifigan_tapconv.cuh); conv_2 takes A = t2, and its epilogue, of the
// rows kind (StageEpi below, four columns a thread), carries the stage's bookkeeping:
//   - the residual: bf16 x at a branch's first unit, else f32 h;
//   - h = residual + (z2 + b2) in f32;
//   - kWriteH (not a branch's last unit): h in place (each element is read and written by the
//     same thread) and the next unit's A, a1 = bf16(lrelu(h)), as the plain version rounds it;
//   - a branch's last unit: kReadAcc adds h to the f32 branch sum as acc + h, in the plain
//     version's order; kWriteAcc stores the sum; kWriteOut writes bf16(sum / num_k).
// The f32 h is the epilogue's largest stream (read and written by all but a branch's first and
// last units); nothing is staged but the accumulators, so every stream is read or written in
// whole sectors. Each unit re-reads the f32 residual from device memory: the price of a stage
// whose receptive halo does not fit one block. Widths: L % 16 == 0, 16 <= L <= 512; any reach,
// up to 64 kept taps a conv.

#include "hifigan_tapconv.cuh"

namespace {

constexpr int kMaxL = 512;

enum : int { kWriteH = 1, kReadAcc = 2, kWriteAcc = 4, kWriteOut = 8 };

struct StageEpi {
  struct In {
    float4 res;
    float4 acc;
    float4 bias;
  };
  static constexpr int kBatch = 4;
  const void* res;         // [B, T, L] residual: bf16 x (res_bf16) or f32 h
  int res_bf16;
  const float* bias;       // [L], b2
  float* h;                // [B, T, L] (kWriteH), may be res
  __nv_bfloat16* a_next;   // [B, T, L] the next unit's A (kWriteH)
  float* acc;              // [B, T, L] branch sum (kReadAcc / kWriteAcc)
  __nv_bfloat16* out;      // [B, T, L] stage output (kWriteOut)
  int mode;
  float num_k;
  int rows;
  int cols;

  __device__ __forceinline__ In load4(int b, int r, int n) const {
    const size_t i = ((size_t)b * rows + r) * cols + n;
    In in;
    if (res_bf16) {
      const uint2 xr = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(res) + i);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
      in.res = make_float4(x01.x, x01.y, x23.x, x23.y);
    } else {
      in.res = *reinterpret_cast<const float4*>(static_cast<const float*>(res) + i);
    }
    in.acc = (mode & kReadAcc) ? *reinterpret_cast<const float4*>(acc + i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    in.bias = *reinterpret_cast<const float4*>(bias + n);
    return in;
  }

  __device__ __forceinline__ void store4(int b, int r, int n, float4 z, const In& in) const {
    const size_t i = ((size_t)b * rows + r) * cols + n;
    float4 v = in.res;
    v.x += z.x + in.bias.x;
    v.y += z.y + in.bias.y;
    v.z += z.z + in.bias.z;
    v.w += z.w + in.bias.w;
    if (mode & kWriteH) {
      *reinterpret_cast<float4*>(h + i) = v;
      const __nv_bfloat162 a01 =
          __floats2bfloat162_rn(tapconv::lrelu(v.x), tapconv::lrelu(v.y));
      const __nv_bfloat162 a23 =
          __floats2bfloat162_rn(tapconv::lrelu(v.z), tapconv::lrelu(v.w));
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&a01);
      q.y = *reinterpret_cast<const unsigned*>(&a23);
      *reinterpret_cast<uint2*>(a_next + i) = q;
    }
    if (mode & kReadAcc) {
      v = make_float4(in.acc.x + v.x, in.acc.y + v.y, in.acc.z + v.z, in.acc.w + v.w);
    }
    if (mode & kWriteAcc) *reinterpret_cast<float4*>(acc + i) = v;
    if (mode & kWriteOut) {
      const __nv_bfloat162 o01 = __floats2bfloat162_rn(v.x / num_k, v.y / num_k);
      const __nv_bfloat162 o23 = __floats2bfloat162_rn(v.z / num_k, v.w / num_k);
      uint2 q;
      q.x = *reinterpret_cast<const unsigned*>(&o01);
      q.y = *reinterpret_cast<const unsigned*>(&o23);
      *reinterpret_cast<uint2*>(out + i) = q;
    }
  }
};

}  // namespace

// a0 = bf16(lrelu(x)), n values (n % 8 == 0), both 16-byte aligned.
extern "C" int hifigan_stage_lrelu_launch(const void* x, void* a0, long long n, void* stream) {
  return (int)tapconv::lrelu_pass(x, a0, n, reinterpret_cast<cudaStream_t>(stream));
}

// One ResBlock1 unit of a stage: conv_1 (A through map_a: a0 or a1) into t2 (bf16 [B, T, L],
// map_t2), then conv_2 with the bookkeeping of mode. map_w1, map_w2: the K-major kept taps of
// each conv [L, n * a_k] (box rows bn); kept1, kept2: the kept taps' indices (host arrays);
// b1, b2 f32 [L]; res: the residual (bf16 x when res_bf16, else f32 h); h, acc f32 and a_next,
// out bf16 [B, T, L]. All pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int hifigan_stage_unit_launch(
    const void* map_a, const void* map_t2, const void* map_w1, const int* kept1, int n1, int d1,
    int p1, const void* map_w2, const int* kept2, int n2, int d2, int p2, const void* b1,
    const void* b2, void* t2, const void* res, int res_bf16, void* h, void* a_next, void* acc,
    void* out, int mode, float num_k, int B, int T, int L, int bn, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || L < 16 || L % 16 != 0 || L > kMaxL || d1 < 1 || d2 < 1 ||
      p1 < 0 || p2 < 0 || !(num_k >= 1.f)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e =
      tapconv::first_conv(map_a, tapconv::Conv{map_w1, kept1, n1, d1, p1}, b1, t2, B, T, L, bn, s);
  if (e != cudaSuccess) return (int)e;
  const StageEpi epi{res, res_bf16, static_cast<const float*>(b2), static_cast<float*>(h),
                     static_cast<__nv_bfloat16*>(a_next), static_cast<float*>(acc),
                     static_cast<__nv_bfloat16*>(out), mode, num_k, T, L};
  return (int)tapconv::conv(map_t2, tapconv::Conv{map_w2, kept2, n2, d2, p2}, B, T, L, bn, epi,
                            s);
}
