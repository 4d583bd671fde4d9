// Fused STFT -> log-mel spectrogram for Hopper (sm_90a), hand-written: one warp a frame, an FFT
// held in registers, several frames a block.
//
// Replaces xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:PallasMelSpectrogram (pl.pallas_call at :100).
// For y [B, T] f32 and each frame f of each sequence b:
//
//     x[k]   = window[k] * y[b, reflect(f * hop + k - pad_l)]      k < n_fft  (reflect padding of
//              ((win - hop) // 2, (win - hop + 1) // 2) samples, as index arithmetic)
//     X      = rfft(x)                                             bins 0 .. n_fft / 2
//     out[m] = log(max(sum_k mel[m, k] * |X[k]|, clip))           [B, n_frames, n_mels] f32
//
// Bound on an H100: f32 operations, with bytes close behind. At the timed shape (B=4, 2048 frames,
// n_fft 2048, hop 512, 128 Slaney mels) its arithmetic, a real FFT (2.5 n log2 n) plus the sparse
// mel projection (1460 weights) and the magnitudes, is ~61 kFLOP per frame, 0.50 GFLOP in all:
// 7.5 us at 67 TFLOP/s of f32; the waveform read once (16.8 MB) and the output written once
// (4.2 MB) take 6.3 us at 3.35 TB/s. The TPU kernel did the DFT as a matrix product (8.4 MFLOP per
// frame, 150 times the FFT's work) on a gathered [frames, n_fft] copy of the waveform; neither is
// carried over, and neither is a DFT on the tensor cores (69 GFLOP: ~0.14 ms even in TF32, whose
// three digits would put the 1e-3-nat bar at risk in quiet bins).
//
// Design. A block takes F consecutive frames of one sequence (F warps, up to 16; the host picks F
// so that shared memory fits, ops/cuda/mel_spec.py:block_plan). The frames overlap, so the block
// stages their common span, (F - 1) * hop + n_fft samples, once with coalesced 16-byte loads
// (reflect indexing only where the span passes a sequence end), and the tables once: the window,
// the four-step twiddles W_N^(n1 k2) and the real split's W_2N^k, k <= N / 2 (all three the host's
// float64 values stored f32). After that one block barrier each warp works alone, syncing with
// __syncwarp:
//   the frame's even/odd samples are packed as N = n_fft / 2 complex points z[n] = x[2n] + i x[2n+1],
//   N = N1 x N2 with N1, N2 <= 32 (32 x 32, 32 x 16, 16 x 16, 16 x 8), n = n1 + N1 n2:
//   1. lane n1 gathers z[n1 + N1 n2] (n2 < N2) into registers (one 8-byte load a point where the
//      frame starts on 8 bytes), runs a length-N2 radix-2 FFT there (fully unrolled; its twiddles,
//      powers of W_32, are kernel parameters, read as operands with no load) and multiplies by
//      W_N^(n1 k2);
//   2. one exchange through shared memory: split re / im planes with rows of N2 + 1 words, so that
//      the 32 lanes of a warp hit 32 banks on both the write and the transposed read;
//   3. lane k2 runs a length-N1 FFT of its column in registers: Z[k2 + N2 k1], written back in
//      natural order;
//   4. the real split: the lane that owns the pair (k, N - k) reads Z[k] and Z[N - k] and writes
//      |X[k]| and |X[N - k]| over them (no other lane touches the pair);
//   5. the mel projection: lane l takes bands l, l + 32, ... (a strided set, for balance), a sparse
//      dot product over each band's run of weights, the clamp and the log; the frame's row is
//      written coalesced. The weights are interleaved by lane, each group of 32 bands padded with
//      zeros to its widest band (ops/cuda/mel_spec.py:mel_groups), so a warp's weight load is one
//      128-byte line and its trip count is the same on every lane.
// So a frame crosses shared memory three times (exchange, real split, magnitudes) in place of the
// ten stages, each with a block barrier, of a radix-2 FFT in shared memory. Everything is f32.
// What limits it on the card is not the f32 rate: in its phase split (chip_smoke.py's [K3 split])
// the FFT's phases take about the time of their shared-memory wavefronts at one a cycle an SM, so
// the design spends few (pairs of samples in one load, twiddles as operands), while the mel
// projection takes several times its count and stays open. (Loading its weights only on the lanes
// whose band still reads cut bank conflicts but took longer, and was left out.)
// Sizes: any power-of-two n_fft from 256 to 2048, win <= n_fft (the window table is the centred,
// zero-padded Hann).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxWarps = 16;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have on an H100
constexpr int kMaxDevices = 16;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// One MUFU instruction, within 2 ulp: the magnitudes feed a sum and a log held to 1e-3 nats.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n >> 1); }
__host__ __device__ constexpr int bitrev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// W_32^j = exp(-2 pi i j / 32), j < 16: the host's float64 values stored f32, passed by value, so
// that they sit in the kernel's parameter bank and the butterflies read them as operands.
struct W32 {
  float2 w[16];
};

// The butterflies of stage S of a radix-2 FFT of length L <= 32, then the later stages: each stage
// a template instance, so that every register index is a compile-time constant.
// W_(2 half)^j = W_32^(j 16 / half).
template <int L, int S>
__device__ __forceinline__ void fft_stages(float2 (&v)[L], const W32& tw) {
  if constexpr ((1 << S) < L) {
    constexpr int half = 1 << S;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float2 w = tw.w[j * (16 / half)];
#pragma unroll
      for (int g = 0; g < L; g += 2 * half) {
        const float2 a = v[g + j];
        const float2 c = v[g + j + half];
        float2 b;
        if (j == 0) {
          b = c;
        } else if (2 * j == half) {  // W = -i
          b = make_float2(c.y, -c.x);
        } else {
          b = cmul(c, w);
        }
        v[g + j] = cadd(a, b);
        v[g + j + half] = csub(a, b);
      }
    }
    fft_stages<L, S + 1>(v, tw);
  }
}

// In-place forward DFT of v (length L, natural order in and out) in registers: the bit-reversal
// permutation (a renaming), then radix-2 decimation in time.
template <int L>
__device__ __forceinline__ void fft_reg(float2 (&v)[L], const W32& tw) {
  constexpr int kBits = ilog2(L);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int r = bitrev(i, kBits);
    if (i < r) {
      const float2 t = v[i];
      v[i] = v[r];
      v[r] = t;
    }
  }
  fft_stages<L, 0>(v, tw);
}

// Shared memory, in order: tw [N / 2 + 2] float2 (the real split's W_2N^k, k <= N / 2, and one of
// padding), stw [N] float2 (W_N^(n1 k2) at k2 * N1 + n1), win [N] float2 (window pairs), F warps'
// planes (re, then im: N1 * (N2 + 1) floats each), then the span (S + 3 floats: its first sample
// at the offset that makes the 16-byte loads' stores aligned).
template <int N1, int N2>
__global__ void __launch_bounds__(32 * kMaxWarps) mel_spec_kernel(
    const float* __restrict__ y, const float2* __restrict__ window, const float2* __restrict__ twiddle,
    const float2* __restrict__ step_twiddle, const W32 w32, const int* __restrict__ band_first,
    const int* __restrict__ group_count, const float* __restrict__ weights,
    float* __restrict__ out, int T, int hop, int pad_l, int n_frames, int n_mels, float clip) {
  constexpr int N = N1 * N2;
  constexpr int kLd = N2 + 1;          // a plane's row: padded against bank conflicts
  constexpr int kPlane = N1 * kLd;     // floats of a plane (> N: holds the bins 0 .. N)
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);
  float2* stw = tw + N / 2 + 2;
  float2* win = stw + N;
  float* planes = reinterpret_cast<float*>(win + N);
  const int F = blockDim.x / 32;
  float* span_buf = planes + 2 * kPlane * F;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * F;
  const int nf = min(F, n_frames - f0);
  const int S = (nf - 1) * hop + 2 * N;  // samples of the block's frames
  const int s0 = f0 * hop - pad_l;       // sequence index of span sample 0
  const float* yb = y + static_cast<size_t>(b) * T;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (i <= N / 2) tw[i] = twiddle[i];
    stw[i] = step_twiddle[i];
    win[i] = window[i];
  }
  // the span: 16-byte loads over [v0, v1), the part inside the sequence whose addresses are
  // 16-byte aligned; single loads, reflected, before and after it
  const int lo = max(s0, 0);
  const int hi = max(min(s0 + S, T), lo);
  const int lo_word = static_cast<int>((reinterpret_cast<uintptr_t>(yb + lo) >> 2) & 3);
  const int v0 = min(lo + ((4 - lo_word) & 3), hi);
  const int n_vec = (hi - v0) >> 2;
  const int v1 = v0 + 4 * n_vec;
  const int shift = (4 - ((v0 - s0) & 3)) & 3;  // span sample i lives at span_buf[shift + i]
  float* span = span_buf + shift;
#pragma unroll 4
  for (int q = threadIdx.x; q < n_vec; q += blockDim.x) {
    *reinterpret_cast<float4*>(span + (v0 - s0) + 4 * q) =
        __ldg(reinterpret_cast<const float4*>(yb + v0) + q);
  }
  const int head = v0 - s0;
  const int tail = S - (v1 - s0);
  for (int q = threadIdx.x; q < head + tail; q += blockDim.x) {
    const int i = q < head ? q : (v1 - s0) + (q - head);
    int j = s0 + i;
    j = j < 0 ? -j : j;
    j = j >= T ? 2 * (T - 1) - j : j;
    span[i] = __ldg(yb + j);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nf) return;
  const float* x = span + warp * hop;  // the frame's samples
  float* re = planes + 2 * kPlane * warp;
  float* im = re + kPlane;

  // 1. lane n1: z[n1 + N1 n2] -> length-N2 FFT -> * W_N^(n1 k2) -> the planes at [n1][k2]
  if (lane < N1) {
    float2 v[N2];
    if ((reinterpret_cast<uintptr_t>(x) & 7) == 0) {  // a frame that starts on 8 bytes: pairs
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        const int n = lane + N1 * n2;
        const float2 w = win[n];
        const float2 s = reinterpret_cast<const float2*>(x)[n];
        v[n2] = make_float2(s.x * w.x, s.y * w.y);
      }
    } else {
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        const int n = lane + N1 * n2;
        const float2 w = win[n];
        v[n2] = make_float2(x[2 * n] * w.x, x[2 * n + 1] * w.y);
      }
    }
    fft_reg<N2>(v, w32);
#pragma unroll
    for (int k2 = 0; k2 < N2; ++k2) {
      const float2 z = k2 == 0 ? v[0] : cmul(v[k2], stw[k2 * N1 + lane]);
      re[lane * kLd + k2] = z.x;
      im[lane * kLd + k2] = z.y;
    }
  }
  __syncwarp();
  // 2.-3. lane k2: the column [n1][k2] -> length-N1 FFT -> Z[k2 + N2 k1] in natural order
  float2 u[N1];
  if (lane < N2) {
#pragma unroll
    for (int n1 = 0; n1 < N1; ++n1) u[n1] = make_float2(re[n1 * kLd + lane], im[n1 * kLd + lane]);
  }
  __syncwarp();
  if (lane < N2) {
    fft_reg<N1>(u, w32);
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      re[lane + N2 * k1] = u[k1].x;
      im[lane + N2 * k1] = u[k1].y;
    }
  }
  __syncwarp();
  // 4. the real split of the pair (k, N - k): X[k] = E + W_2N^k O, X[N - k] = conj(E - W_2N^k O),
  // E = (Z[k] + Z*[N-k]) / 2, O = -i (Z[k] - Z*[N-k]) / 2; |X| written over re[k], re[N - k]
#pragma unroll 2
  for (int k = lane; k <= N / 2; k += 32) {
    const int r = (N - k) & (N - 1);
    const float2 zk = make_float2(re[k], im[k]);
    const float2 zr = make_float2(re[r], im[r]);
    const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
    const float2 o = make_float2(0.5f * (zk.y + zr.y), -0.5f * (zk.x - zr.x));
    const float2 t = cmul(tw[k], o);
    const float2 xp = cadd(e, t);
    const float2 xm = csub(e, t);
    re[k] = sqrt_approx(xp.x * xp.x + xp.y * xp.y);
    re[N - k] = sqrt_approx(xm.x * xm.x + xm.y * xm.y);
  }
  __syncwarp();
  // 5. sparse mel projection, clamp, log: group j, band 32 j + lane; a zero weight past a band's
  // run meets a bin that exists (clamped to N)
  float* ob = out + (static_cast<size_t>(b) * n_frames + f0 + warp) * n_mels;
  const float* wg = weights + lane;
  for (int j = 0; 32 * j < n_mels; ++j) {
    const int first = __ldg(band_first + 32 * j + lane);
    const int count = __ldg(group_count + j);
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < count; ++c) acc = fmaf(__ldg(wg + 32 * c), re[min(first + c, N)], acc);
    wg += 32 * count;
    if (32 * j + lane < n_mels) ob[32 * j + lane] = logf(fmaxf(acc, clip));
  }
}

template <int N1, int N2>
cudaError_t launch(const void* y, const void* window, const void* twiddle, const void* step_twiddle,
                   const W32& w32, const void* band_first, const void* group_count,
                   const void* weights, void* out,
                   int B, int T, int hop, int pad_l, int n_frames,
                   int n_mels, float clip, int frames_per_block, int smem, cudaStream_t stream) {
  auto kernel = mel_spec_kernel<N1, N2>;
  // the attribute belongs to a device: set it once for each
  static bool smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices || !smem_set[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    if (device < kMaxDevices) smem_set[device] = true;
  }
  const dim3 grid((n_frames + frames_per_block - 1) / frames_per_block, B);
  kernel<<<grid, 32 * frames_per_block, smem, stream>>>(
      static_cast<const float*>(y), static_cast<const float2*>(window),
      static_cast<const float2*>(twiddle), static_cast<const float2*>(step_twiddle), w32,
      static_cast<const int*>(band_first), static_cast<const int*>(group_count),
      static_cast<const float*>(weights), static_cast<float*>(out), T, hop, pad_l, n_frames,
      n_mels, clip);
  return cudaGetLastError();
}

// Shared bytes of a block of F frames: the three tables, F warps' planes and the span.
long long smem_bytes(int n1, int n2, int hop, int frames_per_block) {
  const long long n = static_cast<long long>(n1) * n2;
  return 8 * (n / 2 + 2) + 2 * 8 * n + 2LL * 4 * n1 * (n2 + 1) * frames_per_block +
         4 * ((frames_per_block - 1LL) * hop + 2 * n + 3);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue (1) for sizes the
// kernel does not take, without launching. n1 x n2 is the FFT's split of n_fft / 2 points
// (ops/cuda/mel_spec.py:fft_split); frames_per_block and smem come from block_plan there.
extern "C" int mel_spec_launch(const void* y, const void* window, const void* twiddle,
                               const void* step_twiddle, const void* w32_host,
                               const void* band_first, const void* group_count,
                               const void* weights, void* out, int B,
                               int T, int n1, int n2, int hop, int pad_l,
                               int n_frames, int n_mels, int frames_per_block, int smem, float clip,
                               void* stream) {
  if (B < 1 || B > 65535 || n_frames < 1 || hop < 1 || n_mels < 1 || T < 2 ||
      frames_per_block < 1 || frames_per_block > kMaxWarps ||
      smem != smem_bytes(n1, n2, hop, frames_per_block) || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  W32 w32;
  std::memcpy(&w32, w32_host, sizeof(w32));
#define MEL_LAUNCH(A, C)                                                                           \
  if (n1 == A && n2 == C)                                                                          \
    return static_cast<int>(launch<A, C>(y, window, twiddle, step_twiddle, w32, band_first,      \
                                         group_count, weights, out, B, T, hop, pad_l,              \
                                         n_frames, n_mels, clip, frames_per_block, smem, s));
  MEL_LAUNCH(16, 8)
  MEL_LAUNCH(16, 16)
  MEL_LAUNCH(32, 16)
  MEL_LAUNCH(32, 32)
#undef MEL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
