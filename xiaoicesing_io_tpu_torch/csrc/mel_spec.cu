// Fused STFT -> log-mel spectrogram for Hopper (sm_90a), hand-written: a shared-memory FFT per frame.
//
// Replaces xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:PallasMelSpectrogram (pl.pallas_call at :100).
// For y [B, T] f32 and each frame f of each sequence b:
//
//     x[k]   = window[k] * y[b, reflect(f * hop + k - pad_l)]      k < n_fft  (reflect padding of
//              ((win - hop) // 2, (win - hop + 1) // 2) samples, as index arithmetic)
//     X      = rfft(x)                                             bins 0 .. n_fft / 2
//     out[m] = log(max(sum_k mel[m, k] * |X[k]|, clip))           [B, n_frames, n_mels] f32
//
// Bound on an H100: f32 operations, with bytes close behind. At the main-path shape (B=4, 2048
// frames, n_fft 2048, hop 512, 128 Slaney mels) its arithmetic, a real FFT (2.5 n log2 n) plus the
// sparse mel projection (1460 weights) and the magnitudes, is ~61 kFLOP per frame, 0.50 GFLOP in
// all: 7.5 us at 67 TFLOP/s of f32; the waveform read once (16.8 MB) and the output written once
// (4.2 MB) take 6.3 us at 3.35 TB/s. The TPU kernel
// did the DFT as a matrix product (8.4 MFLOP per frame, 150 times the FFT's work) on a gathered
// [frames, n_fft] copy of the waveform, 4 times its size; neither is carried over.
//
// Design. One block per frame (grid: frames x B), min(256, n_fft / 4) threads. The block reads its
// n_fft samples straight from y (reflect padding is index arithmetic, no frames tensor exists),
// windows them and packs even/odd samples into n_fft / 2 complex points: z[n] = x[2n] + i x[2n+1].
// A radix-2 Stockham FFT of z runs in shared memory (two ping-pong buffers of n_fft / 2 float2,
// natural order out, one barrier per stage); twiddles come from a table the host computed in
// float64 (exp(-2 pi i k / n_fft), k < n_fft / 2, stored f32), no __sinf/__cosf. The real-split
// step X[k] = (Z[k] + Z*[N-k]) / 2 - i W^k (Z[k] - Z*[N-k]) / 2 then gives |X[k]| for bins up to
// the last one any mel filter weights (n_bins: 744 of 1025 at the shipped config), written over
// the idle buffer. Each thread then takes mel bands: a sparse dot product over the band's
// (first_bin, count, offset) run of packed weights, the clamp and the log, one f32 per band,
// coalesced across the block. Everything accumulates in f32. Shared memory: 24 KB at n_fft 2048,
// so 8 blocks (2048 threads) per SM. Sizes: any power-of-two n_fft from 256 to 2048, win <= n_fft
// (the window table is the centred, zero-padded Hann). Radix-4 stages and several frames per block
// (fewer barriers per frame) are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxNfft = 2048;
constexpr int kMaxHalf = kMaxNfft / 2;  // complex points of the half-length FFT
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kMaxThreads) mel_spec_kernel(
    const float* __restrict__ y, const float* __restrict__ window, const float2* __restrict__ twiddle,
    const int* __restrict__ band_first, const int* __restrict__ band_count,
    const int* __restrict__ band_offset, const float* __restrict__ weights, float* __restrict__ out,
    int T, int log2_half, int hop, int pad_l, int n_frames, int n_mels, int n_bins, float clip) {
  __shared__ float2 buf[2][kMaxHalf];
  __shared__ float2 tw[kMaxHalf];  // exp(-2 pi i k / n_fft), k < n_fft / 2

  const int half = 1 << log2_half;  // N: complex points
  const int frame = blockIdx.x;
  const int b = blockIdx.y;
  const float* yb = y + static_cast<size_t>(b) * T;
  const int start = frame * hop - pad_l;

  // windowed frame, even/odd samples packed as complex points; reflect padding by index
  for (int n = threadIdx.x; n < half; n += blockDim.x) {
    tw[n] = twiddle[n];
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * n + e;
      int j = start + k;
      j = j < 0 ? -j : j;
      j = j >= T ? 2 * (T - 1) - j : j;
      v[e] = __ldg(yb + j) * __ldg(window + k);
    }
    buf[0][n] = make_float2(v[0], v[1]);
  }
  __syncthreads();

  // radix-2 Stockham FFT of N points: stage s has sub-length n = N >> s and stride 2^s;
  // butterfly (p, q): a = x[q + 2^s p], c = x[q + 2^s (p + n/2)],
  //   z[q + 2^s 2p] = a + c,  z[q + 2^s (2p + 1)] = (a - c) W_n^p,  W_n^p = tw[2^(s+1) p]
  int src = 0;
  for (int s = 0; s < log2_half; ++s) {
    const int m = half >> (s + 1);
    const int qmask = (1 << s) - 1;
    const float2* x = buf[src];
    float2* z = buf[src ^ 1];
    for (int i = threadIdx.x; i < (half >> 1); i += blockDim.x) {
      const int p = i >> s;
      const int q = i & qmask;
      const float2 a = x[q + (p << s)];
      const float2 c = x[q + ((p + m) << s)];
      z[q + ((2 * p) << s)] = cadd(a, c);
      z[q + ((2 * p + 1) << s)] = cmul(csub(a, c), tw[p << (s + 1)]);
    }
    __syncthreads();
    src ^= 1;
  }

  // real split: X[k] = E + W^k O, E = (Z[k] + Z*[N-k]) / 2, O = -i (Z[k] - Z*[N-k]) / 2
  const float2* Z = buf[src];
  float* mag = reinterpret_cast<float*>(buf[src ^ 1]);
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const float2 zk = Z[k & (half - 1)];
    const float2 zr = Z[(half - k) & (half - 1)];
    const float2 e = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
    const float2 o = make_float2(0.5f * (zk.y + zr.y), -0.5f * (zk.x - zr.x));
    const float2 w = k < half ? tw[k] : make_float2(-1.f, 0.f);
    const float2 xk = cadd(e, cmul(w, o));
    mag[k] = sqrtf(xk.x * xk.x + xk.y * xk.y);
  }
  __syncthreads();

  // sparse mel projection, clamp, log
  float* ob = out + (static_cast<size_t>(b) * n_frames + frame) * n_mels;
  for (int mi = threadIdx.x; mi < n_mels; mi += blockDim.x) {
    const int first = __ldg(band_first + mi);
    const int count = __ldg(band_count + mi);
    const float* wm = weights + __ldg(band_offset + mi);
    float acc = 0.f;
    for (int c = 0; c < count; ++c) acc = fmaf(__ldg(wm + c), mag[first + c], acc);
    ob[mi] = logf(fmaxf(acc, clip));
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue (1) for sizes the
// kernel does not take, without launching.
extern "C" int mel_spec_launch(const void* y, const void* window, const void* twiddle,
                               const void* band_first, const void* band_count,
                               const void* band_offset, const void* weights, void* out, int B, int T,
                               int n_fft, int hop, int pad_l, int n_frames, int n_mels, int n_bins,
                               float clip, void* stream) {
  int log2_half = 0;
  while ((2 << log2_half) < n_fft) ++log2_half;
  const int half = 1 << log2_half;
  if (2 * half != n_fft || n_fft < 256 || n_fft > kMaxNfft || B < 1 || B > 65535 || n_frames < 1 ||
      hop < 1 || n_mels < 1 || n_bins < 1 || n_bins > half + 1 || T < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = half / 2 < kMaxThreads ? half / 2 : kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n_frames), static_cast<unsigned>(B));
  mel_spec_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const int*>(band_first),
      static_cast<const int*>(band_count), static_cast<const int*>(band_offset),
      static_cast<const float*>(weights), static_cast<float*>(out), T, log2_half, hop, pad_l,
      n_frames, n_mels, n_bins, clip);
  return static_cast<int>(cudaGetLastError());
}
