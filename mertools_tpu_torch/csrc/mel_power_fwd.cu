// Whisper mel power spectrogram (windowed DFT -> power -> mel filterbank) in
// one kernel, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel mertools_tpu/ops/mel_pallas.py:_kernel
// (lines 62-81), launched at :95 by mel_power_pallas and wrapped by
// log_mel_spectrogram_fused.
//
// Computes, for every clip b and frame f < N / 160 (3000 for a 30 s clip):
//     X[f, k]   = sum_n x[f * 160 + n - 200] * w[n] * exp(-2 pi i k n / 400)
//     out[b, f, m] = sum_k |X[f, k]|^2 * fb[k, m]      k < 201, m < 80
// with x reflect-padded by 200 samples on each side (index i < 0 reads -i,
// i >= N reads 2N - 2 - i, numpy's "reflect") and w the periodic Hann window.
// The padding is done by index while the samples are staged; the
// (B, 3000, 400) framed signal never exists, in device memory or anywhere.
//
// Precision: fp32 FMAs throughout, no tensor cores. TF32 or bf16 operands
// lose about 0.03 in the log domain to the DFT's cancellation
// (mel_pallas.py:20-22), and the JAX kernel runs at HIGHEST precision. Every
// twiddle is cos/sin(2 pi ((k n) mod 400) / 400), so one 400-entry table
// (computed on the host in float64, rounded to fp32) serves all bins.
//
// What bounds it on the H100: the dense DFT is ~0.97 GFLOP per clip against
// 1.9 MB read and 0.96 MB written, so FMA issue and shared-memory bandwidth,
// not device memory, set the time. Design: one block of 256 threads per
// (clip, 128-frame tile). The tile's 20720 samples sit in shared memory with
// one skew slot every 32 floats, so the 32 lanes of a warp, which hold 32
// consecutive frames, read 32 different banks. Each thread owns 4 frames x 13
// bins (cos and sin: 104 accumulators) per round, two rounds cover the 201
// bins; all lanes of a warp share the bins, so each twiddle is one broadcast
// 8-byte load feeding 8 FMAs. The (128, 201) power tile stays in shared
// memory, and the mel product reads the (201, 80) filterbank through the
// read-only cache. The output tile is staged through shared memory so the
// (128, 80) block is written with coalesced stores. Not yet: tensor cores
// with 3xTF32 split operands (wgmma), or TMA staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kBins = kNfft / 2 + 1;               // 201
constexpr int kMels = 80;
constexpr int kTileF = 128;                        // frames per block
constexpr int kThreads = 256;                      // 8 warps
constexpr int kFramesPerLane = kTileF / 32;        // 4
constexpr int kBinsPerThread = 13;                 // per round
constexpr int kRounds = 2;                         // 8 warps x 13 x 2 = 208 >= 201
constexpr int kMelsPerWarp = kMels / (kThreads / 32);  // 10
constexpr int kTileSamples = (kTileF - 1) * kHop + kNfft;  // 20720
constexpr int kSampFloats = kTileSamples + kTileSamples / 32 + 1;
constexpr int kOutPitch = kMels + 1;

static_assert(8 * kBinsPerThread * kRounds >= kBins, "rounds must cover every bin");
static_assert(kTileF * kOutPitch <= kSampFloats, "output tile reuses the sample buffer");
static_assert(kHop % 32 == 0, "the skew formula needs frame starts on 32-float boundaries");

constexpr size_t smem_bytes() {
  // twiddles (float2), window, skewed samples, power tile
  return sizeof(float) * (size_t(2 * kNfft) + kNfft + kSampFloats + size_t(kTileF) * kBins);
}

// shared-memory slot of tile sample s: one skew slot after every 32 floats
__device__ __forceinline__ int skew(int s) { return s + (s >> 5); }

__global__ void __launch_bounds__(kThreads)
mel_power_fwd(const float* __restrict__ wav, const float2* __restrict__ twiddle,
              const float* __restrict__ window, const float* __restrict__ fb,
              float* __restrict__ out, int n_samples) {
  extern __shared__ float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);    // 400 x (cos, sin)
  float* win = smem + 2 * kNfft;                   // 400
  float* samp = win + kNfft;                       // kSampFloats
  float* power = samp + kSampFloats;               // kTileF x kBins

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int n_frames = n_samples / kHop;
  const int f0 = blockIdx.x * kTileF;
  const long long padded_len = (long long)n_samples + 2 * kPad;
  const float* x = wav + (long long)b * n_samples;

  for (int i = tid; i < kNfft; i += kThreads) {
    tw[i] = twiddle[i];
    win[i] = window[i];
  }
  // stage the tile's samples, reflect padding by index
  const long long p0 = (long long)f0 * kHop;
  for (int s = tid; s < kTileSamples; s += kThreads) {
    const long long p = p0 + s;
    float v = 0.0f;
    if (p < padded_len) {
      long long i = p - kPad;
      if (i < 0) i = -i;
      if (i >= n_samples) i = 2LL * n_samples - 2 - i;
      v = x[i];
    }
    samp[skew(s)] = v;
  }
  __syncthreads();

  // ---- windowed DFT -> power, one round of 13 bins per thread at a time
  // sample n of local frame f sits at skew(160 f + n) = 165 f + n + (n >> 5)
  int fbase[kFramesPerLane];
#pragma unroll
  for (int i = 0; i < kFramesPerLane; ++i) fbase[i] = 165 * (lane + 32 * i);

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int k0 = warp + 8 * kBinsPerThread * r;  // this thread's bins: k0 + 8 j
    float re[kFramesPerLane][kBinsPerThread], im[kFramesPerLane][kBinsPerThread];
    int idx[kBinsPerThread];
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      idx[j] = 0;
#pragma unroll
      for (int i = 0; i < kFramesPerLane; ++i) re[i][j] = im[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int n = 0; n < kNfft; ++n) {
      const float wn = win[n];
      const int off = n + (n >> 5);
      float xv[kFramesPerLane];
#pragma unroll
      for (int i = 0; i < kFramesPerLane; ++i) xv[i] = samp[fbase[i] + off] * wn;
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        const float2 c = tw[idx[j]];               // warp-uniform: broadcast
#pragma unroll
        for (int i = 0; i < kFramesPerLane; ++i) {
          re[i][j] = fmaf(xv[i], c.x, re[i][j]);
          im[i][j] = fmaf(xv[i], c.y, im[i][j]);
        }
        idx[j] += k0 + 8 * j;                      // (k n) mod 400, incrementally
        if (idx[j] >= kNfft) idx[j] -= kNfft;
      }
    }
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int k = k0 + 8 * j;
      if (k < kBins) {
#pragma unroll
        for (int i = 0; i < kFramesPerLane; ++i)
          power[(lane + 32 * i) * kBins + k] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
  __syncthreads();

  // ---- mel product: lanes hold frames, each warp 10 mels
  const int m0 = warp * kMelsPerWarp;
  float acc[kFramesPerLane][kMelsPerWarp];
#pragma unroll
  for (int i = 0; i < kFramesPerLane; ++i)
#pragma unroll
    for (int q = 0; q < kMelsPerWarp; ++q) acc[i][q] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < kBins; ++k) {
    float pv[kFramesPerLane];
#pragma unroll
    for (int i = 0; i < kFramesPerLane; ++i) pv[i] = power[(lane + 32 * i) * kBins + k];
#pragma unroll
    for (int q = 0; q < kMelsPerWarp; ++q) {
      const float wkm = __ldg(fb + k * kMels + m0 + q);
#pragma unroll
      for (int i = 0; i < kFramesPerLane; ++i) acc[i][q] = fmaf(pv[i], wkm, acc[i][q]);
    }
  }
  // the sample buffer is free since the barrier above: stage the output tile
  float* out_s = samp;
#pragma unroll
  for (int i = 0; i < kFramesPerLane; ++i)
#pragma unroll
    for (int q = 0; q < kMelsPerWarp; ++q) out_s[(lane + 32 * i) * kOutPitch + m0 + q] = acc[i][q];
  __syncthreads();

  const int nf = min(kTileF, n_frames - f0);
  float* ob = out + ((long long)b * n_frames + f0) * kMels;
  for (int e = tid; e < nf * kMels; e += kThreads) {
    const int f = e / kMels, m = e - f * kMels;
    ob[e] = out_s[f * kOutPitch + m];
  }
}

}  // namespace

// C entry point, bound with ctypes. wav is (B, n_samples) fp32, contiguous;
// twiddle is float2[400] = (cos, sin)(2 pi m / 400); window is float[400];
// fb is the (201, 80) filterbank, row-major; out is (B, n_samples / 160, 80)
// fp32, contiguous. All on `device`. Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int mt_mel_power_fwd(const void* wav, const void* twiddle, const void* window,
                                const void* fb, void* out, int B, int n_samples, int device,
                                void* stream) {
  if (B <= 0 || n_samples <= kPad || n_samples % kHop != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes();
  err = cudaFuncSetAttribute(mel_power_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_frames = n_samples / kHop;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, B);
  mel_power_fwd<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float2*>(twiddle),
      static_cast<const float*>(window), static_cast<const float*>(fb),
      static_cast<float*>(out), n_samples);
  return (int)cudaGetLastError();
}
