// Whisper mel power spectrogram (windowed real FFT -> power -> banded mel
// filterbank) in one kernel, for Hopper (sm_90a).
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
// The padding is done by index while the samples are read; the
// (B, 3000, 400) framed signal never exists, in device memory or anywhere.
//
// Precision: fp32 throughout, no tensor cores. TF32 or bf16 operands lose
// about 0.03 in the log domain (mel_pallas.py:20-22), and the JAX kernel
// runs at HIGHEST precision. Every twiddle is a power of W = exp(-2 pi i /
// 400): one 400-entry table of (cos, sin)(2 pi m / 400), computed on the
// host in float64 and rounded to fp32, serves the FFT and the real split.
//
// What bounds it on the H100: the function needs 0.25 GFLOP at B 8 (a real
// FFT and the filterbank's 391 nonzeros) against 15.4 MB read and 7.7 MB
// written, so device memory bounds it (6.9 us). What the kernel pays
// besides is shared memory: every pass of the FFT, the power and the mel
// sums go through it, so the design counts its wavefronts (bank conflicts)
// more than its bytes. Per block of 256 threads, two tiles of 32 frames of
// one clip one after the other (3 blocks an SM, 47 blocks a clip: one wave
// at B 8, and one set-up of the tables for two tiles):
//  * a 400-point real FFT as a 200-point complex FFT of
//    z[n] = y[2n] + i y[2n+1] (y the windowed frame), then the split
//    X[k] = (Z[k] + Z*[200-k]) / 2 - i W^k (Z[k] - Z*[200-k]) / 2;
//  * the 200-point FFT as 8 x 25 (four-step: a radix-8 pass over the
//    columns, twiddles W^(2 n2 k1), then a 25-point FFT of each row as two
//    radix-5 passes). Every work item of a pass reads and writes the same
//    slots of its frame's buffer, so the passes run in place, with one
//    barrier each and no second buffer; Z[k] ends in slot
//    25 (k mod 8) + 5 ((k / 8) mod 5) + k / 40;
//  * the radix-8 pass has its lanes on n2, so it reads its 16 samples in
//    order straight from device memory (8-byte loads, reflect padding by
//    index at the clip's ends), the window applied as they arrive; the 2.5x
//    overlap of the frames is served by L1. A thread loads its next item's
//    samples while it transforms this one, its first item's with the tables
//    and, for the second tile, during the first tile's mel sums;
//  * every later step has a warp's 32 lanes on the tile's 32 frames at one
//    index of the work: twiddles and band entries are broadcast, and a
//    frame's buffer is 201 float2 long (odd), so the lanes hit distinct
//    banks. Every twiddle is laid out in the order its pass reads it;
//  * the power of bins k and 200 - k comes from the same two slots and is
//    written back into them;
//  * the mel product runs over each filter's band only: the host passes one
//    [lo, lo + n) bin range per mel and the band's weights, derived from the
//    filterbank, so a skipped term is an exact zero; beside each band
//    entry's weight sits where its bin's power is. The (32, 80) output tile
//    is staged in shared memory and written with coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNfft / 2;
constexpr int kHalf = kNfft / 2;                   // 200-point complex FFT
constexpr int kBins = kNfft / 2 + 1;               // 201
constexpr int kMels = 80;
constexpr int kTileF = 32;                         // frames a tile, one a lane
constexpr int kFs = kHalf + 1;                     // float2 a frame's buffer: odd, so
                                                   // lanes on frames hit distinct banks
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;
constexpr int kOutPitch = kMels + 1;
constexpr int kTilesPerBlock = 2;                  // one table set-up serves both
static_assert(kThreads >= 7 * 25 && kThreads >= kNfft / 2 && kThreads >= kMels,
              "a thread an entry of the fixed tables");

constexpr size_t smem_bytes(int n_weights) {
  // 8 bytes: the frames' FFT buffers, the twiddles of pass 1 (7 x 25), pass
  // 2 (4 x 5) and the split (101), the window as pairs, the split's slot
  // pairs (101), the mel bands (length, offset); 4 bytes: the band entries'
  // weights and power indices, the output tile
  return sizeof(float2) *
             (size_t(kTileF) * kFs + 7 * 25 + 4 * 5 + 101 + kNfft / 2 + 101 + kMels) +
         sizeof(float) * (2 * size_t(n_weights) + size_t(kTileF) * kOutPitch);
}

// slot of Z[k] in a frame's buffer after the three passes
__device__ __forceinline__ int slot(int k) {
  const int k2 = k >> 3;
  return 25 * (k & 7) + 5 * (k2 % 5) + k2 / 5;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// W^m = exp(-2 pi i m / 400) from the (cos, sin) table
__device__ __forceinline__ float2 w400(const float2* tw, int m) {
  const float2 c = tw[m];
  return make_float2(c.x, -c.y);
}

// in place: v[k] = sum_n v[n] exp(-2 pi i n k / 8)
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float r = 0.70710678118654752f;
  const float2 a0 = cadd(v[0], v[4]), a1 = csub(v[0], v[4]);
  const float2 a2 = cadd(v[2], v[6]), a3 = mul_mi(csub(v[2], v[6]));
  const float2 b0 = cadd(v[1], v[5]), b1 = csub(v[1], v[5]);
  const float2 b2 = cadd(v[3], v[7]), b3 = mul_mi(csub(v[3], v[7]));
  const float2 e0 = cadd(a0, a2), e2 = csub(a0, a2), e1 = cadd(a1, a3), e3 = csub(a1, a3);
  float2 o0 = cadd(b0, b2), o2 = csub(b0, b2), o1 = cadd(b1, b3), o3 = csub(b1, b3);
  o1 = make_float2(r * (o1.x + o1.y), r * (o1.y - o1.x));    // W8 o1
  o2 = mul_mi(o2);                                           // W8^2 o2
  o3 = make_float2(r * (o3.y - o3.x), -r * (o3.x + o3.y));   // W8^3 o3
  v[0] = cadd(e0, o0); v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1); v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2); v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3); v[7] = csub(e3, o3);
}

// in place: v[k] = sum_n v[n] exp(-2 pi i n k / 5)
__device__ __forceinline__ void dft5(float2 (&v)[5]) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;
  constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;
  const float2 p1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]);
  const float2 p2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
  const float2 t1 = make_float2(v[0].x + c1 * p1.x + c2 * p2.x, v[0].y + c1 * p1.y + c2 * p2.y);
  const float2 t2 = make_float2(v[0].x + c2 * p1.x + c1 * p2.x, v[0].y + c2 * p1.y + c1 * p2.y);
  const float2 u1 = make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y);
  const float2 u2 = make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y);
  v[0] = cadd(v[0], cadd(p1, p2));
  v[1] = cadd(t1, mul_mi(u1)); v[4] = csub(t1, mul_mi(u1));
  v[2] = cadd(t2, mul_mi(u2)); v[3] = csub(t2, mul_mi(u2));
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// samples i and i + 1 (i even) of the reflect-padded clip
__device__ __forceinline__ float2 pair_at(const float* x, int i, int n) {
  if (i >= 0 && i + 1 < n) return __ldg(reinterpret_cast<const float2*>(x + i));
  return make_float2(__ldg(x + reflect(i, n)), __ldg(x + reflect(i + 1, n)));
}

// the power of bins k and 200 - k (k <= 100) of one frame's buffer fb, from
// zk = Z[k] in slot sk and zm = Z[200 - k] in slot sm (Z[200] = Z[0]),
// written back into their slots
__device__ __forceinline__ void split_power(float2* fb, float2 wk, int k, int sk, int sm,
                                            float2 zk, float2 zm) {
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 q = cmul(wk, make_float2(0.5f * (zk.x - zm.x), 0.5f * (zk.y + zm.y)));
  const float ar = e.x + q.y, ai = e.y - q.x, br = e.x - q.y, bi = e.y + q.x;
  const float pk = ar * ar + ai * ai, pm = br * br + bi * bi;
  float* fp = reinterpret_cast<float*>(fb);
  if (k == 0) {
    fp[0] = pk;                                      // P[0] and P[200] share slot 0
    fp[1] = pm;
  } else {
    fp[2 * sm] = pm;
    fp[2 * sk] = pk;                                 // k = 100: one slot, P[100]
  }
}

// pass 1's item u of the tile: z[25 n1 + n2] = (y[n], y[n + 1]) before the
// window, n = 50 n1 + 2 n2, for the tile's frame u / 25 and n2 = u mod 25
__device__ __forceinline__ void load_item(float2 (&s)[8], const float* x, int i0, int u,
                                          int n_samples) {
  const int lf = u / 25, n2 = u - 25 * lf;
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1)
    s[n1] = pair_at(x, i0 + lf * kHop + 50 * n1 + 2 * n2, n_samples);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mel_power_fwd(const float* __restrict__ wav, const float2* __restrict__ twiddle,
              const float* __restrict__ window, const int* __restrict__ bands,
              const float* __restrict__ weights, float* __restrict__ out, int n_samples,
              int n_weights) {
  extern __shared__ float2 smem[];
  float2* buf = smem;                          // kTileF x kFs
  float2* t1 = buf + kTileF * kFs;             // W^(2 n2 k1), [k1 - 1][n2]
  float2* t2 = t1 + 7 * 25;                    // W^(16 c ka), [ka - 1][c]
  float2* tk = t2 + 4 * 5;                     // W^k, k <= 100
  float2* win2 = tk + 101;                     // (w[2 i], w[2 i + 1])
  int2* sl = reinterpret_cast<int2*>(win2 + kNfft / 2);     // slots of Z[k], Z[200 - k]
  int2* mband = sl + 101;                                   // (length, offset) a mel
  float* ew = reinterpret_cast<float*>(mband + kMels);      // a band entry's weight
  int* ep = reinterpret_cast<int*>(ew + n_weights);         // its bin's power index
  float* otile = reinterpret_cast<float*>(ep + n_weights);  // kTileF x kOutPitch

  const int tid = threadIdx.x;
  const int n_frames = n_samples / kHop;
  const float* x = wav + (long long)blockIdx.y * n_samples;
  float* ox = out + (long long)blockIdx.y * n_frames * kMels;
  const int tile0 = blockIdx.x * kTilesPerBlock;
  int nf = min(kTileF, n_frames - tile0 * kTileF);

  // ---- the samples of this thread's first pass-1 item and every table
  // entry are loaded before the first store, so the block waits for one
  // round trip to memory, not one a table
  float2 s[8], next[8];
  if (tid < nf * 25) load_item(s, x, tile0 * kTileF * kHop - kPad, tid, n_samples);
  const float2 a1 = tid < 7 * 25 ? w400(twiddle, 2 * (tid % 25) * (tid / 25 + 1)) : float2{};
  const float2 a2 = tid < 4 * 5 ? w400(twiddle, 16 * (tid % 5) * (tid / 5 + 1)) : float2{};
  const float2 ak = tid < 101 ? w400(twiddle, tid) : float2{};
  const float2 aw = tid < kNfft / 2 ? reinterpret_cast<const float2*>(window)[tid] : float2{};
  int lo = 0, n = 0, off = 0;
  if (tid < kMels) {
    lo = bands[tid];
    n = bands[kMels + tid];
    off = bands[2 * kMels + tid];
  }
#pragma unroll 4
  for (int i = tid; i < n_weights; i += kThreads) ew[i] = weights[i];
  // every twiddle laid out in the order a pass reads it; beside each band
  // entry's weight, where its bin's power sits
  if (tid < 7 * 25) t1[tid] = a1;
  if (tid < 4 * 5) t2[tid] = a2;
  if (tid < 101) {
    tk[tid] = ak;
    sl[tid] = make_int2(slot(tid), slot(tid == 0 ? 0 : kHalf - tid));
  }
  if (tid < kNfft / 2) win2[tid] = aw;
  if (tid < kMels) {
    mband[tid] = make_int2(n, off);
    for (int j = 0; j < n; ++j) ep[off + j] = lo + j == kHalf ? 1 : 2 * slot(lo + j);
  }
  __syncthreads();

  for (int t = 0; t < kTilesPerBlock && nf > 0; ++t) {
    const int f0 = (tile0 + t) * kTileF;
    const int i0 = f0 * kHop - kPad;           // sample of the tile's n = 0
    const int nf_next = min(kTileF, n_frames - f0 - kTileF);

    // ---- pass 1, lanes on n2 so the samples are read in order: radix 8
    // over n1 of z[25 n1 + n2], then W^(2 n2 k1); into slot 25 k1 + n2.
    // The next item's samples are loaded while this one is transformed.
    for (int u = tid; u < nf * 25; u += kThreads) {
      if (u + kThreads < nf * 25) load_item(next, x, i0, u + kThreads, n_samples);
      const int lf = u / 25, n2 = u - 25 * lf;
      float2 v[8];
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) {
        const float2 w = win2[25 * n1 + n2];         // window at n = 50 n1 + 2 n2
        v[n1] = make_float2(s[n1].x * w.x, s[n1].y * w.y);
      }
      dft8(v);
      float2* p = buf + lf * kFs + n2;
      p[0] = v[0];
#pragma unroll
      for (int k1 = 1; k1 < 8; ++k1) p[25 * k1] = cmul(v[k1], t1[25 * (k1 - 1) + n2]);
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) s[n1] = next[n1];
    }
    __syncthreads();

    // from here on a warp's lanes are the tile's 32 frames at one index of
    // the work, so tables are broadcast and the buffers' odd pitch keeps
    // the lanes on distinct banks

    // ---- pass 2: radix 5 over a of row k1's n2 = 5 a + c, then W^(16 c ka)
    for (int u = tid; u < 40 * kTileF; u += kThreads) {
      const int r = u / kTileF, lf = u % kTileF, k1 = r / 5, c = r - 5 * k1;
      if (lf >= nf) continue;
      float2* p = buf + lf * kFs + 25 * k1 + c;
      float2 v[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) v[a] = p[5 * a];
      dft5(v);
      p[0] = v[0];
#pragma unroll
      for (int ka = 1; ka < 5; ++ka) p[5 * ka] = cmul(v[ka], t2[5 * (ka - 1) + c]);
    }
    __syncthreads();

    // ---- pass 3: radix 5 over c; Z[k1 + 8 (ka + 5 kc)] lands in 25 k1 + 5 ka + kc
    for (int u = tid; u < 40 * kTileF; u += kThreads) {
      const int r = u / kTileF, lf = u % kTileF;   // r = 5 k1 + ka
      if (lf >= nf) continue;
      float2* p = buf + lf * kFs + 5 * r;
      float2 v[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) v[c] = p[c];
      dft5(v);
#pragma unroll
      for (int kc = 0; kc < 5; ++kc) p[kc] = v[kc];
    }
    __syncthreads();

    // ---- real split and power of bins k and 200 - k, k <= 100, back into
    // their own slots: with e = (Z[k] + Z*[200-k]) / 2, q = W^k (Z[k] -
    // Z*[200-k]) / 2, X[k] = e - i q and X[200-k] = conj(e + i q)
    for (int u = tid; u < 101 * kTileF; u += kThreads) {
      const int k = u / kTileF, lf = u % kTileF;
      if (lf >= nf) continue;
      float2* fb = buf + lf * kFs;
      const int2 ks = sl[k];
      split_power(fb, tk[k], k, ks.x, ks.y, fb[ks.x], fb[ks.y]);
    }
    // the next tile's first samples are on their way during the mel sums
    if (tid < nf_next * 25 && t + 1 < kTilesPerBlock)
      load_item(s, x, i0 + kTileF * kHop, tid, n_samples);
    __syncthreads();

    // ---- mel sums over each filter's band, a mel a warp, into the output tile
    for (int u = tid; u < kMels * kTileF; u += kThreads) {
      const int m = u / kTileF, lf = u % kTileF;
      const float* fp = reinterpret_cast<const float*>(buf + lf * kFs);
      const int2 nb = mband[m];
      float acc = 0.0f;
      for (int j = nb.y; j < nb.y + nb.x; ++j) acc = fmaf(fp[ep[j]], ew[j], acc);
      otile[lf * kOutPitch + m] = acc;
    }
    __syncthreads();
    float* ob = ox + (long long)f0 * kMels;
    for (int i = tid; i < nf * kMels; i += kThreads)
      ob[i] = otile[(i / kMels) * kOutPitch + i % kMels];
    nf = nf_next;   // the next tile's first writes to buf and otile lie barriers ahead
  }
}

cudaError_t prepare(int device, int n_weights) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(mel_power_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(n_weights));
}

}  // namespace

// C entry point, bound with ctypes. wav is (B, n_samples) fp32, contiguous,
// starting on an 8-byte boundary; twiddle is float2[400] = (cos, sin)(2 pi m
// / 400); window is float[400]; bands is int32[3][80]: for each mel the first
// bin of its band, the band's length and the offset of its weights in
// `weights` (fp32, n_weights long, band after band); out is (B, n_samples /
// 160, 80) fp32, contiguous. All on `device`. Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int mt_mel_power_fwd(const void* wav, const void* twiddle, const void* window,
                                const void* bands, const void* weights, void* out, int B,
                                int n_samples, int n_weights, int device, void* stream) {
  if (B <= 0 || n_samples <= kPad || n_samples % kHop != 0 || n_weights < 0 ||
      n_weights > kBins * kMels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(device, n_weights);
  if (err != cudaSuccess) return (int)err;
  const int n_frames = n_samples / kHop;
  const int tiles = (n_frames + kTileF - 1) / kTileF;
  const dim3 grid((tiles + kTilesPerBlock - 1) / kTilesPerBlock, B);
  mel_power_fwd<<<grid, kThreads, smem_bytes(n_weights), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float2*>(twiddle),
      static_cast<const float*>(window), static_cast<const int*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out), n_samples, n_weights);
  return (int)cudaGetLastError();
}

// The launch's shape for n_samples per clip: plan[0..5] = threads a block,
// frames a block, blocks a clip, dynamic shared memory bytes, blocks an SM
// (the occupancy API) and registers a thread. Returns a cudaError_t.
extern "C" int mt_mel_power_fwd_plan(int n_samples, int n_weights, int device, int* plan) {
  if (n_samples <= kPad || n_samples % kHop != 0 || n_weights < 0 || n_weights > kBins * kMels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(device, n_weights);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mel_power_fwd, kThreads,
                                                      smem_bytes(n_weights));
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mel_power_fwd)) != cudaSuccess) return (int)err;
  const int n_frames = n_samples / kHop;
  plan[0] = kThreads;
  plan[1] = kTileF * kTilesPerBlock;
  plan[2] = ((n_frames + kTileF - 1) / kTileF + kTilesPerBlock - 1) / kTilesPerBlock;
  plan[3] = (int)smem_bytes(n_weights);
  plan[4] = per_sm;
  plan[5] = attr.numRegs;
  return (int)cudaSuccess;
}
