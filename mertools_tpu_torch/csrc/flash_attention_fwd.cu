// Bidirectional flash-attention forward with per-row key lengths, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU flash attention that the JAX package calls from
// mertools_tpu/encoders/wav2vec2.py:_Attention.__call__ (lines 160-181;
// jax.experimental.pallas.ops.tpu.flash_attention with causal=False,
// sm_scale=1.0 and segment ids "valid frame = 1, pad = 2").
//
// Computes, for every (batch b, head h, query row t):
//     out[b, t, h, :] = softmax_j(q[b, t, h, :] . k[b, j, h, :]) @ v[b, :, h, :]
// over the keys j < kv_len[b]. q is already scaled by hd^-0.5. Validity on the
// HuBERT path is always a prefix of the frames (mask = t < frames), so one
// length per row replaces the segment ids exactly. Keys at or past kv_len are
// never read, so pad rows of K and V may hold anything (even NaN). Query rows
// past kv_len attend to the valid keys and stay finite. A row with
// kv_len <= 0 writes zeros. Both kernels read the projections' own
// (B, T, nh, hd) layout through strides (the head dimension contiguous), so
// there is no transpose and no pad to a tile multiple.
//
// Both kernels: one block per (64-query tile, head, batch row); a loop over
// 64-key tiles staged in shared memory; an online max and sum per query row
// (the FlashAttention-2 recurrence) with the output accumulator in registers,
// all in fp32. The (B, nh, T, T) logits never reach device memory.
//
// What bounds it on the H100: at HuBERT-large shapes (T = 499, hd = 64, 16
// rows x 16 heads) a layer's q, k, v and out are 33 MB in bf16 and the two
// products 16 GFLOP, so compute, not memory, sets the time.
//  * bf16 (the production mode): both products run on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate); each of 4 warps owns 16
//    query rows, keeps its Q fragments in registers, and turns the score
//    accumulator into the A operand of P.V without a trip through shared
//    memory. V is stored transposed in shared memory so that its B fragments
//    are 32-bit loads. Rows are padded by 8 elements to keep fragment loads
//    free of bank conflicts. Not yet pipelined (no cp.async / TMA, no wgmma):
//    loads and math of a tile do not overlap, which is the next step.
//  * fp32 (the parity mode): plain FMAs, because the tensor cores' TF32
//    would break fp32 parity. 256 threads, each 4 query rows x (hd / 16)
//    columns; two shared loads per 16 FMAs, bounded by FMA issue and shared
//    memory bandwidth; rows padded to hd + 1 floats against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;       // query rows per block
constexpr int kBlockK = 64;       // keys per shared-memory tile
constexpr int kFmaThreads = 256;  // fp32: 16 x 16 threads
constexpr int kMmaThreads = 128;  // bf16: 4 warps x 16 query rows

// ---------------------------------------------------------------- fp32, FMA

template <int HD>
constexpr size_t fma_smem_bytes() {
  // Q, K and V tiles with padded rows, plus the probability tile.
  return sizeof(float) * (size_t(kBlockQ + 2 * kBlockK) * (HD + 1) + size_t(kBlockQ) * (kBlockK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_attention_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        const int* __restrict__ kv_len, int seq_len,
                        int sqb, int sqt, int sqh, int skb, int skt, int skh,
                        int svb, int svt, int svh, int sob, int sot, int soh) {
  constexpr int LD = HD + 1;        // padded row stride of the Q, K, V tiles
  constexpr int LP = kBlockK + 1;   // padded row stride of the probability tile
  constexpr int CO = HD / 16;       // output columns per thread
  constexpr int CS = kBlockK / 16;  // score columns per thread

  extern __shared__ float fma_smem[];
  float* sQ = fma_smem;
  float* sK = sQ + kBlockQ * LD;
  float* sV = sK + kBlockK * LD;
  float* sP = sV + kBlockK * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // owns query rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // owns columns tx, tx+16, ... (keys, then head dims)

  const float* qb = q + (long long)b * sqb + (long long)h * sqh;
  const float* kb = k + (long long)b * skb + (long long)h * skh;
  const float* vb = v + (long long)b * svb + (long long)h * svh;
  float* ob = o + (long long)b * sob + (long long)h * soh;

  const int n_keys = min(kv_len[b], seq_len);
  if (n_keys <= 0) {  // filler row: nothing to attend to
    for (int idx = tid; idx < kBlockQ * HD; idx += kFmaThreads) {
      const int r = idx / HD, c = idx % HD, t = q0 + r;
      if (t < seq_len) ob[(long long)t * sot + c] = 0.0f;
    }
    return;
  }

  for (int idx = tid; idx < kBlockQ * HD; idx += kFmaThreads) {
    const int r = idx / HD, c = idx % HD, t = q0 + r;
    sQ[r * LD + c] = t < seq_len ? qb[(long long)t * sqt + c] : 0.0f;
  }

  float acc[4][CO];
  float row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    for (int idx = tid; idx < kBlockK * HD; idx += kFmaThreads) {
      const int r = idx / HD, c = idx % HD, j = k0 + r;
      const bool valid = j < n_keys;
      sK[r * LD + c] = valid ? kb[(long long)j * skt + c] : 0.0f;
      sV[r * LD + c] = valid ? vb[(long long)j * svt + c] : 0.0f;
    }
    __syncthreads();

    float s[4][CS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) s[i][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[CS];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) kv[jj] = sK[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CS; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        if (k0 + tx + 16 * jj >= n_keys) s[i][jj] = -INFINITY;
        m = fmaxf(m, s[i][jj]);
      }
      // The 16 threads that share a query row are 16 neighbouring lanes.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      // Key k0 is valid, so m is finite for every row.
      const float new_max = fmaxf(row_max[i], m);
      const float corr = expf(row_max[i] - new_max);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        const float p = expf(s[i][jj] - new_max);
        psum += p;
        sP[(ty * 4 + i) * LP + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      row_sum[i] = row_sum[i] * corr + psum;
      row_max[i] = new_max;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int kmax = min(kBlockK, n_keys - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[4], vv[CO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // the next tile overwrites sK, sV and sP
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= seq_len) continue;
    const float inv = 1.0f / row_sum[i];
#pragma unroll
    for (int c = 0; c < CO; ++c) ob[(long long)t * sot + tx + 16 * c] = acc[i][c] * inv;
  }
}

// ------------------------------------------------------- bf16, tensor cores

template <int HD>
constexpr size_t mma_smem_bytes() {
  // Q and K tiles (rows of HD + 8), and V transposed (rows of kBlockK + 8).
  return sizeof(__nv_bfloat16) *
         (size_t(kBlockQ + kBlockK) * (HD + 8) + size_t(HD) * (kBlockK + 8));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> bf16x2, the lower column in the low half (fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 * g + c:
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..), a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8..2c+9, n g)
//   C (16x8):  c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                        const int* __restrict__ kv_len, int seq_len,
                        int sqb, int sqt, int sqh, int skb, int skt, int skh,
                        int svb, int svt, int svh, int sob, int sot, int soh) {
  constexpr int LDQ = HD + 8;       // shared row stride of Q and K (elements)
  constexpr int LDV = kBlockK + 8;  // shared row stride of V^T
  constexpr int CH = HD / 8;        // 16-byte chunks per row
  constexpr int KQ = HD / 16;       // k-steps of Q.K^T
  constexpr int NS = kBlockK / 8;   // n-tiles of the score tile
  constexpr int KP = kBlockK / 16;  // k-steps of P.V
  constexpr int NO = HD / 8;        // n-tiles of the output

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LDQ;
  __nv_bfloat16* sVt = sK + kBlockK * LDQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row (A, C) / column (B)
  const int c2 = (tid & 3) * 2;   // fragment column pair

  const __nv_bfloat16* qb = q + (long long)b * sqb + (long long)h * sqh;
  const __nv_bfloat16* kb = k + (long long)b * skb + (long long)h * skh;
  const __nv_bfloat16* vb = v + (long long)b * svb + (long long)h * svh;
  __nv_bfloat16* ob = o + (long long)b * sob + (long long)h * soh;

  const int n_keys = min(kv_len[b], seq_len);
  if (n_keys <= 0) {  // filler row: nothing to attend to
    for (int idx = tid; idx < kBlockQ * HD; idx += kMmaThreads) {
      const int r = idx / HD, c = idx % HD, t = q0 + r;
      if (t < seq_len) ob[(long long)t * sot + c] = __float2bfloat16(0.0f);
    }
    return;
  }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < kBlockQ * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx % CH) * 8, t = q0 + r;
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) =
        t < seq_len ? *reinterpret_cast<const uint4*>(qb + (long long)t * sqt + c) : zero;
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const __nv_bfloat16* p = sQ + r0 * LDQ + kk * 16 + c2;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LDQ);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LDQ + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.0f, 0.0f};  // this thread's partial sums

  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    for (int idx = tid; idx < kBlockK * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = (idx % CH) * 8, j = k0 + r;
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) =
          j < n_keys ? *reinterpret_cast<const uint4*>(kb + (long long)j * skt + c) : zero;
    }
    // V: neighbouring threads take neighbouring keys, so the transposed
    // stores of a warp land in one shared row.
    for (int idx = tid; idx < kBlockK * CH; idx += kMmaThreads) {
      const int r = idx % kBlockK, c = (idx / kBlockK) * 8, j = k0 + r;
      const uint4 val =
          j < n_keys ? *reinterpret_cast<const uint4*>(vb + (long long)j * svt + c) : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(c + i) * LDV + r] = e[i];
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* p = sK + (n * 8 + g) * LDQ + kk * 16 + c2;
        mma_16816(s[n], qa[kk], ld32(p), ld32(p + 8));
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + n * 8 + c2 + e >= n_keys) s[n][e] = s[n][2 + e] = -INFINITY;
        mx[0] = fmaxf(mx[0], s[n][e]);
        mx[1] = fmaxf(mx[1], s[n][2 + e]);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 lanes that share a row are neighbours
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float new_max = fmaxf(row_max[i], mx[i]);  // finite: key k0 is valid
      corr[i] = expf(row_max[i] - new_max);
      row_max[i] = new_max;
      row_sum[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - row_max[e >> 1]);
        row_sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // P (scores' C fragments, rounded to bf16) is the A operand of P.V.
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = sVt + (n * 8 + g) * LDV + kk * 16 + c2;
        mma_16816(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
    __syncthreads();  // the next tile overwrites sK and sVt
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
  }
  const float inv0 = 1.0f / row_sum[0], inv1 = 1.0f / row_sum[1];
  const int t0 = q0 + r0, t1 = t0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + c2;
    if (t0 < seq_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)t0 * sot + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (t1 < seq_len)
      *reinterpret_cast<uint32_t*>(ob + (long long)t1 * sot + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ----------------------------------------------------------------- launch

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, const int*, int,
                          int, int, int, int, int, int, int, int, int, int, int, int);

template <typename T>
cudaError_t launch(KernelFn<T> kernel, size_t smem, int threads, const void* q, const void* k,
                   const void* v, void* o, const int* kv_len, int B, int T_len, int nh,
                   const int* s, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBlockQ - 1) / kBlockQ, nh, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, T_len,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(bool bf16, const void* q, const void* k, const void* v, void* o,
                      const int* kv_len, int B, int T_len, int nh, const int* s,
                      cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(flash_attention_fwd_mma<HD>, mma_smem_bytes<HD>(),
                                      kMmaThreads, q, k, v, o, kv_len, B, T_len, nh, s, stream)
              : launch<float>(flash_attention_fwd_fma<HD>, fma_smem_bytes<HD>(), kFmaThreads,
                              q, k, v, o, kv_len, B, T_len, nh, s, stream);
}

}  // namespace

// C entry point, bound with ctypes. q, k, v and o are (B, T, nh, hd) with the
// given element strides for (b, t, h) and a contiguous head dimension; for
// bf16 every row must start on a 16-byte boundary. kv_len is int32[B] on the
// device. Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" int mt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      const int* kv_len, int B, int T_len, int nh, int hd,
                                      int is_bf16, int device,
                                      int sqb, int sqt, int sqh, int skb, int skt, int skh,
                                      int svb, int svt, int svh, int sob, int sot, int soh,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int s[12] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)launch_hd<32>(is_bf16, q, k, v, o, kv_len, B, T_len, nh, s, st);
    case 64: return (int)launch_hd<64>(is_bf16, q, k, v, o, kv_len, B, T_len, nh, s, st);
    case 128: return (int)launch_hd<128>(is_bf16, q, k, v, o, kv_len, B, T_len, nh, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
