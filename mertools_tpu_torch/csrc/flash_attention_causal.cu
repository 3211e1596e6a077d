// Causal flash attention with segment ids, forward and backward, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU flash attention that the JAX package calls from
// mertools_tpu/mllm/llm.py:_LLMLayer.__call__ (lines 185-197;
// jax.experimental.pallas.ops.tpu.flash_attention with causal=True,
// sm_scale=1/sqrt(hd) and segment ids from the attention mask), i.e. the
// library's three pallas_calls: the forward (_flash_attention_impl, with the
// l and m residuals saved for the VJP), _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq.
//
// Semantics, for batch row b, query head h, query row i and key j:
//     key j reaches query i  iff  j <= i  and  seg[b, i] == seg[b, j]
//     out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, g(h)]) @ v[b, :, g(h)]
// with g(h) = h / (nh / nkv) (GQA: kv heads are indexed, never repeated).
// Every row has at least one key (itself), so pad rows (segment 0) attend to
// the earlier pad keys and stay finite, as in the library. Four kernels:
//   fwd : one block per (64-query tile, head, b); a loop over the key tiles
//         up to the diagonal with the online softmax; writes O and the row
//         logsumexp lse = m + log(l) in fp32.
//   prep: di[b, h, i] = sum_d dO . O (fp32), one warp per row.
//   dkv : one block per (64-key tile, kv head, b); loops over the query
//         heads of the group and, for each, over the query tiles from the
//         diagonal down; dK and dV of the kv head are the sums over the group,
//         kept in registers, so no atomics are needed.
//   dq  : one block per (64-query tile, head, b); loops over the key tiles up
//         to the diagonal.
// Tiles wholly above the diagonal are skipped; the ragged edge of S (any
// length, on the LLM path a multiple of 32) is masked inside the kernel.
// q, k, v, O and dO are read in the projections' (B, S, heads, hd) layout
// through strides; lse and di are (B, nh, S) fp32.
//
// What bounds it on the H100: at the training shape (B 8, S 512, nh 32,
// nkv 4, hd 64, bf16) the forward moves ~38 MB (q, o: 16.8 MB each) and does
// ~8.6 GFLOP of causal products: ~11 us of HBM time against ~9 us of tensor-
// core time, so bytes bound it; the backward does twice the forward's
// products over the same bytes and is bound by operations.
//  * bf16: every product on the tensor cores with mma.sync m16n8k16 (bf16
//    in, fp32 accumulate), 4 warps of 16 rows; score accumulators become the
//    A operand of the next product in registers (as in
//    flash_attention_fwd.cu); operands whose k-dimension runs along the
//    sequence are staged transposed in shared memory so fragment loads are
//    32-bit. Not yet pipelined (no cp.async / TMA / wgmma): loads and math of
//    a tile do not overlap.
//  * fp32 (parity mode): plain FMAs through shared memory, never TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;        // query rows (fwd, dq) or key rows (dkv) per block
constexpr int kFmaThreads = 256;  // fp32: 16 x 16 threads, 4 rows each
constexpr int kMmaThreads = 128;  // bf16: 4 warps x 16 rows
typedef __nv_bfloat16 bf16;

struct Str {  // element strides of a (B, S, heads, hd) tensor
  int b, t, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------- fp32, FMA

// Rows t0 .. t0 + kBlock - 1 of one head into a padded shared tile (zeros
// past S).
template <int HD>
__device__ __forceinline__ void fma_load(float* dst, const float* src, int ts, int t0, int S) {
  for (int idx = threadIdx.x; idx < kBlock * HD; idx += kFmaThreads) {
    const int r = idx / HD, c = idx % HD, t = t0 + r;
    dst[r * (HD + 1) + c] = t < S ? src[(long long)t * ts + c] : 0.0f;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int* segb, int t0, int n, int S) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) dst[r] = t0 + r < S ? segb[t0 + r] : 0;
}

template <int HD>
constexpr size_t fwd_fma_smem() {
  return sizeof(float) * (3 * size_t(kBlock) * (HD + 1) + size_t(kBlock) * (kBlock + 1)) +
         sizeof(int) * kBlock;
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
fwd_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const int* __restrict__ seg, float* __restrict__ o, float* __restrict__ lse, int S,
        int group, float scale, Str sq, Str sk, Str sv, Str so) {
  constexpr int LD = HD + 1, LP = kBlock + 1, CO = HD / 16, CS = kBlock / 16;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sK = sQ + kBlock * LD;
  float* sV = sK + kBlock * LD;
  float* sP = sV + kBlock * LD;
  int* sSeg = reinterpret_cast<int*>(sP + kBlock * LP);

  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y, q0 = blockIdx.x * kBlock;
  const int kvh = h / group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const float* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const float* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  float* ob = o + (long long)b * so.b + (long long)h * so.h;
  const int* segb = seg + (long long)b * S;

  fma_load<HD>(sQ, qb, sq.t, q0, S);
  int tq[4], sg[4];
  float acc[4][CO], row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tq[i] = q0 + ty * 4 + i;
    sg[i] = tq[i] < S ? segb[tq[i]] : 0;
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.0f;
  }

  const int kend = min(q0 + kBlock, S);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    fma_load<HD>(sK, kb, sk.t, k0, S);
    fma_load<HD>(sV, vb, sv.t, k0, S);
    load_seg(sSeg, segb, k0, kBlock, S);
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
        const int j = k0 + tx + 16 * jj;
        const bool ok = tq[i] < S && j <= tq[i] && sSeg[tx + 16 * jj] == sg[i];
        s[i][jj] = ok ? s[i][jj] * scale : -INFINITY;
        m = fmaxf(m, s[i][jj]);
      }
      // the 16 threads that share a query row are 16 neighbouring lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float new_max = fmaxf(row_max[i], m);
      // a row may have no key in this tile yet: keep exp() away from -inf - -inf
      const float m_use = new_max == -INFINITY ? 0.0f : new_max;
      const float corr = expf(row_max[i] - m_use);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        const float p = expf(s[i][jj] - m_use);
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

    const int kmax = min(kBlock, S - k0);
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
    __syncthreads();  // the next tile overwrites sK, sV, sP and sSeg
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tq[i];
    if (t >= S) continue;
    const float inv = 1.0f / row_sum[i];  // > 0: the diagonal key is always in
#pragma unroll
    for (int c = 0; c < CO; ++c) ob[(long long)t * so.t + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[((long long)b * nh + h) * S + t] = row_max[i] + logf(row_sum[i]);
  }
}

template <int HD>
constexpr size_t dq_fma_smem() {
  return sizeof(float) * (4 * size_t(kBlock) * (HD + 1) + size_t(kBlock) * (kBlock + 1)) +
         sizeof(int) * kBlock;
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
dq_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const int* __restrict__ seg, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq,
       int S, int group, float scale, Str sq, Str sk, Str sv, Str sdo, Str sdq) {
  constexpr int LD = HD + 1, LP = kBlock + 1, CO = HD / 16, CS = kBlock / 16;
  extern __shared__ float fsm[];
  float* sQ = fsm;
  float* sdO = sQ + kBlock * LD;
  float* sK = sdO + kBlock * LD;
  float* sV = sK + kBlock * LD;
  float* sP = sV + kBlock * LD;
  int* sSeg = reinterpret_cast<int*>(sP + kBlock * LP);

  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y, q0 = blockIdx.x * kBlock;
  const int kvh = h / group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const float* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const float* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  const float* ob = dout + (long long)b * sdo.b + (long long)h * sdo.h;
  float* dqb = dq + (long long)b * sdq.b + (long long)h * sdq.h;
  const int* segb = seg + (long long)b * S;
  const float* lb = lse + ((long long)b * nh + h) * S;
  const float* db = di + ((long long)b * nh + h) * S;

  fma_load<HD>(sQ, qb, sq.t, q0, S);
  fma_load<HD>(sdO, ob, sdo.t, q0, S);
  int tq[4], sg[4];
  float lq[4], dq_i[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tq[i] = q0 + ty * 4 + i;
    const bool in = tq[i] < S;
    sg[i] = in ? segb[tq[i]] : 0;
    lq[i] = in ? lb[tq[i]] : 0.0f;
    dq_i[i] = in ? db[tq[i]] : 0.0f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.0f;
  }

  const int kend = min(q0 + kBlock, S);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    fma_load<HD>(sK, kb, sk.t, k0, S);
    fma_load<HD>(sV, vb, sv.t, k0, S);
    load_seg(sSeg, segb, k0, kBlock, S);
    __syncthreads();

    float s[4][CS], dp[4][CS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) s[i][jj] = dp[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[CS], vv[CS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * LD + d];
        ov[i] = sdO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        kv[jj] = sK[(tx + 16 * jj) * LD + d];
        vv[jj] = sV[(tx + 16 * jj) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CS; ++jj) {
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = fmaf(ov[i], vv[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        const int j = k0 + tx + 16 * jj;
        const bool ok = tq[i] < S && j <= tq[i] && sSeg[tx + 16 * jj] == sg[i];
        const float p = ok ? expf(s[i][jj] * scale - lq[i]) : 0.0f;
        sP[(ty * 4 + i) * LP + tx + 16 * jj] = p * (dp[i][jj] - dq_i[i]);  // dS
      }
    __syncthreads();

    const int kmax = min(kBlock, S - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[4], kv[CO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(pv[i], kv[c], acc[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tq[i] >= S) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c) dqb[(long long)tq[i] * sdq.t + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int HD>
constexpr size_t dkv_fma_smem() {
  return sizeof(float) * (4 * size_t(kBlock) * (HD + 1) + 2 * size_t(kBlock) * (kBlock + 1) +
                          2 * size_t(kBlock)) +
         sizeof(int) * kBlock;
}

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
dkv_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const int* __restrict__ seg, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk,
        float* __restrict__ dv, int S, int group, float scale, Str sq, Str sk, Str sv, Str sdo,
        Str sdk, Str sdv) {
  constexpr int LD = HD + 1, LP = kBlock + 1, CO = HD / 16, CS = kBlock / 16;
  extern __shared__ float fsm[];
  float* sK = fsm;
  float* sV = sK + kBlock * LD;
  float* sQ = sV + kBlock * LD;
  float* sdO = sQ + kBlock * LD;
  float* sPt = sdO + kBlock * LD;
  float* sdSt = sPt + kBlock * LP;
  float* sLse = sdSt + kBlock * LP;
  float* sDi = sLse + kBlock;
  int* sSeg = reinterpret_cast<int*>(sDi + kBlock);

  const int b = blockIdx.z, kvh = blockIdx.y, nh = gridDim.y * group, k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int* segb = seg + (long long)b * S;

  fma_load<HD>(sK, k + (long long)b * sk.b + (long long)kvh * sk.h, sk.t, k0, S);
  fma_load<HD>(sV, v + (long long)b * sv.b + (long long)kvh * sv.h, sv.t, k0, S);
  int tk[4], sg[4];
  float accK[4][CO], accV[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tk[i] = k0 + ty * 4 + i;
    sg[i] = tk[i] < S ? segb[tk[i]] : 0;
#pragma unroll
    for (int c = 0; c < CO; ++c) accK[i][c] = accV[i][c] = 0.0f;
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qb = q + (long long)b * sq.b + (long long)h * sq.h;
    const float* ob = dout + (long long)b * sdo.b + (long long)h * sdo.h;
    const float* lb = lse + ((long long)b * nh + h) * S;
    const float* db = di + ((long long)b * nh + h) * S;
    for (int q0 = k0; q0 < S; q0 += kBlock) {  // query tiles from the diagonal down
      __syncthreads();  // the previous tile's readers are done
      fma_load<HD>(sQ, qb, sq.t, q0, S);
      fma_load<HD>(sdO, ob, sdo.t, q0, S);
      for (int r = tid; r < kBlock; r += kFmaThreads) {
        const int i = q0 + r;
        sLse[r] = i < S ? lb[i] : 0.0f;
        sDi[r] = i < S ? db[i] : 0.0f;
        sSeg[r] = i < S ? segb[i] : 0;
      }
      __syncthreads();

      float st[4][CS], dpt[4][CS];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CS; ++jj) st[i][jj] = dpt[i][jj] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[CS], ov[CS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * LD + d];
          vv[i] = sV[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int jj = 0; jj < CS; ++jj) {
          qv[jj] = sQ[(tx + 16 * jj) * LD + d];
          ov[jj] = sdO[(tx + 16 * jj) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < CS; ++jj) {
            st[i][jj] = fmaf(kv[i], qv[jj], st[i][jj]);
            dpt[i][jj] = fmaf(vv[i], ov[jj], dpt[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CS; ++jj) {
          const int col = tx + 16 * jj, qi = q0 + col;
          const bool ok = qi < S && tk[i] <= qi && sSeg[col] == sg[i];
          const float p = ok ? expf(st[i][jj] * scale - sLse[col]) : 0.0f;
          sPt[(ty * 4 + i) * LP + col] = p;
          sdSt[(ty * 4 + i) * LP + col] = p * (dpt[i][jj] - sDi[col]);
        }
      __syncthreads();

      const int kmax = min(kBlock, S - q0);
      for (int kk = 0; kk < kmax; ++kk) {
        float pv[4], dsv[4], ov[CO], qv[CO];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sPt[(ty * 4 + i) * LP + kk];
          dsv[i] = sdSt[(ty * 4 + i) * LP + kk];
        }
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          ov[c] = sdO[kk * LD + tx + 16 * c];
          qv[c] = sQ[kk * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CO; ++c) {
            accV[i][c] = fmaf(pv[i], ov[c], accV[i][c]);
            accK[i][c] = fmaf(dsv[i], qv[c], accK[i][c]);
          }
      }
    }
  }

  float* dkb = dk + (long long)b * sdk.b + (long long)kvh * sdk.h;
  float* dvb = dv + (long long)b * sdv.b + (long long)kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tk[i] >= S) continue;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      dkb[(long long)tk[i] * sdk.t + tx + 16 * c] = accK[i][c] * scale;
      dvb[(long long)tk[i] * sdv.t + tx + 16 * c] = accV[i][c];
    }
  }
}

// ------------------------------------------------------- bf16, tensor cores

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> bf16x2, the lower column in the low half (fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows p[0 .. 15] (row stride ld), p already at (row g, col 2c).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Score C fragments of n-tiles 2kk, 2kk+1 -> the A fragment of k-step kk.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows t0 .. t0 + ROWS - 1 of one head as 16-byte vectors (zeros past S),
// row-major with row stride ld.
template <int HD, int ROWS>
__device__ __forceinline__ void mma_load(bf16* dst, int ld, const bf16* src, int ts, int t0,
                                         int S) {
  constexpr int CH = HD / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx % CH) * 8, t = t0 + r;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        t < S ? *reinterpret_cast<const uint4*>(src + (long long)t * ts + c) : zero;
  }
}

// The same rows transposed: dst[d * ld + r]. Neighbouring threads take
// neighbouring rows, so a warp's stores land in one shared row.
template <int HD, int ROWS>
__device__ __forceinline__ void mma_load_t(bf16* dst, int ld, const bf16* src, int ts, int t0,
                                           int S) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = threadIdx.x; idx < ROWS * (HD / 8); idx += kMmaThreads) {
    const int r = idx % ROWS, c = (idx / ROWS) * 8, t = t0 + r;
    const uint4 val = t < S ? *reinterpret_cast<const uint4*>(src + (long long)t * ts + c) : zero;
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * ld + r] = e[i];
  }
}

// Fragment layout of mma.m16n8k16 (PTX ISA), lane = 4 * g + c:
//   A (16x16): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..), a3 = (g+8, 2c+8..)
//   B (16x8):  b0 = (k 2c..2c+1, n g), b1 = (k 2c+8..2c+9, n g)
//   C (16x8):  c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)

template <int HD>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (2 * size_t(kBlock) * (HD + 8) + size_t(HD) * (kBlock + 8)) +
         sizeof(int) * kBlock;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const int* __restrict__ seg, bf16* __restrict__ o, float* __restrict__ lse, int S,
        int group, float scale, Str sq, Str sk, Str sv, Str so) {
  constexpr int LDQ = HD + 8, LDV = kBlock + 8;
  constexpr int KQ = HD / 16, NS = kBlock / 8, KP = kBlock / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char msm[];
  bf16* sQ = reinterpret_cast<bf16*>(msm);
  bf16* sK = sQ + kBlock * LDQ;
  bf16* sVt = sK + kBlock * LDQ;
  int* sSeg = reinterpret_cast<int*>(sVt + HD * LDV);

  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y, q0 = blockIdx.x * kBlock;
  const int kvh = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const bf16* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const bf16* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const bf16* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  bf16* ob = o + (long long)b * so.b + (long long)h * so.h;
  const int* segb = seg + (long long)b * S;

  mma_load<HD, kBlock>(sQ, LDQ, qb, sq.t, q0, S);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) load_a(qa[kk], sQ + r0 * LDQ + kk * 16 + c2, LDQ);
  const int t0 = q0 + r0, t1 = t0 + 8;
  const int sg0 = t0 < S ? segb[t0] : 0, sg1 = t1 < S ? segb[t1] : 0;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.0f, 0.0f};  // this thread's partial sums

  const int kend = min(q0 + kBlock, S);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    mma_load<HD, kBlock>(sK, LDQ, kb, sk.t, k0, S);
    mma_load_t<HD, kBlock>(sVt, LDV, vb, sv.t, k0, S);
    load_seg(sSeg, segb, k0, kBlock, S);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* p = sK + (n * 8 + g) * LDQ + kk * 16 + c2;
        mma_16816(s[n], qa[kk], ld32(p), ld32(p + 8));
      }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + c2 + e, j = k0 + col, js = sSeg[col];
        s[n][e] = (t0 < S && j <= t0 && js == sg0) ? s[n][e] * scale : -INFINITY;
        s[n][2 + e] = (t1 < S && j <= t1 && js == sg1) ? s[n][2 + e] * scale : -INFINITY;
        mx[0] = fmaxf(mx[0], s[n][e]);
        mx[1] = fmaxf(mx[1], s[n][2 + e]);
      }
    float corr[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 lanes that share a row are neighbours
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float new_max = fmaxf(row_max[i], mx[i]);
      m_use[i] = new_max == -INFINITY ? 0.0f : new_max;  // no key for this row yet
      corr[i] = expf(row_max[i] - m_use[i]);
      row_max[i] = new_max;
      row_sum[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);
        row_sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* p = sVt + (n * 8 + g) * LDV + kk * 16 + c2;
        mma_16816(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
    __syncthreads();  // the next tile overwrites sK, sVt and sSeg
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
    row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
  }
  const float inv0 = 1.0f / row_sum[0], inv1 = 1.0f / row_sum[1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + c2;
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)t0 * so.t + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(ob + (long long)t1 * so.t + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if ((tid & 3) == 0) {
    float* lb = lse + ((long long)b * nh + h) * S;
    if (t0 < S) lb[t0] = row_max[0] + logf(row_sum[0]);
    if (t1 < S) lb[t1] = row_max[1] + logf(row_sum[1]);
  }
}

template <int HD>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (4 * size_t(kBlock) * (HD + 8) + size_t(HD) * (kBlock + 8)) +
         sizeof(int) * kBlock;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ di, bf16* __restrict__ dq, int S, int group, float scale,
       Str sq, Str sk, Str sv, Str sdo, Str sdq) {
  constexpr int LD = HD + 8, LDT = kBlock + 8;
  constexpr int KQ = HD / 16, NS = kBlock / 8, KP = kBlock / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char msm[];
  bf16* sQ = reinterpret_cast<bf16*>(msm);
  bf16* sdO = sQ + kBlock * LD;
  bf16* sK = sdO + kBlock * LD;
  bf16* sV = sK + kBlock * LD;
  bf16* sKt = sV + kBlock * LD;
  int* sSeg = reinterpret_cast<int*>(sKt + HD * LDT);

  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y, q0 = blockIdx.x * kBlock;
  const int kvh = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const bf16* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const bf16* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  bf16* dqb = dq + (long long)b * sdq.b + (long long)h * sdq.h;
  const int* segb = seg + (long long)b * S;
  const float* lb = lse + ((long long)b * nh + h) * S;
  const float* db = di + ((long long)b * nh + h) * S;

  mma_load<HD, kBlock>(sQ, LD, q + (long long)b * sq.b + (long long)h * sq.h, sq.t, q0, S);
  mma_load<HD, kBlock>(sdO, LD, dout + (long long)b * sdo.b + (long long)h * sdo.h, sdo.t, q0,
                       S);
  const int r0 = warp * 16 + g;
  const int tr[2] = {q0 + r0, q0 + r0 + 8};
  int sg[2];
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = tr[i] < S;
    sg[i] = in ? segb[tr[i]] : 0;
    lr[i] = in ? lb[tr[i]] : 0.0f;
    dr[i] = in ? db[tr[i]] : 0.0f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int kend = min(q0 + kBlock, S);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    mma_load<HD, kBlock>(sK, LD, kb, sk.t, k0, S);
    mma_load<HD, kBlock>(sV, LD, vb, sv.t, k0, S);
    mma_load_t<HD, kBlock>(sKt, LDT, kb, sk.t, k0, S);
    load_seg(sSeg, segb, k0, kBlock, S);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, sQ + r0 * LD + kk * 16 + c2, LD);
      load_a(ad, sdO + r0 * LD + kk * 16 + c2, LD);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* pk = sK + (n * 8 + g) * LD + kk * 16 + c2;
        const bf16* pv = sV + (n * 8 + g) * LD + kk * 16 + c2;
        mma_16816(s[n], a, ld32(pk), ld32(pk + 8));
        mma_16816(dp[n], ad, ld32(pv), ld32(pv + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + c2 + (e & 1), j = k0 + col;
        const bool ok = tr[i] < S && j <= tr[i] && sSeg[col] == sg[i];
        const float p = ok ? expf(s[n][e] * scale - lr[i]) : 0.0f;
        s[n][e] = p * (dp[n][e] - dr[i]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* p = sKt + (n * 8 + g) * LDT + kk * 16 + c2;
        mma_16816(acc[n], pa, ld32(p), ld32(p + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + c2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tr[i] < S)
        *reinterpret_cast<uint32_t*>(dqb + (long long)tr[i] * sdq.t + c) =
            pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int HD, int BQ>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (2 * size_t(kBlock) * (HD + 8) + 2 * size_t(BQ) * (HD + 8) +
                         2 * size_t(HD) * (BQ + 8)) +
         (2 * sizeof(float) + sizeof(int)) * BQ;
}

// BQ: query rows per inner tile (32 at hd 128 keeps dK, dV and the two
// score tiles within the register file).
template <int HD, int BQ>
__global__ void __launch_bounds__(kMmaThreads)
dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const int* __restrict__ seg, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int S, int group, float scale, Str sq, Str sk, Str sv, Str sdo,
        Str sdk, Str sdv) {
  constexpr int LD = HD + 8, LDT = BQ + 8;
  constexpr int KQ = HD / 16, NS = BQ / 8, KP = BQ / 16, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char msm[];
  bf16* sK = reinterpret_cast<bf16*>(msm);
  bf16* sV = sK + kBlock * LD;
  bf16* sQ = sV + kBlock * LD;
  bf16* sdO = sQ + BQ * LD;
  bf16* sQt = sdO + BQ * LD;
  bf16* sdOt = sQt + HD * LDT;
  float* sLse = reinterpret_cast<float*>(sdOt + HD * LDT);
  float* sDi = sLse + BQ;
  int* sSeg = reinterpret_cast<int*>(sDi + BQ);

  const int b = blockIdx.z, kvh = blockIdx.y, nh = gridDim.y * group, k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const int* segb = seg + (long long)b * S;

  mma_load<HD, kBlock>(sK, LD, k + (long long)b * sk.b + (long long)kvh * sk.h, sk.t, k0, S);
  mma_load<HD, kBlock>(sV, LD, v + (long long)b * sv.b + (long long)kvh * sv.h, sv.t, k0, S);
  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  const int tj[2] = {k0 + r0, k0 + r0 + 8};
  const int sg[2] = {tj[0] < S ? segb[tj[0]] : 0, tj[1] < S ? segb[tj[1]] : 0};
  float accK[NO][4], accV[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[n][e] = accV[n][e] = 0.0f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const bf16* qb = q + (long long)b * sq.b + (long long)h * sq.h;
    const bf16* ob = dout + (long long)b * sdo.b + (long long)h * sdo.h;
    const float* lb = lse + ((long long)b * nh + h) * S;
    const float* db = di + ((long long)b * nh + h) * S;
    for (int q0 = k0; q0 < S; q0 += BQ) {  // query tiles from the diagonal down
      __syncthreads();  // the previous tile's readers are done
      mma_load<HD, BQ>(sQ, LD, qb, sq.t, q0, S);
      mma_load<HD, BQ>(sdO, LD, ob, sdo.t, q0, S);
      mma_load_t<HD, BQ>(sQt, LDT, qb, sq.t, q0, S);
      mma_load_t<HD, BQ>(sdOt, LDT, ob, sdo.t, q0, S);
      for (int r = tid; r < BQ; r += kMmaThreads) {
        const int i = q0 + r;
        sLse[r] = i < S ? lb[i] : 0.0f;
        sDi[r] = i < S ? db[i] : 0.0f;
        sSeg[r] = i < S ? segb[i] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 key rows x BQ queries per warp
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, sK + r0 * LD + kk * 16 + c2, LD);
        load_a(av, sV + r0 * LD + kk * 16 + c2, LD);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const bf16* pq = sQ + (n * 8 + g) * LD + kk * 16 + c2;
          const bf16* pd = sdO + (n * 8 + g) * LD + kk * 16 + c2;
          mma_16816(st[n], ak, ld32(pq), ld32(pq + 8));
          mma_16816(dpt[n], av, ld32(pd), ld32(pd + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, col = n * 8 + c2 + (e & 1), qi = q0 + col;
          const bool ok = qi < S && tj[i] <= qi && sSeg[col] == sg[i];
          const float p = ok ? expf(st[n][e] * scale - sLse[col]) : 0.0f;
          dpt[n][e] = p * (dpt[n][e] - sDi[col]);  // dS^T
          st[n][e] = p;                            // P^T
        }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const bf16* po = sdOt + (n * 8 + g) * LDT + kk * 16 + c2;
          const bf16* pq = sQt + (n * 8 + g) * LDT + kk * 16 + c2;
          mma_16816(accV[n], pa, ld32(po), ld32(po + 8));
          mma_16816(accK[n], da, ld32(pq), ld32(pq + 8));
        }
      }
    }
  }

  bf16* dkb = dk + (long long)b * sdk.b + (long long)kvh * sdk.h;
  bf16* dvb = dv + (long long)b * sdv.b + (long long)kvh * sdv.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + c2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tj[i] < S) {
        *reinterpret_cast<uint32_t*>(dkb + (long long)tj[i] * sdk.t + c) =
            pack_bf16(accK[n][2 * i] * scale, accK[n][2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + (long long)tj[i] * sdv.t + c) =
            pack_bf16(accV[n][2 * i], accV[n][2 * i + 1]);
      }
  }
}

// ----------------------------------------------------------- di pre-pass

// di[(b * nh + h) * S + t] = sum_d o[b, t, h, d] * dout[b, t, h, d] in fp32;
// one warp per row, 8 rows per block.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ di, int B,
         int S, int nh, Str so, Str sdo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)B * nh * S) return;
  const int t = (int)(row % S), h = (int)((row / S) % nh), b = (int)(row / ((long long)S * nh));
  const T* op = o + (long long)b * so.b + (long long)t * so.t + (long long)h * so.h;
  const T* dp = dout + (long long)b * sdo.b + (long long)t * sdo.t + (long long)h * sdo.h;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

// ----------------------------------------------------------------- launch

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Str str(const int* s, int i) { return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <int HD>
cudaError_t fwd_hd(bool bf, const void* q, const void* k, const void* v, const int* seg, void* o,
                   float* lse, int B, int S, int nh, int group, const int* s, cudaStream_t st) {
  const dim3 grid((S + kBlock - 1) / kBlock, nh, B);
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t err;
  if (bf) {
    constexpr size_t smem = fwd_mma_smem<HD>();
    if ((err = prepare(fwd_mma<HD>, smem)) != cudaSuccess) return err;
    fwd_mma<HD><<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, seg, (bf16*)o, lse, S, group, scale,
        str(s, 0), str(s, 1), str(s, 2), str(s, 3));
  } else {
    constexpr size_t smem = fwd_fma_smem<HD>();
    if ((err = prepare(fwd_fma<HD>, smem)) != cudaSuccess) return err;
    fwd_fma<HD><<<grid, kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (float*)o, lse, S, group, scale,
        str(s, 0), str(s, 1), str(s, 2), str(s, 3));
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dq_hd(bool bf, const void* q, const void* k, const void* v, const int* seg,
                  const void* dout, const float* lse, const float* di, void* dq, int B, int S,
                  int nh, int group, const int* s, cudaStream_t st) {
  const dim3 grid((S + kBlock - 1) / kBlock, nh, B);
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t err;
  if (bf) {
    constexpr size_t smem = dq_mma_smem<HD>();
    if ((err = prepare(dq_mma<HD>, smem)) != cudaSuccess) return err;
    dq_mma<HD><<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, seg, (const bf16*)dout, lse, di,
        (bf16*)dq, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3), str(s, 4));
  } else {
    constexpr size_t smem = dq_fma_smem<HD>();
    if ((err = prepare(dq_fma<HD>, smem)) != cudaSuccess) return err;
    dq_fma<HD><<<grid, kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (const float*)dout, lse, di,
        (float*)dq, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3), str(s, 4));
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dkv_hd(bool bf, const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* di, void* dk, void* dv,
                   int B, int S, int nkv, int group, const int* s, cudaStream_t st) {
  const dim3 grid((S + kBlock - 1) / kBlock, nkv, B);
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t err;
  if (bf) {
    constexpr int BQ = HD == 128 ? 32 : 64;
    constexpr size_t smem = dkv_mma_smem<HD, BQ>();
    if ((err = prepare(dkv_mma<HD, BQ>, smem)) != cudaSuccess) return err;
    dkv_mma<HD, BQ><<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, seg, (const bf16*)dout, lse, di,
        (bf16*)dk, (bf16*)dv, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3),
        str(s, 4), str(s, 5));
  } else {
    constexpr size_t smem = dkv_fma_smem<HD>();
    if ((err = prepare(dkv_fma<HD>, smem)) != cudaSuccess) return err;
    dkv_fma<HD><<<grid, kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (const float*)dout, lse, di,
        (float*)dk, (float*)dv, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3),
        str(s, 4), str(s, 5));
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t prep_hd(bool bf, const void* o, const void* dout, float* di, int B, int S, int nh,
                    const int* s, cudaStream_t st) {
  const long long rows = (long long)B * nh * S;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (bf)
    bwd_prep<bf16, HD><<<blocks, 256, 0, st>>>((const bf16*)o, (const bf16*)dout, di, B, S, nh,
                                               str(s, 0), str(s, 1));
  else
    bwd_prep<float, HD><<<blocks, 256, 0, st>>>((const float*)o, (const float*)dout, di, B, S,
                                                nh, str(s, 0), str(s, 1));
  return cudaGetLastError();
}

bool shapes_ok(int B, int S, int nh, int nkv) {
  return B > 0 && S > 0 && nh > 0 && nkv > 0 && nh % nkv == 0;
}

}  // namespace

// C entry points, bound with ctypes. Every tensor argument is (B, S, heads,
// hd) with a contiguous head dimension; `strides` is a host array of element
// strides (b, t, h) per tensor, in the order the arguments list the tensors.
// seg is int32 (B, S) contiguous, lse and di fp32 (B, nh, S) contiguous, all on
// the device. For bf16 every row starts on a 16-byte boundary. Each launches
// on `stream`, does not synchronise, and returns the launch's cudaError_t.

// q (B,S,nh,hd), k, v (B,S,nkv,hd) -> o (B,S,nh,hd), lse. strides: q, k, v, o.
extern "C" int mt_flash_attention_causal_fwd(const void* q, const void* k, const void* v,
                                             const int* seg, void* o, float* lse, int B, int S,
                                             int nh, int nkv, int hd, int is_bf16, int device,
                                             const int* strides, void* stream) {
  if (!shapes_ok(B, S, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)fwd_hd<64>(is_bf16, q, k, v, seg, o, lse, B, S, nh, nh / nkv, strides, st);
    case 128: return (int)fwd_hd<128>(is_bf16, q, k, v, seg, o, lse, B, S, nh, nh / nkv, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// o, dout (B,S,nh,hd) -> di. strides: o, dout.
extern "C" int mt_flash_attention_causal_bwd_prep(const void* o, const void* dout, float* di,
                                                  int B, int S, int nh, int hd, int is_bf16,
                                                  int device, const int* strides, void* stream) {
  if (!shapes_ok(B, S, nh, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)prep_hd<64>(is_bf16, o, dout, di, B, S, nh, strides, st);
    case 128: return (int)prep_hd<128>(is_bf16, o, dout, di, B, S, nh, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -> dk, dv (B,S,nkv,hd), each the sum over its group's query heads.
// strides: q, k, v, dout, dk, dv.
extern "C" int mt_flash_attention_causal_bwd_dkv(const void* q, const void* k, const void* v,
                                                 const int* seg, const void* dout,
                                                 const float* lse, const float* di, void* dk,
                                                 void* dv, int B, int S, int nh, int nkv, int hd,
                                                 int is_bf16, int device, const int* strides,
                                                 void* stream) {
  if (!shapes_ok(B, S, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)dkv_hd<64>(is_bf16, q, k, v, seg, dout, lse, di, dk, dv, B, S, nkv, nh / nkv,
                             strides, st);
    case 128:
      return (int)dkv_hd<128>(is_bf16, q, k, v, seg, dout, lse, di, dk, dv, B, S, nkv, nh / nkv,
                              strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -> dq (B,S,nh,hd). strides: q, k, v, dout, dq.
extern "C" int mt_flash_attention_causal_bwd_dq(const void* q, const void* k, const void* v,
                                                const int* seg, const void* dout,
                                                const float* lse, const float* di, void* dq,
                                                int B, int S, int nh, int nkv, int hd,
                                                int is_bf16, int device, const int* strides,
                                                void* stream) {
  if (!shapes_ok(B, S, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)dq_hd<64>(is_bf16, q, k, v, seg, dout, lse, di, dq, B, S, nh, nh / nkv,
                            strides, st);
    case 128:
      return (int)dq_hd<128>(is_bf16, q, k, v, seg, dout, lse, di, dq, B, S, nh, nh / nkv,
                             strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
