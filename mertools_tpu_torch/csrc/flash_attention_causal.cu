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
//   fwd : one block per (64-query tile, head, b), in bf16 the last query
//         tile (the longest walk) first; a loop over the key tiles up to the
//         diagonal with the online softmax; writes O and the row logsumexp
//         lse = m + log(l) in fp32, natural units.
//   prep: di[b, h, i] = sum_d dO . O (fp32); one block per (32 tokens, 8
//         heads, b) reads the rows in memory order with 16-byte loads.
//   dkv : dK and dV, each the sum over the kv head's group of query heads.
//         bf16: one block per (64-key tile, slice of the group's heads, b),
//         key tile 0 (the longest walk) first; the blocks of one kv head
//         form a thread-block cluster that adds their dK and dV through
//         distributed shared memory in rank order (deterministic, no
//         atomics). fp32: one block per (key tile, kv head, b) walks the
//         whole group and sums in registers.
//   dq  : one block per (64-query tile, head, b), in bf16 the last query
//         tile (the longest walk) first; loops over the key tiles up to the
//         diagonal.
// Tiles wholly above the diagonal are skipped; the ragged edge of S (any
// length, on the LLM path a multiple of 32) is masked inside the kernel.
// q, k, v, O and dO are read in the projections' (B, S, heads, hd) layout
// through strides; lse and di are (B, nh, S) fp32.
//
// What bounds it on the H100, at the training shape (B 8, S 512, nh 32,
// nkv 4, hd 64, bf16, ragged lengths 512 .. 97), counting each input read
// once, each output written once and the products over the pairs the mask
// lets through: the forward moves 38 MB for 6.0 GFLOP (11 us of HBM time
// against 6 us at the bf16 tensor peak: bytes); dkv moves 43.0 MB for 12.0
// GFLOP (12.8 us against 12.2 us: bytes and operations about equal); dq
// 55.6 MB for 9.0 GFLOP (16.6 us against 9.1 us: bytes). With the tiles
// padded to 64 rows dkv executes ~19 GFLOP and dq ~14.
//    The forward's 64 x 64 tiles up to the diagonal are ~9.7 GFLOP of padded
//    products, 10 us at the bf16 peak: the bytes and the padded products
//    bound it about equally, so it needs both the copies hidden and the
//    tensor cores fed.
//  * bf16 (all three kernels): wgmma on one warpgroup per block, tiles by
//    cp.async through rings of stages (three at hd 64; two for the forward
//    and dq at hd 128, where a third would leave one block an SM) in the
//    swizzle wgmma reads both K-major and MN-major, so no operand is read
//    twice or transposed (V in the forward's P V is read MN-major from its
//    one copy); the grids give 2048 blocks at the training shape, the
//    longest walks first. The forward (causal_fwd_wgmma, with the main loop
//    of hopper_wgmma.cuh) overlaps each step's softmax with the previous
//    step's P V product, skips the per-element mask on tiles wholly below
//    the diagonal and inside one segment, and exponentiates with ex2 with
//    log2(e) / sqrt(hd) folded into one FMA (see the notes above the
//    kernels).
//  * fp32 (parity mode): plain FMAs through shared memory, never TF32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 64;        // query rows (fwd, dq) or key rows (dkv) per block
constexpr int kFmaThreads = 256;  // fp32: 16 x 16 threads, 4 rows each

struct Str {  // element strides of a (B, S, heads, hd) tensor
  int b, t, h;
};

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

// ------------------------------------------------------ bf16, wgmma (Hopper)
//
// The three bf16 kernels (forward, dK/dV, dQ) run one warpgroup (128
// threads) per block and run every product as wgmma.mma_async m64nNk16 (bf16
// in, fp32 accumulate) on a 64-row tile, with the helpers of hopper_wgmma.cuh.
// Tiles come from HBM by cp.async (16-byte copies, zero-filled past S) into a
// ring of stages, so the next tiles land while the current ones are
// multiplied. In shared memory a tile of ROWS rows of HD bf16 is stored in
// the 128-byte swizzle the wgmma descriptors name: HD / 64 column panels of
// ROWS x 128 bytes, chunk c (8 bf16) of row r at chunk c ^ (r % 8) of its
// panel. That one copy is read both ways: K-major where the product's
// reduction runs along hd (Q and K in Q K^T, K and Q in K Q^T, V and dO in
// V dO^T) and MN-major where it runs along the sequence (V in P V, dO in
// P^T dO, Q in dS^T Q, K in dS K), so nothing is read twice from HBM or
// transposed by hand. P, P^T, dS^T and dS go from the score accumulators
// into A fragments in registers.

// The softmax scale 1 / sqrt(hd), as a constant of the kernel.
template <int HD>
__device__ __forceinline__ constexpr float inv_sqrt_hd() {
  static_assert(HD == 64 || HD == 128, "head dims 64 and 128");
  return HD == 64 ? 0.125f : 0.08838834764831845f;
}

// bf16 forward. Grid (nh, B, S / 64 query tiles), the last query tile (the
// longest walk) launched first. A block holds its 64 query rows of Q and
// walks the key tiles up to the diagonal through fwd_mainloop (K with the
// keys' seg, and V, in rings of NST stages). When the query tile lies inside
// S and in one segment, the walk starts at the tile of that segment's first
// key (the tiles before it hold no key the rows reach: in a right-padded
// batch a pad tile skips the prompt), and a key tile in the same segment
// takes no per-element mask below the diagonal and only the causal one on
// it; other tiles are masked by position, S and segment. The running max is
// kept in base 2 (sl2 = log2(e) / sqrt(hd)); lse is written in natural
// units, m ln 2 + ln l, as the backward and the plain version read it.
template <int HD, int NST>
__global__ void __launch_bounds__(kWgThreads)
causal_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int group, Str sq, Str sk, Str sv, Str so) {
  using L = FwdSmem<HD, NST>;
  constexpr float sl2 = inv_sqrt_hd<HD>() * kLog2e;
  extern __shared__ unsigned char dsm[];
  unsigned char* sm = smem_1k(dsm);
  int* sSeg = reinterpret_cast<int*>(sm + L::ints);

  const int h = blockIdx.x, nh = gridDim.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kBlock, kvh = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const bf16* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const bf16* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  const int* segb = seg + (long long)b * S;

  load_tile<HD, kBlock>(sm, q + (long long)b * sq.b + (long long)h * sq.h, sq.t, q0, S);
  auto load_k = [&](int t) {  // key tile t and its seg into stage t % NST
    if (t > qt) return;
    load_tile<HD, kBlock>(sm + L::k_ring + (t % NST) * L::tile, kb, sk.t, t * kBlock, S);
    if (tid < kBlock) {
      const int j = t * kBlock + tid;
      cp_async4(sSeg + (t % NST) * kBlock + tid, segb + (j < S ? j : 0), j < S);
    }
  };
  auto load_v = [&](int t) {
    if (t <= qt) load_tile<HD, kBlock>(sm + L::v_ring + (t % NST) * L::tile, vb, sv.t, t * kBlock, S);
  };

  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8
  // row r0 + 8 i's segment (0 past S); read again where needed, not held
  auto row_seg = [&](int i) { return q0 + r0 + 8 * i < S ? segb[q0 + r0 + 8 * i] : 0; };
  const int seg0 = segb[q0];  // the query tile's segment, when it has one
  // the first key of that segment: the key tiles before its tile hold no key
  // of this query tile (a pad tile skips the whole prompt)
  int first = q0;
#pragma unroll 4
  for (int j = tid; j < q0; j += kWgThreads) first = segb[j] == seg0 ? min(first, j) : first;
  first = __reduce_min_sync(0xffffffffu, (unsigned)first);
  __shared__ int warp_first[kWgThreads / 32];
  if ((tid & 31) == 0) warp_first[warp] = first;
  const bool quni =
      __syncthreads_and(q0 + kBlock <= S && row_seg(0) == seg0 && row_seg(1) == seg0);
  const int t0 = quni ? min(min(warp_first[0], warp_first[1]),
                            min(warp_first[2], warp_first[3])) / kBlock
                      : 0;

  auto mask = [&](int t, float (&s)[32]) {
    const int* ks = sSeg + (t % NST) * kBlock;
    if (quni && warp_all_seg(ks, kBlock, seg0)) {  // one segment: causal only
      if (t < qt) return;                           // wholly below the diagonal
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((j >> 2) * 8 + c2 + (j & 1) > r0 + 8 * ((j >> 1) & 1)) s[j] = -INFINITY;
      return;
    }
    const int sg[2] = {row_seg(0), row_seg(1)};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = (j >> 1) & 1, col = (j >> 2) * 8 + c2 + (j & 1), ti = q0 + r0 + 8 * i;
      if (!(ti < S && t * kBlock + col <= ti && ks[col] == sg[i])) s[j] = -INFINITY;
    }
  };
  float acc[HD / 2], m[2], l[2];
  fwd_mainloop<HD, NST>(smem_u32(sm), t0, qt + 1, sl2, load_k, load_v, mask, acc, m, l);

  store_tile<HD>(sm, o + (long long)b * so.b + (long long)h * so.h, so.t, q0, S, r0, c2, acc, l);
  if ((tid & 3) == 0) {  // l is now the row's whole sum, > 0: the diagonal key is always in
    float* lb = lse + ((long long)b * nh + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (q0 + r0 + 8 * i < S) lb[q0 + r0 + 8 * i] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// The two backward kernels walk a sequence of steps; step i's streamed tiles sit in
// stage i % NST of a ring, copied NST - 1 steps ahead. Per step: wait for
// the step's tiles, start the two score products (S and dP), form P while
// dP runs, then start each register-A product as soon as its operand exists
// so that it runs under the next piece of work: dQ (dq) runs on into the
// next step's score products; dV (dkv) runs while dS is formed, and the
// step ends when dK is done (carrying dV and dK into the next step costs
// registers, and with them a block an SM). A step whose tile pair lies
// wholly below the diagonal, inside S and inside one segment (most of a
// right-padded batch) skips the per-element mask.

template <int HD>
struct DkvSmem {
  static constexpr int BQ = 32, NST = 3;  // query rows per step, ring stages
  static constexpr int kTile = kBlock * HD * 2, qTile = BQ * HD * 2;
  static constexpr int stage = 2 * qTile;             // Q, dO
  static constexpr int rows = 2 * kTile + NST * stage;  // lse, di, seg of each stage
  static constexpr int ldr = HD + 8;                  // fp32 row of the dK/dV sums
  static constexpr int loop = rows + NST * 3 * BQ * 4;
  static constexpr int sums = 2 * kBlock * ldr * 4;
  static constexpr size_t bytes = (loop > sums ? loop : sums) + 1024;
};

// dK, dV. Grid (nh / hpb, B, S / 64 key tiles), key tile 0 (the longest
// walk) launched first; clusters of `group / hpb` blocks along x hold one kv
// head. A block takes hpb query heads of that kv head and walks, for each,
// the query tiles of BQ = 32 rows from the diagonal down: that keeps dK, dV,
// the score tiles and the in-flight dV operand within 168 registers at hd
// 64, so 3 blocks share an SM (64-row steps did not fit, and ran slower at
// 2 blocks an SM), and without spills at hd 128. The cluster sums its
// blocks' dK and dV through distributed shared memory in rank order:
// deterministic, no atomics.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const int* __restrict__ seg, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ di, bf16* __restrict__ dk,
          bf16* __restrict__ dv, int S, int group, int hpb, Str sq, Str sk, Str sv, Str sdo,
          Str sdk, Str sdv) {
  using L = DkvSmem<HD>;
  constexpr int BQ = L::BQ, NST = L::NST;
  constexpr float scale = inv_sqrt_hd<HD>(), sl2 = scale * kLog2e;
  constexpr int RK = HD / 2, RS = BQ / 2, KD = HD / 16, KQ = BQ / 16;
  extern __shared__ unsigned char dsm[];
  unsigned char* sm = smem_1k(dsm);
  float* sRows = reinterpret_cast<float*>(sm + L::rows);
  cg::cluster_group cluster = cg::this_cluster();

  const int nh = gridDim.x * hpb, h0 = blockIdx.x * hpb, kvh = h0 / group;
  const int b = blockIdx.y, k0 = blockIdx.z * kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const int* segb = seg + (long long)b * S;
  const int nq = (S - k0 + BQ - 1) / BQ, items = hpb * nq;

  // item it = (query head h0 + it / nq, query tile it % nq) into stage it % NST
  auto load_item = [&](int it) {
    if (it >= items) return;
    const int h = h0 + it / nq, q0 = k0 + (it % nq) * BQ;
    unsigned char* sQ = sm + 2 * L::kTile + (it % NST) * L::stage;
    load_tile<HD, BQ>(sQ, q + (long long)b * sq.b + (long long)h * sq.h, sq.t, q0, S);
    load_tile<HD, BQ>(sQ + L::qTile, dout + (long long)b * sdo.b + (long long)h * sdo.h, sdo.t,
                      q0, S);
    const long long row = ((long long)b * nh + h) * S;
    float* r = sRows + (it % NST) * 3 * BQ;
    for (int i = tid; i < 3 * BQ; i += kWgThreads) {
      const int a = i / BQ, t = q0 + i % BQ, tt = t < S ? t : 0;
      const void* src = a == 0 ? (const void*)(lse + row + tt)
                        : a == 1 ? (const void*)(di + row + tt)
                                 : (const void*)(segb + tt);
      cp_async4(r + i, src, t < S);
    }
  };
  load_tile<HD, kBlock>(sm, k + (long long)b * sk.b + (long long)kvh * sk.h, sk.t, k0, S);
  load_tile<HD, kBlock>(sm + L::kTile, v + (long long)b * sv.b + (long long)kvh * sv.h, sv.t, k0,
                        S);
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {  // one commit group per item
    load_item(i);
    cp_async_commit();
  }

  const int r0 = warp * 16 + g, tj = k0 + r0;  // this thread's key rows: tj and tj + 8
  const int sg[2] = {tj < S ? segb[tj] : 0, tj + 8 < S ? segb[tj + 8] : 0};
  const int seg0 = segb[k0];  // the key tile's segment, when it has one
  const bool kuni = __syncthreads_and(k0 + kBlock <= S && sg[0] == seg0 && sg[1] == seg0);
  const uint32_t aK = smem_u32(sm), aV = aK + L::kTile;
  float accK[RK], accV[RK], st[RS], dpt[RS];
#pragma unroll
  for (int i = 0; i < RK; ++i) accK[i] = accV[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < RS; ++i) st[i] = dpt[i] = 0.0f;

  for (int it = 0; it < items; ++it) {
    cp_async_wait<NST - 2>();
    fence_async_shared();
    __syncthreads();  // item it landed; every warp is done with item it - 1
    load_item(it + NST - 1);  // into the stage item it - 1 left
    cp_async_commit();
    const int q0 = k0 + (it % nq) * BQ;
    const uint32_t aQ = aK + 2 * L::kTile + (it % NST) * L::stage, adO = aQ + L::qTile;
    const float* rl = sRows + (it % NST) * 3 * BQ;
    const float* rd = rl + BQ;
    const int* rs = reinterpret_cast<const int*>(rl + 2 * BQ);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_ss(st, desc_k<kBlock>(aK, kk), desc_k<BQ>(aQ, kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_ss(dpt, desc_k<kBlock>(aV, kk), desc_k<BQ>(adO, kk), kk);
    wg_commit();

    const bool fast = kuni && q0 >= k0 + kBlock && q0 + BQ <= S && warp_all_seg(rs, BQ, seg0);
    wg_wait<1>();
    reg_fence(st);
    if (fast) {  // P^T, while dP^T is still in flight
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int col = (j >> 2) * 8 + c2 + (j & 1);
        st[j] = ex2(fmaf(st[j], sl2, -rl[col] * kLog2e));
      }
    } else {
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int i = (j >> 1) & 1, col = (j >> 2) * 8 + c2 + (j & 1), qi = q0 + col;
        const bool ok = qi < S && tj + 8 * i <= qi && rs[col] == sg[i];
        st[j] = ok ? ex2(fmaf(st[j], sl2, -rl[col] * kLog2e)) : 0.0f;
      }
    }
    // dV += P^T dO, in flight while dS^T is formed
    uint32_t pa[KQ][4], da[KQ][4];
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) acc_to_a(pa[kk], st, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) wgmma_rs(accV, pa[kk], desc_mn<BQ>(adO, kk));
    wg_commit();
    wg_wait<1>();  // dP^T is done (dV may still run)
    reg_fence(dpt);
#pragma unroll
    for (int j = 0; j < RS; ++j) dpt[j] = st[j] * (dpt[j] - rd[(j >> 2) * 8 + c2 + (j & 1)]);

    // dK += dS^T Q (its 1/sqrt(hd) is applied at the end)
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) acc_to_a(da[kk], dpt, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) wgmma_rs(accK, da[kk], desc_mn<BQ>(aQ, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(accV);
    reg_fence(pa);
    reg_fence(accK);
    reg_fence(da);
  }
  __syncthreads();  // every warp's products are done before the sums overwrite the tiles

  // The cluster's sum: each block parks its fp32 dK, dV in its own shared
  // memory; block `rank` then adds rows of all blocks in rank order and
  // writes them in bf16.
  float* sums = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int j = 0; j < RK; j += 2) {
    const int row = r0 + 8 * ((j >> 1) & 1), col = (j >> 2) * 8 + c2;
    *reinterpret_cast<float2*>(sums + row * L::ldr + col) = make_float2(accK[j], accK[j + 1]);
    *reinterpret_cast<float2*>(sums + (kBlock + row) * L::ldr + col) =
        make_float2(accV[j], accV[j + 1]);
  }
  cluster.sync();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  constexpr int C4 = HD / 4, PER = kBlock * C4;
  bf16* dkb = dk + (long long)b * sdk.b + (long long)kvh * sdk.h;
  bf16* dvb = dv + (long long)b * sdv.b + (long long)kvh * sdv.h;
  for (int idx = rank * kWgThreads + tid; idx < 2 * PER; idx += C * kWgThreads) {
    const int which = idx / PER, row = (idx % PER) / C4, c = (idx % C4) * 4, t = k0 + row;
    const int off = (which * kBlock + row) * L::ldr + c;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < C; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sums, r) + off);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    if (t < S) {
      const float f = which ? 1.0f : scale;
      bf16* dst = which ? dvb + (long long)t * sdv.t + c : dkb + (long long)t * sdk.t + c;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(acc.x * f, acc.y * f), pack_bf16(acc.z * f, acc.w * f));
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its sums
}

template <int HD, int NST>
struct DqSmem {
  static constexpr int tile = kBlock * HD * 2;
  static constexpr int stage = 2 * tile;               // K, V
  static constexpr int segs = 2 * tile + NST * stage;  // Q, dO, then the ring
  static constexpr size_t bytes = segs + NST * kBlock * 4 + 1024;
};

// dQ. Grid (nh, B, S / 64 query tiles), the last query tile (the longest
// walk) launched first. A block holds its 64 query rows of Q and dO and walks
// the key tiles up to the diagonal, K and V (and the keys' seg) through the
// ring.
template <int HD, int NST>
__global__ void __launch_bounds__(kWgThreads)
dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const int* __restrict__ seg, const bf16* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ di, bf16* __restrict__ dq, int S, int group, Str sq, Str sk,
         Str sv, Str sdo, Str sdq) {
  using L = DqSmem<HD, NST>;
  constexpr float scale = inv_sqrt_hd<HD>(), sl2 = scale * kLog2e;
  constexpr int RQ = HD / 2, RS = kBlock / 2, KD = HD / 16, KK = kBlock / 16;
  extern __shared__ unsigned char dsm[];
  unsigned char* sm = smem_1k(dsm);
  int* sSeg = reinterpret_cast<int*>(sm + L::segs);

  const int h = blockIdx.x, nh = gridDim.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kBlock, kvh = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c2 = (tid & 3) * 2;
  const bf16* kb = k + (long long)b * sk.b + (long long)kvh * sk.h;
  const bf16* vb = v + (long long)b * sv.b + (long long)kvh * sv.h;
  const int* segb = seg + (long long)b * S;

  auto load_kv = [&](int kt) {  // key tile kt into stage kt % NST
    if (kt > qt) return;
    unsigned char* sK = sm + 2 * L::tile + (kt % NST) * L::stage;
    load_tile<HD, kBlock>(sK, kb, sk.t, kt * kBlock, S);
    load_tile<HD, kBlock>(sK + L::tile, vb, sv.t, kt * kBlock, S);
    if (tid < kBlock) {
      const int t = kt * kBlock + tid;
      cp_async4(sSeg + (kt % NST) * kBlock + tid, segb + (t < S ? t : 0), t < S);
    }
  };
  load_tile<HD, kBlock>(sm, q + (long long)b * sq.b + (long long)h * sq.h, sq.t, q0, S);
  load_tile<HD, kBlock>(sm + L::tile, dout + (long long)b * sdo.b + (long long)h * sdo.h, sdo.t,
                        q0, S);
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {  // one commit group per key tile
    load_kv(i);
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8
  const int tr[2] = {q0 + r0, q0 + r0 + 8};
  int sg[2];
  float l2[2], dr[2];
  const float* lb = lse + ((long long)b * nh + h) * S;
  const float* db = di + ((long long)b * nh + h) * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = tr[i] < S;
    sg[i] = in ? segb[tr[i]] : 0;
    l2[i] = in ? lb[tr[i]] * kLog2e : 0.0f;
    dr[i] = in ? db[tr[i]] : 0.0f;
  }
  const int seg0 = segb[q0];  // the query tile's segment, when it has one
  const bool quni = __syncthreads_and(q0 + kBlock <= S && sg[0] == seg0 && sg[1] == seg0);
  const uint32_t aQ = smem_u32(sm), adO = aQ + L::tile;
  float acc[RQ], s[RS], dp[RS];
  uint32_t da[KK][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < RS; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[i][e] = 0u;

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles up to the diagonal
    cp_async_wait<NST - 2>();
    fence_async_shared();
    __syncthreads();  // key tile kt has landed for every thread
    const int k0 = kt * kBlock;
    const uint32_t aK = aQ + 2 * L::tile + (kt % NST) * L::stage, aV = aK + L::tile;
    const int* ks = sSeg + (kt % NST) * kBlock;

    // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_ss(s, desc_k<kBlock>(aQ, kk), desc_k<kBlock>(aK, kk), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss(dp, desc_k<kBlock>(adO, kk), desc_k<kBlock>(aV, kk), kk);
    wg_commit();
    wg_wait<2>();  // the previous key tile's dQ product is done
    reg_fence(acc);
    reg_fence(da);
    __syncthreads();  // ... in every warp: its stage takes key tile kt + NST - 1
    load_kv(kt + NST - 1);
    cp_async_commit();

    const bool fast = quni && kt < qt && warp_all_seg(ks, kBlock, seg0);
    wg_wait<1>();
    reg_fence(s);
    if (fast) {  // P, while dP is still in flight
#pragma unroll
      for (int j = 0; j < RS; ++j) s[j] = ex2(fmaf(s[j], sl2, -l2[(j >> 1) & 1]));
    } else {
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int i = (j >> 1) & 1, col = (j >> 2) * 8 + c2 + (j & 1);
        const bool ok = tr[i] < S && k0 + col <= tr[i] && ks[col] == sg[i];
        s[j] = ok ? ex2(fmaf(s[j], sl2, -l2[i])) : 0.0f;
      }
    }
    wg_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int j = 0; j < RS; ++j) dp[j] = s[j] * (dp[j] - dr[(j >> 1) & 1]);  // dS

    // dQ += dS K (the 1/sqrt(hd) is applied at the end)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) acc_to_a(da[kk], dp, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs(acc, da[kk], desc_mn<kBlock>(aK, kk));
    wg_commit();
  }
  wg_wait<0>();
  reg_fence(acc);
  reg_fence(da);

  bf16* dqb = dq + (long long)b * sdq.b + (long long)h * sdq.h;
#pragma unroll
  for (int j = 0; j < RQ; j += 2) {
    const int t = tr[(j >> 1) & 1], c = (j >> 2) * 8 + c2;
    if (t < S)
      *reinterpret_cast<uint32_t*>(dqb + (long long)t * sdq.t + c) =
          pack_bf16(acc[j] * scale, acc[j + 1] * scale);
  }
}

// ----------------------------------------------------------- di pre-pass

// di[(b * nh + h) * S + t] = sum_d o[b, t, h, d] * dout[b, t, h, d] in fp32,
// the library's XLA reduction before its two backward kernels
// (flash_attention.py:273). A pure read: at the training shape it moves
// 33.5 MB of O and dO and writes 0.5 MB of di, 10.2 us at 3.35 TB/s, so the
// design is about the bytes in flight and the order they are read in:
//  * one block per (32 tokens, 8 heads, b); its rows are (token, head)
//    pairs with the head fastest, so where a token's heads are adjacent
//    (stride h == hd, as the projections give them) consecutive rows are
//    consecutive in memory;
//  * a row is read by a group of HD * sizeof(T) / 16 lanes (8 at hd 64 in
//    bf16, 16 at hd 128), each with 16-byte non-coherent loads (8 bf16 or 4
//    fp32 values); a lane group takes 4 rows at once, so every thread has 4
//    loads of each tensor in flight before it multiplies;
//  * each lane sums its products in fp32 in index order, then the lane
//    group adds by __shfl_xor_sync in a fixed order: di is bit-equal from
//    launch to launch;
//  * di is staged in shared memory as [head][token] and written as one
//    128-byte run of 32 tokens per head.
// 512 blocks at the training shape (B 8, S 512, nh 32), about 4 an SM, all
// resident at once.
constexpr int kPrepTokens = 32, kPrepHeads = 8, kPrepRows = 4;
constexpr int kPrepThreads = kPrepTokens * kPrepHeads;  // one thread per di of the tile

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// sum of the products of two 16-byte vectors of T, in fp32, in index order
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 2) {  // two bf16 a word, the lower first
      acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
      acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
    } else {
      acc = fmaf(__uint_as_float(x[i]), __uint_as_float(y[i]), acc);
    }
  }
  return acc;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ di, int S,
         int nh, Str so, Str sdo) {
  constexpr int VEC = 16 / sizeof(T);   // values a 16-byte load
  constexpr int LG = HD / VEC;          // lanes a row
  constexpr int NG = kPrepThreads / LG; // lane groups a block
  constexpr int ROWS = kPrepTokens * kPrepHeads;
  static_assert(32 % LG == 0 && ROWS % (NG * kPrepRows) == 0, "whole rows, whole passes");
  __shared__ float s_di[kPrepHeads][kPrepTokens + 1];

  const int j = threadIdx.x % LG, g = threadIdx.x / LG;
  const int h0 = blockIdx.x * kPrepHeads, t0 = blockIdx.y * kPrepTokens;
  const T* ob = o + (long long)blockIdx.z * so.b + j * VEC;
  const T* db = dout + (long long)blockIdx.z * sdo.b + j * VEC;
#pragma unroll
  for (int r0 = 0; r0 < ROWS; r0 += NG * kPrepRows) {
    uint4 va[kPrepRows], vb[kPrepRows];
#pragma unroll
    for (int i = 0; i < kPrepRows; ++i) {
      const int r = r0 + g + NG * i;
      const int t = t0 + r / kPrepHeads, h = h0 + r % kPrepHeads;
      va[i] = vb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (t < S && h < nh) {
        va[i] = ldg16(ob + (long long)t * so.t + (long long)h * so.h);
        vb[i] = ldg16(db + (long long)t * sdo.t + (long long)h * sdo.h);
      }
    }
#pragma unroll
    for (int i = 0; i < kPrepRows; ++i) {
      float acc = dot16<T>(va[i], vb[i]);
#pragma unroll
      for (int off = LG / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int r = r0 + g + NG * i;
      if (j == 0) s_di[r % kPrepHeads][r / kPrepHeads] = acc;
    }
  }
  __syncthreads();
  const int hl = threadIdx.x / kPrepTokens, tl = threadIdx.x % kPrepTokens;
  if (h0 + hl < nh && t0 + tl < S)
    di[((long long)blockIdx.z * nh + h0 + hl) * S + t0 + tl] = s_di[hl][tl];
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
  const int tiles = (S + kBlock - 1) / kBlock;
  cudaError_t err;
  if (bf) {
    // rings of 3 at hd 64; 2 at hd 128, where 3 would leave one block an SM
    constexpr int NST = HD == 128 ? 2 : 3;
    constexpr size_t smem = FwdSmem<HD, NST>::bytes;
    if ((err = prepare(causal_fwd_wgmma<HD, NST>, smem)) != cudaSuccess) return err;
    causal_fwd_wgmma<HD, NST><<<dim3(nh, B, tiles), kWgThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, seg, (bf16*)o, lse, S, group, str(s, 0),
        str(s, 1), str(s, 2), str(s, 3));
  } else {
    constexpr size_t smem = fwd_fma_smem<HD>();
    if ((err = prepare(fwd_fma<HD>, smem)) != cudaSuccess) return err;
    fwd_fma<HD><<<dim3(tiles, nh, B), kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (float*)o, lse, S, group,
        1.0f / sqrtf((float)HD), str(s, 0), str(s, 1), str(s, 2), str(s, 3));
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dq_hd(bool bf, const void* q, const void* k, const void* v, const int* seg,
                  const void* dout, const float* lse, const float* di, void* dq, int B, int S,
                  int nh, int group, const int* s, cudaStream_t st) {
  const int tiles = (S + kBlock - 1) / kBlock;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t err;
  if (bf) {
    // a ring of 3 at hd 64; 2 at hd 128, where 3 would leave one block an SM
    constexpr int NST = HD == 128 ? 2 : 3;
    constexpr size_t smem = DqSmem<HD, NST>::bytes;
    if ((err = prepare(dq_wgmma<HD, NST>, smem)) != cudaSuccess) return err;
    dq_wgmma<HD, NST><<<dim3(nh, B, tiles), kWgThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, seg, (const bf16*)dout, lse, di,
        (bf16*)dq, S, group, str(s, 0), str(s, 1), str(s, 2), str(s, 3), str(s, 4));
  } else {
    constexpr size_t smem = dq_fma_smem<HD>();
    if ((err = prepare(dq_fma<HD>, smem)) != cudaSuccess) return err;
    dq_fma<HD><<<dim3(tiles, nh, B), kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (const float*)dout, lse, di,
        (float*)dq, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3), str(s, 4));
  }
  return cudaGetLastError();
}

// cluster: blocks per thread-block cluster of the bf16 kernel, a divisor of
// the group of at most 8 (the host's plan, ops/flash_attention_causal.py).
template <int HD>
cudaError_t dkv_hd(bool bf, const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* di, void* dk, void* dv,
                   int B, int S, int nkv, int group, int cluster, const int* s, cudaStream_t st) {
  const int tiles = (S + kBlock - 1) / kBlock;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t err;
  if (bf) {
    if (cluster < 1 || cluster > 8 || group % cluster) return cudaErrorInvalidValue;
    constexpr size_t smem = DkvSmem<HD>::bytes;
    if ((err = prepare(dkv_wgmma<HD>, smem)) != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nkv * cluster, B, tiles);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, dkv_wgmma<HD>, (const bf16*)q, (const bf16*)k,
                                  (const bf16*)v, seg, (const bf16*)dout, lse, di, (bf16*)dk,
                                  (bf16*)dv, S, group, group / cluster, str(s, 0),
                                  str(s, 1), str(s, 2), str(s, 3), str(s, 4), str(s, 5))) !=
        cudaSuccess)
      return err;
  } else {
    constexpr size_t smem = dkv_fma_smem<HD>();
    if ((err = prepare(dkv_fma<HD>, smem)) != cudaSuccess) return err;
    dkv_fma<HD><<<dim3(tiles, nkv, B), kFmaThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, seg, (const float*)dout, lse, di,
        (float*)dk, (float*)dv, S, group, scale, str(s, 0), str(s, 1), str(s, 2), str(s, 3),
        str(s, 4), str(s, 5));
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t prep_hd(bool bf, const void* o, const void* dout, float* di, int B, int S, int nh,
                    const int* s, cudaStream_t st) {
  const dim3 grid((nh + kPrepHeads - 1) / kPrepHeads, (S + kPrepTokens - 1) / kPrepTokens, B);
  if (bf)
    bwd_prep<bf16, HD><<<grid, kPrepThreads, 0, st>>>((const bf16*)o, (const bf16*)dout, di, S,
                                                      nh, str(s, 0), str(s, 1));
  else
    bwd_prep<float, HD><<<grid, kPrepThreads, 0, st>>>((const float*)o, (const float*)dout, di,
                                                       S, nh, str(s, 0), str(s, 1));
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
// the device. Every row starts on a 16-byte boundary. Each launches
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
// strides: q, k, v, dout, dk, dv; dk and dv rows start on 8-byte boundaries.
// cluster: blocks per cluster of the bf16 kernel (a divisor of nh / nkv, at
// most 8; each block takes nh / nkv / cluster query heads); fp32 ignores it.
extern "C" int mt_flash_attention_causal_bwd_dkv(const void* q, const void* k, const void* v,
                                                 const int* seg, const void* dout,
                                                 const float* lse, const float* di, void* dk,
                                                 void* dv, int B, int S, int nh, int nkv, int hd,
                                                 int cluster, int is_bf16, int device,
                                                 const int* strides, void* stream) {
  if (!shapes_ok(B, S, nh, nkv)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)dkv_hd<64>(is_bf16, q, k, v, seg, dout, lse, di, dk, dv, B, S, nkv, nh / nkv,
                             cluster, strides, st);
    case 128:
      return (int)dkv_hd<128>(is_bf16, q, k, v, seg, dout, lse, di, dk, dv, B, S, nkv, nh / nkv,
                              cluster, strides, st);
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
