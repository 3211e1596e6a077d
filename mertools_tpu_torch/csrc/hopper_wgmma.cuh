// Hopper building blocks shared by the bf16 attention kernels (sm_90a):
// asynchronous copies, the 128-byte swizzle and wgmma's shared-memory
// descriptors, wgmma itself (operands from shared memory or registers), and
// the forward main loop that flash_attention_fwd.cu (B1) and
// flash_attention_causal.cu (B3) both run. Every name sits in an anonymous
// namespace, so each source that includes this file gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Two floats -> bf16x2, the lower column in the low half (fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// This thread's landed copies become visible to wgmma's (async-proxy) reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties registers to this point: no read of an accumulator moves above the
// wait that completes it, and no register an in-flight wgmma reads is reused.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, warp w =
// t / 32, lane = 4 g + c: d[4 n + e] is row 16 w + g + 8 (e >> 1), column
// 8 n + 2 c + (e & 1). The A fragment from registers has mma.m16n8k16's
// layout on each warp's 16 rows, so columns 16 kk .. 16 kk + 15 of an
// accumulator are the A fragment of k-step kk of the next product.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d = A (64x16, K-major in shared) * B (16x32, K-major in shared), plus d if acc
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d = A (64x16, K-major in shared) * B (16x64, K-major in shared), plus d if acc
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d += A (64x16, bf16 fragments in registers) * B (16x64, MN-major in shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A (64x16, bf16 fragments in registers) * B (16x128, MN-major in shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Shared-memory matrix descriptor of wgmma, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// k-step kk (columns 16 kk .. 16 kk + 15) of a swizzled tile of ROWS rows,
// read K-major: 8-row groups 1024 bytes apart, 32 bytes per k-step inside
// the 128-byte swizzled row (the hardware applies the XOR to the address).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}
// k-step kk (rows 16 kk .. 16 kk + 15) of the same tile read MN-major: the
// 64-column panels ROWS * 128 bytes apart, 8-row groups 1024 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 2048, ROWS * 128, 1024);
}

// Byte offset of 16-byte chunk c (columns 8 c .. 8 c + 7) of row r.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c ^ r) & 7) << 4);
}

// Rows t0 .. t0 + ROWS - 1 of one head into a swizzled tile by cp.async,
// zeros past S; the caller commits.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src, int ts, int t0,
                                          int S) {
  constexpr int CH = HD / 8;
  static_assert(ROWS * CH % kWgThreads == 0, "whole passes of the warpgroup");
#pragma unroll
  for (int i = 0; i < ROWS * CH / kWgThreads; ++i) {
    const int idx = i * kWgThreads + threadIdx.x, r = idx / CH, c = idx % CH, t = t0 + r;
    const bool ok = t < S;
    cp_async16(dst + swz<ROWS>(r, c), src + (long long)(ok ? t : 0) * ts + c * 8, ok);
  }
}

// The block's dynamic shared memory from a 1024-byte boundary (the swizzle
// repeats every 8 rows of 128 bytes); every block of a cluster gets the
// same offsets.
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}


// 2^x by the special function unit (2 ulp, denormal results flushed to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Every thread of the warp sees segment id v in all n entries of seg.
__device__ __forceinline__ bool warp_all_seg(const int* seg, int n, int v) {
  bool same = true;
  for (int c = threadIdx.x & 31; c < n; c += 32) same &= seg[c] == v;
  return __all_sync(0xffffffffu, same);
}

// ------------------------------------------------------ the forward main loop
//
// Shared memory of the forward kernels, from a 1024-byte boundary: the 64
// query rows of Q, a ring of NST K tiles, a ring of NST V tiles (64 keys
// each, swizzled), then NST * 64 ints the caller may use (B3: the keys'
// segment ids, one slot per K stage).
template <int HD, int NST>
struct FwdSmem {
  static constexpr int tile = 64 * HD * 2;
  static constexpr int k_ring = tile, v_ring = tile + NST * tile, ints = tile + 2 * NST * tile;
  static constexpr size_t bytes = ints + NST * 64 * 4 + 1024;
};

// One step of the online softmax, in base 2. s holds the raw scores of this
// thread's rows r0 and r0 + 8 (the accumulator layout above: s[j] is in row
// r0 + 8 ((j >> 1) & 1)), -inf where the mask is out; sl2 is the softmax
// scale times log2(e). m is the running max of sl2 * score, l this thread's
// share of the running sum. s becomes P = 2^(sl2 * s - m) and corr the
// factor that rescales the output rows.
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float sl2, float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the 4 lanes that share a row are neighbours
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float nm = fmaxf(m[i], mx[i] * sl2);
    mu[i] = nm == -INFINITY ? 0.0f : nm;  // no key for this row yet: no -inf - -inf
    corr[i] = ex2(m[i] - mu[i]);
    m[i] = nm;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = (j >> 1) & 1;
    s[j] = ex2(fmaf(s[j], sl2, -mu[i]));
    l[i] += s[j];
  }
}

// One warpgroup's 64 query rows (Q already being copied to the start of
// FwdSmem at aQ, uncommitted) against key tiles t0 .. t1 - 1 (t1 > t0) of 64
// keys: o = sum_t P(t) V(t), unnormalised, with m and l as softmax_step
// leaves them. K(t) and V(t) sit in stage t % NST of their rings, each tile
// one cp.async commit group, committed in the order K(t0), V(t0), K(t0 + 1),
// ...; the caller's load_k(t) / load_v(t) copy tile t (nothing from t1 on)
// and mask(t, s) sets the scores of tile t that are out to -inf.
// Step t: once K(t) and V(t - 1) have landed, refill the K stage that S(t - 1)
// read; start S(t) = Q K(t)^T (both K-major) and then O += P(t - 1) V(t - 1)
// (P from registers, V read MN-major from the same swizzled copy); mask and
// exponentiate S(t) while that product runs; rescale O once it is done;
// then refill the V stage it read. So the copies run NST - 1 steps ahead and
// the softmax overlaps the tensor cores.
template <int HD, int NST, class LoadK, class LoadV, class Mask>
__device__ __forceinline__ void fwd_mainloop(uint32_t aQ, int t0, int t1, float sl2, LoadK load_k,
                                             LoadV load_v, Mask mask, float (&o)[HD / 2],
                                             float (&m)[2], float (&l)[2]) {
  using L = FwdSmem<HD, NST>;
  constexpr int KD = HD / 16, KP = 64 / 16;
  static_assert(NST >= 2, "a ring of two stages or more");
  const uint32_t aK = aQ + L::k_ring, aV = aQ + L::v_ring;
  float s[32], corr[2];
  uint32_t pa[KP][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int t = t0; t < t0 + NST - 1; ++t) {
    load_k(t);
    cp_async_commit();
    load_v(t);
    cp_async_commit();
  }
  auto start = [&](int t) {
    cp_async_wait<2 * NST - 3>();
    fence_async_shared();
    __syncthreads();  // K(t), V(t - 1) landed; every warp is done with S(t - 1)
    load_k(t + NST - 1);
    cp_async_commit();
    const uint32_t ks = aK + (t % NST) * L::tile;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_ss(s, desc_k<64>(aQ, kk), desc_k<64>(ks, kk), kk);
    wg_commit();
  };
  auto pv = [&](int t) {
    const uint32_t vs = aV + (t % NST) * L::tile;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) wgmma_rs(o, pa[kk], desc_mn<64>(vs, kk));
    wg_commit();
  };
  auto refill_v = [&](int t) {
    __syncthreads();  // every warp is done with P V(t - 1)
    load_v(t + NST - 1);
    cp_async_commit();
  };

  start(t0);
  wg_wait<0>();
  reg_fence(s);
  mask(t0, s);
  softmax_step(s, m, l, sl2, corr);
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) acc_to_a(pa[kk], s, kk);
  refill_v(t0);
  for (int t = t0 + 1; t < t1; ++t) {
    start(t);
    pv(t - 1);
    wg_wait<1>();  // S(t) is done; P V(t - 1) runs on
    reg_fence(s);
    mask(t, s);
    softmax_step(s, m, l, sl2, corr);
    wg_wait<0>();
    reg_fence(o);
    reg_fence(pa);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) acc_to_a(pa[kk], s, kk);
    refill_v(t);
  }
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();  // V(t1 - 1) has landed
  wg_fence();
  pv(t1 - 1);
  wg_wait<0>();
  reg_fence(o);
  reg_fence(pa);
}

// The epilogue: the rows' sums l over their 4 lanes, then o / l in bf16
// through the swizzled Q tile at sm (free once the main loop is done) into
// rows q0 .. q0 + 63 of out (those below `rows`; row stride ts) as 16-byte
// stores, neighbouring threads on neighbouring bytes. r0 is the thread's
// first row (16 warp + lane / 4), c2 = 2 (lane % 4).
template <int HD>
__device__ __forceinline__ void store_tile(unsigned char* sm, bf16* out, long long ts, int q0,
                                           int rows, int r0, int c2, const float (&o)[HD / 2],
                                           float (&l)[2]) {
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  __syncthreads();  // every warp is done with Q
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int i = (j >> 1) & 1;
    *reinterpret_cast<uint32_t*>(sm + swz<64>(r0 + 8 * i, j >> 2) + c2 * 2) =
        pack_bf16(o[j] * inv[i], o[j + 1] * inv[i]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 64 * CH / kWgThreads; ++i) {
    const int idx = i * kWgThreads + threadIdx.x, r = idx / CH, c = idx % CH;
    if (q0 + r < rows)
      *reinterpret_cast<uint4*>(out + (q0 + r) * ts + c * 8) =
          *reinterpret_cast<const uint4*>(sm + swz<64>(r, c));
  }
}

}  // namespace
