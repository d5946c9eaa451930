// llt_panel: the fused LLT panel step of an (m, b) f32 slab in one launch,
// the slab's rows spread over the card's SMs; b a multiple of 32 up to 512,
// any m >= b.
//
// Replaces: faer_tpu/ops/pallas/llt_panel_v5.py `llt_panel_v5_pallas` (:176,
// body `_llt_panel_v5_kernel` :97). Contract: out[:b] = L11 (lower, zeros
// above), out[b:] = L21 = A21 * L11^-T, plus the dynamic-regularization count
// and the success flag, with (eps, delta) applied per pivot exactly as at
// llt_panel_v5.py:123-129: ok &= pivot > 0 before any replacement; with
// eps > 0 a pivot <= delta becomes eps and is counted, else a pivot <= 0
// becomes 1. Only the lower triangle of slab[:b] is read; the slab may have
// any row stride lda >= b, with unit column stride.
//
// What bounds it on the H100: the (m - b) b^2 + b^3 / 3 FP32 operations
// (257 M at (4096, 256): 3.8 us at the card's 67 TFLOP/s, 0.5 ms on one
// SM) and the bytes (8 MiB: 2.5 us) are far below the chain of b dependent
// pivots (each a reciprocal square root and a rank-1 update that the next
// pivot reads) and of b / 32 hand-overs of a factored 32 x 32 diagonal tile from the SM
// that factors it to every other. The TPU kernel keeps the slab in VMEM and
// forms L21 as one product against an explicit inverse of L11 (its matrix
// unit wants a product); here the slab does not fit one SM, and L21 comes
// from substitution, so there is no inverse.
//
// Design. CTA q owns rows [q rpc, (q + 1) rpc), rpc a multiple of 32, so
// that each 32-row diagonal tile T_t lies in one CTA. The panel is walked
// in 32-column sub-blocks, left-looking: at step k every row r >= 32 (k + 1)
// forms its column block k,
//   x = A[r, K] - L[r, :32k] L[T_k, :32k]^T (an FFMA chain over c' = 0, 1,
//       ..., from A), then x L_kk^T = x by substitution (x_j scaled by
//       1/sqrt(pivot j), then subtracted from the later x_c in order),
// from its own earlier columns and the published row block k, B_k =
// L[T_k, :32(k + 1)] (the tile's rows, L_kk included). B_k is all a CTA
// needs from the others: one exchange a sub-block, b / 32 in all. The tile's
// owner publishes B_k column-major into a (b, b) scratch `pub` (L11^T, so
// that every reader copies it with coalesced 16-byte loads), with the 32
// reciprocal pivots, then raises flag k (__threadfence + st.release.gpu);
// a reader's thread 0 spins on it (ld.acquire.gpu) and the CTA copies B_k
// into shared memory with __ldcg. Nothing published is ever rewritten, so
// no CTA waits for another's progress, only for the flag it reads: the
// exchange is a flag, not a barrier. One grid barrier at the start makes
// the zeroed flags visible (the scratch is the caller's, uninitialised).
// The chain from one flag to the next runs through the owner of the next
// tile, so that owner does at step k only what needs B_k (lookahead): the
// last 32 terms of its tile's rows' chain for block k and their
// substitution (by warp 0, a row a lane, in registers), the last 32 of the
// tile's own products, and the factor:
// warp 0 factors the tile in registers (lane i holds row i; the pivot of
// row j + 1 shuffled out first, column j broadcast through 32 floats of
// shared memory; no block barrier inside the 32 pivots) and raises flag
// k + 1 while warps 1..7 form the owner's other rows. The rest it forms
// ahead, in the same order of rounding: the tile's products S_t = A_tt -
// sum L[T_t, K] L[T_t, K]^T take each column block as soon as its rows have
// it, in place of A_tt; and the chain of block t - 1 of its rows up to
// column 32 (t - 2) is formed at step t - 2 from tile t - 1's rows, whose
// owner raises an early flag once their blocks up to t - 3 are published.
// Each row's block is formed by 8 threads, 4 columns each: the FMA chain
// reads the row 16 bytes at a time and B_k from shared memory as float4
// broadcasts, and the substitution shuffles each x_j within the 8 threads.
//
// Routes, decided in plan_of from (m, b) and the card alone
// (faer_llt_panel_route tells callers which; nothing retries on another):
// a cooperative grid of at most one CTA an SM with the CTA's rows in shared
// memory (rows of b + 4 floats) where they fit, else as many CTAs as the
// card holds co-resident (at most kGlobalPerSm an SM) with the rows in
// place in the output (L1/L2-resident). Every row's arithmetic is the same
// on both routes and whichever CTA holds it (explicit __fmaf_rn, __fmul_rn
// and the correctly rounded __frsqrt_rn), so the routes, any split of the
// rows and any prefix of the slab agree to the bit; llt_panel_blocked_plain
// (ops/kernels/llt_panel.py) repeats that order. No m >= b is refused: a
// CTA loops over as many rows as it holds. FP32 FFMA only; no TF32.
//
// Built with -DFAER_LLT_PANEL_PROFILE (`tools/torch_profile.py llt_panel`
// does, into a library of its own), thread 0 of each CTA adds its SM cycles
// by phase into g_prof, read by faer_llt_panel_profile_read, and
// faer_llt_panel_profile_force_global sends every shape to the rows in
// global memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifdef FAER_LLT_PANEL_PROFILE
// 0 init (A's rows staged, flags zeroed, grid barrier, tile 0), 1 flag
// waits, 2 copies of the published row blocks, 3-4 lookahead (the next
// tile's rows' column block, then its last products into sT), 5 factor, 6
// publication, 7 the other rows, 8 ahead (the later tiles' updates, the
// next lookahead's chain), 9 out; inside every row block, 10 the FMA chains
// and 11 the substitutions: thread 0's cycles, summed over CTAs and
// launches
constexpr int kProf = 12;
__device__ long long g_prof[kProf];
__shared__ long long s_prof[kProf];
static int g_force_global = 0;
#define PROF_START \
  if (threadIdx.x < kProf) s_prof[threadIdx.x] = 0; \
  long long t_prof = clock64();
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long u = clock64(); s_prof[k] += u - t_prof; t_prof = u; }
#define PROF_SPAN_START long long s_span = clock64();
#define PROF_SPAN(k) \
  if (threadIdx.x == 0) { const long long u = clock64(); s_prof[k] += u - s_span; s_span = u; }
#define PROF_END \
  if (threadIdx.x == 0) \
    for (int k = 0; k < kProf; ++k) \
      atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)s_prof[k]);
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_SPAN_START
#define PROF_SPAN(k)
#define PROF_END
#endif

namespace {

constexpr int SB = 32;                  // sub-block and tile width
constexpr int kThreads = 256;
constexpr int kGroup = 8;               // threads a row, 4 columns each
constexpr int kMaxB = 512;
constexpr int kRowPad = 4;              // shared rows b + 4 floats apart: conflict-free float4 reads
constexpr int kGlobalPerSm = 2;         // CTAs an SM on the route with the rows in global memory
constexpr int kCopyBatch = 8;           // 16-byte loads a thread has in flight in copy_block
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// faer_llt_panel_route's codes
enum Route { kRefused = -1, kGlobalRows = 0, kSharedRows = 1 };

struct Args {
  const float* slab;
  long long lda;
  float* out;    // (m, b); on the global route also every CTA's rows
  float* pub;    // (b, b): pub[c * b + r] = L[r][c], r < b, as each is final
  float* rs;     // (b,): 1 / sqrt(pivot j)
  int* flags;    // (b / 32,): row block k published
  int* early;    // (b / 32,): tile k's rows' column blocks up to k - 2 published
  int* tally;    // (2 b / 32,): each tile's count and ok
  int* cnt_ok;   // (2,)
  int m, b, rpc;
  float eps, delta;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst[c' * 32 + c] = pub[c' * b + col + c] for c' < n: a published row
// block into shared memory, 16 bytes a load, kCopyBatch loads of each
// thread in flight before its stores (an L2 round trip each otherwise).
__device__ __forceinline__ void copy_block(float* dst, const float* pub, int b, int col, int n) {
  const int n4 = n * (SB / 4);
  for (int v0 = threadIdx.x; v0 < n4; v0 += kCopyBatch * kThreads) {
    float4 t[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int v = v0 + u * kThreads;
      if (v < n4)
        t[u] = __ldcg(reinterpret_cast<const float4*>(pub + (size_t)(v >> 3) * b + col +
                                                      (v & 7) * 4));
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int v = v0 + u * kThreads;
      if (v < n4) *reinterpret_cast<float4*>(dst + (v >> 3) * SB + (v & 7) * 4) = t[u];
    }
  }
}

// Column block kb of the CTA's local rows [l0, l1) by threads [t0, t0 + nth)
// of the CTA (nth a multiple of 32; 8 threads a row, 4 columns each): the
// FMA chain over c' in [c_begin, c_end) from x, which is A's entries (in
// the rows when staged there, as a diagonal row's always are, else in the
// slab) or, from c_begin > 0, the chain left in the rows; against B in sB
// (sB[c' * 32 + c] = L[32kb + c][c']). With kSolve (c_end = 32kb) then the
// substitution against L_kb,kb (sB's rows [32kb, 32kb + 32)), the results
// to the rows and, for rows < b, to pub; else the chain back to the rows.
template <bool kSolve, bool kStaged>
__device__ __forceinline__ void row_block(const Args& a, float* rows, int ldr, const float* sB,
                                          const float* sRs, int kb, int c_begin, int c_end,
                                          int l0, int l1, int t0, int nth, int r0) {
  const int me = threadIdx.x - t0, q = me & (kGroup - 1), nslot = nth / kGroup;
  const int b = a.b, col = kb * SB, c0 = 4 * q;
  for (int base = l0; base < l1; base += nslot) {  // uniform across the threads
    const int i = base + me / kGroup, r = r0 + i;
    const bool live = i < l1;
    PROF_SPAN_START
    const float* lr = rows + (size_t)(live ? i : l0) * ldr;
    float x[4];
    if (kStaged || r < b) {
      const float4 a4 = ld4(lr + col + c0);
      x[0] = a4.x, x[1] = a4.y, x[2] = a4.z, x[3] = a4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = live ? a.slab[(size_t)r * a.lda + col + c0 + e] : 0.0f;
    }
#pragma unroll 2
    for (int c = c_begin; c < c_end; c += 4) {
      const float4 l4 = ld4(lr + c);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b4 = ld4(sB + (c + u) * SB + c0);
        x[0] = __fmaf_rn(-lv[u], b4.x, x[0]);
        x[1] = __fmaf_rn(-lv[u], b4.y, x[1]);
        x[2] = __fmaf_rn(-lv[u], b4.z, x[2]);
        x[3] = __fmaf_rn(-lv[u], b4.w, x[3]);
      }
    }
    PROF_SPAN(10)
    if constexpr (kSolve) {
      // x L_kk^T = x: column j scaled by 1/sqrt(pivot j), shuffled from its
      // owner to the row's 8 threads, subtracted from the later columns
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        float v = x[j & 3];
        if (q == (j >> 2)) {
          v = __fmul_rn(v, sRs[j]);
          x[j & 3] = v;
        }
        const float xj = __shfl_sync(kFull, v, j >> 2, kGroup);
        if (j + 1 < SB) {
          const float4 l4 = ld4(sB + (col + j) * SB + c0);  // L_kk[c0 + e][j]
          const float lc[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + e > j) x[e] = __fmaf_rn(-xj, lc[e], x[e]);
        }
      }
    }
    if (live) {
      *reinterpret_cast<float4*>(rows + (size_t)i * ldr + col + c0) =
          make_float4(x[0], x[1], x[2], x[3]);
      if (kSolve && r < b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a.pub[(size_t)(col + c0 + e) * b + r] = x[e];
      }
    }
    PROF_SPAN(11)
  }
}

// Warp 0: the substitution of one 32-row group, the CTA's local rows
// [lt, lt + 32), whose chains for column block kb are in the rows: lane i
// holds row i's 32 entries in registers, L_kb,kb comes from sB as float4
// broadcasts, and no shuffle stands in the chain (the same operations in
// the same order as row_block's substitution). Results to the rows and pub.
__device__ __forceinline__ void solve_tile_rows(const Args& a, float* rows, int ldr,
                                                const float* sB, const float* sRs, int kb,
                                                int lt, int r0) {
  const int i = threadIdx.x & 31, col = kb * SB, r = r0 + lt + i;
  float* row = rows + (size_t)(lt + i) * ldr + col;
  float y[SB];
#pragma unroll
  for (int c4 = 0; c4 < SB / 4; ++c4) {
    const float4 v = ld4(row + 4 * c4);
    y[4 * c4] = v.x, y[4 * c4 + 1] = v.y, y[4 * c4 + 2] = v.z, y[4 * c4 + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    y[j] = __fmul_rn(y[j], sRs[j]);
#pragma unroll
    for (int c4 = (j + 1) / 4; c4 < SB / 4; ++c4) {
      const float4 v = ld4(sB + (col + j) * SB + 4 * c4);  // L_kk[4 c4 + u][j]
      const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c4 + u > j) y[4 * c4 + u] = __fmaf_rn(-y[j], lc[u], y[4 * c4 + u]);
    }
  }
#pragma unroll
  for (int c4 = 0; c4 < SB / 4; ++c4)
    *reinterpret_cast<float4*>(row + 4 * c4) =
        make_float4(y[4 * c4], y[4 * c4 + 1], y[4 * c4 + 2], y[4 * c4 + 3]);
#pragma unroll
  for (int c = 0; c < SB; ++c) a.pub[(size_t)(col + c) * a.b + r] = y[c];  // coalesced
}

// The diagonal tile t whose rows are the CTA's local rows [lt, lt + 32):
// S_t -= L[T_t, K] L[T_t, K]^T over column block kb of those rows, one FMA
// a product in column order. S_t is kept in place in the rows' columns
// [32t, 32t + 32) (lower entries), so that each column block is applied as
// soon as it is formed and the lookahead applies only the last; with kToT
// the result goes to sT for the factor instead. The block is first
// transposed into sB2 (sB2[j * 32 + c] = L[lt + c][32kb + j]). The caller
// synchronises after.
template <bool kToT>
__device__ __forceinline__ void tile_update(float* rows, int ldr, float* sB2,
                                            float (*sT)[SB + 1], int lt, int t, int kb) {
  const int tid = threadIdx.x;
  for (int v = tid; v < SB * SB; v += kThreads) {
    const int c = v & (SB - 1), j = v >> 5;
    sB2[j * SB + c] = rows[(size_t)(lt + c) * ldr + kb * SB + j];
  }
  __syncthreads();
  const int i = tid >> 3, c0 = 4 * (tid & 7);
  float* si = rows + (size_t)(lt + i) * ldr + t * SB;
  const float* li = rows + (size_t)(lt + i) * ldr + kb * SB;
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = si[c0 + e];
#pragma unroll
  for (int j = 0; j < SB; j += 4) {
    const float4 l4 = ld4(li + j);
    const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b4 = ld4(sB2 + (j + u) * SB + c0);
      x[0] = __fmaf_rn(-lv[u], b4.x, x[0]);
      x[1] = __fmaf_rn(-lv[u], b4.y, x[1]);
      x[2] = __fmaf_rn(-lv[u], b4.z, x[2]);
      x[3] = __fmaf_rn(-lv[u], b4.w, x[3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (kToT) sT[i][c0 + e] = x[e];
    else if (c0 + e <= i) si[c0 + e] = x[e];
  }
}

// Warp 0: the diagonal tile in sT (lower entries), factored in registers,
// lane i holding row i of L in x, 1/sqrt(pivot i) in my_rs; the tile's
// count and ok tallied alike in every lane. The lane's own diagonal entry
// is kept apart so that the pivot chain runs through registers and
// shuffles, beside the column broadcast through cb.
__device__ __forceinline__ void factor_tile(const Args& a, float (*sT)[SB + 1],
                                            float (*cb)[SB], float (&x)[SB], float& my_rs,
                                            int& cnt, int& ok) {
  const int i = threadIdx.x & 31;
  const bool use_eps = a.eps > 0.0f;
#pragma unroll
  for (int c = 0; c < SB; ++c) x[c] = c <= i ? sT[i][c] : 0.0f;
  float dg = sT[i][i];
  cnt = 0;
  ok = 1;
  // a pivot's rule (llt_panel_v5.py:123-129) and its 1/sqrt, rounded once
  auto pivot = [&](float& p, float& r) {
    const bool needs = p <= a.delta;
    ok &= p > 0.0f;
    cnt += use_eps && needs;
    if (use_eps ? needs : p <= 0.0f) p = use_eps ? a.eps : 1.0f;  // 1: keep finite
    r = __frsqrt_rn(p);
  };
  float pj = __shfl_sync(kFull, dg, 0), rj;
  pivot(pj, rj);
#pragma unroll
  for (int j = 0; j < SB; ++j) {
    if (i == j) {
      x[j] = __fmul_rn(pj, rj);
      my_rs = rj;
    } else {
      x[j] = __fmul_rn(x[j], rj);
    }
    dg = __fmaf_rn(-x[j], x[j], dg);  // the same FMA as x[i] gets below
    float pn = 0.0f, rn = 0.0f;
    if (j + 1 < SB) pn = __shfl_sync(kFull, dg, j + 1);
    float* col = cb[j & 1];  // lane c's L[c][j] at col[c]
    col[i] = x[j];
    __syncwarp();
    // the next pivot's rule and 1/sqrt first in the order, so that its
    // latency overlaps the rank-1 update's loads and FMAs
    if (j + 1 < SB) pivot(pn, rn);
#pragma unroll
    for (int c4 = (j + 1) / 4; c4 < SB / 4; ++c4) {
      const float4 v = ld4(col + 4 * c4);
      const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c4 + u > j) x[4 * c4 + u] = __fmaf_rn(-x[j], lc[u], x[4 * c4 + u]);
    }
    pj = pn;
    rj = rn;
  }
}

// Warp 0, after factor_tile: L_tt to the rows (zeros above it and right of
// it) and to pub, the reciprocal pivots to rs, the tile's count and ok to
// tally (the last tile's owner also sums them into cnt_ok), then flag t.
__device__ __forceinline__ void publish(const Args& a, float* rows, int ldr, int lt, int t,
                                        const float (&x)[SB], float my_rs, int cnt, int ok) {
  const int i = threadIdx.x & 31, b = a.b, k0 = t * SB;
  float* row = rows + (size_t)(lt + i) * ldr;
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    const float v = c <= i ? x[c] : 0.0f;
    row[k0 + c] = v;
    a.pub[(size_t)(k0 + c) * b + k0 + i] = v;  // coalesced across the lanes
  }
  for (int c = k0 + SB; c < b; c += 4)
    *reinterpret_cast<float4*>(row + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  a.rs[k0 + i] = my_rs;
  if (i == 0) {
    a.tally[2 * t] = cnt;
    a.tally[2 * t + 1] = ok;
    if (k0 + SB == b) {  // the last tile: every earlier tally is visible (flag chain)
      for (int s = 0; s < t; ++s) {
        cnt += __ldcg(a.tally + 2 * s);
        ok &= __ldcg(a.tally + 2 * s + 1);
      }
      a.cnt_ok[0] = cnt;
      a.cnt_ok[1] = ok;
    }
  }
  __syncwarp();
  if (i == 0) {
    __threadfence();
    store_release(a.flags + t, 1);
  }
}

template <bool kSharedRowsRoute>
__global__ void __launch_bounds__(kThreads, kSharedRowsRoute ? 1 : kGlobalPerSm)
    llt_panel_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sT[SB][SB + 1];
  __shared__ float sRs[SB];
  __shared__ __align__(16) float cb[2][SB];
  const int b = a.b, m = a.m, rpc = a.rpc, nsb = b / SB;
  const int cta = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int r0 = cta * rpc, nrows = min(rpc, m - r0);
  float* sB = smem;  // B_k: sB[c' * 32 + c] = L[32k + c][c'], c' < 32 (k + 1)
  float* sB2 = smem + SB * b;  // a tile's own block, or an early row block
  const int ldr = kSharedRowsRoute ? b + kRowPad : b;
  float* rows = kSharedRowsRoute ? smem + 2 * SB * b : a.out + (size_t)r0 * b;
  PROF_START

  if (cta == 0 && tid < 2 * nsb) a.flags[tid] = 0;  // flags and early flags
  {  // A's rows into the rows: all of them when in shared memory, else only
     // A11's (the diagonal rows), each up to its tile's end, zeros above
     // A11's diagonal
    const int lane = tid & 31, nst = kSharedRowsRoute ? nrows : min(nrows, max(0, b - r0));
    for (int i = warp; i < nst; i += kThreads / 32) {
      const int r = r0 + i, w = min(b, r + 1);  // past w: above A11's diagonal
      const int ce = kSharedRowsRoute ? b : min(b, (r / SB + 1) * SB);
      const float* src = a.slab + (size_t)r * a.lda;
      float v[kMaxB / 32];
#pragma unroll
      for (int u = 0; u < kMaxB / 32; ++u) {
        const int c = u * 32 + lane;
        v[u] = c < w ? src[c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMaxB / 32; ++u) {
        const int c = u * 32 + lane;
        if (c < ce) rows[i * ldr + c] = v[u];
      }
    }
  }
  cg::this_grid().sync();
  float x[SB], my_rs;
  int cnt, ok;
  if (cta == 0) {  // tile 0: S_0 is A's own
    for (int v = tid; v < SB * SB; v += kThreads)
      sT[v >> 5][v & (SB - 1)] = rows[(v >> 5) * ldr + (v & (SB - 1))];
    __syncthreads();
    if (warp == 0) {
      factor_tile(a, sT, cb, x, my_rs, cnt, ok);
      publish(a, rows, ldr, 0, 0, x, my_rs, cnt, ok);
    }
    __syncthreads();
  }
  PROF_MARK(0)

  for (int k = 0; k < nsb; ++k) {
    if (tid == 0)
      while (load_acquire(a.flags + k) == 0) {
      }
    __syncthreads();
    PROF_MARK(1)
    copy_block(sB, a.pub, b, k * SB, (k + 1) * SB);
    if (tid < SB) sRs[tid] = __ldcg(a.rs + k * SB + tid);
    __syncthreads();
    PROF_MARK(2)
    const int t = k + 1, lo = max(r0, t * SB) - r0;  // the rows still to form
    if (t < nsb && t * SB >= r0 && t * SB < r0 + nrows) {  // this CTA owns tile t
      // its rows' chain up to column 32 (k - 1) was formed at the last
      // step; the rest of it by all, the substitution by warp 0
      row_block<false, kSharedRowsRoute>(a, rows, ldr, sB, sRs, k, t >= 3 ? (k - 1) * SB : 0,
                                         k * SB, lo, lo + SB, 0, kThreads, r0);
      __syncthreads();
      if (warp == 0) solve_tile_rows(a, rows, ldr, sB, sRs, k, lo, r0);
      __syncthreads();
      PROF_MARK(3)
      tile_update<true>(rows, ldr, sB2, sT, lo, t, k);  // the last block, into sT
      __syncthreads();
      PROF_MARK(4)
      if (warp == 0) {
        factor_tile(a, sT, cb, x, my_rs, cnt, ok);
        PROF_MARK(5)
        publish(a, rows, ldr, lo, t, x, my_rs, cnt, ok);
        PROF_MARK(6)
      } else {
        row_block<true, kSharedRowsRoute>(a, rows, ldr, sB, sRs, k, 0, k * SB, lo + SB, nrows,
                                          32, kThreads - 32, r0);
      }
    } else if (lo < nrows) {
      row_block<true, kSharedRowsRoute>(a, rows, ldr, sB, sRs, k, 0, k * SB, lo, nrows, 0,
                                        kThreads, r0);
    }
    __syncthreads();
    PROF_MARK(7)
    // every later diagonal tile of this CTA takes column block k now, off
    // the chain of its own lookahead
    for (int tt = max(t + 1, (r0 + SB - 1) / SB); tt < nsb && tt * SB < r0 + nrows; ++tt) {
      tile_update<false>(rows, ldr, sB2, sT, tt * SB - r0, tt, k);
      __syncthreads();
    }
    // tile te = k + 2 of this CTA: its rows' column blocks up to k are
    // published (early flag te), and the chain of its next lookahead's
    // block te - 1 is formed up to column 32 (te - 2) from tile te - 1's
    // rows, published as early (early flag te - 1)
    const int te = k + 2;
    if (te < nsb && te * SB >= r0 && te * SB < r0 + nrows) {
      if (tid == 0) {
        __threadfence();
        store_release(a.early + te, 1);
      }
      if (te >= 3) {
        if (tid == 0)
          while (load_acquire(a.early + te - 1) == 0) {
          }
        __syncthreads();
        copy_block(sB2, a.pub, b, (te - 1) * SB, (te - 2) * SB);
        __syncthreads();
        row_block<false, kSharedRowsRoute>(a, rows, ldr, sB2, sRs, te - 1, 0, (te - 2) * SB,
                                           te * SB - r0, te * SB - r0 + SB, 0, kThreads, r0);
        __syncthreads();
      }
    }
    PROF_MARK(8)
  }

  if constexpr (kSharedRowsRoute) {
    const int n4 = nrows * (b / 4);
    for (int v = tid; v < n4; v += kThreads) {
      const int i = v / (b / 4), c = (v - i * (b / 4)) * 4;
      *reinterpret_cast<float4*>(a.out + (size_t)(r0 + i) * b + c) = ld4(rows + i * ldr + c);
    }
  }
  PROF_MARK(9)
  PROF_END
}

using Kernel = void (*)(Args);

Kernel kernel_for(int route) {
  return route == kSharedRows ? llt_panel_kernel<true> : llt_panel_kernel<false>;
}

struct DeviceInfo {
  bool known = false;
  int sms = 0, smem_max = 0;
};

// Per device: SMs and the dynamic shared memory a CTA can take (the opt-in
// limit less the kernel's static shared memory); sets both kernels'
// attributes once.
cudaError_t device_info(DeviceInfo* out) {
  static DeviceInfo cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev].known) {
    *out = cache[dev];
    return cudaSuccess;
  }
  DeviceInfo d;
  err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel_for(kSharedRows));
  if (err != cudaSuccess) return err;
  d.smem_max -= (int)fa.sharedSizeBytes;
  for (int k : {kSharedRows, kGlobalRows}) {
    err = cudaFuncSetAttribute(kernel_for(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_max);
    if (err != cudaSuccess) return err;
  }
  d.known = true;
  if (dev < kMaxDevices) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

struct Plan {
  int route, ctas, rpc;
  long long smem_bytes, scratch_floats;
};

long long cdiv(long long x, long long y) { return (x + y - 1) / y; }

// The route of an (m, b) slab on the current device: the 32-row tiles of
// rows dealt to at most one CTA an SM, each CTA's rows in its shared memory
// when they fit; else to at most kGlobalPerSm co-resident CTAs an SM, the
// rows in place in the output. Refused: b not a multiple of 32 in
// [32, 512], or m < b.
cudaError_t plan_of(int m, int b, Plan* pl) {
  *pl = Plan{kRefused, 0, 0, 0, 0};
  if (b < SB || b % SB != 0 || b > kMaxB || m < b) return cudaSuccess;
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return err;
  bool force_global = false;
#ifdef FAER_LLT_PANEL_PROFILE
  force_global = g_force_global;
#endif
  const long long tiles = cdiv(m, SB), sb_floats = 2LL * SB * b;  // sB and sB2
  const long long scratch = (long long)b * b + b + 4LL * (b / SB);
  long long n = tiles < d.sms ? tiles : d.sms;
  long long rpc = SB * cdiv(tiles, n);
  const long long fit = (d.smem_max / 4 - sb_floats) / (b + kRowPad) / SB * SB;
  if (!force_global && rpc <= fit) {
    *pl = Plan{kSharedRows, (int)cdiv(m, rpc), (int)rpc,
               (sb_floats + rpc * (b + kRowPad)) * 4, scratch};
    return cudaSuccess;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(kGlobalRows), kThreads,
                                                      (size_t)sb_floats * 4);
  if (err != cudaSuccess) return err;
  per_sm = per_sm < kGlobalPerSm ? per_sm : kGlobalPerSm;
  const long long held = (long long)d.sms * per_sm;
  if (held < 1) return cudaSuccess;
  n = tiles < held ? tiles : held;
  rpc = SB * cdiv(tiles, n);
  *pl = Plan{kGlobalRows, (int)cdiv(m, rpc), (int)rpc, sb_floats * 4, scratch};
  return cudaSuccess;
}

}  // namespace

// The route of an (m, b) slab on the current device (plan_of): 1 rows in
// shared memory, 0 rows in global memory, -1 refused, or -(CUDA error) - 2
// if the device query failed. ctas, rows_per_cta and scratch_floats (each
// may be null) get the CTAs, the rows each holds, and the floats of global
// scratch faer_llt_panel needs.
extern "C" int faer_llt_panel_route(int m, int b, int* ctas, int* rows_per_cta,
                                    long long* scratch_floats) {
  Plan pl;
  const cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return -(int)err - 2;
  if (ctas) *ctas = pl.ctas;
  if (rows_per_cta) *rows_per_cta = pl.rpc;
  if (scratch_floats) *scratch_floats = pl.scratch_floats;
  return pl.route;
}

// slab: (m, b) f32 with row stride lda >= b, rows contiguous (lower
// triangle of slab[:b] read); out: (m, b) contiguous; scratch: at least
// scratch_floats floats as faer_llt_panel_route gives them; cnt_ok: int[2]
// = {regularization count, success}; all on the current device (the caller
// selects it). Returns the CUDA error of the launch, 100000 if the CTAs
// cannot be co-resident, 0 on success.
extern "C" int faer_llt_panel(const float* slab, long long lda, float* out, float* scratch,
                              long long scratch_floats, int* cnt_ok, int m, int b, float eps,
                              float delta, void* stream) {
  Plan pl;
  cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return err;
  if (pl.route == kRefused || lda < b || scratch == nullptr ||
      scratch_floats < pl.scratch_floats)
    return cudaErrorInvalidValue;
  const int nsb = b / SB;
  float* rs = scratch + (size_t)b * b;
  int* flags = reinterpret_cast<int*>(rs + b);
  Args args{slab,      lda,   out,  scratch, rs,    flags, flags + nsb, flags + 2 * nsb,
            cnt_ok,    m,     b,    pl.rpc,  eps,   delta};
  const Kernel kern = kernel_for(pl.route);
  int per_sm = 0, device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        (size_t)pl.smem_bytes);
  DeviceInfo d;
  if (err == cudaSuccess) err = device_info(&d);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * d.sms < pl.ctas) return 100000;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(pl.ctas), dim3(kThreads), kargs,
                                    (size_t)pl.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FAER_LLT_PANEL_PROFILE
// Copies the kProf phase counters (SM cycles summed over CTAs and launches)
// to the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_llt_panel_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}

// For every later plan: a non-zero `on` sends every shape to the route with
// the rows in global memory, 0 restores the plan's own.
extern "C" void faer_llt_panel_profile_force_global(int on) { g_force_global = on; }
#endif
