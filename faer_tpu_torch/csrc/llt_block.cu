// llt_block: blocked LLT of one (b, b) f32 symmetric block in one CTA,
// b <= 1024.
//
// Replaces three Pallas functions that compute the same function in other
// orders of rounding: faer_tpu/ops/pallas/panel_kernels.py
// `llt_block_pallas` (:151, body `_llt_block_kernel` :116) and
// `llt_block_v3_pallas` (:586, body `_llt_block_v3_kernel` :530), and
// faer_tpu/ops/pallas/leaf_v4.py `llt_block_v4_pallas` (:132, body :73).
// Contract: out = L (lower, zeros above); cnt_ok = {regularization count as
// an int32, then one byte: every pivot > 0}. Only the lower triangle of a is
// read. Per pivot, as at panel_kernels.py:126-133: ok &= pj > 0 before any
// replacement; with use_eps a pivot <= delta becomes eps and is counted;
// without, a pivot <= 0 becomes 1.
//
// What bounds it on the H100: b^3/3 FP32 operations (88 us at b = 512 on
// one SM's share of the 67 TFLOP/s), the chain of b dependent pivots (each
// a reciprocal square root, a product and an update that the next pivot
// reads), and the shared-memory reads that feed the FFMAs. The bytes
// (2 b^2 floats) are nothing. The earlier unblocked kernel paid two block
// barriers a column; this one pays three a 32-column panel.
//
// Design: one CTA of 512 threads walks the block in 32-column panels,
// right-looking:
//  1. the 32 x 32 diagonal tile is factored by one warp in registers, lane
//     i holding row i. Row j + 1's pivot needs only that row's own entries
//     (its diagonal is kept in a register of its own), so it is formed and
//     shuffled to the warp first; the scaled column j
//     then goes to the other lanes through a 32-float shared buffer, four
//     entries a load, for the rest of the rank-1 update. No block barrier
//     inside the 32-pivot chain;
//  2. the rows below the tile are solved against it by substitution
//     (L21 = A21 L11^-T, no explicit inverse; the divide by L[j][j] is a
//     product with 1/sqrt(pivot j), kept from step 1): G threads share a
//     row (G = 8, 4, 2 or 1, the most that keep every row in one pass of
//     512 threads), each owning the columns j = q (mod G), each finished x_j
//     shuffled within the group;
//  3. the trailing lower triangle gets the rank-32 update C -= P P^T, an
//     FFMA chain from C over the 32 panel columns. Lookahead: all threads
//     update the next diagonal tile first, then warp 0 factors it (step 1
//     of the next panel) while warps 1..15 update the rest, one 128 x 8
//     tile each: lane l holds rows l, l + 32, l + 64, l + 96 and the 8
//     columns are the same across the warp, so the row reads are
//     unit-stride and the column reads two aligned float4 broadcasts, with
//     no bank conflicts.
// Three block barriers a panel: after step 2, after the next tile's update
// and after step 3 (10 at b = 128 with the first tile's, against 256 in
// the unblocked kernel).
//
// Routes, fixed by b (no route gives way to another at run time):
//  - b <= 337 (shared): the lower triangle, column-major, in shared memory,
//    packed with each column's row 0 at a 16-byte boundary (at most 3 floats
//    of padding a column), so that the panel's column reads are float4;
//    every step works there.
//  - 338 <= b <= 1024 (L2): the lower triangle lives column-major in the
//    output buffer itself (L's column c in out's row c, 4 MiB at 1024, in
//    L2), and each panel's 32 columns and diagonal tile are copied to
//    shared memory as the solve writes them, so the update reads the panel
//    from shared memory and streams C through L2 once a panel (16 passes at
//    512, against the unblocked kernel's 512 (v1) and 64 (v3)).
//    Warp-private 32 x 33 tiles stage the block in and transpose it back in
//    place at the end, with zeros above the diagonal, so that every global
//    access is coalesced.
//    A thread-block cluster with the triangle dealt over its CTAs' shared
//    memory would also split the FMAs over SMs; it was left for a later
//    change: eight portable CTAs do not hold a 1024 triangle, so the L2
//    route is needed in any case, and one route covers 338..1024.
// The route is decided here alone: faer_llt_block_route(b) tells callers
// which one a launch takes.
//
// No thread reads an entry that another thread writes in the same phase
// (between two block barriers), nor anything past the block: a load above
// the diagonal, past the last row or column, or in the rows of the tile
// warp 0 is factoring is skipped and its register starts at 0 (warp 0
// itself reads its own rows and zeroes what lies above the diagonal).
// Such values are never stored and never reach the pivot chain.
//
// The unblocked kernel's sub-block template (1 for v1, 8 for v3) meant the
// order of rounding only; this kernel has one order, so the entry point no
// longer takes it. FP32 only, no TF32.
//
// Built with -DFAER_LLT_PROFILE (`tools/torch_profile.py llt` does, into a
// library of its own), the kernel also sums the SM cycles of each phase as
// thread 0 sees them into g_prof, read by faer_llt_block_profile_read.
#include <cuda_runtime.h>

#ifdef FAER_LLT_PROFILE
// 0 stage, 1 first tile, 2 solves, 3 next-tile updates, 4 factors and
// trailing updates, 5 warp 0's factors, 6 warp 15's trailing updates, 7 out
__device__ long long g_prof[8];
#define PROF_START long long t_prof = clock64();
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long u = clock64(); g_prof[k] += u - t_prof; t_prof = u; }
#define PROF_SPAN_START const long long s_prof = clock64();
#define PROF_SPAN(k, thread) \
  if (threadIdx.x == (thread)) g_prof[k] += clock64() - s_prof;
#define PROF_SYNC __syncthreads();
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_SPAN_START
#define PROF_SPAN(k, thread)
#define PROF_SYNC
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNb = 32;                 // panel width
constexpr int kMaxB = 1024;
constexpr int kSmemBytes = 232448;      // 227 KiB
constexpr int kTileLd = 33;             // padded 32 x 32 tile
constexpr int kTileFloats = 32 * kTileLd;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr size_t kStaticBytes = 3 * kNb * sizeof(float);  // rs and cb

// Offset of column c's row 0 in the shared route's packed layout: the
// packed offset plus up to 3c + 3 floats, rounded to a multiple of 4.
// Column c holds rows c .. b - 1, and never reaches column c + 1's row c + 1.
__host__ __device__ inline int packed_col(int c, int b) {
  return (c * b - c * (c - 1) / 2 + 2 * c + 3) & ~3;
}

// Floats of the shared route's layout, to the last column's end.
__host__ __device__ inline int packed_floats(int b) {
  return packed_col(b - 1, b) + b;
}

// The route of a (b, b) block: shared memory when the packed layout and the
// static arrays fit a CTA's 227 KiB (b <= 337), else L2.
inline bool staged_route(int b) {
  return (size_t)packed_floats(b) * sizeof(float) + kStaticBytes <= (size_t)kSmemBytes;
}

// The lower triangle, column-major: element (r, c), r >= c, at col(c)[r]:
// packed in shared memory, or with column stride b in global memory.
struct Lower {
  float* base;
  int b;
  bool packed;
  __device__ __forceinline__ float* col(int c) const {
    return base + (packed ? packed_col(c, b) : c * b);
  }
};

// Shared memory of the L2 route: the panel (32 columns of b rows, column
// stride panel_ld(b), a multiple of 8 so that 8 columns' entries of a row
// are two aligned float4), also room for 16 warp tiles while staging, then
// the diagonal tile.
__host__ __device__ inline int panel_ld(int b) { return (b + 7) & ~7; }
__host__ __device__ inline int panel_floats(int b) {
  return 32 * panel_ld(b) > kWarps * kTileFloats ? 32 * panel_ld(b)
                                                 : kWarps * kTileFloats;
}

// Column kk of the panel at k0, indexed by row: in place on the shared
// route, the copy in sp on the L2 route. Row 0 sits on a 16-byte boundary.
template <bool kStaged>
__device__ __forceinline__ const float* panel_col(const Lower& L, const float* sp,
                                                  int k0, int kk) {
  return kStaged ? L.col(k0 + kk) : sp + kk * panel_ld(L.b);
}

// Row I >= column J of the t-th lower 32 x 32 tile, t = I (I + 1) / 2 + J.
__device__ __forceinline__ void tile_of(int t, int& I, int& J) {
  I = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  while (I * (I + 1) / 2 > t) --I;
  J = t - I * (I + 1) / 2;
}

// L2 route, staging: the lower triangle of a (row-major, stride lda) into
// out column-major (out[c * b + r] = a[r][c], r >= c).
__device__ void stage_in_l2(const float* __restrict__ a, int lda, float* out,
                            int b, float* tile, int warp, int lane) {
  const int nt = (b + 31) / 32, pairs = nt * (nt + 1) / 2;
  for (int t = warp; t < pairs; t += kWarps) {
    int I, J;
    tile_of(t, I, J);
    const int c = J * 32 + lane;
    float v[32];  // all 32 loads in flight before the first store
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = I * 32 + i;
      v[i] = (r < b && c < b) ? a[(size_t)r * lda + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) tile[i * kTileLd + lane] = v[i];
    __syncwarp();
    const int r = I * 32 + lane;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int cj = J * 32 + j;
      if (r < b && cj <= r) out[(size_t)cj * b + r] = tile[lane * kTileLd + j];
    }
    __syncwarp();
  }
}

// L2 route, the end: out holds L column-major (L's column c in row c, on
// and right of the diagonal); transpose it in place to row-major with zeros
// above the diagonal. Each warp owns a pair of tiles, (I, J) and (J, I).
__device__ void unstage_l2(float* out, int b, float* tile, int warp, int lane) {
  const int nt = (b + 31) / 32, pairs = nt * (nt + 1) / 2;
  for (int t = warp; t < pairs; t += kWarps) {
    int I, J;
    tile_of(t, I, J);
    const int ci = I * 32 + lane;  // a row of L, read along out's row J*32+j
    float v[32];  // all 32 loads in flight before the first store
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int rj = J * 32 + j;
      v[j] = (rj < b && ci < b) ? out[(size_t)rj * b + ci] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) tile[j * kTileLd + lane] = v[j];
    __syncwarp();
    const int c = J * 32 + lane;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = I * 32 + i;
      if (r < b && c < b) out[(size_t)r * b + c] = c <= r ? tile[lane * kTileLd + i] : 0.0f;
    }
    if (I != J) {  // the source tile lies above the diagonal: zeros
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int rj = J * 32 + j;
        if (rj < b && ci < b) out[(size_t)rj * b + ci] = 0.0f;
      }
    }
    __syncwarp();
  }
}

// N consecutive rows c0 .. c0 + N - 1 of a panel column p (N = 2 or 8,
// c0 a multiple of N): as aligned vectors when kWhole says they all lie in
// the block, else one by one, none past the last row b - 1 (past it, the
// packed layout holds the next column, which another warp may be writing).
template <int N, bool kWhole>
__device__ __forceinline__ void panel_rows(const float* p, int c0, int b, float (&v)[N]) {
  if constexpr (kWhole && N == 2) {
    const float2 u = reinterpret_cast<const float2*>(p + c0)[0];
    v[0] = u.x, v[1] = u.y;
  } else if constexpr (kWhole) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 u = reinterpret_cast<const float4*>(p + c0 + q)[0];
      v[q] = u.x, v[q + 1] = u.y, v[q + 2] = u.z, v[q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = c0 + j < b ? p[c0 + j] : 0.0f;
  }
}

// acc[i][j] -= P[rows[i]][:] . P[c0 + j][:] over the panel's 32 columns: one
// FFMA a product, the panel read-only in this phase (rows clamped into it).
template <int R, int N, bool kStaged, bool kWhole>
__device__ __forceinline__ void panel_products(const Lower& L, const float* sp, int k0,
                                               const int (&rows)[R], int c0,
                                               float (&acc)[R][N]) {
#pragma unroll 8
  for (int kk = 0; kk < kNb; ++kk) {
    const float* p = panel_col<kStaged>(L, sp, k0, kk);
    float av[R], bv[N];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = p[rows[i]];
    panel_rows<N, kWhole>(p, c0, L.b, bv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(-av[i], bv[j], acc[i][j]);
  }
}

// Step 3 for the next diagonal tile (rows and columns k1 .. k1 + 31), by
// all 512 threads, two entries each: thread t owns row k1 + t / 16 and
// columns k1 + 2 (t % 16) + {0, 1}; the same FFMA chain from C as
// update_trailing, written back in place (lower entries only, and only
// those are loaded).
template <bool kStaged>
__device__ void update_tile(const Lower& L, const float* sp, int k0, int tid) {
  const int b = L.b, k1 = k0 + kNb, r = k1 + (tid >> 4), c0 = k1 + 2 * (tid & 15);
  const int rows[1] = {min(r, b - 1)};
  const bool lo0 = r < b && c0 <= r, lo1 = r < b && c0 + 1 <= r;
  float acc[1][2] = {{lo0 ? L.col(c0)[r] : 0.0f, lo1 ? L.col(c0 + 1)[r] : 0.0f}};
  if (k1 + kNb <= b)  // uniform across the block: a whole tile
    panel_products<1, 2, kStaged, true>(L, sp, k0, rows, c0, acc);
  else
    panel_products<1, 2, kStaged, false>(L, sp, k0, rows, c0, acc);
  if (lo0) L.col(c0)[r] = acc[0][0];
  if (lo1) L.col(c0 + 1)[r] = acc[0][1];
}

// Step 1: warp 0 factors the diagonal tile at k1 (w <= 32 columns) in
// registers, lane i holding row i. Writes L11 to its home and, on the L2
// route, to sd (row-major, stride kTileLd); rs[j] = 1/sqrt(pivot j), by
// which column j was scaled. Only the lower entries of the tile's rows are
// loaded; the others (above the diagonal, or in lanes past the block) start
// at 0, are updated too (they feed only entries above the diagonal) and are
// never stored.
template <bool kStaged>
__device__ void factor_tile(const Lower& L, float* sd, float* rs, float (*cb)[kNb],
                            int k1, int w, int lane, float eps, float delta,
                            int use_eps, int& cnt, int& ok) {
  const int i = lane;
  const bool live = i < w;
  // every lane loads from its row (row b - 1, of this tile, past the
  // block), at most up to the diagonal: only this warp writes those rows
  // in this phase; the loads need no branch, the selects zero the rest
  const int ri = min(k1 + i, L.b - 1);
  float x[kNb];
#pragma unroll
  for (int c = 0; c < kNb; ++c) {
    const float v = L.col(min(k1 + c, ri))[ri];
    x[c] = live && c <= i ? v : 0.0f;
  }
  // the lane's own diagonal entry, kept apart (x[i] needs a dynamic index):
  // it needs only the lane's own entries, so the pivot chain runs through
  // registers and shuffles alone, beside the column broadcast
  const float d = L.col(ri)[ri];
  float dg = live ? d : 0.0f;
  float pj = __shfl_sync(kFull, x[0], 0);
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    if (j < w) {  // uniform across the warp
      const bool needs = pj <= delta;
      ok &= pj > 0.0f;
      cnt += use_eps && needs;
      if (use_eps ? needs : pj <= 0.0f) pj = use_eps ? eps : 1.0f;  // 1: keep finite
      const float r = rsqrtf(pj);  // one MUFU op on the chain, not a divide
      if (i == j) {
        x[j] = pj * r;
        rs[j] = r;
      } else {
        x[j] *= r;
      }
      dg = fmaf(-x[j], x[j], dg);  // the same FMA as x[i] gets below
      if (j + 1 < kNb) pj = __shfl_sync(kFull, dg, j + 1);
      float* col = cb[j & 1];  // lane c's L[c][j] at col[c]
      col[i] = x[j];
      __syncwarp();
#pragma unroll
      for (int c4 = (j + 1) / 4; c4 < kNb / 4; ++c4) {
        const float4 v = reinterpret_cast<const float4*>(col)[c4];
        const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * c4 + u > j) x[4 * c4 + u] = fmaf(-x[j], lc[u], x[4 * c4 + u]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kNb; ++c) {
      if (c <= i) {
        L.col(k1 + c)[k1 + i] = x[c];
        if (!kStaged) sd[i * kTileLd + c] = x[c];
      }
    }
  }
}

// L11[j][c] (c <= j) of the panel at k0: from its home in shared memory, or
// from sd on the L2 route.
template <bool kStaged>
__device__ __forceinline__ float diag_at(const Lower& L, const float* sd, int k0,
                                         int j, int c) {
  return kStaged ? L.col(k0 + c)[k0 + j] : sd[j * kTileLd + c];
}

// Step 2: rows k0 + 32 .. b - 1 of the panel's 32 columns solved against
// L11 by substitution, G threads a row. On the L2 route each result also
// goes to the shared panel sp (column c at sp + c * panel_ld(b), indexed
// by row).
template <int G, bool kStaged>
__device__ void solve_rows(const Lower& L, const float* sd, const float* rs,
                           float* sp, int k0, int tid) {
  constexpr int M = kNb / G;
  const int b = L.b, q = tid & (G - 1);
  for (int r0 = k0 + kNb; r0 < b; r0 += kThreads / G) {  // uniform
    const int r = r0 + tid / G;
    float x[M];  // rows past the block solve zeros
#pragma unroll
    for (int m = 0; m < M; ++m) x[m] = r < b ? L.col(k0 + q + G * m)[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      const int mj = j / G, oj = j % G;
      float xj = x[mj] * rs[j];  // x_j = a_j / L[j][j]
      if constexpr (G > 1) xj = __shfl_sync(kFull, xj, oj, G);  // the owner's
      if (q == oj) x[mj] = xj;
#pragma unroll
      for (int m = mj; m < M; ++m) {
        const int c = q + G * m;
        if (c > j) x[m] = fmaf(-xj, diag_at<kStaged>(L, sd, k0, c, j), x[m]);
      }
    }
    if (r < b) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c = q + G * m;
        L.col(k0 + c)[r] = x[m];
        if (!kStaged) sp[c * panel_ld(b) + r] = x[m];
      }
    }
  }
}

// Step 3 without the next diagonal tile (warp 0's): the trailing lower
// triangle (rows and columns k1 .. b - 1, k1 = k0 + 32) minus P P^T, by
// warps 1 .. 15. Row tile rt covers 128 rows and needs column groups of 8
// up to its last row: min(ncg, 16 (rt + 1)). C is loaded only where it is
// stored: lower entries of the block, not in the next tile's rows; the
// panel (read-only in this phase) is read with clamped rows.
template <bool kStaged>
__device__ void update_trailing(const Lower& L, const float* sp, int k0, int warp,
                                int lane) {
  const int b = L.b, k1 = k0 + kNb, n2 = b - k1;
  const int ncg = (n2 + 7) / 8, nrt = (n2 + 127) / 128;
  // warps 4, 8 and 12 share a scheduler with warp 0, which factors the next
  // tile meanwhile: they take tiles only when 12 warps do not cover them
  int t = (warp & 3) ? warp - 1 - (warp >> 2) : 11 + (warp >> 2), first = 0;
  for (int rt = 0; rt < nrt; ++rt) {
    const int tiles = min(ncg, 16 * (rt + 1));
    for (; t < first + tiles; t += kWarps - 1) {
      const int cg = t - first;
      const int rbase = k1 + rt * 128 + lane, c0 = k1 + cg * 8;
      const int i0 = (rt == 0 && cg < kNb / 8) ? 1 : 0;  // rows of the next tile
      // acc starts from C, loaded before the products so that its latency
      // (L2 on that route) overlaps them; then one FFMA a product
      float acc[4][8];
      int rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i] = min(rbase + 32 * i, b - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rbase + 32 * i;
          acc[i][j] = i >= i0 && r < b && c0 + j <= r ? L.col(c0 + j)[r] : 0.0f;
        }
      }
      if (c0 + 8 <= b)  // uniform across the warp: all 8 columns in the block
        panel_products<4, 8, kStaged, true>(L, sp, k0, rows, c0, acc);
      else
        panel_products<4, 8, kStaged, false>(L, sp, k0, rows, c0, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rbase + 32 * i;
          if (i >= i0 && r < b && c0 + j <= r) L.col(c0 + j)[r] = acc[i][j];
        }
      }
    }
    first += tiles;
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
llt_block_kernel(const float* __restrict__ a, int lda, float* out,
                 unsigned char* cnt_ok, int b, float eps, float delta,
                 int use_eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float rs[kNb];
  __shared__ __align__(16) float cb[2][kNb];
  const Lower L{kStaged ? smem : out, b, kStaged};
  float* sp = smem;  // L2 route: the panel, or the warp tiles while staging
  float* sd = kStaged ? nullptr : smem + panel_floats(b);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PROF_START

  // the shared route walks the (b, b) block row-major, thread tid at
  // element tid + 512 k, its (row, column) advanced without a divide
  const int step_r = kThreads / b, step_c = kThreads - step_r * b;
  if (kStaged) {  // 16 loads in flight a thread before their stores
    int r = tid / b, c = tid - (tid / b) * b;
    while (r < b) {
      float v[16];
      int rr[16], cc[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        rr[u] = r, cc[u] = c;
        v[u] = (r < b && c <= r) ? a[(size_t)r * lda + c] : 0.0f;
        r += step_r, c += step_c;
        if (c >= b) c -= b, ++r;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (rr[u] < b && cc[u] <= rr[u]) L.col(cc[u])[rr[u]] = v[u];
    }
  } else {
    stage_in_l2(a, lda, out, b, smem + warp * kTileFloats, warp, lane);
  }
  __syncthreads();
  PROF_MARK(0)

  int cnt = 0, ok = 1;  // warp 0 tallies alike; thread 0 stores them
  if (warp == 0)
    factor_tile<kStaged>(L, sd, rs, cb, 0, min(kNb, b), lane, eps, delta, use_eps,
                         cnt, ok);
  __syncthreads();
  PROF_MARK(1)
  for (int k0 = 0; k0 + kNb < b; k0 += kNb) {
    const int k1 = k0 + kNb, nt = b - k1;
    if (nt <= kThreads / 8) solve_rows<8, kStaged>(L, sd, rs, sp, k0, tid);
    else if (nt <= kThreads / 4) solve_rows<4, kStaged>(L, sd, rs, sp, k0, tid);
    else if (nt <= kThreads / 2) solve_rows<2, kStaged>(L, sd, rs, sp, k0, tid);
    else solve_rows<1, kStaged>(L, sd, rs, sp, k0, tid);
    __syncthreads();
    PROF_MARK(2)
    update_tile<kStaged>(L, sp, k0, tid);  // the next tile first, by all
    __syncthreads();
    PROF_MARK(3)
    PROF_SPAN_START
    if (warp == 0) {
      factor_tile<kStaged>(L, sd, rs, cb, k1, min(kNb, nt), lane, eps, delta,
                           use_eps, cnt, ok);
      PROF_SPAN(5, 0)
    } else {
      update_trailing<kStaged>(L, sp, k0, warp, lane);
      PROF_SPAN(6, 480)
    }
    __syncthreads();
    PROF_MARK(4)
  }

  if (kStaged) {
    for (int r = tid / b, c = tid - (tid / b) * b; r < b;) {
      out[(size_t)r * b + c] = c <= r ? L.col(c)[r] : 0.0f;
      r += step_r, c += step_c;
      if (c >= b) c -= b, ++r;
    }
  } else {
    unstage_l2(out, b, smem + warp * kTileFloats, warp, lane);
  }
  PROF_SYNC
  PROF_MARK(7)
  if (tid == 0) {
    *reinterpret_cast<int*>(cnt_ok) = cnt;
    cnt_ok[4] = (unsigned char)ok;
  }
}

}  // namespace

// a: (b, b) f32 with row stride lda (lower triangle read); out: (b, b)
// contiguous, also the L2 route's scratch; cnt_ok: 8 bytes, the count as an
// int32 at 0 and ok as one byte at 4; all on the current device (the caller
// selects it). Returns the CUDA error of the launch (0 on success).
extern "C" int faer_llt_block(const float* a, int lda, float* out,
                              void* cnt_ok, int b, float eps, float delta,
                              int use_eps, void* stream) {
  if (b < 1 || b > kMaxB || lda < b) return cudaErrorInvalidValue;
  const bool staged = staged_route(b);
  const size_t smem = (size_t)(staged ? packed_floats(b) : panel_floats(b) + kTileFloats) *
                      sizeof(float);
  void (*kern)(const float*, int, float*, unsigned char*, int, float, float, int) =
      staged ? llt_block_kernel<true> : llt_block_kernel<false>;
  // the dynamic shared-memory ceiling is raised to what the 227 KiB leave
  // beside the static rs and cb, once per device and route, not on every call
  static bool raised[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !raised[dev][staged]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes - (int)kStaticBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev][staged] = true;
  }
  kern<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      a, lda, out, static_cast<unsigned char*>(cnt_ok), b, eps, delta, use_eps);
  return cudaGetLastError();
}

// The route faer_llt_block takes for a (b, b) block: 1 shared memory, 0 L2,
// -1 for a b it refuses.
extern "C" int faer_llt_block_route(int b) {
  if (b < 1 || b > kMaxB) return -1;
  return staged_route(b) ? 1 : 0;
}

#ifdef FAER_LLT_PROFILE
// Copies the 8 phase counters (SM cycles summed over launches) to the host
// and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_llt_block_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[8] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
