// lu_panel_batched: partial-pivot LU of one (m, b) f32 panel, or of a stack
// of g independent ones, with virtual pivots, in one launch.
//
// Replaces every virtual-pivot LU panel of faer_tpu/ops/pallas/, which
// compute one function in different orders of rounding:
// lu_panel_v5.py `lu_panel_v5_pallas` (:157, body `_lu_v5_kernel` :78; the
// fused route's panels), leaf_v4.py `lu_panel_v4_pallas` (:228, body :168;
// the recursive driver's leaves), lu_panel_v2.py `lu_panel_v2_pallas` (:152,
// body `_lu_panel_v2_kernel` :58; the CALU leaf's groups and candidates)
// and lu_panel_v3.py `lu_panel_v3_pallas` (:125, body :51; v2 unrolled).
// Like them it takes kmax = min(m, b) steps, so a wide panel (m < b) comes
// back whole: U12 = L11^-1 A12 lands in the columns right of m. Per column
// r: the unused row p with the largest |V[p, r]| (ties to the lowest row,
// as jax.lax.argmax; a NaN counts as +inf), the other unused rows' entries
// of column r scaled by 1/V[p, r], and the update of their later columns.
// No row moves while the panel is factored; the kernel writes the result
// in packed order at the end: the pivot row of step k to row k, the unused
// rows after row kmax in their order, and perm (int64) beside it.
//
// What bounds it on the H100: a (4096, 256) f32 panel is 4 MiB, more than
// one thread-block cluster's shared memory (16 x 227 KB), and every one of
// the b columns needs a search over all m rows before the next column can
// start. The panel is bound by those b exchanges between SMs in a row, not
// by its m b^2 FP32 operations (4 us at 67 TFLOP/s) or its bytes.
//
// Design, in the Pallas body's order (`_lu_v5_kernel`): rank-1 steps only
// inside a working block of SB = 32 columns, and one deferred rank-SB
// update of the later columns at the end of each sub-block. CTA x of a
// panel owns rows [x rpc, (x + 1) rpc) for the whole factorization. Its
// working block W (rpc x SB at a row stride of SB + 1, so that a column
// read one thread a row hits 32 banks) is in shared memory; thread t holds
// rows t, t + 256, ... of it. Its whole rows are in place in a global
// scratch (L2-resident: 4 MiB for one panel). Keeping them in shared memory
// where they fit bought nothing measurable (profile build on an H100,
// 700 W, ms a launch, rows in shared memory / in L2: (2048, 256) 0.5944 /
// 0.6229, (1024, 256) 0.5989 / 0.5852; the deferred update 285 305 /
// 289 178 and 213 389 / 204 298 cycles a CTA), so they are always in L2.
// Per column, one exchange:
//  1. each thread's candidate (the largest |v| of its unused rows, a NaN
//     as +inf, ties to the lowest row) was found by the update of the last
//     column; a warp reduction (redux.sync on the bits of |v|, then on the
//     row), one block barrier, and every warp reduces the warps' candidates
//     again. The CTA's candidate and its SB working entries are then pushed
//     into a slot of every CTA's shared memory (warp w to CTAs w, w + 8;
//     st.shared::cluster), by the parity of the column;
//  2. barrier.cluster arrive.release / wait.acquire (cluster route) or
//     grid.sync() (grid route, where the candidate and its entries go to
//     global scratch with __stcg);
//  3. every warp reads the G candidates from its own CTA's slots (grid
//     route: from L2 with __ldcg) and reduces them: the best of distinct
//     rows is the same in any order, so every warp of every CTA agrees with
//     no further barrier, and the pivot row's entries are the winner's slot;
//  4. every thread scales its unused rows' entry of the column and updates
//     their working columns after it, the pivot entries in registers (four
//     16-byte broadcast loads), and offers its new entry of the next column
//     as its next candidate. A thread searches and updates only its own rows.
// At the end of a sub-block every CTA writes W back to its rows and, for
// the later columns in chunks of kChunk: reads the SB pivot rows' entries
// (unchanged since the sub-block began; their owners never write them
// again, and write the pivot rows out directly), forms U12 = L11^-1 T by
// unit-lower substitution in one fixed order, one thread a column, and
// updates its unused rows by -L21 U12 in 8-row by 4-column register tiles,
// the next tile's loads in flight. In the first sub-block the later columns
// are read from the panel itself, so only the working block is staged.
// Then it writes its pivot rows of the
// sub-block to packed rows sb0 + k (U12's rows right of the sub-block) and
// loads the next working columns of its unused rows. After the last column
// the CTAs count their unused rows, one more exchange gives each its
// offset, each writes its rows in packed order with perm, and the CTAs of
// the panel count perm's cycles by pointer doubling (one exchange a round)
// for nt. Every row's arithmetic runs in one order whichever CTA holds it
// and whichever route runs (explicit __fmul_rn / __fmaf_rn, IEEE
// division), so a batch equals g single launches and the two routes agree
// to the bit; lu_panel_blocked_plain (ops/kernels/lu_panel.py) repeats that
// order.
//
// Two routes, decided in plan_of from (g, m, b) and the device alone
// (faer_lu_panel_route tells callers which; a launch the route cannot make
// fails, nothing retries on the other route):
//  - cluster: one thread-block cluster of up to 16 CTAs a panel (g clusters
//    in one launch, with no co-residency condition across them), from
//    kClusterMinRows to kClusterMaxRows rows a CTA: m up to 6 144 on an
//    H100 (lu_panel.cluster_edge; its shared memory alone would take
//    22 752 at b = 256);
//  - grid: one cooperative grid of g x G CTAs, one an SM, at least
//    kGridMinRows rows a CTA; where a CTA's W does not fit its shared
//    memory (m past 132 x 1 422 at b = 256 for one panel), W goes to global
//    scratch too, column-major, with as many CTAs an SM as are co-resident.
// A batch the grid route cannot hold one CTA an SM takes the cluster route
// past kClusterMaxRows where its shared memory holds the rows' W. Refused:
// m past kMaxRowsPerCta (8192) rows a CTA over all the CTAs the card holds
// co-resident, shared among the g panels (plan_of).
// Built with -DFAER_LU_PROFILE (`tools/torch_profile.py lu` does, into a
// library of its own), thread 0 of each CTA adds its cycles by phase into
// g_prof, read by faer_lu_panel_profile_read, and
// faer_lu_panel_profile_force_grid forces the grid route.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>


namespace cg = cooperative_groups;

#ifdef FAER_LU_PROFILE
// 0 stage, 1 local search, 2 exchange wait, 3 candidate reduction and pivot
// row, 4 column scale and rank-1 update, 5 deferred trailing update, 6 final
// write: thread 0's cycles, summed over CTAs and launches
__device__ long long g_prof[7];
// host: every shape on the grid route
static int g_force_grid = 0;
#define PROF_START long long t_prof = clock64();
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long u = clock64(); prof[k] += u - t_prof; t_prof = u; }
#define PROF_END \
  if (threadIdx.x == 0) for (int k = 0; k < 7; ++k) atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)prof[k]);
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_END
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// SB, the working block's columns: on an H100 (profile build) (4096, 256)
// 0.7449 ms at 32 against 0.8599 at 16, whose more sub-blocks cost more in
// the deferred update than the narrower rank-1 steps save
constexpr int SB = 32;
constexpr int kChunk = 512;      // later columns a deferred update takes at once
constexpr int kTileRows = 8;     // rows of a warp's tile in the deferred update
constexpr int kTileCols = 4;     // a lane's columns of it, 32 apart
constexpr int kMaxCluster = 16;  // non-portable; 8 is the portable size
// the fewest rows a CTA takes on each route; on an H100 (profile build):
// (1024, 256) 0.5777 ms at 64 rows a CTA (16 CTAs) against 0.6040 at 128
// (8), (2048, 256) 0.6228 at 128 (16) against 0.7086 at 256 (8)
constexpr int kClusterMinRows = 64;
// the most rows a CTA of the largest cluster takes: past it the grid's
// more CTAs win (`tools/torch_profile.py lu` on an H100, ms a launch,
// cluster / grid: (6144, 256) at 384 rows a CTA 0.9300 / 0.9465,
// (8192, 256) at 512 1.0701 / 0.9760, (8192, 64) 0.2609 / 0.2601)
constexpr int kClusterMaxRows = 384;
constexpr int kGridMinRows = 128;
constexpr int kMaxRowsPerThread = 32;  // a thread's unused rows are one 32-bit mask
constexpr int kMaxRowsPerCta = kThreads * kMaxRowsPerThread;
constexpr int kMaxDevices = 64;
constexpr int kNotCoResident = 100000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCopyBatch = 16;  // 32-column row segments a warp loads before it stores

// faer_lu_panel_route's codes; kGridGlobalW is the grid route with W in
// global scratch
enum Route { kRefused = -1, kGrid = 0, kCluster = 1, kGridGlobalW = 2 };

// A row's state at the end of a sub-block: pivoted before it, pivoted in
// it, or still unused
enum RowState { kDead = 0, kPivot = 1, kLive = 2 };

struct Args {
  const float* panels;
  long long batch_stride, lda;
  float* packed;      // (g, m, b)
  long long* perm;    // (g, m)
  int* nt;            // (g,)
  unsigned char* ok;  // (g,), bool
  float* work;        // the rows in global memory, (g, m, b), when not in shared memory
  float* slots;       // grid route: candidates, candidate rows, counts
  float* wglob;       // grid route, W in global memory: (g, G, w_floats)
  int* cyc;           // (g, 4, m): the cycle count's pointer doubling
  int m, b, rpc;
};

__host__ __device__ constexpr int chunk_of(int sb, int b) {
  return b - sb < 1 ? 1 : (b - sb < kChunk ? b - sb : kChunk);
}

// W, rpc x (SB + 1), padded to 16 bytes.
__host__ __device__ constexpr long long w_floats(long long rpc) {
  return (rpc * (SB + 1) + 3) & ~3LL;
}

// Shared-memory floats of a CTA of rpc rows: W when it is in shared
// memory, the pivot rows' working entries (SB x (SB + 4)), a chunk of U12
// (SB x chunk_of), the rows' states (rpc) and the pivot row of each step
// (b ints).
__host__ __device__ constexpr long long smem_floats(int b, long long rpc, bool smem_w) {
  return (smem_w ? w_floats(rpc) : 0) + (long long)SB * (SB + 4) +
         (long long)SB * chunk_of(SB, b) + rpc + b;
}

// A candidate is (bits of |v|, row): a NaN counts as +inf, and the bits of
// non-negative floats order as their values. The larger bits win, ties go to
// the lower row, and (0, INT_MAX) is no candidate (any row beats it).
__device__ __forceinline__ void offer(unsigned& cb, int& cr, float x, int row) {
  float v = fabsf(x);
  if (v != v) v = INFINITY;
  const unsigned bits = __float_as_uint(v);
  if (bits > cb || (bits == cb && row < cr)) {
    cb = bits;
    cr = row;
  }
}

// The warp's best candidate, in every lane: two warp reductions.
__device__ __forceinline__ void warp_argmax(unsigned& cb, int& cr) {
  const unsigned best = __reduce_max_sync(kFull, cb);
  cr = __reduce_min_sync(kFull, cb == best ? cr : INT_MAX);
  cb = best;
}

// Copies an nrows x ncols block one 32-column row segment a warp at a
// time, U segments' loads in flight before the first store (a copy from
// global memory is latency-bound otherwise): store(i, c, load(i, c)).
template <int U, typename Load, typename Store>
__device__ __forceinline__ void copy_rows(int nrows, int ncols, Load load, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_row = (ncols + 31) / 32, nseg = nrows * per_row;
  for (int s0 = warp; s0 < nseg; s0 += kWarps * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * kWarps, i = s / per_row, c = s % per_row * 32 + lane;
      v[u] = s < nseg && c < ncols ? load(i, c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * kWarps, i = s / per_row, c = s % per_row * 32 + lane;
      if (s < nseg && c < ncols) store(i, c, v[u]);
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kCl: the cluster route, else the grid route; kGW: W in global scratch
// (grid route only), and then two CTAs an SM where their registers allow
template <bool kCl, bool kGW>
__global__ void __launch_bounds__(kThreads, kGW ? 2 : 1) lu_panel_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned sRedB[kWarps];
  __shared__ int sRedR[kWarps];
  // cluster: every CTA's candidate, by column parity: its SB working
  // entries, then (bits, row), pushed here by that CTA
  __shared__ __align__(16) float sAll[2][kMaxCluster][SB + 4];
  __shared__ __align__(16) float sPivW[kWarps * SB];  // grid: each warp's pivot row
  __shared__ int sWarpCnt[kWarps];
  __shared__ int sCount;      // cluster: this CTA's unused rows at the end
  constexpr int ldp = SB + 4;  // sWpiv's row stride: 16-byte rows
  const int m = a.m, b = a.b, rpc = a.rpc, kmax = min(m, b);
  // W's strides, of a row and of a column: in shared memory rows SB + 1
  // floats apart, so that a column read one thread a row hits 32 banks; in
  // global scratch column-major, so that it is one coalesced access
  const int wr = kGW ? 1 : SB + 1, wc = kGW ? rpc : 1;
  const int G = gridDim.x, cta = blockIdx.x, q = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  const int R = (nrows + kThreads - 1) / kThreads;  // rows a thread holds
  const int chunk = chunk_of(SB, b);
#ifdef FAER_LU_PROFILE
  long long prof[7] = {0};
#endif
  PROF_START

  float* W = kGW ? a.wglob + ((size_t)q * G + cta) * w_floats(rpc) : smem;
  float* sWpiv = kGW ? smem : W + w_floats(rpc);                     // SB x ldp
  float* sU = sWpiv + SB * ldp;                                      // SB x chunk
  int* sState = reinterpret_cast<int*>(sU + (size_t)SB * chunk);    // rpc
  int* sPivIdx = sState + rpc;                                       // b
  float* rows = a.work + ((size_t)q * m + r_begin) * b;
  const float* panel = a.panels + (size_t)q * a.batch_stride + (size_t)r_begin * a.lda;
  float* packed = a.packed + (size_t)q * m * b;
  // grid route: candidates [2][gridDim.y * G] as (|v| bits, row), their
  // rows [2][gridDim.y * G][SB], the unused-row counts [gridDim.y * G]
  const size_t nslot = (size_t)gridDim.y * G;
  const size_t mine = (size_t)q * G;  // this panel's first slot
  uint2* gCand = reinterpret_cast<uint2*>(a.slots);
  float* gRow = a.slots + 4 * nslot;
  int* gCount = reinterpret_cast<int*>(gRow + 2 * nslot * SB);

  // stage: the first working block (the rows in global scratch are first
  // written by the first sub-block's update, which reads the panel itself)
  copy_rows<kCopyBatch>(nrows, min(b, SB),
                        [&](int i, int c) { return panel[(size_t)i * a.lda + c]; },
                        [&](int i, int c, float v) { W[i * wr + c * wc] = v; });
  uint32_t live = 0;  // bit k: row tid + k kThreads is unused
  for (int k = 0; k < R; ++k)
    if (tid + k * kThreads < nrows) live |= 1u << k;
  __syncthreads();
  PROF_MARK(0)

  int ok = 1;
  for (int sb0 = 0; sb0 < kmax; sb0 += SB) {
    const int nj = min(SB, kmax - sb0), sbw = min(SB, b - sb0);
    const uint32_t live0 = live;
    // this thread's candidate for the next column: (|v| bits, row), the
    // largest |v| (a NaN as +inf; bits order non-negative floats as their
    // values), ties to the lowest row; (0, INT_MAX) when it has none
    unsigned cb = 0;
    int cr = INT_MAX;
    for (int k = 0; k < R; ++k)
      if (live >> k & 1) offer(cb, cr, W[(tid + k * kThreads) * wr], r_begin + tid + k * kThreads);
    for (int jl = 0; jl < nj; ++jl) {
      const int r = sb0 + jl, h = r & 1;
      // 1. this CTA's candidate, published with its working entries
      warp_argmax(cb, cr);
      if (lane == 0) {
        sRedB[warp] = cb;
        sRedR[warp] = cr;
      }
      __syncthreads();
      {  // every warp: the CTA's candidate, and its share of the publication
        unsigned bb = lane < kWarps ? sRedB[lane] : 0u;
        int br = lane < kWarps ? sRedR[lane] : INT_MAX;
        warp_argmax(bb, br);
        const float own = br != INT_MAX && lane < sbw ? W[(br - r_begin) * wr + lane * wc] : 0.0f;
        if constexpr (kCl) {
          // pushed into every CTA's slot for this CTA, warp w to CTAs w,
          // w + 8: the SB entries, then (bits, row), so that each CTA
          // reads them locally
          for (int g = warp; g < G; g += kWarps) {
            float* dst = cg::this_cluster().map_shared_rank(&sAll[h][cta][0], g);
            if (lane < sbw) dst[lane] = own;
            if (lane == 0) {
              dst[SB] = __uint_as_float(bb);
              dst[SB + 1] = __int_as_float(br);
            }
          }
        } else if (warp == 0) {
          const size_t slot = h * nslot + mine + cta;
          if (lane < sbw) __stcg(gRow + slot * SB + lane, own);
          if (lane == 0) __stcg(gCand + slot, make_uint2(bb, (unsigned)br));
        }
      }
      PROF_MARK(1)
      // 2. the exchange
      if constexpr (kCl) {
        cluster_arrive();
        cluster_wait();
      } else {
        cg::this_grid().sync();
      }
      PROF_MARK(2)
      // 3. every warp: the panel's pivot (lane g takes CTA g's candidate;
      // the best of distinct rows is the same in any order, so every warp
      // of every CTA agrees), then the pivot row's working entries: on the
      // cluster route both from this CTA's own slots, on the grid route
      // from L2
      unsigned pb = 0;
      int p = INT_MAX;
      if constexpr (kCl) {
        if (lane < G) {
          pb = __float_as_uint(sAll[h][lane][SB]);
          p = __float_as_int(sAll[h][lane][SB + 1]);
        }
      } else {
        for (int g = lane; g < G; g += 32) {
          const uint2 t = __ldcg(gCand + h * nslot + mine + g);
          if (t.x > pb || (t.x == pb && (int)t.y < p)) {
            pb = t.x;
            p = (int)t.y;
          }
        }
      }
      warp_argmax(pb, p);
      const int owner = p / rpc, lr = p - owner * rpc;
      const float* piv;
      if constexpr (kCl) {
        piv = &sAll[h][owner][0];
      } else {
        float* mine_w = sPivW + warp * SB;
        if (lane < sbw) mine_w[lane] = __ldcg(gRow + (h * nslot + mine + owner) * SB + lane);
        __syncwarp();
        piv = mine_w;
      }
      if (warp == 0) {
        if (lane < sbw) sWpiv[jl * ldp + lane] = piv[lane];
        if (lane == 0) sPivIdx[r] = p;
      }
      const float pv = piv[jl];
      ok &= pv != 0.0f;
      const float inv = 1.0f / (pv == 0.0f ? 1.0f : pv);
      if (owner == cta && lr % kThreads == tid) live &= ~(1u << (lr / kThreads));
      PROF_MARK(3)
      // 4. the multipliers of column r (kept in column r), the update of
      // the working columns > r, and this thread's candidate for column
      // r + 1 from its new entries
      float pr[SB];  // the pivot row's working entries, in registers
#pragma unroll
      for (int c4 = 0; c4 < SB; c4 += 4) {
        const float4 t = *reinterpret_cast<const float4*>(piv + c4);
        pr[c4] = t.x, pr[c4 + 1] = t.y, pr[c4 + 2] = t.z, pr[c4 + 3] = t.w;
      }
      const bool more = jl + 1 < nj;
      cb = 0;
      cr = INT_MAX;
      for (int k = 0; k < R; ++k) {
        if (!(live >> k & 1)) continue;
        float* wi = W + (tid + k * kThreads) * wr;
        const float mk = __fmul_rn(wi[jl * wc], inv);
        wi[jl * wc] = mk;
#pragma unroll
        for (int c = 1; c < SB; ++c)
          if (c > jl && c < sbw) wi[c * wc] = __fmaf_rn(-mk, pr[c], wi[c * wc]);
        if (more) offer(cb, cr, wi[(jl + 1) * wc], r_begin + tid + k * kThreads);
      }
      PROF_MARK(4)
    }

    // the end of the sub-block: the rows' states, W back to the rows
    for (int k = 0; k < R; ++k) {
      const int i = tid + k * kThreads;
      if (i < nrows) sState[i] = (live >> k & 1) ? kLive : ((live0 >> k & 1) ? kPivot : kDead);
    }
    __syncthreads();
    copy_rows<kCopyBatch>(nrows, sbw, [&](int i, int c) { return W[i * wr + c * wc]; },
                          [&](int i, int c, float v) {
                            if (sState[i] != kDead) rows[(size_t)i * b + sb0 + c] = v;
                          });
    __syncthreads();
    const int tr0 = sb0 + SB;  // the later columns: [tr0, b)
    // this CTA's pivot rows of the sub-block to packed rows sb0 + k, up to
    // the sub-block's end (U12's part goes out with each chunk)
    for (int k = warp; k < nj; k += kWarps) {
      const int p = sPivIdx[sb0 + k], owner = p / rpc, lr = p - owner * rpc;
      if (owner != cta) continue;
      for (int c = lane; c < min(tr0, b); c += 32)
        packed[(size_t)(sb0 + k) * b + c] = rows[(size_t)lr * b + c];
    }
    // the later columns' source: the panel itself in the first sub-block,
    // else the rows
    const bool first = sb0 == 0;
    const float* src = first ? panel : rows;
    const long long lds = first ? a.lda : b;
    for (int cc = tr0; cc < b; cc += chunk) {
      const int cw = min(chunk, b - cc);
      // U12 = L11^-1 T, T the pivot rows' entries of the chunk: a thread a
      // column
      for (int c = tid; c < cw; c += kThreads) {
        float u[SB];
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          if (k < nj) {
            const int p = sPivIdx[sb0 + k];
            u[k] = first ? a.panels[(size_t)q * a.batch_stride + (size_t)p * a.lda + cc + c]
                         : __ldcg(a.work + ((size_t)q * m + p) * b + cc + c);
          }
        }
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          if (k < nj) {
#pragma unroll
            for (int j4 = 0; j4 < k; j4 += 4) {  // L[k, j4..j4+3], one 16-byte load
              const float4 l4 = *reinterpret_cast<const float4*>(sWpiv + k * ldp + j4);
              const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j4 + e < k) u[k] = __fmaf_rn(-l[e], u[j4 + e], u[k]);
            }
            sU[(size_t)k * chunk + c] = u[k];
          }
        }
      }
      __syncthreads();
      // the unused rows' chunk -= L21 U12: 8-row by 4-column tiles, a
      // warp's lanes on consecutive columns, the next tile's entries loaded
      // before this one's products
      const int nct = (cw + 32 * kTileCols - 1) / (32 * kTileCols);
      const int ntile = (nrows + kTileRows - 1) / kTileRows * nct;
      auto load_tile = [&](int t, float (&x)[kTileRows][kTileCols]) {
        const int i0 = t / nct * kTileRows, c0 = t % nct * 32 * kTileCols + lane;
#pragma unroll
        for (int u = 0; u < kTileRows; ++u) {
          const int i = i0 + u;
          const bool rl = i < nrows && sState[i] == kLive;
#pragma unroll
          for (int v = 0; v < kTileCols; ++v) {
            const int c = c0 + 32 * v;
            x[u][v] = rl && c < cw ? src[(size_t)i * lds + cc + c] : 0.0f;
          }
        }
      };
      float acc[kTileRows][kTileCols];
      if (warp < ntile) load_tile(warp, acc);
      for (int t = warp; t < ntile; t += kWarps) {
        float nx[kTileRows][kTileCols];
        if (t + kWarps < ntile) load_tile(t + kWarps, nx);
        const int i0 = t / nct * kTileRows, c0 = t % nct * 32 * kTileCols + lane;
        bool rl[kTileRows];
#pragma unroll
        for (int u = 0; u < kTileRows; ++u) rl[u] = i0 + u < nrows && sState[i0 + u] == kLive;
#pragma unroll 8
        for (int j = 0; j < nj; ++j) {
          float mu[kTileRows], uv[kTileCols];
#pragma unroll
          for (int u = 0; u < kTileRows; ++u) mu[u] = rl[u] ? W[(i0 + u) * wr + j * wc] : 0.0f;
#pragma unroll
          for (int v = 0; v < kTileCols; ++v) {
            const int c = c0 + 32 * v;
            uv[v] = c < cw ? sU[(size_t)j * chunk + c] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kTileRows; ++u)
#pragma unroll
            for (int v = 0; v < kTileCols; ++v) acc[u][v] = __fmaf_rn(-mu[u], uv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < kTileRows; ++u)
#pragma unroll
          for (int v = 0; v < kTileCols; ++v) {
            const int c = c0 + 32 * v;
            if (rl[u] && c < cw) rows[(size_t)(i0 + u) * b + cc + c] = acc[u][v];
          }
#pragma unroll
        for (int u = 0; u < kTileRows; ++u)
#pragma unroll
          for (int v = 0; v < kTileCols; ++v) acc[u][v] = nx[u][v];
      }
      // U12's rows of this CTA's pivots go out
      for (int k = warp; k < nj; k += kWarps) {
        const int p = sPivIdx[sb0 + k];
        if (p / rpc != cta) continue;
        for (int c = lane; c < cw; c += 32)
          packed[(size_t)(sb0 + k) * b + cc + c] = sU[(size_t)k * chunk + c];
      }
      __syncthreads();
    }
    // the next working block, for the unused rows only
    if (sb0 + SB < kmax) {
      copy_rows<kCopyBatch>(
          nrows, min(SB, b - tr0),
          [&](int i, int c) { return sState[i] == kLive ? rows[(size_t)i * b + tr0 + c] : 0.0f; },
          [&](int i, int c, float v) {
            if (sState[i] == kLive) W[i * wr + c * wc] = v;
          });
      __syncthreads();
    }
    PROF_MARK(5)
  }

  // the unused rows, in order, after row kmax: this CTA's count, its offset
  // from the lower CTAs' counts (one more exchange), each row's place. A
  // thread takes a contiguous run of rows here.
  const int run0 = min(tid * R, nrows), run1 = min(run0 + R, nrows);
  int cnt = 0;
  for (int i = run0; i < run1; ++i) cnt += sState[i] == kLive;
  int incl = cnt;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) sWarpCnt[warp] = incl;
  __syncthreads();
  int before = incl - cnt, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sWarpCnt[w];
    total += sWarpCnt[w];
  }
  int offset = 0;
  if constexpr (kCl) {
    if (tid == 0) sCount = total;
    cluster_arrive();
    cluster_wait();
    for (int g = 0; g < cta; ++g) offset += *cg::this_cluster().map_shared_rank(&sCount, g);
  } else {
    if (tid == 0) __stcg(gCount + mine + cta, total);
    cg::this_grid().sync();
    for (int g = 0; g < cta; ++g) offset += __ldcg(gCount + mine + g);
  }
  // sState now holds each unused row's packed row (-1 for the others)
  for (int i = run0, d = kmax + offset + before; i < run1; ++i)
    sState[i] = sState[i] == kLive ? d++ : -1;
  __syncthreads();
  copy_rows<kCopyBatch>(
      nrows, b, [&](int i, int c) { return sState[i] >= 0 ? rows[(size_t)i * b + c] : 0.0f; },
      [&](int i, int c, float v) {
        const int d = sState[i];
        if (d < 0) return;
        packed[(size_t)d * b + c] = v;
        if (c == 0) a.perm[(size_t)q * m + d] = r_begin + i;
      });
  if (cta == 0)
    for (int k = tid; k < kmax; k += kThreads) a.perm[(size_t)q * m + k] = sPivIdx[k];
  // nt = m - (cycles of perm), by pointer doubling over cycle-minimum
  // labels (as perm_transposition_count): every CTA of the panel takes
  // positions gt, gt + G kThreads, ... of two buffers each in global
  // scratch, one panel barrier a round
  auto panel_sync = [&]() {
    if constexpr (kCl) {
      cluster_arrive();
      cluster_wait();
    } else {
      cg::this_grid().sync();
    }
  };
  panel_sync();  // every row of perm written
  int* nxt = a.cyc + (size_t)q * 4 * m;
  int* mn = nxt + 2 * m;  // nxt and mn: two buffers each, by the round's parity
  const int gt = cta * kThreads + tid, gs = G * kThreads;
  for (int i = gt; i < m; i += gs) {
    nxt[i] = (int)__ldcg(a.perm + (size_t)q * m + i);
    mn[i] = i;
  }
  panel_sync();
  const int rounds = m > 1 ? 32 - __clz(m - 1) : 1;
  for (int t = 0; t < rounds; ++t) {
    const int *nc = nxt + (t & 1) * m, *mc = mn + (t & 1) * m;
    int *nn = nxt + (~t & 1) * m, *mnn = mn + (~t & 1) * m;
    for (int i0 = gt; i0 < m; i0 += kCopyBatch * gs) {
      int j[kCopyBatch], lo[kCopyBatch], lj[kCopyBatch], nj2[kCopyBatch];
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        const int i = i0 + u * gs;
        j[u] = i < m ? __ldcg(nc + i) : 0;
        lo[u] = i < m ? __ldcg(mc + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        lj[u] = __ldcg(mc + j[u]);
        nj2[u] = __ldcg(nc + j[u]);
      }
#pragma unroll
      for (int u = 0; u < kCopyBatch; ++u) {
        const int i = i0 + u * gs;
        if (i < m) {
          mnn[i] = min(lo[u], lj[u]);
          nn[i] = nj2[u];
        }
      }
    }
    panel_sync();
  }
  const int* mc = mn + (rounds & 1) * m;
  int leaders = 0;  // one position a cycle holds its cycle's minimum label
  for (int i = gt; i < m; i += gs) leaders += __ldcg(mc + i) == i;
  leaders = __reduce_add_sync(kFull, leaders);
  if (lane == 0) sWarpCnt[warp] = leaders;
  __syncthreads();
  if (tid == 0) {
    int cycles = 0;
    for (int w = 0; w < kWarps; ++w) cycles += sWarpCnt[w];
    if constexpr (kCl) sCount = cycles;
    else __stcg(gCount + mine + cta, cycles);
  }
  panel_sync();
  if (cta == 0 && tid == 0) {
    int cycles = 0;
    for (int g = 0; g < G; ++g)
      if constexpr (kCl) cycles += *cg::this_cluster().map_shared_rank(&sCount, g);
      else cycles += __ldcg(gCount + mine + g);
    a.nt[q] = m - cycles;
    a.ok[q] = ok;
  }
  if constexpr (kCl) {  // no CTA leaves while CTA 0 may still read it
    cluster_arrive();
    cluster_wait();
  }
  PROF_MARK(6)
  PROF_END
}

using Kernel = void (*)(Args);

Kernel kernel_for(int route) {
  if (route == kCluster) return lu_panel_kernel<true, false>;
  return route == kGridGlobalW ? lu_panel_kernel<false, true> : lu_panel_kernel<false, false>;
}

// How many clusters of g CTAs, each of kThreads threads and smem bytes of
// shared memory, the current device can hold at once (the kernel's
// attributes set).
cudaError_t active_clusters(int g, int smem, int* n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(g);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel_for(kCluster), &cfg);
}

struct DeviceInfo {
  bool known = false;
  int sms = 0, smem_max = 0, max_cluster = 0;
};

// Per device: SMs, the dynamic shared memory a CTA can take (the opt-in
// limit less the kernel's static shared memory), and the largest cluster
// (16, 8, 4, 2 or 1) the card places with a CTA of kThreads threads and
// that shared memory on each SM. Sets every instantiation's attributes once.
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
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel_for(kCluster));
  if (err != cudaSuccess) return err;
  d.smem_max -= (int)fa.sharedSizeBytes;
  for (int k : {kCluster, kGrid, kGridGlobalW}) {
    err = cudaFuncSetAttribute(kernel_for(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_max);
    if (err == cudaSuccess && k == kCluster)
      err = cudaFuncSetAttribute(kernel_for(k), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  for (int g = kMaxCluster; g >= 1 && !d.max_cluster; g /= 2) {
    int n = 0;
    err = active_clusters(g, d.smem_max, &n);
    if (err != cudaSuccess) return err;
    if (n >= 1) d.max_cluster = g;
  }
  d.known = true;
  if (dev < kMaxDevices) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

struct Plan {
  int route, ctas, rpc;
  long long smem_bytes, scratch_floats, work_floats, slot_floats, wglob_floats;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The route of g (m, b) panels on the current device, the first that holds
// them of:
//  1. the cluster route, when the largest cluster the card places takes the
//     rows with a CTA's W in its shared memory and at most kClusterMaxRows
//     rows a CTA;
//  2. the grid route, one CTA an SM, when the g x G CTAs' W fit theirs;
//  3. the cluster route past kClusterMaxRows rows a CTA (a batch of more
//     panels than the grid route holds one CTA an SM);
//  4. the grid route with W in global scratch, as many CTAs an SM as are
//     co-resident, at most kMaxRowsPerCta rows a CTA;
// else refused: m > kMaxRowsPerCta x (CTAs co-resident) / g, or b so wide
// that a CTA's U12 chunk and step indices alone exceed its shared memory.
cudaError_t plan_of(int g, int m, int b, Plan* pl) {
  *pl = Plan{kRefused, 0, 0, 0, 0, 0, 0, 0};
  if (g < 1 || m < 1 || b < 1 || g > 65535) return cudaSuccess;
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return err;
  bool force_grid = false;
#ifdef FAER_LU_PROFILE
  force_grid = g_force_grid;
#endif
  const long long cap = d.smem_max / 4;
  // the most rows a CTA holds with W in shared memory
  long long fit = 0, hi = kMaxRowsPerCta;
  while (fit < hi) {
    const long long mid = (fit + hi + 1) / 2;
    if (smem_floats(b, mid, true) <= cap) fit = mid; else hi = mid - 1;
  }
  const long long work = ((long long)g * m * b + 3) & ~3LL;  // keeps the slots 16-byte aligned
  const long long cyc = 4LL * g * m;  // the cycle count's ints
  const bool cluster_holds = !force_grid && fit >= 1 && cdiv(m, fit) <= d.max_cluster;
  long long n = cdiv(m, kGridMinRows);
  n = n < d.sms / g ? n : d.sms / g;
  const bool grid_holds = n >= 1 && cdiv(m, n) <= fit;
  if (cluster_holds && (cdiv(m, d.max_cluster) <= kClusterMaxRows || !grid_holds)) {
    long long nc = cdiv(m, kClusterMinRows);
    nc = nc < d.max_cluster ? nc : d.max_cluster;
    nc = nc > cdiv(m, fit) ? nc : cdiv(m, fit);
    const long long rpc = cdiv(m, nc);
    *pl = Plan{kCluster, (int)cdiv(m, rpc), (int)rpc, smem_floats(b, rpc, true) * 4,
               work + cyc, work, 0, 0};
    return cudaSuccess;
  }
  int route = kGrid;
  if (!grid_holds) {
    // W in global scratch: the CTAs an SM the device holds at the most
    // rows a CTA
    const long long smem = smem_floats(b, kMaxRowsPerCta, false);
    int per_sm = 0;
    if (smem <= cap) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_for(kGridGlobalW), kThreads, (size_t)smem * 4);
      if (err != cudaSuccess) return err;
    }
    n = cdiv(m, kGridMinRows);
    const long long held = (long long)d.sms * per_sm / g;
    n = n < held ? n : held;
    if (n < 1 || cdiv(m, n) > kMaxRowsPerCta) return cudaSuccess;
    route = kGridGlobalW;
  }
  const long long rpc = cdiv(m, n);
  n = cdiv(m, rpc);
  const bool smem_w = route == kGrid;
  // candidates (2 floats) and their rows (SB) by parity, the counts
  const long long slots = ((long long)g * n * (2 * 2 + 2 * SB + 1) + 3) & ~3LL;
  const long long wglob = smem_w ? 0 : g * n * w_floats(rpc);
  *pl = Plan{route, (int)n, (int)rpc, smem_floats(b, rpc, smem_w) * 4,
             work + slots + wglob + cyc, work, slots, wglob};
  return cudaSuccess;
}

}  // namespace

// The route of g (m, b) panels on the current device (plan_of): 1 cluster,
// 0 grid, 2 grid with W in global scratch, -1 refused (g, m or b < 1,
// g > 65535, or a shape past plan_of's last route), or -(CUDA error) - 2
// if the device query failed.
// ctas and scratch_floats (either may be null) get the CTAs a panel and the
// floats of global scratch faer_lu_panel_batched needs.
extern "C" int faer_lu_panel_route(int g, int m, int b, int* ctas, long long* scratch_floats) {
  Plan pl;
  const cudaError_t err = plan_of(g, m, b, &pl);
  if (err != cudaSuccess) return -(int)err - 2;
  if (ctas) *ctas = pl.ctas;
  if (scratch_floats) *scratch_floats = pl.scratch_floats;
  return pl.route;
}

// The largest cluster the cluster route uses on the current device, and how
// many clusters of `size` CTAs (1..16) at the most shared memory a CTA can
// take the device holds at once (cudaOccupancyMaxActiveClusters). Returns
// the CUDA error (0 on success).
extern "C" int faer_lu_panel_clusters(int size, int* max_cluster, int* active) {
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err == cudaSuccess) err = active_clusters(size, d.smem_max, active);
  if (err == cudaSuccess) *max_cluster = d.max_cluster;
  return (int)err;
}

// panels: g panels of (m, b) f32, panel q at panels + q * batch_stride, row
// stride lda >= b, rows contiguous; packed: (g, m, b) contiguous; perm:
// int64 (g, m); nt: int (g,), each perm's minimal transposition count; ok:
// bool (g,), no pivot exactly zero; scratch: scratch_floats floats of global
// memory, at least what faer_lu_panel_route gives (may be null when that is
// 0); all on the current device (the caller selects it). Returns the CUDA
// error of the launch, 100000 if the grid route's CTAs cannot be
// co-resident, 0 on success.
extern "C" int faer_lu_panel_batched(const float* panels, long long batch_stride,
                                     long long lda, float* packed, long long* perm, int* nt,
                                     unsigned char* ok, float* scratch,
                                     long long scratch_floats, int g, int m, int b,
                                     void* stream) {
  Plan pl;
  cudaError_t err = plan_of(g, m, b, &pl);
  if (err != cudaSuccess) return err;
  if (pl.route == kRefused || lda < b || scratch_floats < pl.scratch_floats ||
      (pl.scratch_floats > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  Args args{panels, batch_stride, lda, packed, perm, nt, ok, scratch,
            scratch + pl.work_floats, scratch + pl.work_floats + pl.slot_floats,
            reinterpret_cast<int*>(scratch + pl.work_floats + pl.slot_floats +
                                   pl.wglob_floats),
            m, b, pl.rpc};
  const Kernel kern = kernel_for(pl.route);
  if (pl.route == kCluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(pl.ctas, g);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)pl.smem_bytes;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, args);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  int per_sm = 0, sms = 0, device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        (size_t)pl.smem_bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < (long long)pl.ctas * g) return kNotCoResident;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(pl.ctas, g), dim3(kThreads), kargs,
                                    (size_t)pl.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FAER_LU_PROFILE
// Copies the 7 phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_lu_panel_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[7] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}

// For every later plan: a non-zero `on` sends every shape to the grid
// route (W in shared memory where it fits), 0 restores the plan's own.
extern "C" void faer_lu_panel_profile_force_grid(int on) { g_force_grid = on; }

#endif
