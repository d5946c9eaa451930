// lu_panel_swap: partial-pivot LU of an (m, b) f32 panel that swaps rows.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `lu_panel_pallas` (:81,
// body `_lu_panel_kernel` :35), the first LU panel kernel. Unlike the
// virtual-pivot kernels it swaps rows physically: at column j it picks the
// position p >= j with the largest |A[p, j]| in the current row order (ties
// to the lowest position, as jax.lax.argmax; a NaN counts as +inf), swaps
// rows j and p and their perm entries, counts the swap when p != j, writes
// the multipliers A[i, j] / A[j, j] below the pivot and applies one rank-1
// update to the trailing rows and columns. nt is that swap count, not the
// transposition count of the final permutation (the same parity, another
// number), and perm is the identity with every swap applied. kmax =
// min(m, b) steps, each updating all b columns, as the Pallas body does: a
// wide panel (m < b) comes back whole.
//
// What bounds it on the H100: the b pivot searches over all m rows form a
// chain of b exchanges between SMs; a (4096, 128) panel's 67 MFLOP and 4 MiB
// of traffic (0.001 ms) are far below it. So the design keeps each column to
// one exchange and moves no row between SMs.
//
// Design: CTA x holds rows [x rpc, (x + 1) rpc) of the panel, in its shared
// memory (16-byte rows an odd number of 16-byte chunks apart, so that 8
// threads on 8 consecutive rows meet in no bank) or, past it, in a global
// scratch. A row never moves: a swap relabels. Each held row carries its
// current position (its label); its perm entry is its original row. After
// the pivot p of column j is known, the row labelled p is final (row j of
// the result: its multipliers left of j and its U entries from j on are
// never written again), so the CTA that holds it writes it straight to
// packed row j with perm[j], and the row labelled j takes the label p: the
// physical swap of the reference, with no data moved. A thread holds a row
// (with fewer rows than threads, P threads share one, each a run of its
// 16-byte column groups). Per column j, one exchange:
//  1. each thread's candidate (the largest |v| of its live rows' entry j, a
//     NaN as +inf, ties to the lowest label) was found by the update of the
//     last column; a warp reduction, one block barrier, and every warp
//     reduces the warps' candidates again. Cluster route: the CTA's
//     candidate (|v| bits, label) and its row's entries j..b - 1 are pushed
//     into a slot of every CTA's shared memory (warp w to CTAs w, w + 8;
//     st.shared::cluster), by the parity of the column. Grid route: the same
//     into global scratch with __stcg;
//  2. barrier.cluster arrive.release / wait.acquire, or grid.sync();
//  3. every warp reduces the G candidates (lane g takes CTA g's): the best of
//     distinct labels is the same in any order, so every warp of every CTA
//     agrees with no further barrier; the winner's slot holds the pivot and
//     the pivot row's entries (the grid route stages them in shared memory,
//     one more block barrier);
//  4. the winner's holder writes it out (a warp along the columns) and drops
//     it; the row labelled j takes label p; each thread's live rows get
//     their multiplier A[i, j] / pivot (IEEE division, __fdiv_rn) in column
//     j and the rank-1 update of their columns, 16 bytes at a time, A[i, c]
//     = __fsub_rn(A[i, c], __fmul_rn(l_i, u_c)): the product rounded before
//     the subtraction, as the plain version's two PyTorch operations; then
//     the thread offers its row's new entry j + 1 as its next candidate.
// At the end each CTA writes its live rows (labels >= kmax) to their packed
// rows with perm; CTA 0 writes nt and ok. Every element sees exactly the
// plain version's IEEE operations in its order and the pivot search is
// exact, so packed, perm, nt and ok equal lu_panel_swap_plain's to the bit,
// whatever the route and the input.
//
// Where the time goes (H100, (4096, 128), the cluster route, 0.36 ms): the
// exchange alone, the update left out, takes 0.264 ms, 2.1 us a column; the
// update the rest. Pulling the winner's row from its holder's shared memory
// after the barrier (ld.shared::cluster) in place of pushing every
// candidate's row before it took 0.425 ms: the pull's latency comes after
// the barrier, on the chain.
//
// Built with -DFAER_LU_SWAP_PROFILE (`tools/torch_profile.py lu_swap` does,
// into a library of its own), thread 0 of each CTA adds its cycles by phase
// into g_prof, read by faer_lu_panel_swap_profile_read.
//
// Two routes, decided in plan_of from (m, b) and the device alone
// (faer_lu_panel_swap_route tells callers which; a launch the route cannot
// make fails, nothing retries on the other route):
//  - cluster: one thread-block cluster of up to 16 CTAs, at least
//    kClusterMinRows rows a CTA, at most kClusterMaxRows, the rows and the
//    candidates' slots in shared memory (m up to 6 144 at b = 128, 3 040 at
//    b = 256 on an H100);
//  - grid: one cooperative grid, one CTA an SM, at least kGridMinRows rows
//    a CTA, the rows in shared memory where they fit, else in global
//    scratch; refused past kMaxRowsPerCta rows a CTA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

#ifdef FAER_LU_SWAP_PROFILE
// 0 stage, 1 local candidate and its push, 2 exchange wait, 3 the pivot and
// its row, 4 the pivot row out, 5 multipliers, update and next candidates,
// 6 final write: thread 0's cycles, summed over CTAs and launches
__device__ long long g_prof[7];
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
constexpr int kMaxCluster = 16;  // non-portable; 8 is the portable size
constexpr int kClusterMinRows = 64;
constexpr int kClusterMaxRows = 384;
constexpr int kGridMinRows = 8;
constexpr int kMaxGrid = 256;  // CTAs of the grid route, at most
constexpr int kBatch = 4;      // 16-byte column groups a thread updates at once
constexpr int kMaxRowsPerCta = 1 << 16;
constexpr int kMaxDevices = 64;
constexpr int kNotCoResident = 100000;
constexpr unsigned kFull = 0xffffffffu;

// faer_lu_panel_swap_route's codes
enum Route { kRefused = -1, kGrid = 0, kCluster = 1, kGridGlobalRows = 2 };

struct Args {
  const float* panel;
  long long lda;
  float* packed;        // (m, b)
  long long* perm;      // (m,)
  int* nt;              // (1,)
  unsigned char* ok;    // (1,), bool
  float* rows;          // grid route, rows in global memory: (G rpc, b)
  uint2* cand;          // grid route: [2][G] (|v| bits, label)
  float* cand_rows;     // grid route: [2][G][slot_ld(b)]
  int m, b, rpc;
};

// The row stride of the held rows: a multiple of 4 floats (16-byte rows)
// that is an odd number of 16-byte chunks, so that 8 threads reading 16
// bytes of 8 consecutive rows at one column meet in no bank.
__host__ __device__ constexpr int row_ld(int b) { return 4 * (((b + 3) / 4) | 1); }

// A candidate's slot: entries 0..b-1 at 16-byte alignment, then its |v|
// bits and label.
__host__ __device__ constexpr int slot_ld(int b) { return 4 * ((b + 3) / 4) + 4; }

// The shared-memory floats of a CTA of rpc rows: the rows (when held there),
// the slots (a cluster of g CTAs: every CTA's candidate, by parity; the grid
// route, g = 0: the pivot row), the threads' labels.
__host__ __device__ constexpr long long smem_floats(int b, long long rpc, int g, bool rows) {
  return (rows ? rpc * row_ld(b) : 0) + (g > 0 ? 2LL * g : 1LL) * slot_ld(b) +
         (rpc > kThreads ? rpc : kThreads);
}

// A candidate is (bits of |v|, label, slot): the larger bits win (a NaN as
// +inf; the bits of non-negative floats order as their values), ties go to
// the lower label, and (0, INT_MAX) is no candidate.
__device__ __forceinline__ void offer(unsigned& cb, int& cl, int& cs, float x, int label,
                                      int slot) {
  float v = fabsf(x);
  if (v != v) v = INFINITY;
  const unsigned bits = __float_as_uint(v);
  if (bits > cb || (bits == cb && label < cl)) {
    cb = bits;
    cl = label;
    cs = slot;
  }
}

// The warp's best candidate, in every lane; `slot` comes from the lane that
// held it (labels are distinct).
__device__ __forceinline__ void warp_argmax(unsigned& cb, int& cl, int& cs) {
  const unsigned best = __reduce_max_sync(kFull, cb);
  const int lab = __reduce_min_sync(kFull, cb == best ? cl : INT_MAX);
  const unsigned from = __ballot_sync(kFull, cb == best && cl == lab);
  cs = __shfl_sync(kFull, cs, __ffs(from) - 1);
  cb = best;
  cl = lab;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kCl: the cluster route, else the grid route; kGR: the rows in global
// scratch (grid route only)
template <bool kCl, bool kGR>
__global__ void __launch_bounds__(kThreads, 1) lu_swap_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned sRedB[kWarps];
  __shared__ int sRedL[kWarps], sRedS[kWarps];
  const int m = a.m, b = a.b, rpc = a.rpc, kmax = min(m, b);
  const int G = gridDim.x, cta = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  const int ldr = row_ld(b), sld = slot_ld(b);
  float* R = kGR ? a.rows + (size_t)r_begin * ldr : smem;
  // cluster: every CTA's candidate slot [2][G][sld]; grid: the pivot row
  float* sAll = smem + (kGR ? 0 : (size_t)rpc * ldr);
  int* sLab = reinterpret_cast<int*>(sAll + (kCl ? 2 * G * sld : sld));
  // a thread a row, for rows [0, R2) of every pass of R2 rows, and a part of
  // the columns: with fewer rows than threads, P threads share a row, each
  // with its own run of 16-byte column groups
  const int R2 = rpc >= kThreads ? kThreads : 1 << (32 - __clz(rpc - 1));
  const int P = kThreads / R2, part = tid / R2, rsub = tid % R2;
  const int ng = (b + 3) / 4;
  const int cbeg = 4 * (part * ng / P), cend = min(b, 4 * ((part + 1) * ng / P));
  // each thread's labels: its rows' current positions (-1 once written
  // out), private to the thread (entry s, or tid when P threads share rows)
  auto label_of = [&](int s) -> int& { return sLab[P == 1 ? s : tid]; };
#ifdef FAER_LU_SWAP_PROFILE
  long long prof[7] = {0};
#endif
  PROF_START

  // the rows: into shared memory by cp.async, all in flight at once (16
  // bytes a copy where the panel's rows are 16-byte aligned, 4 else); into
  // global scratch a warp a row, lanes along the columns
  if constexpr (!kGR) {
    const bool v4 = (a.lda & 3) == 0 && (reinterpret_cast<uintptr_t>(a.panel) & 15) == 0;
    const int whole = v4 ? b / 4 : 0, per = whole + (b - 4 * whole);  // copies a row
    for (int idx = tid; idx < nrows * per; idx += kThreads) {
      const int i = idx / per, e = idx % per;
      const float* src = a.panel + (size_t)(r_begin + i) * a.lda;
      float* dst = R + (size_t)i * ldr;
      if (e < whole) {
        hopper::cp_async16(dst + 4 * e, src + 4 * e, 16);
      } else {
        const int c = 4 * whole + e - whole;
        hopper::cp_async4(dst + c, src + c, true);
      }
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  } else {
    for (int i = warp; i < nrows; i += kWarps)
      for (int c = lane; c < b; c += 32) R[(size_t)i * ldr + c] = a.panel[(size_t)(r_begin + i) * a.lda + c];
  }
  for (int s = rsub; s < nrows; s += R2) label_of(s) = r_begin + s;
  __syncthreads();
  unsigned cb = 0;
  int cl = INT_MAX, cs = -1;
  if (part == 0)
    for (int s = rsub; s < nrows; s += R2) offer(cb, cl, cs, R[(size_t)s * ldr], r_begin + s, s);

  PROF_MARK(0)
  int ok = 1, nt = 0;
  // a multiplier whose write waits for the next block barrier, when other
  // threads of its row still read the entry it replaces (P > 1)
  int pend = -1;
  float pend_v = 0.0f;
  for (int j = 0; j < kmax; ++j) {
    const int h = j & 1;
    // 1. the CTA's candidate, published with its row's entries from j on
    warp_argmax(cb, cl, cs);
    if (lane == 0) {
      sRedB[warp] = cb;
      sRedL[warp] = cl;
      sRedS[warp] = cs;
    }
    __syncthreads();
    if (pend >= 0) {
      R[pend] = pend_v;
      pend = -1;
    }
    unsigned bb = lane < kWarps ? sRedB[lane] : 0u;
    int bl = lane < kWarps ? sRedL[lane] : INT_MAX, bs = lane < kWarps ? sRedS[lane] : -1;
    warp_argmax(bb, bl, bs);
    const float* crow = R + (size_t)max(bs, 0) * ldr;
    // 16-byte column group q of the candidate's row; in the group of
    // column j only the entries from j on (the one left of j may be a
    // multiplier being written, and no one reads it from the slot)
    auto group = [&](int q) -> float4 {
      if (bs < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (4 * q >= j) return *reinterpret_cast<const float4*>(crow + 4 * q);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 4 * q + e >= j ? crow[4 * q + e] : 0.0f;
      return make_float4(v[0], v[1], v[2], v[3]);
    };
    if constexpr (kCl) {
      for (int g = warp; g < G; g += kWarps) {
        float* dst = cg::this_cluster().map_shared_rank(sAll + (size_t)(h * G + cta) * sld, g);
        for (int q = j / 4 + lane; q < ng; q += 32) *reinterpret_cast<float4*>(dst + 4 * q) = group(q);
        if (lane == 0) {
          dst[sld - 4] = __uint_as_float(bb);
          dst[sld - 3] = __int_as_float(bl);
        }
      }
    } else if (warp == 0) {
      float* dst = a.cand_rows + ((size_t)h * G + cta) * sld;
      for (int q = j / 4 + lane; q < ng; q += 32) __stcg(reinterpret_cast<float4*>(dst + 4 * q), group(q));
      if (lane == 0) __stcg(a.cand + (size_t)h * G + cta, make_uint2(bb, (unsigned)bl));
    }
    PROF_MARK(1)
    // 2. the exchange
    if constexpr (kCl) {
      cluster_sync();
    } else {
      cg::this_grid().sync();
    }
    PROF_MARK(2)
    // 3. every warp: the pivot (lane g takes CTA g's candidate, all of a
    // lane's loads in flight at once on the grid route) and its row's
    // entries, on the grid route staged in shared memory
    unsigned pb = 0;
    int p = INT_MAX, pg = -1;
    if constexpr (kCl) {
      if (lane < G) {
        const float* slot = sAll + (size_t)(h * G + lane) * sld;
        pb = __float_as_uint(slot[sld - 4]);
        p = __float_as_int(slot[sld - 3]);
        pg = lane;
      }
    } else {
      uint2 t[kMaxGrid / 32];
#pragma unroll
      for (int k = 0; k < kMaxGrid / 32; ++k) {
        const int g = lane + 32 * k;
        t[k] = g < G ? __ldcg(a.cand + (size_t)h * G + g) : make_uint2(0u, (unsigned)INT_MAX);
      }
#pragma unroll
      for (int k = 0; k < kMaxGrid / 32; ++k)
        if (t[k].x > pb || (t[k].x == pb && (int)t[k].y < p)) {
          pb = t[k].x;
          p = (int)t[k].y;
          pg = lane + 32 * k;
        }
    }
    warp_argmax(pb, p, pg);
    const float* piv = sAll + (kCl ? (size_t)(h * G + pg) * sld : 0);
    if constexpr (!kCl) {
      const float* src = a.cand_rows + ((size_t)h * G + pg) * sld;
      for (int q = j / 4 + tid; q < ng; q += kThreads)
        *reinterpret_cast<float4*>(sAll + 4 * q) = __ldcg(reinterpret_cast<const float4*>(src + 4 * q));
      __syncthreads();
    }
    auto piv1 = [&](int c) { return piv[c]; };
    auto piv4 = [&](int c) { return *reinterpret_cast<const float4*>(piv + c); };
    const float pv = piv1(j);
    ok &= pv != 0.0f;
    const float safe = pv == 0.0f ? 1.0f : pv;
    if (p != j) ++nt;
    PROF_MARK(3)
    // 4. the pivot row is final: row j of the result. Its holder writes it
    // out, a whole warp along the columns (a part of the columns each when
    // P threads share it)
    int ws = -1;
    for (int s = rsub; s < nrows; s += R2)
      if (label_of(s) == p) {
        label_of(s) = -1;
        ws = s;
      }
    float* prow = a.packed + (size_t)j * b;
    if (P == 1) {
      const unsigned wm = __ballot_sync(kFull, ws >= 0);
      if (wm) {
        const int s = __shfl_sync(kFull, ws, __ffs(wm) - 1);
        const float* row = R + (size_t)s * ldr;
        __syncwarp();  // the row's last writes were its thread's
        if ((b & 3) == 0) {
          for (int q = lane; q < ng; q += 32)
            *reinterpret_cast<float4*>(prow + 4 * q) = *reinterpret_cast<const float4*>(row + 4 * q);
        } else {
          for (int c = lane; c < b; c += 32) prow[c] = row[c];
        }
        if (lane == 0) a.perm[j] = r_begin + s;
      }
    } else if (ws >= 0) {
      const float* row = R + (size_t)ws * ldr;
      for (int c = cbeg; c < cend; ++c) prow[c] = row[c];
      if (part == 0) a.perm[j] = r_begin + ws;
    }
    PROF_MARK(4)
    // 5. this thread's other rows: the relabel, the multiplier, the update
    // of its columns, its candidate for column j + 1
    cb = 0;
    cl = INT_MAX;
    cs = -1;
    const bool offers = j + 1 < kmax && cbeg <= j + 1 && j + 1 < cend;
    for (int s = rsub; s < nrows; s += R2) {
      int& lab = label_of(s);
      float* row = R + (size_t)s * ldr;
      if (lab == j) lab = p;  // the row at position j moves to position p
      if (lab <= j) continue;  // written out (-1)
      const float lm = __fdiv_rn(row[j], safe);
      if (cbeg <= j && j < cend) {
        if (P == 1) {
          row[j] = lm;
        } else {
          pend = (int)((size_t)s * ldr + j);
          pend_v = lm;
        }
      }
      int c = max(j + 1, cbeg);
      for (; c < cend && (c & 3); ++c) row[c] = __fsub_rn(row[c], __fmul_rn(lm, piv1(c)));
      // kBatch 16-byte groups at a time, every load before the first store,
      // so that their latencies overlap
      for (; c + 4 * kBatch <= cend; c += 4 * kBatch) {
        float4 r4[kBatch], u4[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          r4[q] = *reinterpret_cast<const float4*>(row + c + 4 * q);
          u4[q] = piv4(c + 4 * q);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          r4[q].x = __fsub_rn(r4[q].x, __fmul_rn(lm, u4[q].x));
          r4[q].y = __fsub_rn(r4[q].y, __fmul_rn(lm, u4[q].y));
          r4[q].z = __fsub_rn(r4[q].z, __fmul_rn(lm, u4[q].z));
          r4[q].w = __fsub_rn(r4[q].w, __fmul_rn(lm, u4[q].w));
          *reinterpret_cast<float4*>(row + c + 4 * q) = r4[q];
        }
      }
      for (; c + 3 < cend; c += 4) {
        float4 r4 = *reinterpret_cast<const float4*>(row + c);
        const float4 u4 = piv4(c);
        r4.x = __fsub_rn(r4.x, __fmul_rn(lm, u4.x));
        r4.y = __fsub_rn(r4.y, __fmul_rn(lm, u4.y));
        r4.z = __fsub_rn(r4.z, __fmul_rn(lm, u4.z));
        r4.w = __fsub_rn(r4.w, __fmul_rn(lm, u4.w));
        *reinterpret_cast<float4*>(row + c) = r4;
      }
      for (; c < cend; ++c) row[c] = __fsub_rn(row[c], __fmul_rn(lm, piv1(c)));
      if (offers) offer(cb, cl, cs, row[j + 1], lab, s);
    }
    PROF_MARK(5)
  }

  // the rows left, each to its packed row with its perm entry: a warp a row
  // along the columns, or each thread its part of the columns
  __syncthreads();
  if (pend >= 0) R[pend] = pend_v;
  __syncthreads();
  if (P == 1) {
    for (int s0 = 0; s0 < nrows; s0 += kThreads) {
      const int lab = s0 + tid < nrows ? label_of(s0 + tid) : -1;
      for (unsigned mk = __ballot_sync(kFull, lab >= 0); mk; mk &= mk - 1) {
        const int q = __ffs(mk) - 1, s = s0 + warp * 32 + q;
        const int d = __shfl_sync(kFull, lab, q);
        const float* row = R + (size_t)s * ldr;
        float* dst = a.packed + (size_t)d * b;
        if ((b & 3) == 0) {
          for (int g = lane; g < ng; g += 32)
            *reinterpret_cast<float4*>(dst + 4 * g) = *reinterpret_cast<const float4*>(row + 4 * g);
        } else {
          for (int c = lane; c < b; c += 32) dst[c] = row[c];
        }
        if (lane == 0) a.perm[d] = r_begin + s;
      }
    }
  } else {
    for (int s = rsub; s < nrows; s += R2) {
      const int lab = label_of(s);
      if (lab < 0) continue;
      const float* row = R + (size_t)s * ldr;
      float* dst = a.packed + (size_t)lab * b;
      for (int c = cbeg; c < cend; ++c) dst[c] = row[c];
      if (part == 0) a.perm[lab] = r_begin + s;
    }
  }
  if (cta == 0 && tid == 0) {
    *a.nt = nt;
    *a.ok = ok;
  }
  PROF_MARK(6)
  PROF_END
}

using Kernel = void (*)(Args);

Kernel kernel_for(int route) {
  if (route == kCluster) return lu_swap_kernel<true, false>;
  return route == kGridGlobalRows ? lu_swap_kernel<false, true> : lu_swap_kernel<false, false>;
}

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
// limit less the kernels' static shared memory), and the largest cluster
// (16, 8, 4, 2 or 1) the card places at that shared memory a CTA. Sets
// every instantiation's attributes once.
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
  // less the largest static shared memory of the three kernels
  size_t fixed = 0;
  for (int k : {kCluster, kGrid, kGridGlobalRows}) {
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel_for(k));
    if (err == cudaSuccess && fa.sharedSizeBytes > fixed) fixed = fa.sharedSizeBytes;
  }
  if (err != cudaSuccess) return err;
  d.smem_max -= (int)fixed;
  for (int k : {kCluster, kGrid, kGridGlobalRows}) {
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
  long long smem_bytes, scratch_floats;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The route of an (m, b) panel on the current device, the first that holds
// it of:
//  1. the cluster route: the largest cluster the card places, or fewer CTAs
//     of at least kClusterMinRows rows, holding every row and the slots in
//     shared memory at most kClusterMaxRows rows a CTA;
//  2. the grid route, one CTA an SM of at least kGridMinRows rows, the rows
//     in shared memory where a CTA's fit, else in global scratch (at most
//     kMaxRowsPerCta rows a CTA, whose labels fill shared memory);
// else refused.
cudaError_t plan_of(int m, int b, Plan* pl) {
  *pl = Plan{kRefused, 0, 0, 0, 0};
  if (m < 1 || b < 1) return cudaSuccess;
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return err;
  const long long cap = d.smem_max / 4;
  long long g = cdiv(m, kClusterMinRows);
  g = g < d.max_cluster ? g : d.max_cluster;
  long long rpc = cdiv(m, g);
  g = cdiv(m, rpc);
  if (rpc <= kClusterMaxRows && smem_floats(b, rpc, (int)g, true) <= cap) {
    *pl = Plan{kCluster, (int)g, (int)rpc, smem_floats(b, rpc, (int)g, true) * 4, 0};
    return cudaSuccess;
  }
  g = cdiv(m, kGridMinRows);
  g = g < d.sms ? g : d.sms;
  g = g < kMaxGrid ? g : kMaxGrid;
  rpc = cdiv(m, g);
  g = cdiv(m, rpc);
  if (rpc > kMaxRowsPerCta) return cudaSuccess;
  const long long slots = 2 * g * 2 + 2 * g * slot_ld(b);  // candidates (uint2), their rows
  if (smem_floats(b, rpc, 0, true) <= cap) {
    *pl = Plan{kGrid, (int)g, (int)rpc, smem_floats(b, rpc, 0, true) * 4, slots};
    return cudaSuccess;
  }
  if (smem_floats(b, rpc, 0, false) > cap) return cudaSuccess;
  *pl = Plan{kGridGlobalRows, (int)g, (int)rpc, smem_floats(b, rpc, 0, false) * 4,
             slots + g * rpc * row_ld(b)};
  return cudaSuccess;
}

}  // namespace

// The route of an (m, b) panel on the current device (plan_of): 1 cluster,
// 0 grid, 2 grid with the rows in global scratch, -1 refused (m or b < 1,
// or more than 65 536 rows a CTA), or -(CUDA error) - 2 if the device query
// failed. ctas and scratch_floats (either may be null) get the CTAs and the
// floats of global scratch faer_lu_panel_swap needs.
extern "C" int faer_lu_panel_swap_route(int m, int b, int* ctas, long long* scratch_floats) {
  Plan pl;
  const cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return -(int)err - 2;
  if (ctas) *ctas = pl.ctas;
  if (scratch_floats) *scratch_floats = pl.scratch_floats;
  return pl.route;
}

// panel: (m, b) f32, row stride lda >= b, rows contiguous; packed: (m, b)
// contiguous; perm: int64 (m,); nt: int (1,), the swap count; ok: bool (1,),
// no pivot exactly zero; scratch: scratch_floats floats of global memory,
// 16-byte aligned, at least what faer_lu_panel_swap_route gives (may be null
// when that is 0); all on the current device (the caller selects it).
// Returns the CUDA error of the launch, 100000 if the grid route's CTAs
// cannot be co-resident, 0 on success.
extern "C" int faer_lu_panel_swap(const float* panel, long long lda, float* packed,
                                  long long* perm, int* nt, unsigned char* ok, float* scratch,
                                  long long scratch_floats, int m, int b, void* stream) {
  Plan pl;
  cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return err;
  if (pl.route == kRefused || lda < b || scratch_floats < pl.scratch_floats ||
      (pl.scratch_floats > 0 && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)))
    return cudaErrorInvalidValue;
  // grid scratch: the candidates (uint2), their rows, the rows
  const long long g = pl.ctas;
  float* cand_rows = scratch ? scratch + 2 * g * 2 : nullptr;
  Args args{panel, lda, packed, perm, nt, ok,
            pl.route == kGridGlobalRows ? cand_rows + 2 * g * slot_ld(b) : nullptr,
            reinterpret_cast<uint2*>(scratch), cand_rows, m, b, pl.rpc};
  const Kernel kern = kernel_for(pl.route);
  if (pl.route == kCluster) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(pl.ctas);
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
  if ((long long)per_sm * sms < pl.ctas) return kNotCoResident;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(pl.ctas), dim3(kThreads), kargs,
                                    (size_t)pl.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FAER_LU_SWAP_PROFILE
// Copies the 7 phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_lu_panel_swap_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[7] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
