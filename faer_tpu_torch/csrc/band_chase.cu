// band_chase: `steps` serially dependent bulge-chase window steps over g
// independent strips of (4b, 2b) f32, b <= 1024.
//
// Replaces: faer_tpu/ops/pallas/band_chase.py `chase_probe` (:89, body
// `_chase_kernel` :73, step `_window_step` :39). Step i works on the
// (2b, 2b) window at rows (i mod 3) b of each strip: the Householder that
// zeroes rows 2..b of its column 0 (tau = 0 when that tail is zero), then
// u = tau W v, gamma = tau/2 v^T u, w~ = u - gamma v and the rank-2 update
// W <- W - v w~^T - w~ v^T. The windows of steps i and i + 1 share b rows,
// so the steps form a chain. The strip is not symmetric: a step updates
// the whole window.
//
// What bounds it on the H100: the chain. A step is two reductions, a
// (2b x b) matvec and a (2b)^2 update, about 20 b^2 FLOPs, each needing the
// one before; bytes (the strip in and out once) and FLOPs are far below
// what the card can do, so the design shortens the chain of one step.
//
// Design: one thread-block cluster a strip (a grid of g clusters, in waves
// when they do not all fit). CTA j of the cluster holds the strip's columns
// [j cw, (j + 1) cw) of all 4b rows, in its shared memory (the shared
// route) or in a global scratch copy with 16-byte rows (the global route,
// for strips no cluster holds), and its own copy of the strip's column 0.
// A step, in every CTA at once:
//  B. the CTAs whose columns meet 1..b form their partial sums of W v, a
//     thread a row (16-byte loads, four accumulators), and push each 4
//     rows' sums into a slot of every CTA's shared memory with st.async,
//     which completes the transaction count of that CTA's mbarrier of the
//     step's parity (slots and mbarriers alternate by the parity of the
//     step, so a push never overwrites a slot still being read);
//  C. each CTA waits on its own mbarrier until every partial sum has
//     arrived: the step's only exchange, no cluster barrier. A CTA without
//     partial sums sends every CTA with them a 4-byte token once it has read
//     the step's slots, which their next step's mbarrier also counts, so no
//     push can overtake a reader by two steps;
//  D. every CTA adds the partial sums in rank order (the same u in every
//     CTA), forms u = tau (W v) into shared memory, the warps' sums of
//     v^T u, one block barrier, and gamma from the warps' sums in order;
//  E. warp 0 updates the rows of its column-0 copy that the next
//     Householder reads, with the operations of their elements in CTA 0
//     (v is 0 at row 0), summing their squares as it goes, then forms the
//     next Householder (tau and 1/(alpha - beta) to the bit the same in
//     every CTA) and v on the CTA's columns;
//  F. meanwhile warps 1.. update the other column-0 rows and the CTA's
//     columns of the window, each thread a 16-byte column group (its v and
//     w~ in registers) on every R-th row, four rows in flight; one block
//     barrier ends the step.
// The scalar steps and the update are rounded one operation at a time
// (__fmul_rn and friends) in the order of `_window_step` (w - v[r] w~[c],
// then - w~[r] v[c]), so a zero tail gives tau = 0 and leaves the strip
// unchanged to the bit; the sums (|x|^2, W v, v^T u) are FFMA chains, warp
// shuffles and the CTAs' partials in rank order. FP32 only.
//
// Where the time goes (H100, b = 128, 8 CTAs of 32 columns, about 1.9 us a
// step; `tools/torch_profile.py chase`): the matvec of the CTAs that form
// one, the exchange's latency, the partial sums' reduction and gamma, and
// warp 0's next Householder, each 0.3-0.6 us, in a chain; the update hides
// behind the Householder. Measured slower at b = 128 and dropped: a
// cluster barrier a step with every warp forming the Householder itself,
// the columns interleaved over the CTAs so that every CTA forms partial
// sums, 512 threads, two or four threads a matvec row, every warp reducing
// gamma itself in place of the block barrier.
//
// The plan (CTAs of a cluster, columns a CTA, route) is the caller's
// (ops/kernels/band_chase.py `plan`, from b and the card alone);
// faer_chase_probe checks it and launches it, and nothing retries on the
// other route. faer_chase_device gives the card's facts the plan needs,
// faer_chase_smem_bytes the shared memory of a plan.
//
// Built with -DFAER_CHASE_PROFILE (`tools/torch_profile.py chase` does,
// into a library of its own), thread 0 of each CTA adds its cycles by phase
// into g_prof, read by faer_chase_profile_read.
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

#ifdef FAER_CHASE_PROFILE
// 0 stage, 1 matvec, 2 push, 3 exchange wait, 4 u and gamma, 5 warp 0's
// column-0 update and next Householder, 6 the rest of the update, 7 out:
// thread 0's cycles, summed over CTAs and launches
constexpr int kProf = 8;
__device__ long long g_prof[kProf];
#define PROF_START long long t_prof = clock64();
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long t_ = clock64(); prof[k] += t_ - t_prof; t_prof = t_; }
#define PROF_END \
  if (threadIdx.x == 0) for (int k = 0; k < kProf; ++k) atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)prof[k]);
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_END
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUpdThreads = kThreads - 32;  // warps 1.. update W; warp 0 the rest
constexpr int kMaxB = 1024;
constexpr int kMaxCluster = 16;  // non-portable; 8 is the portable size
constexpr int kRows = 4;         // rows of a column group in flight in the update
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// faer_chase_probe's routes
enum Route { kShared = 1, kGlobal = 2 };

struct Args {
  const float* in;  // (g 4b, 2b)
  float* out;       // (g 4b, 2b)
  float* scratch;   // global route: (g 4b, ldg), every strip's columns
  int b, steps, cw, ldg;
};

__host__ __device__ constexpr int r4(int x) { return (x + 3) & ~3; }

// The row stride of a CTA's columns in shared memory: 4 times an odd
// number, so that 8 threads reading 16 bytes of 8 consecutive rows meet in
// no bank (the matvec).
__host__ __device__ constexpr int slice_ld(int cw) { return 4 * ((cw / 4) | 1); }

// The CTAs whose columns [j cw, (j + 1) cw) meet 1..b: those with partial
// sums of W v, ranks 0 .. b / cw.
__host__ __device__ constexpr int contributors(int b, int cw) { return b / cw + 1; }

// Shared-memory floats of a CTA: its columns (shared route), v on them, the
// slots of the partial sums by parity, u and v on the window's rows, the
// column-0 copy, then kTail floats: the two mbarriers (4), the token word
// (4), the warps' sums of v^T u (kWarps), tau and 1/(alpha - beta) (4).
constexpr int kTail = 12 + kWarps;
__host__ __device__ constexpr long long smem_floats(int b, int cw, bool shared) {
  return (shared ? 4LL * b * slice_ld(cw) : 0LL) + cw +
         (2LL * contributors(b, cw) + 2) * r4(2 * b) + 4LL * b + kTail;
}

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(x));
  return x;
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(x));
  return x;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of shared::cta address `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory, completing 16 bytes of the
// transaction count of its mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr), "r"(v), "r"(bar)
               : "memory");
}

// v at window index r (0 outside 1..b, 1 at 1), from the window's column 0
__device__ __forceinline__ float v_at(const float* x, int r, int b, float inv_s) {
  return r == 1 ? 1.0f : (r >= 1 && r <= b ? __fmul_rn(x[r], inv_s) : 0.0f);
}

// w - v[r] w~[c] - w~[r] v[c], rounded as `_window_step`
__device__ __forceinline__ float upd(float w, float vr, float wr, float vc, float wc) {
  return __fsub_rn(__fsub_rn(w, __fmul_rn(vr, wc)), __fmul_rn(wr, vc));
}

// tau and 1/(alpha - beta) of the Householder of a window's column 0 from
// its sum of squares over rows 1..b and alpha = its row 1, rounded as
// `_window_step`.
__device__ __forceinline__ float2 householder(float sq, float alpha) {
  const float tail_sq = __fsub_rn(sq, __fmul_rn(alpha, alpha));
  const float norm = __fsqrt_rn(sq);
  const float beta = alpha >= 0.0f ? -norm : norm;
  const bool is_id = tail_sq <= 0.0f;
  const float safe_s = is_id ? 1.0f : __fsub_rn(alpha, beta);
  const float safe_b = is_id ? 1.0f : beta;
  return make_float2(is_id ? 0.0f : __fdiv_rn(__fsub_rn(beta, alpha), safe_b),
                     __fdiv_rn(1.0f, safe_s));
}

// Between a strip's rows (row stride tb) and a CTA's columns (row stride
// ld), `rows` rows: the CTA's group q (4 columns) is the strip's columns
// c0 + 4 q .. + 3. In (kIn): all nq groups, 0 past the strip's 2b columns;
// out: the columns that lie in the strip. 16 bytes a copy when `v4` (2b a
// multiple of 4: every group whole or wholly past the strip), four copies
// in flight a thread.
template <bool kIn>
__device__ __forceinline__ void copy_groups(float* loc, int ld, float* strip, int tb, int rows,
                                            int nq, int c0, bool v4, int tid) {
  const int per = v4 ? nq : 4 * nq, total = rows * per;
  for (int i0 = tid; i0 < total; i0 += kRows * kThreads) {
    if (v4) {
      float4 t[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * kThreads, r = i / per, q = i - r * per, c = c0 + 4 * q;
        const float4* from = reinterpret_cast<const float4*>(
            kIn ? strip + (size_t)r * tb + c : loc + (size_t)r * ld + 4 * q);
        t[k] = i < total && c < tb ? *from : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * kThreads, r = i / per, q = i - r * per, c = c0 + 4 * q;
        if (i < total && (kIn || c < tb))
          *reinterpret_cast<float4*>(kIn ? loc + (size_t)r * ld + 4 * q
                                         : strip + (size_t)r * tb + c) = t[k];
      }
    } else {
      float t[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * kThreads, r = i / per, l = i - r * per;
        const int c = c0 + l;
        t[k] = i < total && c < tb ? (kIn ? strip[(size_t)r * tb + c] : loc[(size_t)r * ld + l])
                                   : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * kThreads, r = i / per, l = i - r * per;
        const int c = c0 + l;
        if (i < total && (kIn || c < tb)) (kIn ? loc[(size_t)r * ld + l] : strip[(size_t)r * tb + c]) = t[k];
      }
    }
  }
}

template <bool kSh>
__global__ void __launch_bounds__(kThreads, 1) chase_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int ctas = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
  const int strip = blockIdx.x / ctas;
  const int b = a.b, tb = 2 * b, cw = a.cw, nq = cw / 4, nr = 4 * b;
  const int kc = contributors(b, cw), sld = r4(tb);
  // the CTA holds the strip's columns [c0, c0 + cw); its first ncv meet
  // columns 1..b (ncv > 0: it forms partial sums of W v)
  const int c0 = rank * cw, ncv = c0 <= b ? min(cw, r4(b + 1 - c0)) : 0;
  const bool forms = rank < kc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = kSh ? slice_ld(cw) : a.ldg;
  const float* src = a.in + (size_t)strip * nr * tb;
  float* dst = a.out + (size_t)strip * nr * tb;
  float* W = kSh ? smem : a.scratch + (size_t)strip * nr * a.ldg + c0;
  float* vcol = smem + (kSh ? (size_t)nr * ld : 0);  // v on the CTA's columns
  float* slots = vcol + cw;                           // [2][kc][sld]: partial sums of W v
  float* us = slots + 2 * kc * sld;                   // u on the window's rows
  float* vs = us + sld;                               // v on the window's rows
  float* x0 = vs + sld;                               // the strip's column 0
  uint64_t* bar = reinterpret_cast<uint64_t*>(x0 + nr);  // [2], by the parity of the step
  float* token = reinterpret_cast<float*>(bar + 2);
  float* part = token + 4;                            // [kWarps]: the warps' sums of v^T u
  float* sc = part + kWarps;                          // tau, 1/(alpha - beta)
  // what a CTA receives a step: kc partial sums, and on a CTA with partial
  // sums a token from every CTA without (from the second step on)
  const uint32_t rx = 4u * kc * sld, rx_tokens = forms ? 4u * (ctas - kc) : 0u;
#ifdef FAER_CHASE_PROFILE
  long long prof[kProf] = {0};
#endif
  PROF_START

  // the CTA's columns (0 past the strip's 2b) and the column-0 copy, every
  // copy in flight at once: 16 bytes a copy where the strip's rows are
  // 16-byte aligned (2b a multiple of 4), else 4
  const bool v4 = (tb & 3) == 0;
  if constexpr (kSh) {
    if (v4) {
      for (int i = tid; i < nr * nq; i += kThreads) {
        const int r = i / nq, q = i - r * nq, c = c0 + 4 * q;
        hopper::cp_async16(W + (size_t)r * ld + 4 * q, src + (size_t)r * tb + (c < tb ? c : 0),
                           c < tb ? 16 : 0);
      }
    } else {
      for (int i = tid; i < nr * cw; i += kThreads) {
        const int r = i / cw, l = i - r * cw, c = c0 + l;
        hopper::cp_async4(W + (size_t)r * ld + l, src + (size_t)r * tb + (c < tb ? c : 0),
                          c < tb);
      }
    }
  } else {
    copy_groups<true>(W, ld, const_cast<float*>(src), tb, nr, nq, c0, v4, tid);
  }
  for (int r = tid; r < nr; r += kThreads) hopper::cp_async4(x0 + r, src + (size_t)r * tb, true);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0 && a.steps > 0) {  // the first step's Householder
    float sq = 0.0f;
#pragma unroll 4
    for (int r = 1 + lane; r <= b; r += 32) sq = fmaf(x0[r], x0[r], sq);
    const float2 t = householder(warp_sum(sq), x0[1]);
    for (int l = lane; l < ncv; l += 32) vcol[l] = v_at(x0, c0 + l, b, t.y);
    if (lane == 0) {
      sc[0] = t.x;
      sc[1] = t.y;
    }
  }
  // every CTA of the cluster has started, its mbarriers initialized, before
  // the first push
  cluster_sync();
  PROF_MARK(0)

  // the update's threads (warps 1..): column group q (4 columns) of every
  // R-th row from rp; with more groups than threads, every kUpdThreads-th
  // group
  const int ut = tid - 32;
  const int R = nq <= kUpdThreads ? kUpdThreads / nq : 1;
  const int q0 = nq <= kUpdThreads ? ut % nq : ut, rp = nq <= kUpdThreads ? ut / nq : 0;
  const int qstep = nq <= kUpdThreads ? nq : kUpdThreads;
  const uint32_t slots_a = hopper::smem_addr(slots), token_a = hopper::smem_addr(token);

  for (int s = 0; s < a.steps; ++s) {
    const int off = (s % 3) * b, h = s & 1;
    float* w = W + (size_t)off * ld;  // the window's rows, this CTA's columns
    const float* x = x0 + off;         // the window's column 0
    const uint32_t bar_a = hopper::smem_addr(&bar[h]);
    if (tid == 0) hopper::mbar_expect_tx(&bar[h], rx + (s > 0 ? rx_tokens : 0u));
    const float tau = sc[0], inv_s = sc[1];
    // B. partial sums of W v over this CTA's first ncv columns, a thread a
    // row; each 4 rows' sums go to slot `rank` of every CTA, 16 bytes a
    // store, the group's 4 lanes taking every 4th CTA each
    if (forms) {
      const uint32_t slot_a = slots_a + 4u * (h * kc + rank) * sld;
      for (int r0 = warp * 32; r0 < sld; r0 += kThreads) {
        const int r = r0 + lane;
        float p = 0.0f;
        if (r < tb) {
          const float* row = w + (size_t)r * ld;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
          for (int c = 0; c < ncv; c += 4) {
            const float4 e = *reinterpret_cast<const float4*>(row + c);
            const float4 f = *reinterpret_cast<const float4*>(vcol + c);
            acc.x = fmaf(e.x, f.x, acc.x);
            acc.y = fmaf(e.y, f.y, acc.y);
            acc.z = fmaf(e.z, f.z, acc.z);
            acc.w = fmaf(e.w, f.w, acc.w);
          }
          p = (acc.x + acc.y) + (acc.z + acc.w);
        }
        const int g4 = lane & ~3;
        const float4 q = make_float4(__shfl_sync(kFull, p, g4), __shfl_sync(kFull, p, g4 + 1),
                                     __shfl_sync(kFull, p, g4 + 2), __shfl_sync(kFull, p, g4 + 3));
        PROF_MARK(1)
        if (r0 + g4 < sld) {
          const uint32_t at = slot_a + 4u * (r0 + g4);
          for (int d = lane & 3; d < ctas; d += 4) st_async(map_rank(at, d), q, map_rank(bar_a, d));
        }
        PROF_MARK(2)
      }
    }
    // v on the window's rows (needs no partial sum)
    for (int r = tid; r < tb; r += kThreads) vs[r] = v_at(x, r, b, inv_s);
    // C. the exchange: every partial sum of this step here
    hopper::mbar_wait(&bar[h], (s >> 1) & 1);
    PROF_MARK(3)
    // D. u = tau (W v): the partial sums in rank order; the warps' sums of
    // v^T u, then every thread adds them in warp order
    const float* sl = slots + h * kc * sld;
    for (int r0 = warp * 32; r0 < tb; r0 += kThreads) {
      const int r = r0 + lane;
      float vu = 0.0f;
      if (r < tb) {
        float acc = sl[r];
#pragma unroll 4
        for (int j = 1; j < kc; ++j) acc = __fadd_rn(acc, sl[j * sld + r]);
        const float u = __fmul_rn(acc, tau);
        us[r] = u;
        vu = __fmul_rn(vs[r], u);
      }
      vu = warp_sum(vu);
      if (lane == 0) part[warp] = r0 == warp * 32 ? vu : part[warp] + vu;
    }
    if (tid < kWarps && tid * 32 >= tb) part[tid] = 0.0f;
    __syncthreads();
    // this CTA is done with the step's slots: a CTA without partial sums
    // tells every CTA with them, whose next step waits for it
    if (!forms && tid < kc && s + 1 < a.steps)
      st_async(map_rank(token_a, tid), 0u, map_rank(hopper::smem_addr(&bar[h ^ 1]), tid));
    float vu = part[0];
    for (int k = 1; k < kWarps; ++k) vu = __fadd_rn(vu, part[k]);
    const float gamma = __fmul_rn(__fmul_rn(0.5f, tau), vu);
    PROF_MARK(4)
    // the CTA's copy of column 0 gets the operations of its element in CTA
    // 0 (v is 0 at row 0): warp 0 updates the rows the next Householder
    // reads (its rows 1..b; some lie outside this window), summing their
    // squares as it goes, and forms that Householder; warps 1.. the other
    // rows of the window
    const int offn = ((s + 1) % 3) * b;  // the next window's rows
    const float v0 = vs[0], wt0 = __fsub_rn(us[0], __fmul_rn(gamma, v0));
    if (warp == 0) {
      if (s + 1 < a.steps) {
        // kRows rows a lane at a time, every load before the first store
        float sq = 0.0f;
        for (int r0 = 1; r0 <= b; r0 += 32 * kRows) {
          float xv[kRows], vr[kRows], ur[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int r = r0 + lane + 32 * k, i = offn + r - off;  // its row in this window
            const bool in = r <= b && i >= 0 && i < tb;
            xv[k] = r <= b ? x0[offn + r] : 0.0f;
            vr[k] = in ? vs[i] : 0.0f;
            ur[k] = in ? us[i] : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const int r = r0 + lane + 32 * k, i = offn + r - off;
            if (r <= b && i >= 0 && i < tb) {
              xv[k] = upd(xv[k], vr[k], __fsub_rn(ur[k], __fmul_rn(gamma, vr[k])), v0, wt0);
              x0[offn + r] = xv[k];
            }
            sq = fmaf(xv[k], xv[k], sq);
          }
        }
        sq = warp_sum(sq);
        __syncwarp();
        const float* xn = x0 + offn;
        const float2 t = householder(sq, xn[1]);
        for (int l = lane; l < ncv; l += 32) vcol[l] = v_at(xn, c0 + l, b, t.y);
        if (lane == 0) {
          sc[0] = t.x;
          sc[1] = t.y;
        }
      }
      PROF_MARK(5)
    } else {
      for (int r = ut; r < tb; r += kUpdThreads) {
        const int i = off + r - offn;  // its row in the next window
        if (i < 1 || i > b)
          x0[off + r] = upd(x0[off + r], vs[r], __fsub_rn(us[r], __fmul_rn(gamma, vs[r])), v0, wt0);
      }
    }
    // F. warps 1..: the rank-2 update of this CTA's columns of the window
    if (warp > 0 && rp < R) {
      for (int q = q0; q < nq; q += qstep) {
        float vc[4], wc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + 4 * q + e;
          vc[e] = j < tb ? vs[j] : 0.0f;
          wc[e] = j < tb ? __fsub_rn(us[j], __fmul_rn(gamma, vs[j])) : 0.0f;
        }
        float* col = w + 4 * q;
        int r = rp;
        // kRows rows at a time, every load before the first store
        for (; r + (kRows - 1) * R < tb; r += kRows * R) {
          float4 e4[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k)
            e4[k] = *reinterpret_cast<const float4*>(col + (size_t)(r + k * R) * ld);
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const float vr = vs[r + k * R];
            const float wr = __fsub_rn(us[r + k * R], __fmul_rn(gamma, vr));
            e4[k].x = upd(e4[k].x, vr, wr, vc[0], wc[0]);
            e4[k].y = upd(e4[k].y, vr, wr, vc[1], wc[1]);
            e4[k].z = upd(e4[k].z, vr, wr, vc[2], wc[2]);
            e4[k].w = upd(e4[k].w, vr, wr, vc[3], wc[3]);
            *reinterpret_cast<float4*>(col + (size_t)(r + k * R) * ld) = e4[k];
          }
        }
        for (; r < tb; r += R) {
          float4 e = *reinterpret_cast<const float4*>(col + (size_t)r * ld);
          const float vr = vs[r], wr = __fsub_rn(us[r], __fmul_rn(gamma, vr));
          e.x = upd(e.x, vr, wr, vc[0], wc[0]);
          e.y = upd(e.y, vr, wr, vc[1], wc[1]);
          e.z = upd(e.z, vr, wr, vc[2], wc[2]);
          e.w = upd(e.w, vr, wr, vc[3], wc[3]);
          *reinterpret_cast<float4*>(col + (size_t)r * ld) = e;
        }
      }
    }
    __syncthreads();
    PROF_MARK(6)
  }

  // no CTA leaves while another may still store into it
  cluster_sync();
  // the CTA's columns back to the output
  copy_groups<false>(W, ld, dst, tb, nr, nq, c0, v4, tid);
  PROF_MARK(7)
  PROF_END
}

using Kernel = void (*)(Args);

Kernel kernel_for(int route) { return route == kShared ? chase_kernel<true> : chase_kernel<false>; }

struct DeviceInfo {
  bool known = false;
  int smem_max = 0, max_cluster = 0;
};

// Per device: the dynamic shared memory a CTA can take (the opt-in limit
// less the kernels' static shared memory) and the largest cluster (16, 8,
// 4, 2 or 1) the card places at that shared memory a CTA. Sets both
// instantiations' attributes once.
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
  err = cudaDeviceGetAttribute(&d.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  size_t fixed = 0;
  for (int k : {kShared, kGlobal}) {
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel_for(k));
    if (err == cudaSuccess && fa.sharedSizeBytes > fixed) fixed = fa.sharedSizeBytes;
  }
  if (err != cudaSuccess) return err;
  d.smem_max -= (int)fixed;
  for (int k : {kShared, kGlobal}) {
    err = cudaFuncSetAttribute(kernel_for(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_max);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_for(k), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  for (int g = kMaxCluster; g >= 1 && !d.max_cluster; g /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(g);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = d.smem_max;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel_for(kShared), &cfg);
    if (err != cudaSuccess) return err;
    if (n >= 1) d.max_cluster = g;
  }
  d.known = true;
  if (dev < kMaxDevices) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

}  // namespace

// The current device's facts a plan needs: the dynamic shared memory a CTA
// of the kernel can take, and the largest cluster the card places at it.
// Returns the CUDA error of the query (0 on success).
extern "C" int faer_chase_device(int* smem_max, int* max_cluster) {
  DeviceInfo d;
  const cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return (int)err;
  *smem_max = d.smem_max;
  *max_cluster = d.max_cluster;
  return 0;
}

// The dynamic shared memory (bytes) of a CTA of cw columns at b, on the
// shared route (shared != 0) or the global route.
extern "C" int faer_chase_smem_bytes(int b, int cw, int shared) {
  return (int)(4 * smem_floats(b, cw, shared != 0));
}

// in, out: (g 4b, 2b) f32, contiguous; scratch: at least g 4b ctas cw
// floats, 16-byte aligned, on the global route (may be null on the shared
// route); the plan: ctas CTAs a cluster of cw columns each (a multiple of
// 4, ctas = ceil(2b / cw)), route 1 (shared) or 2 (global); all on the
// current device (the caller selects it). Returns the CUDA error of the
// launch (0 on success); a plan the card cannot take is cudaErrorInvalidValue.
extern "C" int faer_chase_probe(const float* in, float* out, float* scratch,
                                long long scratch_floats, int b, int steps, int g, int ctas,
                                int cw, int route, void* stream) {
  if (b < 1 || b > kMaxB || steps < 0 || g < 1 || cw < 4 || cw % 4 ||
      ctas != (2 * b + cw - 1) / cw || (route != kShared && route != kGlobal))
    return cudaErrorInvalidValue;
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return err;
  const long long smem = 4 * smem_floats(b, cw, route == kShared);
  const int ldg = ctas * cw;
  if (ctas > d.max_cluster || smem > d.smem_max) return cudaErrorInvalidValue;
  if (route == kGlobal && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 ||
                           scratch_floats < (long long)g * 4 * b * ldg))
    return cudaErrorInvalidValue;
  Args args{in, out, scratch, b, steps, cw, ldg};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)((long long)ctas * g));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_for(route), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FAER_CHASE_PROFILE
// Copies the 8 phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_chase_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
