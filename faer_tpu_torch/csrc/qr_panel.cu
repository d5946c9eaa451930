// qr_panel: Householder QR of an (m, b) f32 panel, b <= 4096, any m >= 1.
//
// Replaces every Householder QR panel of faer_tpu/ops/pallas/, which
// compute one function in different orders of rounding:
// qr_panel_v5.py `qr_panel_v5_pallas` (:144, body `_qr_v5_kernel` :73; the
// QR driver's leaves), panel_kernels.py `qr_panel_pallas` (:224, body
// `_qr_panel_kernel` :185; v1, one eager rank-1 update a column, the order
// of this kernel), qr_panel_v2.py `qr_panel_v2_pallas` (:141, body :44),
// qr_panel_v3.py `qr_panel_v3_pallas` (:127, body :41) and leaf_v4.py
// `qr_panel_v4_pallas` (:351, body :281). Contract: the kmax = min(m, b)
// reflectors of the panel's leading columns; out holds beta on the diagonal,
// the reflector tails v (v[j] = 1 implied) strictly below it and R above it,
// Q^T A in the columns right of m when the panel is wide (m < b);
// taus[j] = tau_j (kmax of them), with H_j = I - tau_j v v^T. Signs as in
// the TPU kernels (qr_panel_v5.py:92-108) and LAPACK larfg: beta =
// -sign(alpha) * norm with sign = +1 for alpha >= 0 (so -0.0 counts as
// >= 0), norm = sqrt(alpha^2 + sum(tail^2)), tau = (beta - alpha) / beta,
// v = x / (alpha - beta); a zero tail gives tau = 0, beta = alpha and
// v = e_j. Where alpha^2 + |t|^2 < 2^-103 (tiny / eps: the squares are
// subnormal and lose bits) the reflector is formed on the column scaled by
// 2^64, an exact power of two, as LAPACK's slarfg and snrm2 scale (the
// plain twins and ops/householder.py do the same); above it every bit is
// as without the scaling. This deliberately differs from the reference,
// whose unscaled squares (faer_tpu/linalg/qr.py:51-53) XLA flushes to
// zero: a Gaussian panel of scale 1e-20 reconstructed to 56 n eps. So the last step of a wide panel (j = m - 1, no tail) has
// tau = 0, and every step still updates all b columns, as the Pallas
// bodies do.
//
// What bounds it on the H100: a (4096, 128) panel is 2 MiB, more than one
// SM's 227 KB of shared memory, and every column needs a reduction over all
// m rows before the next column can start. The panel is bound by those b
// exchanges between SMs in a row, not by its 2 b^2 (m - b/3) FP32
// operations (2 us at 67 TFLOP/s) or its 4 MiB of traffic (1.3 us).
//
// One exchange a column. With x = A[j:, j], alpha = x[0], the tail t =
// x[1:], s = 1 / (alpha - beta) and v = [1; s t], the later columns need
// w = v^T A[j:, j+1:] = A[j, j+1:] + s (t^T A[j+1:, j+1:]), and s depends
// only on alpha and |t|^2. So one pass over a CTA's rows forms both of its
// shares at once: of |t|^2 and of t^T A[j+1:, j+1:] (|t|^2 is the first
// entry of x^T A[:, j:] over the rows below j). Better still, the pass that
// applies reflector j - 1 to a row already holds the row's new column j and
// its new later entries, so the update of step j - 1 and the shares of step
// j are one pass. The owner of row j publishes that row (alpha and
// A[j, j+1:] as they stand before reflector j). After one barrier every CTA
// reads all shares in one fixed rank order, so all CTAs compute beta, tau,
// s and w bit for bit the same, and applies A[i, c] -= tau v_i w_c to its
// own rows; row j becomes R[j, c] = A[j, c] - tau w_c with beta on the
// diagonal. Each reflector is applied to all later columns at once (the TPU
// kernel defers it to compact-WY sub-blocks of 16): the same function in
// another order of rounding. All arithmetic is FP32, with explicit
// __fmaf_rn / __fmul_rn where two threads must round alike.
//
// Two routes, decided in plan_of from (m, b) and the device alone
// (faer_qr_panel_route tells callers which; a launch the route cannot make
// fails, nothing retries on the other route):
//  - cluster: CTA r of one thread-block cluster (up to 16 CTAs, one an SM)
//    owns a contiguous slab of rows in its shared memory for the whole
//    panel, when the rows fit the cluster: m up to 6 560 at b = 128, every
//    leaf of a 4096^2 QR. (Rows held in registers, a warp's rows and a
//    lane's 4 columns, with the column entries passed by shuffles, were
//    tried: 0.63-0.68 ms against 0.45 at (4096, 128).) Its shares and its
//    copy of row j go to its own shared memory, the barrier is barrier.cluster
//    (arrive.release, wait.acquire), and the others read them through
//    distributed shared memory (map_shared_rank). No global scratch.
//  - grid: one cooperative grid of up to one CTA an SM, rows in shared
//    memory when a CTA's fit, else in place in `out` (L2-resident up to
//    tens of MB); shares in global scratch written with __stcg and read
//    with __ldcg (an SM's L1 may hold the same lines from two columns ago);
//    the barrier is grid.sync().
// One barrier a column is enough because the published buffers have two
// halves, by the parity of j: a CTA writes column j + 2's shares only after
// every CTA has passed column j + 1's barrier, and so has finished reading
// column j's. Per column (after the barrier):
//  0. every CTA sums the shares P[c] = sum over CTAs of x^T A[:, c] (c >= j;
//     P[j] = |t|^2) in rank order and reads the owner's row j (R[c]);
//  1. every thread forms beta, tau, s from P[j], R[j]; tau w[c] = tau (R[c] +
//     s P[c]) for the later columns; one thread a row turns column j into v
//     (beta on row j) and keeps v_i and the row's new column j + 1 entry
//     x'_i = A[i, j+1] - tau w[j+1] v_i (0 unless i > j + 1);
//  2. the warps update the CTA's rows (rows >= j, columns > j; a lane 4
//     columns, a warp 128 columns of one row: one 16-byte access a lane when
//     the rows are in shared memory, 4 bytes 32 columns apart in global
//     memory; 4 rows' loads in flight before the first store) and sum
//     x'_i A'[i, c] over them for c >= j + 1; warps that shared columns add
//     their sums in warp order, the CTA publishes them, and the owner of row
//     j + 1 publishes that row. Then the next barrier.
// CTA 0 keeps the taus in shared memory and writes them at the end, so no
// global store waits in the barrier's fence.
// Built with -DFAER_QR_PROFILE (`tools/torch_profile.py qr` does, into a
// library of its own), thread 0 of each CTA adds its cycles by phase into
// g_prof, read by faer_qr_panel_profile_read, and
// faer_qr_panel_profile_force_grid sends every shape to the grid route, so
// that both routes can be timed at the cluster route's shapes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifdef FAER_QR_PROFILE
// 0 stage, 1 exchange wait, 2 reflector (step 0 and 1), 3 update (step 2's
// pass), 4 partials (step 2's sums and publication), 5 out
__device__ long long g_prof[6];
static bool g_force_grid = false;  // host: plan every shape on the grid route
#define PROF_START long long t_prof = clock64();
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long u = clock64(); prof[k] += u - t_prof; t_prof = u; }
#define PROF_END \
  if (threadIdx.x == 0) for (int k = 0; k < 6; ++k) atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)prof[k]);
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_END
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;            // columns a lane takes in step 2
constexpr int kChunk = 32 * kCols;  // columns a warp takes of a row
constexpr int kRows = 4;            // rows a warp loads before it stores
constexpr int kMaxB = 4096;
constexpr int kMaxCluster = 16;     // non-portable; 8 is the portable size
// the fewest rows a CTA takes: below this, more CTAs cost more in the
// exchange (each CTA reads every other's shares) than they save. The grid's
// was measured on an H100 (profile build): (4096, 256) 1.54 / 1.29 / 1.30 ms
// and (8192, 128) 0.73 / 0.72 / 0.67 ms at 32 / 64 / 128 rows a CTA
constexpr int kClusterMinRows = 128;
constexpr int kGridMinRows = 128;
constexpr int kMaxDevices = 64;
constexpr int kNotCoResident = 100000;

enum Route { kRefused = -1, kGrid = 0, kCluster = 1 };

struct Args {
  const float* panel;
  long long lda;
  float* out;
  float* taus;
  float* scratch;  // grid route: the published buffers (and v, x' per row)
  int m, b, rpc;
};

__host__ __device__ constexpr int pad4(int b) { return (b + 3) & ~3; }

// Shared-memory floats besides the rows: tau w, P, R and the taus (b each,
// padded to a multiple of 4) and the warps' partial sums; the cluster route
// adds its two published halves of the shares and of row j (4 b); 2 floats
// of slack keep what follows v, x' 16-byte aligned.
__host__ __device__ constexpr long long fixed_floats(int b, bool cluster) {
  return 4LL * pad4(b) + kWarps * kChunk + (cluster ? 4LL * pad4(b) : 0) + 2;
}

// Shared-memory floats a row takes: the row at a stride of pad4(b) + 4 (a
// multiple of 4, for 16-byte row accesses; + 4 so that the column reads of
// step 1 spread over 8 banks), v_i and x'_i.
__host__ __device__ constexpr int row_stride(int b) { return pad4(b) + 4; }
__host__ __device__ constexpr long long row_floats(int b) { return row_stride(b) + 2; }

// Reflector j from the gathered |t|^2 (sigma) and alpha: the same bits in
// every thread of every CTA.
struct Reflector {
  float beta, tau, sc;  // sc = s = 1 / (alpha - beta) (of the scaled column)
  float pre, wsc;       // v_i = (x_i pre) sc; tau w_c = tau (R[c] + wsc P[c])
  bool is_id;           // a zero tail: tau = 0, beta = alpha, v = e_j
};

constexpr float kSmallNormSq = 9.86076131526264760e-32f;  // 2^-103 = tiny / eps
constexpr float kUp = 18446744073709551616.0f;             // 2^64
constexpr float kDown = 5.42101086242752217e-20f;          // 2^-64

// pre = 1: sigma and P[c] = t^T A[:, c] are unscaled and w = R + s P. pre =
// 2^64 (the scaled branch): sigma is |t 2^64|^2 and P[c] is v^T A[:, c]
// itself, so w = R + P.
__device__ __forceinline__ Reflector reflector_of(float sigma, float alpha, float pre) {
  const float as = alpha * pre;  // exact
  const float norm = sqrtf(__fmaf_rn(as, as, sigma));
  const float bt = alpha >= 0.0f ? -norm : norm;
  const bool is_id = sigma == 0.0f;
  const float sc = is_id ? 1.0f : 1.0f / (as - bt);
  return Reflector{is_id ? alpha : (pre == 1.0f ? bt : bt * kDown),
                   is_id ? 0.0f : (bt - as) / bt, sc, pre, pre == 1.0f ? sc : 1.0f, is_id};
}

// tau w_c = tau (R[c] + s P[c]) of a later column.
__device__ __forceinline__ float tau_w(const Reflector& f, float p, float r) {
  return __fmul_rn(f.tau, __fmaf_rn(f.wsc, p, r));
}

// v_i of a row below j.
__device__ __forceinline__ float v_of(const Reflector& f, float x) {
  return __fmul_rn(__fmul_rn(x, f.pre), f.sc);
}

// Cluster route, after the barrier of step j: P[c] (c >= j) summed over the
// CTAs' published shares (half h of pub) in rank order, every remote load
// in flight at once, and R[c] from the copy of row j its owner published.
// (Tried on the card at (4096, 128), 0.45 ms a panel with this: each warp
// forming P[j], P[j + 1] for itself, in place of the barrier that follows
// this, 0.66 ms; 16-byte remote loads by a quarter of the threads, 0.56;
// every share pushed into every CTA's shared memory for local reads, 0.53.)
__device__ __forceinline__ void cluster_gather(float* pub, int b4, int b, int j, int h,
                                               int owner, float* sP, float* sR) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  for (int c = j + (int)threadIdx.x; c < b; c += kThreads) {
    float part[kMaxCluster];
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g)
      part[g] = g < G ? cluster.map_shared_rank(pub, g)[h * b4 + c] : 0.0f;
    const float r = cluster.map_shared_rank(pub, owner)[(2 + h) * b4 + c];
    float acc = 0.0f;
#pragma unroll
    for (int g = 0; g < kMaxCluster; ++g)
      if (g < G) acc += part[g];
    sP[c] = acc;
    sR[c] = r;
  }
}

template <bool kCl, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1) qr_panel_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int b = p.b, m = p.m, rpc = p.rpc;
  const int kmax = min(m, b);
  const int G = gridDim.x, cta = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  const int b4 = pad4(b);
  const int ld = kSmem ? row_stride(b) : b;
#ifdef FAER_QR_PROFILE
  long long prof[6] = {0};
#endif
  PROF_START

  // shared memory: [the rows, v and x' per row (float2)], tau w, P, R, the
  // taus, the warps' sums, [cluster: shares[2][b4], row j[2][b4]]; without
  // the rows, v and x' go to global scratch
  float* rows = kSmem ? smem : p.out + (size_t)r_begin * b;
  float2* vx = kSmem ? reinterpret_cast<float2*>(smem + (size_t)rpc * ld)
                     : reinterpret_cast<float2*>(p.scratch + 2LL * (G + 1) * b) +
                           (size_t)cta * rpc;
  float* sTw = smem + (kSmem ? (size_t)rpc * ld + 2 * ((rpc + 1) & ~1) : 0);
  float* sP = sTw + b4;
  float* sR = sP + b4;
  float* sTau = sR + b4;  // CTA 0 keeps the taus, written out at the end
  float* sRed = sTau + b4;
  float* pub = sRed + kWarps * kChunk;  // cluster: this CTA's published halves
  // where this CTA publishes its shares and its copy of row j, half h
  auto share_at = [&](int h) {
    return kCl ? pub + h * b4 : p.scratch + ((size_t)h * G + cta) * b;
  };
  auto row_at = [&](int h) {
    return kCl ? pub + (2 + h) * b4 : p.scratch + (2LL * G + h) * b;
  };
  auto put = [&](float* dst, float v) {
    if constexpr (kCl) *dst = v; else __stcg(dst, v);
  };

  for (int i = warp; i < nrows; i += kWarps)
    for (int c = lane; c < b; c += 32)
      rows[(size_t)i * ld + c] = p.panel[(size_t)(r_begin + i) * p.lda + c];
  __syncthreads();
  PROF_MARK(0)

  // j = -1 is the prologue: no reflector, only column 0's shares
  for (int j = -1; j < kmax; ++j) {
    Reflector f{0.0f, 0.0f, 0.0f, true};  // the prologue's: no reflector
    float tw1 = 0.0f;  // tau w of column j + 1
    if (j >= 0) {
      const int h = j & 1, owner = j / rpc;
      if constexpr (kCl) cg::this_cluster().sync(); else cg::this_grid().sync();
      PROF_MARK(1)
      // 0. P[c] (c >= j) over the CTAs in rank order, R[c] from row j's owner
      const int ncol = b - j;
      const int ng = kCl ? 1 : max(1, min(min(G, kWarps), kThreads / ncol));
      if (ng > 1) {  // grid: groups of CTAs summed apart, then in group order
        const int cl = tid % ncol, grp = tid / ncol;
        if (grp < ng) {
          float acc = 0.0f;
#pragma unroll 16
          for (int g = grp; g < G; g += ng)
            acc += __ldcg(p.scratch + ((size_t)h * G + g) * b + j + cl);
          sRed[grp * ncol + cl] = acc;
        }
        __syncthreads();
      }
      if constexpr (kCl) {
        cluster_gather(pub, b4, b, j, h, owner, sP, sR);
      } else {
        for (int c = j + tid; c < b; c += kThreads) {
          float acc = 0.0f;
          if (ng > 1) {
#pragma unroll
            for (int q = 0; q < kWarps; ++q)
              if (q < ng) acc += sRed[q * ncol + c - j];
          } else {
#pragma unroll 16
            for (int g = 0; g < G; ++g) acc += __ldcg(p.scratch + ((size_t)h * G + g) * b + c);
          }
          sP[c] = acc;
          sR[c] = __ldcg(p.scratch + (2LL * G + h) * b + c);
        }
      }
      __syncthreads();
      // 1. the reflector, the same bits in every thread of every CTA
      f = reflector_of(sP[j], sR[j], 1.0f);
      if (__fmaf_rn(sR[j], sR[j], sP[j]) < kSmallNormSq) {
        // F2, the same branch in every CTA: the column's squares lose bits.
        // Two more exchanges: |2^64 t|^2 (half 1 - h, slot j; its last
        // readers passed this step's barrier), then P[c] = v^T A[:, c] for
        // the later columns (half h, once every CTA has read it above).
        const int r1 = max(0, j + 1 - r_begin);  // the first local row > j
        float acc = 0.0f;
        for (int r = r1 + tid; r < nrows; r += kThreads) {
          const float x = rows[(size_t)r * ld + j] * kUp;
          acc = __fmaf_rn(x, x, acc);
        }
        for (int o = 16; o > 0; o /= 2) acc += __shfl_down_sync(0xffffffffu, acc, o);
        __syncthreads();  // sRed is free: step 0's sums were read
        if (lane == 0) sRed[warp] = acc;
        __syncthreads();
        if (tid == 0) {
          float t = 0.0f;
          for (int q = 0; q < kWarps; ++q) t += sRed[q];
          put(share_at(1 - h) + j, t);
        }
        if constexpr (kCl) cg::this_cluster().sync(); else cg::this_grid().sync();
        if (tid == 0) {
          float t = 0.0f;
          for (int g = 0; g < G; ++g)
            t += kCl ? cg::this_cluster().map_shared_rank(pub, g)[(1 - h) * b4 + j]
                     : __ldcg(p.scratch + ((size_t)(1 - h) * G + g) * b + j);
          sP[j] = t;
        }
        __syncthreads();
        f = reflector_of(sP[j], sR[j], kUp);
        for (int c = j + 1 + tid; c < b; c += kThreads) {
          float pc = 0.0f;
          for (int r = r1; r < nrows; ++r)
            pc = __fmaf_rn(v_of(f, rows[(size_t)r * ld + j]), rows[(size_t)r * ld + c], pc);
          put(share_at(h) + c, pc);
        }
        if constexpr (kCl) cg::this_cluster().sync(); else cg::this_grid().sync();
        for (int c = j + 1 + tid; c < b; c += kThreads) {
          float t = 0.0f;
          for (int g = 0; g < G; ++g)
            t += kCl ? cg::this_cluster().map_shared_rank(pub, g)[h * b4 + c]
                     : __ldcg(p.scratch + ((size_t)h * G + g) * b + c);
          sP[c] = t;
        }
        __syncthreads();
      }
      for (int c = j + 1 + tid; c < b; c += kThreads) sTw[c] = tau_w(f, sP[c], sR[c]);
      if (j + 1 < b) tw1 = tau_w(f, sP[j + 1], sR[j + 1]);
      if (tid == 0) sTau[j] = f.tau;
    } else {
      for (int c = tid; c < b; c += kThreads) sTw[c] = 0.0f;
    }
    const bool next = j + 1 < kmax;  // another reflector follows
    const int r0 = max(0, j - r_begin);  // the first local row >= j
    // column j becomes v (beta on row j); v_i and x'_i for step 2
    for (int r = r0 + tid; r < nrows; r += kThreads) {
      const int gi = r_begin + r;
      float* row = rows + (size_t)r * ld;
      float v = 0.0f, xn = 0.0f;
      if (j >= 0) {
        v = gi == j ? 1.0f : (f.is_id ? 0.0f : v_of(f, row[j]));
        row[j] = gi == j ? f.beta : v;
      }
      if (next && gi > j + 1) xn = __fmaf_rn(-tw1, v, row[j + 1]);
      vx[r] = make_float2(v, xn);
    }
    __syncthreads();
    PROF_MARK(2)

    // 2. A[i, c] -= tau w_c v_i for the rows >= j and the columns > j, and
    // this CTA's shares x'^T A'[:, c] of the next column (c >= j + 1). A lane
    // takes 4 columns of a row: 16 bytes from a multiple of 4 when the rows
    // are in shared memory (the columns <= j of the first vector, and those
    // past b, are stored back unchanged), else 4 bytes 32 columns apart.
    const int c0 = j + 1;
    if (c0 >= b) continue;  // the last column: nothing to its right
    const int cfirst = kSmem ? c0 & ~3 : c0;  // the first column a warp takes
    const int nch = (b - cfirst + kChunk - 1) / kChunk;
    // warps split the rows of a chunk when there are fewer chunks than warps
    const int groups = nch >= kWarps ? 1 : kWarps / nch;
    const int width = nch * kChunk;
    const int rg = nch >= kWarps ? 0 : warp / nch;
    const int ch_step = nch >= kWarps ? kWarps : nch;
    const int h = (j + 1) & 1;
    for (int ch = rg < groups ? (nch >= kWarps ? warp : warp % nch) : nch; ch < nch;
         ch += ch_step) {
      const int cb = cfirst + ch * kChunk + (kSmem ? 4 * lane : lane);
      const int cstep = kSmem ? 1 : 32;  // this lane's columns: cb + k cstep
      float tw[kCols], acc[kCols];
      bool live[kCols];  // a column this reflector updates (c0 <= c < b)
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = cb + k * cstep;
        live[k] = c >= c0 && c < b;
        tw[k] = live[k] ? sTw[c] : 0.0f;
        acc[k] = 0.0f;
      }
      if (kSmem && cb >= b) continue;  // a whole vector past b: nothing to do
      float* row = rows + (size_t)(r0 + rg) * ld + cb;
      const size_t row_step = (size_t)groups * ld;
      int r = r0 + rg;
      // kRows rows at a time, every load in flight before the first store
      for (; r + (kRows - 1) * groups < nrows; r += kRows * groups) {
        float2 q[kRows];
        float a[kRows][kCols];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          q[u] = vx[r + u * groups];
          const float* ru = row + u * row_step;
          if constexpr (kSmem) {
            const float4 t = *reinterpret_cast<const float4*>(ru);
            a[u][0] = t.x, a[u][1] = t.y, a[u][2] = t.z, a[u][3] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < kCols; ++k) a[u][k] = live[k] ? ru[32 * k] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (live[k]) a[u][k] = __fmaf_rn(-tw[k], q[u].x, a[u][k]);
            acc[k] = __fmaf_rn(q[u].y, a[u][k], acc[k]);
          }
          float* ru = row + u * row_step;
          if constexpr (kSmem) {
            *reinterpret_cast<float4*>(ru) = make_float4(a[u][0], a[u][1], a[u][2], a[u][3]);
          } else {
#pragma unroll
            for (int k = 0; k < kCols; ++k)
              if (live[k]) ru[32 * k] = a[u][k];
          }
        }
        row += kRows * row_step;
      }
      for (; r < nrows; r += groups, row += row_step) {
        const float2 q = vx[r];
        float a[kCols];
        if constexpr (kSmem) {
          const float4 t = *reinterpret_cast<const float4*>(row);
          a[0] = t.x, a[1] = t.y, a[2] = t.z, a[3] = t.w;
        } else {
#pragma unroll
          for (int k = 0; k < kCols; ++k) a[k] = live[k] ? row[32 * k] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (live[k]) a[k] = __fmaf_rn(-tw[k], q.x, a[k]);
          acc[k] = __fmaf_rn(q.y, a[k], acc[k]);
        }
        if constexpr (kSmem) {
          *reinterpret_cast<float4*>(row) = make_float4(a[0], a[1], a[2], a[3]);
        } else {
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            if (live[k]) row[32 * k] = a[k];
        }
      }
      if (next) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = cb + k * cstep;
          if (!live[k]) continue;
          if (groups > 1) sRed[rg * width + c - cfirst] = acc[k];
          else put(share_at(h) + c, acc[k]);
        }
      }
    }
    PROF_MARK(3)
    if (next) {
      // the warps' sums in warp order; the owner of row j + 1 publishes it
      __syncthreads();
      const int r_next = j + 1 - r_begin;
      for (int c = c0 + tid; c < b; c += kThreads) {
        if (groups > 1) {
          float part[kWarps];
#pragma unroll
          for (int q = 0; q < kWarps; ++q)
            part[q] = q < groups ? sRed[q * width + c - cfirst] : 0.0f;
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < kWarps; ++q)
            if (q < groups) acc += part[q];
          put(share_at(h) + c, acc);
        }
        if (r_next >= 0 && r_next < nrows) put(row_at(h) + c, rows[(size_t)r_next * ld + c]);
      }
    }
    PROF_MARK(4)
  }

  // no CTA leaves while another may still read its shared memory
  if constexpr (kCl) cg::this_cluster().sync(); else __syncthreads();
  if (cta == 0)
    for (int j = tid; j < kmax; j += kThreads) p.taus[j] = sTau[j];
  if (kSmem) {
    for (int i = warp; i < nrows; i += kWarps)
      for (int c = lane; c < b; c += 32)
        p.out[(size_t)(r_begin + i) * b + c] = rows[(size_t)i * ld + c];
  }
  PROF_MARK(5)
  PROF_END
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
  return cudaOccupancyMaxActiveClusters(n, qr_panel_kernel<true, true>, &cfg);
}

struct DeviceInfo {
  bool known = false;
  int sms = 0, smem_max = 0, max_cluster = 0;
};

// Per device: SMs, the opt-in shared memory of a CTA, and the largest
// cluster (16, 8, 4, 2 or 1) the card can place with a CTA of kThreads
// threads and that shared memory on each SM. Sets both kernels' attributes
// once.
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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qr_panel_kernel<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qr_panel_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qr_panel_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qr_panel_kernel<true, true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
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
  int route, ctas, rpc, rows_in_smem;
  long long smem_bytes, scratch_floats;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The route of an (m, b) panel on the current device: the cluster route when
// the rows fit the shared memory of the largest cluster the card places,
// else the grid route.
cudaError_t plan_of(int m, int b, Plan* pl) {
  *pl = Plan{kRefused, 0, 0, 0, 0, 0};
  if (m < 1 || b < 1 || b > kMaxB) return cudaSuccess;
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return err;
  const long long avail = d.smem_max / 4;
  const long long per_row = row_floats(b);
  const long long fit = (avail - fixed_floats(b, true)) / per_row;  // rows a CTA holds
#ifdef FAER_QR_PROFILE
  const bool cluster_ok = !g_force_grid;
#else
  const bool cluster_ok = true;
#endif
  if (cluster_ok && fit >= 1 && cdiv(m, fit) <= d.max_cluster) {
    long long g = cdiv(m, kClusterMinRows);
    g = g < d.max_cluster ? g : d.max_cluster;
    g = g > cdiv(m, fit) ? g : cdiv(m, fit);
    const long long rpc = cdiv(m, g);
    *pl = Plan{kCluster, (int)cdiv(m, rpc), (int)rpc, 1,
               (fixed_floats(b, true) + rpc * per_row) * 4, 0};
    return cudaSuccess;
  }
  long long g = cdiv(m, kGridMinRows);
  g = g < d.sms ? g : d.sms;
  const long long rpc = cdiv(m, g);
  g = cdiv(m, rpc);
  const bool in_smem = fixed_floats(b, false) + rpc * per_row <= avail;
  *pl = Plan{kGrid, (int)g, (int)rpc, in_smem,
             (fixed_floats(b, false) + (in_smem ? rpc * per_row : 0)) * 4,
             // shares [2][G][b], row j [2][b], and v, x' per row if the rows
             // are in `out`
             2 * (g + 1) * b + (in_smem ? 0 : 2 * g * rpc)};
  return cudaSuccess;
}

}  // namespace

// The route of an (m, b) panel on the current device: 1 cluster, 0 grid,
// -1 refused (b outside 1..4096 or m < 1), or -(CUDA error) - 2 if the
// device query failed. ctas and scratch_floats (either may be null) get the
// CTAs of the launch and the floats of global scratch faer_qr_panel needs.
extern "C" int faer_qr_panel_route(int m, int b, int* ctas, long long* scratch_floats) {
  Plan pl;
  const cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return -(int)err - 2;
  if (ctas) *ctas = pl.ctas;
  if (scratch_floats) *scratch_floats = pl.scratch_floats;
  return pl.route;
}

// The largest cluster the cluster route uses on the current device, and how
// many clusters of `size` CTAs (1..16) at the most shared memory a CTA can
// take the device holds at once (cudaOccupancyMaxActiveClusters). Returns
// the CUDA error (0 on success).
extern "C" int faer_qr_panel_clusters(int size, int* max_cluster, int* active) {
  DeviceInfo d;
  cudaError_t err = device_info(&d);
  if (err == cudaSuccess) err = active_clusters(size, d.smem_max, active);
  if (err == cudaSuccess) *max_cluster = d.max_cluster;
  return (int)err;
}

// panel: (m, b) f32 with row stride lda, m >= 1, 1 <= b <= 4096; out: (m, b)
// contiguous; taus: [min(m, b)]; scratch: scratch_floats floats of global
// memory, at least what faer_qr_panel_route gives (may be null when that is
// 0); all on the current device (the caller selects it). Returns the CUDA
// error of the launch, 100000 if the grid route's CTAs cannot be
// co-resident, 0 on success.
extern "C" int faer_qr_panel(const float* panel, long long lda, float* out, float* taus,
                             float* scratch, long long scratch_floats, int m, int b,
                             void* stream) {
  Plan pl;
  cudaError_t err = plan_of(m, b, &pl);
  if (err != cudaSuccess) return err;
  if (pl.route == kRefused || lda < b || scratch_floats < pl.scratch_floats ||
      (pl.scratch_floats > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  Args args{panel, lda, out, taus, scratch, m, b, pl.rpc};
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
    err = cudaLaunchKernelEx(&cfg, qr_panel_kernel<true, true>, args);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  void (*kern)(Args) = pl.rows_in_smem ? qr_panel_kernel<false, true>
                                        : qr_panel_kernel<false, false>;
  int per_sm = 0, sms = 0, device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        (size_t)pl.smem_bytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * sms < pl.ctas) return kNotCoResident;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(pl.ctas),
                                    dim3(kThreads), kargs, (size_t)pl.smem_bytes,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef FAER_QR_PROFILE
// Copies the 6 phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_qr_panel_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[6] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}

// on != 0: plan every later (m, b) on the grid route, as faer_qr_panel_route
// then reports; 0: the route (m, b) selects.
extern "C" void faer_qr_panel_profile_force_grid(int on) { g_force_grid = on != 0; }
#endif
