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
// The TPU kernels factor one panel a call, and the CALU leaf
// (faer_tpu/linalg/lu.py:87-128) calls v2 once for each row group; here the
// groups are one batch. Per column r of each panel: the unused row p with
// the largest |V[p, r]| (ties to the lowest row, as jax.lax.argmax), the
// other unused rows' entries of column r scaled by 1/V[p, r], and the
// rank-1 update of their columns > r. No row is swapped (the pivot row
// keeps its values: it is row r of U). The kernel returns each panel's
// virtual-pivot panel, its pivot row for each column and `ok`; the Python
// wrapper builds perm, packed and nt, as the TPU wrappers do outside their
// pallas_call (lu_panel_v2.py:183-196). The Pallas bodies' transposed
// layout, `used` lane masks and row chunks exist for VMEM and lanes and
// have no counterpart here; their deferred rank-8 or rank-16 updates are
// applied here as the rank-1 steps they sum.
//
// What bounds it on the H100: a (4096, 256) f32 panel is 4 MiB, far past
// one SM's 227 KB of shared memory, and every one of the b columns needs a
// search over all m rows of its panel before the next column can start.
// Each panel is latency-bound by b grid-wide reductions, not by its m b^2
// FLOPs or its bytes; a batch pays those b barriers once for all g panels
// where g calls would pay them g times.
//
// Design: one cooperative grid. blockIdx.y is the panel, and the G CTAs of
// that row of the grid own rows [x * rpc, (x + 1) * rpc) of it for the
// whole factorization, in shared memory when they fit (32 rows x 256 x 4 B
// = 32 KB for one (4096, 256) panel on 132 CTAs) and in place in the output
// (global memory) when they do not, so every m runs. With one CTA per SM in
// all the rows of a 16-group CALU batch (64 MiB) or of a 65536-row panel
// cannot fit; the grid then takes every CTA that fits co-resident (six a
// SM), which keeps six times the loads in flight
// (faer_lu_panel_batched_grid). Only the CTA's own
// threads touch its rows, so __syncthreads() orders those accesses in either
// place. Per column: each CTA reduces its own rows to a candidate (value,
// row) and publishes it with a copy of the candidate's row in its panel's
// slots; one grid.sync(); every CTA then reduces its panel's G candidates
// itself (the same order everywhere, so the panel's CTAs agree), takes the
// winner's row as the pivot row, and updates its own rows. The one barrier
// a column steps all panels together, which costs nothing extra since all
// have the same b. Candidate slots alternate between two halves by column
// parity, so a fast CTA never overwrites a slot a slow CTA is still
// reading, and are read with __ldcg (L2 only), since an SM's L1 may still
// hold the same addresses from two columns before. The entry point checks
// that the grid fits co-resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "pivot_argmax.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNotCoResident = 100000;

using faer_pivot::better;

__global__ void __launch_bounds__(kThreads)
lu_panel_batched_kernel(const float* __restrict__ panels, long long batch_stride,
                        int lda, float* virt_all, int* pidx_all, int* ok_all,
                        float* cand_val, int* cand_idx, float* cand_row, int m,
                        int b, int rpc, int rows_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int s_p;

  const int G = gridDim.x, cta = blockIdx.x, q = blockIdx.y, tid = threadIdx.x;
  const int slots = G * gridDim.y;  // candidate slots per column parity
  const int mine = q * G;           // this panel's first slot
  const float* panel = panels + (size_t)q * batch_stride;
  float* virt = virt_all + (size_t)q * m * b;
  int* pidx = pidx_all + (size_t)q * b;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  // this CTA's rows: rpc x b in shared memory, or in place in `virt`
  float* sV = rows_in_smem ? smem : virt + (size_t)r_begin * b;
  float* sPiv = rows_in_smem ? smem + rpc * b : smem;  // b, the pivot row
  int* sUsed = reinterpret_cast<int*>(sPiv + b);      // rpc
  for (int idx = tid; idx < nrows * b; idx += kThreads) {
    const int i = idx / b, j = idx % b;
    sV[idx] = panel[(size_t)(r_begin + i) * lda + j];
  }
  for (int i = tid; i < rpc; i += kThreads) sUsed[i] = (i < nrows) ? 0 : 1;
  __syncthreads();

  int ok = 1;
  for (int r = 0; r < b; ++r) {
    const int half = (r & 1) * slots + mine;
    const int slot = half + cta;
    // 1. this CTA's candidate: the largest |V[i, r]| over its unused rows
    float bv = -1.0f;
    int bi = INT_MAX;
    for (int i = tid; i < nrows; i += kThreads) {
      if (sUsed[i]) continue;
      float v = fabsf(sV[i * b + r]);
      if (v != v) v = INFINITY;  // a NaN wins, as in argmax
      if (better(v, r_begin + i, bv, bi)) {
        bv = v;
        bi = r_begin + i;
      }
    }
    faer_pivot::block_argmax<kThreads>(bv, bi, wv, wi);
    if (tid == 0) {
      cand_val[slot] = bv;
      cand_idx[slot] = bi;
      s_p = bi;
    }
    __syncthreads();
    if (s_p != INT_MAX) {
      const float* src = sV + (s_p - r_begin) * b;
      for (int j = tid; j < b; j += kThreads) cand_row[(size_t)slot * b + j] = src[j];
    }
    grid.sync();

    // 2. the panel's pivot: every CTA of the panel reduces its G candidates
    // in one order
    bv = -2.0f;
    bi = INT_MAX;
    for (int g = tid; g < G; g += kThreads) {
      const float v = __ldcg(cand_val + half + g);
      const int i = __ldcg(cand_idx + half + g);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    faer_pivot::block_argmax<kThreads>(bv, bi, wv, wi);
    if (tid == 0) s_p = bi;
    __syncthreads();
    const int p = s_p;
    const int bg = p / rpc;  // the CTA that owns row p published it in its slot
    for (int j = tid; j < b; j += kThreads)
      sPiv[j] = __ldcg(cand_row + (size_t)(half + bg) * b + j);
    if (tid == 0) {
      if (bg == cta) sUsed[p - r_begin] = 1;
      if (cta == 0) pidx[r] = p;
    }
    __syncthreads();
    const float pv = sPiv[r];
    ok &= (pv != 0.0f);
    const float inv = 1.0f / (pv == 0.0f ? 1.0f : pv);

    // 3. multipliers of column r (kept in column r), then the rank-1 update
    // of columns > r
    for (int i = tid; i < nrows; i += kThreads)
      if (!sUsed[i]) sV[i * b + r] *= inv;
    __syncthreads();
    const int w = b - r - 1;
    if (w > 0) {
      for (int idx = tid; idx < nrows * w; idx += kThreads) {
        const int i = idx / w, c = r + 1 + idx % w;
        if (!sUsed[i])
          sV[i * b + c] = fmaf(-sV[i * b + r], sPiv[c], sV[i * b + c]);
      }
    }
    __syncthreads();
  }

  if (rows_in_smem) {
    for (int idx = tid; idx < nrows * b; idx += kThreads) {
      const int i = idx / b, j = idx % b;
      virt[(size_t)(r_begin + i) * b + j] = sV[idx];
    }
  }
  if (cta == 0 && tid == 0) ok_all[q] = ok;
}

// Dynamic shared memory of a CTA of rpc rows: the rows when they are kept
// there, then the pivot row (b floats) and the used flags (rpc ints).
size_t smem_of(int b, int rpc, bool rows) {
  return ((rows ? (size_t)rpc * b : 0) + b + rpc) * sizeof(float);
}

// How many CTAs of the kernel fit one SM with `smem` bytes each (0 if the
// card's opt-in limit is exceeded); sets the kernel's dynamic limit to it.
cudaError_t per_sm_with(size_t smem, int* per_sm) {
  *per_sm = 0;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess || smem > (size_t)smem_max) return err;
  err = cudaFuncSetAttribute(lu_panel_batched_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, lu_panel_batched_kernel, kThreads, smem);
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

// The grid of faer_lu_panel_batched for g panels of (m, b) on the current
// device: *ctas CTAs a panel of *rpc rows each, at least min_rows. One CTA
// a SM in all when the rows then fit shared memory; else the rows stay in
// global memory and the panels share every CTA that fits co-resident.
extern "C" int faer_lu_panel_batched_grid(int g, int m, int b, int min_rows,
                                          int* ctas, int* rpc) {
  if (g < 1 || b < 1 || m < b || min_rows < 1) return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int most = (m + min_rows - 1) / min_rows;
  int n = std::max(1, std::min(sms / g, most));
  int r = (m + n - 1) / n;
  err = per_sm_with(smem_of(b, r, true), &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) {  // the rows do not fit: global memory
    err = per_sm_with(smem_of(b, r, false), &per_sm);
    if (err != cudaSuccess) return err;
    n = std::max(1, std::min(per_sm * sms / g, most));
    r = (m + n - 1) / n;
  }
  *rpc = r;
  *ctas = (m + r - 1) / r;
  return 0;
}

// panels: g panels of (m, b) f32, panel q at panels + q * batch_stride, row
// stride lda, m >= b; virt: (g, m, b) contiguous; pidx: int[g * b]; ok:
// int[g]; cand_val / cand_idx: [2 * g * ctas]; cand_row: [2 * g * ctas * b];
// all on the current device (the caller selects it). ctas * rpc >= m: each
// panel gets `ctas` CTAs of rpc rows (faer_lu_panel_batched_grid). The rows
// go to shared memory when rpc of them fit one CTA's and the grid is then
// co-resident, else they stay in `virt`. Returns the CUDA error of the
// launch, 100000 if the g * ctas CTAs cannot be co-resident, 0 on success.
extern "C" int faer_lu_panel_batched(const float* panels, long long batch_stride,
                                     int lda, float* virt, int* pidx, int* ok,
                                     float* cand_val, int* cand_idx,
                                     float* cand_row, int g, int m, int b,
                                     int ctas, int rpc, void* stream) {
  if (g < 1 || b < 1 || m < b || lda < b || ctas < 1 || (long)ctas * rpc < m ||
      g > 65535)
    return cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long need = (long)ctas * g;
  int rows_in_smem = 1;
  err = per_sm_with(smem_of(b, rpc, true), &per_sm);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * sms < need) {
    rows_in_smem = 0;
    err = per_sm_with(smem_of(b, rpc, false), &per_sm);
    if (err != cudaSuccess) return err;
    if ((long)per_sm * sms < need) return kNotCoResident;
  }
  const size_t smem = smem_of(b, rpc, rows_in_smem);
  void* args[] = {&panels, &batch_stride, &lda, &virt, &pidx, &ok, &cand_val,
                  &cand_idx, &cand_row, &m, &b, &rpc, &rows_in_smem};
  err = cudaLaunchCooperativeKernel((const void*)lu_panel_batched_kernel,
                                    dim3(ctas, g), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
