// lu_panel_swap: partial-pivot LU of an (m, b) f32 panel that swaps rows.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `lu_panel_pallas` (:81,
// body `_lu_panel_kernel` :35), the first LU panel kernel. Unlike the
// virtual-pivot kernels it swaps rows physically: at column j it picks the
// position p >= j with the largest |A[p, j]| in the current row order (ties
// to the lowest position, as jax.lax.argmax), swaps rows j and p and their
// perm entries, counts the swap when p != j, writes the multipliers
// A[i, j] / A[j, j] below the pivot and applies one rank-1 update to the
// trailing rows and columns. nt is that swap count, not the transposition
// count of the final permutation (the same parity, another number), and
// perm is the identity with every swap applied.
//
// What bounds it on the H100: as for the other LU panels, the b pivot
// searches over all m rows form a chain of b grid-wide reductions; a
// (4096, 128) panel's 0.7 MFLOP and 4 MiB of traffic are far below it.
//
// Design: one cooperative grid of G CTAs (about one per SM), CTA g owning
// row *positions* [g * rpc, (g + 1) * rpc) for the whole factorization: a
// swap moves row contents between the owners of the two positions, never
// the ownership. The rows live in shared memory when they fit and in place
// in the output (global memory) when they do not. Per column j:
//   1. each CTA publishes its best (|value|, position) over its positions
//      >= j with a copy of that row and its perm entry; the owner of
//      position j also publishes row j and its perm entry;
//   2. one grid.sync();
//   3. every CTA reduces the G candidates in one order (ties to the lowest
//      position), so all agree on p;
//   4. the owner of position j takes the winner's published row, the owner
//      of p the published row j (each with its perm entry);
//   5. each CTA writes the multipliers of its positions > j into column j,
//      then the rank-1 update of their columns > j (the product rounded
//      before the subtraction, as the plain version's two PyTorch ops do).
// CTA 0 counts the swaps. The published rows and candidates alternate
// between two buffers by column parity, so a fast CTA never overwrites one
// a slow CTA is still reading, and are read with __ldcg (L2 only), since an
// SM's L1 may still hold the same addresses from two columns before. The
// wrapper checks that the grid fits co-resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "pivot_argmax.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNotCoResident = 100000;

using faer_pivot::better;

__global__ void __launch_bounds__(kThreads)
lu_panel_swap_kernel(const float* __restrict__ panel, int lda, float* out,
                     int* perm_out, int* nt_out, int* ok_out, float* cand_val,
                     int* cand_idx, int* cand_perm, float* cand_row,
                     float* rowj_buf, int* rowj_perm, int m, int b, int rpc,
                     int rows_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int s_p;

  const int G = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  // this CTA's rows: rpc x b in shared memory, or in place in `out`
  float* sA = rows_in_smem ? smem : out + (size_t)r_begin * b;
  float* sPiv = rows_in_smem ? smem + rpc * b : smem;  // b, the pivot row
  int* sPerm = reinterpret_cast<int*>(sPiv + b);      // rpc
  for (int idx = tid; idx < nrows * b; idx += kThreads) {
    const int i = idx / b, j = idx % b;
    sA[idx] = panel[(size_t)(r_begin + i) * lda + j];
  }
  for (int i = tid; i < nrows; i += kThreads) sPerm[i] = r_begin + i;
  __syncthreads();

  const bool counts = cta == 0 && tid == 0;
  int ok = 1, nt = 0;
  // kmax = min(m, b) steps, each updating all b columns, as the Pallas body
  // does: a wide panel (m < b) comes back whole, U12 right of column m
  const int kmax = min(m, b);
  for (int j = 0; j < kmax; ++j) {
    const int half = (j & 1) * G;
    const int slot = half + cta;
    // 1. this CTA's candidate over its positions >= j, and row j
    const int first = max(0, j - r_begin);  // first local row at position >= j
    float bv = -1.0f;
    int bi = INT_MAX;
    for (int i = first + tid; i < nrows; i += kThreads) {
      float v = fabsf(sA[i * b + j]);
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
      const int li = s_p - r_begin;
      for (int c = tid; c < b; c += kThreads)
        cand_row[(size_t)slot * b + c] = sA[li * b + c];
      if (tid == 0) cand_perm[slot] = sPerm[li];
    }
    const bool own_j = j >= r_begin && j < r_begin + nrows;
    if (own_j) {
      const int lj = j - r_begin;
      for (int c = tid; c < b; c += kThreads)
        rowj_buf[(size_t)(j & 1) * b + c] = sA[lj * b + c];
      if (tid == 0) rowj_perm[j & 1] = sPerm[lj];
    }
    grid.sync();

    // 2. the pivot position: every CTA reduces all G candidates in one order
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
    const int bg = p / rpc;  // the CTA that owns position p published row p
    for (int c = tid; c < b; c += kThreads)
      sPiv[c] = __ldcg(cand_row + (size_t)(half + bg) * b + c);
    __syncthreads();

    // 3. the swap: position j takes row p, position p takes row j
    if (p != j) {
      if (own_j) {
        const int lj = j - r_begin;
        for (int c = tid; c < b; c += kThreads) sA[lj * b + c] = sPiv[c];
        if (tid == 0) sPerm[lj] = __ldcg(cand_perm + half + bg);
      }
      if (bg == cta) {
        const int lp = p - r_begin;
        for (int c = tid; c < b; c += kThreads)
          sA[lp * b + c] = __ldcg(rowj_buf + (size_t)(j & 1) * b + c);
        if (tid == 0) sPerm[lp] = __ldcg(rowj_perm + (j & 1));
      }
      if (counts) ++nt;
    }
    const float pv = sPiv[j];
    ok &= (pv != 0.0f);
    const float safe = pv == 0.0f ? 1.0f : pv;
    __syncthreads();

    // 4. multipliers of the positions > j, kept in column j
    const int below = max(0, j + 1 - r_begin);  // first local row at position > j
    for (int i = below + tid; i < nrows; i += kThreads)
      sA[i * b + j] = sA[i * b + j] / safe;
    __syncthreads();
    // 5. rank-1 update of their columns > j
    const int w = b - j - 1;
    const int h = nrows - below;
    if (w > 0 && h > 0) {
      for (int idx = tid; idx < h * w; idx += kThreads) {
        const int i = below + idx / w, c = j + 1 + idx % w;
        sA[i * b + c] = __fsub_rn(sA[i * b + c], __fmul_rn(sA[i * b + j], sPiv[c]));
      }
    }
    __syncthreads();
  }

  if (rows_in_smem) {
    for (int idx = tid; idx < nrows * b; idx += kThreads) {
      const int i = idx / b, j = idx % b;
      out[(size_t)(r_begin + i) * b + j] = sA[idx];
    }
  }
  for (int i = tid; i < nrows; i += kThreads) perm_out[r_begin + i] = sPerm[i];
  if (counts) {
    *nt_out = nt;
    *ok_out = ok;
  }
}

}  // namespace

// panel: (m, b) f32 with row stride lda, m, b >= 1; out: (m, b) contiguous;
// perm: int[m]; nt, ok: int[1]; cand_val / cand_idx / cand_perm: [2 * grid];
// cand_row: [2 * grid * b]; rowj: [2 * b]; rowj_perm: int[2]; all on the
// current device (the caller selects it). grid * rpc >= m. The rows go to
// shared memory when rpc of them fit one CTA's, else they stay in `out`.
// Returns the CUDA error of the launch, 100000 if the grid cannot be
// co-resident, 0 on success.
extern "C" int faer_lu_panel_swap(const float* panel, int lda, float* out,
                                  int* perm, int* nt, int* ok, float* cand_val,
                                  int* cand_idx, int* cand_perm, float* cand_row,
                                  float* rowj, int* rowj_perm, int m, int b,
                                  int grid_size, int rpc, void* stream) {
  if (b < 1 || m < 1 || lda < b || grid_size < 1 || (long)grid_size * rpc < m)
    return cudaErrorInvalidValue;
  const size_t fixed = ((size_t)b + (size_t)rpc) * sizeof(float);
  const size_t rows = (size_t)rpc * b * sizeof(float);
  int per_sm = 0, sms = 0, device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int rows_in_smem = rows + fixed <= (size_t)smem_max;
  const size_t smem = rows_in_smem ? rows + fixed : fixed;
  err = cudaFuncSetAttribute(lu_panel_swap_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lu_panel_swap_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * sms < grid_size) return kNotCoResident;
  void* args[] = {&panel, &lda, &out, &perm, &nt, &ok, &cand_val, &cand_idx,
                  &cand_perm, &cand_row, &rowj, &rowj_perm, &m, &b, &rpc,
                  &rows_in_smem};
  err = cudaLaunchCooperativeKernel((const void*)lu_panel_swap_kernel,
                                    dim3(grid_size), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
