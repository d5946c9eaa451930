// lu_panel: partial-pivot LU of an (m, b) f32 panel with virtual pivots.
//
// Replaces: faer_tpu/ops/pallas/lu_panel_v5.py `lu_panel_v5_pallas` (:157,
// body `_lu_v5_kernel` :78). Like the TPU kernel it swaps no rows: for column
// r it picks the unused row p with the largest |V[p, r]| (ties to the lowest
// row index, as jax.lax.argmax does), scales the other unused rows' entries
// of column r by 1/V[p, r] and applies the rank-1 update to their columns
// > r. The pivot row keeps its values (it is row r of U). The kernel returns
// the virtual-pivot panel, the pivot row of each column and `ok`; the
// Python wrapper builds perm, packed and nt from them, as the TPU wrapper
// does outside its pallas_call (lu_panel_v5.py:193-205).
//
// What bounds it on the H100: a (4096, 256) panel is 4 MiB, far more than one
// SM's 227 KB of shared memory, and each of the b columns needs a search over
// all m rows before the next column can start: the panel is latency-bound by
// b grid-wide reductions, not by its 2 m b^2 / 2 FLOPs or its bytes.
//
// Design: one cooperative grid of G CTAs (about one per SM), CTA g owning
// rows [g * rpc, (g + 1) * rpc) of the panel for the whole factorization.
// When they fit, the rows live in shared memory (32 rows x 256 x 4 B = 32 KB
// at m = 4096); past about 29 000 rows at b = 256 they do not, and each CTA
// works on its rows in place in the output, in global memory, so every m
// runs. Only the CTA's own threads touch its rows, so __syncthreads() orders
// those accesses in either place. Per column: each
// CTA reduces its own rows to a candidate (value, row) and publishes it with
// a copy of the candidate's row; one grid.sync(); every CTA then reduces the
// G candidates itself (the same order everywhere, so every CTA agrees),
// takes the winner's row as the pivot row, and updates its own rows. One
// grid barrier per column. Candidate buffers alternate between two halves
// by column parity, so a fast CTA never overwrites a buffer a slow CTA is
// still reading; they are read with __ldcg (L2 only), since an SM's L1 may
// still hold the same addresses from two columns before. The wrapper checks
// that the grid fits co-resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNotCoResident = 100000;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide argmax; the result is valid in thread 0.
__device__ void block_argmax(float& v, int& i, float* wv, int* wi) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  warp_argmax(v, i);
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? wv[lane] : -2.0f;
    i = lane < kWarps ? wi[lane] : INT_MAX;
    warp_argmax(v, i);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lu_panel_kernel(const float* __restrict__ panel, int lda, float* virt,
                int* pidx, int* ok_out, float* cand_val, int* cand_idx,
                float* cand_row, int m, int b, int rpc, int rows_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int s_p;

  const int G = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
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
    const int slot = (r & 1) * G + cta;
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
    block_argmax(bv, bi, wv, wi);
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

    // 2. the global pivot: every CTA reduces all G candidates in one order
    const int half = (r & 1) * G;
    bv = -2.0f;
    bi = INT_MAX;
    int bg = 0;
    for (int g = tid; g < G; g += kThreads) {
      const float v = __ldcg(cand_val + half + g);
      const int i = __ldcg(cand_idx + half + g);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    block_argmax(bv, bi, wv, wi);
    if (tid == 0) s_p = bi;
    __syncthreads();
    const int p = s_p;
    bg = p / rpc;  // the CTA that owns row p published it in its slot
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
  if (cta == 0 && tid == 0) *ok_out = ok;
}

}  // namespace

// panel: (m, b) f32 with row stride lda, m >= b; virt: (m, b) contiguous;
// pidx: int[b]; ok: int[1]; cand_val / cand_idx: [2 * grid]; cand_row:
// [2 * grid * b]; all on the current device (the caller selects it).
// grid * rpc >= m. The rows go to shared memory when rpc of them fit one
// CTA's, else they stay in `virt`. Returns the CUDA error of the launch,
// 100000 if the grid cannot be co-resident, 0 on success.
extern "C" int faer_lu_panel(const float* panel, int lda, float* virt,
                             int* pidx, int* ok, float* cand_val,
                             int* cand_idx, float* cand_row, int m, int b,
                             int grid_size, int rpc, void* stream) {
  if (b < 1 || m < b || lda < b || grid_size < 1 || grid_size * rpc < m)
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
  err = cudaFuncSetAttribute(lu_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_panel_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * sms < grid_size) return kNotCoResident;
  void* args[] = {&panel, &lda, &virt, &pidx, &ok, &cand_val,
                  &cand_idx, &cand_row, &m, &b, &rpc, &rows_in_smem};
  err = cudaLaunchCooperativeKernel((const void*)lu_panel_kernel,
                                    dim3(grid_size), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
