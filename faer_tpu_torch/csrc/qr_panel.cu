// qr_panel: Householder QR of an (m, b) f32 panel, m >= b, b <= 512.
//
// Replaces: faer_tpu/ops/pallas/qr_panel_v5.py `qr_panel_v5_pallas` (:144,
// body `_qr_v5_kernel` :73). Contract: out holds beta on the diagonal, the
// reflector tails v (v[j] = 1 implied) strictly below it and R above it;
// taus[j] = tau_j, with H_j = I - tau_j v v^T. Signs as in the TPU kernel
// (qr_panel_v5.py:92-108) and LAPACK larfg: beta = -sign(alpha) * norm with
// sign = +1 for alpha >= 0 (so -0.0 counts as >= 0), norm = sqrt(alpha^2 +
// sum(tail^2)) unscaled, tau = (beta - alpha) / beta, v = x / (alpha - beta);
// a zero tail gives tau = 0, beta = alpha and v = e_j.
//
// What bounds it on the H100: a (4096, 128) panel is 2 MiB, far more than
// one SM's 227 KB of shared memory, and every column needs two reductions
// over all m rows before the next column can start: the tail norm (for beta
// and tau), then w = v^T A over the later columns. The panel is bound by
// those 2 b grid-wide reductions in a row, not by its 2 b^2 (m - b/3) FLOPs
// (2 us at 67 TFLOP/s) or its 4 MiB of traffic (1.3 us).
//
// Design: one cooperative grid of G CTAs (at most one per SM, at least 64
// rows each), CTA g owning rows [g * rpc, (g + 1) * rpc) for the whole
// factorization. When they fit, the rows live in shared memory (64 rows x
// 129 x 4 B = 33 KB at m = 4096, b = 128; the row stride b + 1 keeps column
// reads free of bank conflicts). Past about 58 000 rows at b = 128 (13 700
// at b = 512) they do not, and each CTA works on its rows in place in the
// output, in global memory (L2-resident up to tens of MB), so every m runs.
// Only the CTA's own threads touch its rows, so __syncthreads() orders those
// accesses in either place. v is not stored apart: it is column j itself,
// which holds 1 on row j until the later columns are updated.
// Per column j, two grid barriers:
//   1. each CTA publishes its share of the tail's sum of squares (and the
//      owner of row j publishes alpha); grid.sync();
//   2. every CTA sums the G shares itself, in one fixed order, so all CTAs
//      compute the same beta, tau and 1 / (alpha - beta) bit for bit and
//      apply the same reflector; it then forms v on its own rows and
//      publishes its share of w = v^T A[:, j+1:]; grid.sync();
//   3. every CTA sums the G shares of w in one fixed order and applies the
//      rank-1 update A -= tau v w^T to its own rows.
// Each reflector is applied to all later columns at once (the TPU kernel
// defers it to compact-WY sub-blocks of 16): the same function in another
// order of rounding. All arithmetic is FP32. Each published buffer is
// written before one barrier and read before the next, and the next write
// to it comes only after that next barrier, so no buffer needs two halves;
// they are written with __stcg and read with __ldcg (L2 only), since an
// SM's L1 may still hold the same addresses from an earlier column. The
// wrapper checks that the grid fits co-resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 512;
constexpr int kNotCoResident = 100000;

// Block-wide sum in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = 0.0f;
    for (int q = 0; q < kWarps; ++q) v += red[q];
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
qr_panel_kernel(const float* __restrict__ panel, int lda, float* out,
                float* taus, float* part_sq, float* part_w, float* alpha_buf,
                int m, int b, int rpc, int rows_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float s_tau, s_beta, s_sinv;
  __shared__ int s_id;

  const int G = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int r_begin = cta * rpc;
  const int nrows = max(0, min(rpc, m - r_begin));
  // this CTA's rows: rpc x ld in shared memory, or in place in `out`
  const int ld = rows_in_smem ? b + 1 : b;
  float* sA = rows_in_smem ? smem : out + (size_t)r_begin * b;
  float* sTw = rows_in_smem ? smem + rpc * ld : smem;  // b, tau * w
  float* sRed = sTw + b;  // kWarps x b, per-warp column sums
  for (int idx = tid; idx < nrows * b; idx += kThreads) {
    const int i = idx / b, c = idx % b;
    sA[i * ld + c] = panel[(size_t)(r_begin + i) * lda + c];
  }
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    // 1. this CTA's share of the tail's sum of squares (its rows > j)
    float s = 0.0f;
    for (int i = max(0, j + 1 - r_begin) + tid; i < nrows; i += kThreads) {
      const float x = sA[i * ld + j];
      s = fmaf(x, x, s);
    }
    s = block_sum(s, red);
    if (tid == 0) {
      __stcg(part_sq + cta, s);
      const int lj = j - r_begin;
      if (lj >= 0 && lj < nrows) __stcg(alpha_buf, sA[lj * ld + j]);
    }
    grid.sync();

    // 2. the reflector, from the G shares summed in one fixed order
    if (warp == 0) {
      float t = 0.0f;
      for (int g = lane; g < G; g += 32) t += __ldcg(part_sq + g);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_down_sync(0xffffffffu, t, off);
      if (lane == 0) {
        const float alpha = __ldcg(alpha_buf);
        const float norm = sqrtf(alpha * alpha + t);
        const float beta = alpha >= 0.0f ? -norm : norm;
        const bool is_id = (t == 0.0f);
        s_id = is_id;
        s_tau = is_id ? 0.0f : (beta - alpha) / beta;
        s_beta = is_id ? alpha : beta;
        s_sinv = is_id ? 1.0f : 1.0f / (alpha - beta);
        if (cta == 0) taus[j] = s_tau;
      }
    }
    __syncthreads();
    const float tau = s_tau;
    const int w = b - j - 1;
    const int id = j - r_begin;  // the local index of row j, if this CTA has it
    // column j becomes v (with v_j = 1 on row j while the later columns are
    // updated, then beta there)
    for (int i = max(0, id) + tid; i < nrows; i += kThreads) {
      float* x = sA + i * ld + j;
      *x = i == id ? (w == 0 ? s_beta : 1.0f) : (s_id ? 0.0f : *x * s_sinv);
    }
    __syncthreads();
    if (w == 0) break;  // the last column: nothing to its right

    // this CTA's share of w = v^T A[:, j+1:] over its rows >= j: warps split
    // the rows, then their sums are added in warp order
    const int i0 = max(0, id);
    for (int c = j + 1 + lane; c < b; c += 32) {
      float acc = 0.0f;
      for (int i = i0 + warp; i < nrows; i += kWarps)
        acc = fmaf(sA[i * ld + j], sA[i * ld + c], acc);
      sRed[warp * b + c] = acc;
    }
    __syncthreads();
    for (int c = j + 1 + tid; c < b; c += kThreads) {
      float acc = 0.0f;
      for (int q = 0; q < kWarps; ++q) acc += sRed[q * b + c];
      __stcg(part_w + (size_t)cta * b + c, acc);
    }
    grid.sync();

    // 3. w from the G shares in one fixed order, then A -= tau v w^T
    for (int c = j + 1 + lane; c < b; c += 32) {
      float acc = 0.0f;
      for (int g = warp; g < G; g += kWarps)
        acc += __ldcg(part_w + (size_t)g * b + c);
      sRed[warp * b + c] = acc;
    }
    __syncthreads();
    for (int c = j + 1 + tid; c < b; c += kThreads) {
      float acc = 0.0f;
      for (int q = 0; q < kWarps; ++q) acc += sRed[q * b + c];
      sTw[c] = tau * acc;
    }
    __syncthreads();
    const int nr = nrows - i0;
    for (int idx = tid; idx < nr * w; idx += kThreads) {
      const int i = i0 + idx / w, c = j + 1 + idx % w;
      sA[i * ld + c] = fmaf(-sTw[c], sA[i * ld + j], sA[i * ld + c]);
    }
    __syncthreads();
    // row j takes beta; no later step of the panel reads column j
    if (tid == 0 && id >= 0 && id < nrows) sA[id * ld + j] = s_beta;
  }

  if (rows_in_smem) {
    for (int idx = tid; idx < nrows * b; idx += kThreads) {
      const int i = idx / b, c = idx % b;
      out[(size_t)(r_begin + i) * b + c] = sA[i * ld + c];
    }
  }
}

}  // namespace

// panel: (m, b) f32 with row stride lda, m >= b, b <= 512; out: (m, b)
// contiguous; taus: [b]; part_sq: [grid]; part_w: [grid * b]; alpha: [1];
// all on the current device (the caller selects it). grid * rpc >= m.
// The rows go to shared memory when rpc of them fit one CTA's, else they
// stay in `out`. Returns the CUDA error of the launch, 100000 if the grid
// cannot be co-resident, 0 on success.
extern "C" int faer_qr_panel(const float* panel, int lda, float* out,
                             float* taus, float* part_sq, float* part_w,
                             float* alpha, int m, int b, int grid_size,
                             int rpc, void* stream) {
  if (b < 1 || b > kMaxB || m < b || lda < b || grid_size < 1 ||
      grid_size * rpc < m)
    return cudaErrorInvalidValue;
  const size_t fixed = ((size_t)b + (size_t)kWarps * b) * sizeof(float);
  const size_t rows = (size_t)rpc * (b + 1) * sizeof(float);
  int per_sm = 0, sms = 0, device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int rows_in_smem = rows + fixed <= (size_t)smem_max;
  const size_t smem = rows_in_smem ? rows + fixed : fixed;
  err = cudaFuncSetAttribute(
      qr_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_panel_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if ((long)per_sm * sms < grid_size) return kNotCoResident;
  void* args[] = {&panel, &lda, &out, &taus, &part_sq, &part_w,
                  &alpha, &m, &b, &rpc, &rows_in_smem};
  err = cudaLaunchCooperativeKernel((const void*)qr_panel_kernel,
                                    dim3(grid_size), dim3(kThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
