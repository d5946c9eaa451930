// llt_block: unblocked LLT of one (b, b) f32 symmetric block in one CTA,
// b <= 1024.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `llt_block_pallas` (:151,
// body `_llt_block_kernel` :116) at SB = 1, and `llt_block_v3_pallas` (:586,
// body `_llt_block_v3_kernel` :530) at SB = 8. Contract: out = L (lower,
// zeros above), cnt_ok = {regularization count, every pivot > 0}, with
// (eps, delta) applied per pivot as at :126-133 and :556-563.
//
// What bounds it on the H100: neither bytes (2 b^2 floats) nor FLOPs (b^3/3)
// but the chain of b dependent pivots, each a square root, a divide and an
// update that the next pivot reads. The Pallas kernels are one program with
// no grid over a block resident in VMEM; here one CTA walks the chain, and
// every step costs barriers.
//
// Design: one CTA of 512 threads holds the lower triangle column-major:
// packed in shared memory when b(b+1)/2 floats fit the 227 KiB a CTA can
// use (b <= 340), else in a b x b global-memory scratch that stays in L2
// (4 MiB at b = 1024). Per column j every thread reads the pivot, the CTA
// scales column j (IEEE divide, as `colj / piv`), and after a barrier:
//  - SB = 1 (v1): the trailing lower triangle gets the rank-1 update
//    L[r, c] -= L[c, j] * L[r, j], the product rounded, then subtracted, as
//    `o - col * colT`;
//  - SB = 8 (v3): the rest of the 8-column sub-block gets the same eager
//    update, and once per sub-block the trailing lower triangle gets
//    L[r, c] -= sum_k L[c, k] L[r, k] over its 8 columns, an FFMA chain in
//    place of the body's HIGHEST dot.
// The update maps a warp to a column and its lanes to consecutive rows, so
// loads are unit-stride in either memory. The diagonal entry is written by
// thread 0 after the barrier, when no thread reads it. FP32 only, no TF32.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 1024;
constexpr size_t kSmemBytes = 232448;  // 227 KiB

// The lower triangle, column-major: element (r, c), r >= c, at col(c)[r].
struct Lower {
  float* base;
  int b;
  bool packed;
  __device__ __forceinline__ float* col(int c) const {
    const long long cc = c;
    return packed ? base + (cc * b - cc * (cc - 1) / 2 - cc) : base + cc * b;
  }
};

template <int SB>
__global__ void __launch_bounds__(kThreads)
llt_block_kernel(const float* __restrict__ a, int lda, float* __restrict__ out,
                 float* work, int* cnt_ok, int b, float eps, float delta,
                 int use_eps) {
  extern __shared__ float smem[];
  const bool packed = work == nullptr;
  const Lower L{packed ? smem : work, b, packed};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int r = idx / b, c = idx - r * b;
    if (c <= r) L.col(c)[r] = a[(size_t)r * lda + c];
  }
  __syncthreads();

  int cnt = 0, ok = 1;  // every thread tallies alike; thread 0 stores them
  for (int s0 = 0; s0 < b; s0 += SB) {
    const int s1 = min(s0 + SB, b);
    for (int j = s0; j < s1; ++j) {
      float* cj = L.col(j);
      float pj = cj[j];
      const bool needs = pj <= delta;
      ok &= pj > 0.0f;
      if (use_eps) {
        if (needs) {
          pj = eps;
          ++cnt;
        }
      } else if (pj <= 0.0f) {
        pj = 1.0f;  // keep finite
      }
      const float piv = __fsqrt_rn(pj);
      for (int r = j + 1 + tid; r < b; r += kThreads)
        cj[r] = __fdiv_rn(cj[r], piv);
      __syncthreads();
      if (tid == 0) cj[j] = piv;
      if (j + 1 < s1) {  // eager update of the sub-block's later columns
        for (int r = j + 1 + tid; r < b; r += kThreads) {
          const float lrj = cj[r];
          const int cend = min(r, s1 - 1);
          for (int c = j + 1; c <= cend; ++c) {
            float* cc = L.col(c);
            cc[r] = __fsub_rn(cc[r], __fmul_rn(cj[c], lrj));
          }
        }
        __syncthreads();
      }
    }
    if (s1 < b) {  // a full sub-block: update the trailing lower triangle
      for (int c = s1 + warp; c < b; c += kWarps) {
        float lc[SB];
#pragma unroll
        for (int k = 0; k < SB; ++k) lc[k] = L.col(s0 + k)[c];
        float* cc = L.col(c);
        for (int r = c + lane; r < b; r += 32) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < SB; ++k) acc = fmaf(lc[k], L.col(s0 + k)[r], acc);
          cc[r] = __fsub_rn(cc[r], acc);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();  // the last diagonal entry

  for (int idx = tid; idx < b * b; idx += kThreads) {
    const int r = idx / b, c = idx - r * b;
    out[idx] = (c <= r) ? L.col(c)[r] : 0.0f;
  }
  if (tid == 0) {
    cnt_ok[0] = cnt;
    cnt_ok[1] = ok;
  }
}

}  // namespace

// a: (b, b) f32 with row stride lda (lower triangle read); out: (b, b)
// contiguous; work: b * b floats of scratch, or null when the packed lower
// triangle fits shared memory; cnt_ok: int[2]; sb: 1 (v1) or 8 (v3); all on
// the current device (the caller selects it). Returns the CUDA error of the
// launch (0 on success).
extern "C" int faer_llt_block(const float* a, int lda, float* out, float* work,
                              int* cnt_ok, int b, int sb, float eps,
                              float delta, int use_eps, void* stream) {
  if (b < 1 || b > kMaxB || lda < b || (sb != 1 && sb != 8))
    return cudaErrorInvalidValue;
  const size_t packed = (size_t)b * (b + 1) / 2 * sizeof(float);
  const bool staged = packed <= kSmemBytes;
  if (!staged && work == nullptr) return cudaErrorInvalidValue;
  const size_t smem = staged ? packed : 0;
  void (*kern)(const float*, int, float*, float*, int*, int, float, float, int) =
      sb == 1 ? llt_block_kernel<1> : llt_block_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      a, lda, out, staged ? nullptr : work, cnt_ok, b, eps, delta, use_eps);
  return cudaGetLastError();
}
