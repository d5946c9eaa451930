// tridiag_sweep: one Wilkinson-shifted implicit-QR bulge chase on the block
// [l, m] of a symmetric tridiagonal (d (n,), e (n-1,)), f32.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `tridiag_sweep_pallas`
// (:390, body `_tridiag_sweep_kernel` :322), which runs the same recurrence
// on VMEM-resident rows with register carries and emits the Givens
// coefficients for the eigenvector GEMM chain.
//
// What bounds it on the H100: neither bytes (6n floats in and out) nor
// FLOPs (about 30 per step), but the serial dependence of the chase: step i
// needs the (x, bulge) carry of step i-1, and each step has a square root
// and two divides on that chain. Nothing inside one sweep runs in parallel.
//
// Design: one CTA. Its threads set c = 1 and s = 0 and copy d and e to where
// the chase works on them: shared memory when the 2n floats fit in the 48 KB
// of dynamic shared memory a block gets without opting in (every D&C leaf and
// every direct-route n), else in place in the outputs in global memory, so
// that every n runs. Then one thread runs the chain over i in [l, m) in
// registers (the Pallas loop's inactive steps are identity, so skipping them
// computes the same thing), and the CTA copies the staged d and e out.
// l, m and the shift mu are read from device memory, so the driver never
// copies them to the host to launch a sweep. Every operation is rounded on
// its own (__fmul_rn and friends, no FMA contraction), in the order of the
// Pallas body, so the kernel and its plain PyTorch version round alike.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedN = 6144;  // 2n floats in 48 KB

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
tridiag_sweep_kernel(const int* __restrict__ lm, const float* __restrict__ mu_p,
                     const float* __restrict__ d_in,
                     const float* __restrict__ e_in, float* d_out,
                     float* e_out, float* c_out, float* s_out, int n,
                     int staged) {
  extern __shared__ float smem[];
  float* d = staged ? smem : d_out;
  float* e = staged ? smem + n : e_out;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = d_in[i];
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    e[i] = e_in[i];
    c_out[i] = 1.0f;
    s_out[i] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int l = lm[0], m = lm[1];
    if (0 <= l && l < m && m <= n - 1) {  // else an identity sweep
      float x = sub(d[l], mu_p[0]);
      float bz = e[l];
      for (int i = l; i < m; ++i) {
        const float r = __fsqrt_rn(add(mul(x, x), mul(bz, bz)));
        const float c = (r == 0.0f) ? 1.0f : __fdiv_rn(x, r);
        const float s = (r == 0.0f) ? 0.0f : __fdiv_rn(bz, r);
        c_out[i] = c;
        s_out[i] = s;
        if (i > l) e[i - 1] = r;
        const float di = d[i], dip1 = d[i + 1], ei = e[i];
        const float cc = mul(c, c), ss = mul(s, s);
        const float cs2 = mul(mul(2.0f, c), s);
        const float new_di = add(add(mul(cc, di), mul(cs2, ei)), mul(ss, dip1));
        const float new_dip1 = add(sub(mul(ss, di), mul(cs2, ei)), mul(cc, dip1));
        const float new_ei = add(mul(mul(c, s), sub(dip1, di)), mul(sub(cc, ss), ei));
        d[i] = new_di;
        d[i + 1] = new_dip1;
        e[i] = new_ei;
        const bool has_next = i + 1 < m;
        const float e_next = e[min(i + 1, n - 2)];
        if (has_next) e[i + 1] = mul(c, e_next);
        bz = has_next ? mul(s, e_next) : 0.0f;
        x = new_ei;
      }
    }
  }
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) d_out[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) e_out[i] = e[i];
  }
}

}  // namespace

// lm: int32 (l, m); mu: one f32; d, d_out: (n,); e, e_out, c, s: (n-1,); all
// contiguous on the current device (the caller selects it), n >= 2. Returns
// the CUDA error of the launch (0 on success).
extern "C" int faer_tridiag_sweep(const int* lm, const float* mu,
                                  const float* d, const float* e, float* d_out,
                                  float* e_out, float* c, float* s, int n,
                                  void* stream) {
  if (n < 2) return cudaErrorInvalidValue;
  const int staged = n <= kMaxStagedN;
  const size_t smem = staged ? 2 * (size_t)n * sizeof(float) : 0;
  tridiag_sweep_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      lm, mu, d, e, d_out, e_out, c, s, n, staged);
  return cudaGetLastError();
}
