// bidiag_sweep: one shifted Golub-Kahan implicit-QR sweep on the block
// [l, m] of an upper bidiagonal (d (n,), e (n-1,)), f32.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `bidiag_sweep_pallas`
// (:502, body `_bidiag_sweep_kernel` :423), which runs the chase on
// VMEM-resident rows and emits the right rotations (c1, s1, for V) and the
// left ones (c2, s2, for U).
//
// What bounds it on the H100: the serial chain, as in tridiag_sweep.cu: step
// i needs the (x, bulge) carry of step i-1, and each step has two square
// roots and four divides on it. Bytes (8n floats in and out) and FLOPs are
// negligible beside that latency.
//
// Design: the same as tridiag_sweep.cu. One CTA sets the rotations to the
// identity and stages d and e in shared memory when they fit in 48 KB, else
// works in place in the outputs in global memory; one thread runs the chase
// over [l, m) with register carries; l, m and mu come from device memory.
// Every operation is rounded on its own, in the Pallas body's order, so the
// kernel and its plain PyTorch version round alike.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedN = 6144;  // 2n floats in 48 KB

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// c, s, r with [[c, -s], [s, c]]^T [a, b]^T = [r, 0]^T
__device__ __forceinline__ void givens(float a, float b, float& c, float& s,
                                       float& r) {
  r = __fsqrt_rn(add(mul(a, a), mul(b, b)));
  c = (r == 0.0f) ? 1.0f : __fdiv_rn(a, r);
  s = (r == 0.0f) ? 0.0f : __fdiv_rn(b, r);
}

__global__ void __launch_bounds__(kThreads)
bidiag_sweep_kernel(const int* __restrict__ lm, const float* __restrict__ mu_p,
                    const float* __restrict__ d_in,
                    const float* __restrict__ e_in, float* d_out, float* e_out,
                    float* c1_out, float* s1_out, float* c2_out, float* s2_out,
                    int n, int staged) {
  extern __shared__ float smem[];
  float* d = staged ? smem : d_out;
  float* e = staged ? smem + n : e_out;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = d_in[i];
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    e[i] = e_in[i];
    c1_out[i] = 1.0f;
    s1_out[i] = 0.0f;
    c2_out[i] = 1.0f;
    s2_out[i] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int l = lm[0], m = lm[1];
    if (0 <= l && l < m && m <= n - 1) {  // else an identity sweep
      const float dl = d[l];
      float x = sub(mul(dl, dl), mu_p[0]);
      float bz = mul(dl, e[l]);
      for (int i = l; i < m; ++i) {
        float c1, s1, r1;
        givens(x, bz, c1, s1, r1);
        c1_out[i] = c1;
        s1_out[i] = s1;
        if (i > l) e[i - 1] = r1;
        const float di = d[i], dip1 = d[i + 1], ei = e[i];
        const float new_di = add(mul(c1, di), mul(s1, ei));
        const float new_ei = add(mul(-s1, di), mul(c1, ei));
        const float bulge = mul(s1, dip1);
        const float new_dip1 = mul(c1, dip1);
        float c2, s2, r2;
        givens(new_di, bulge, c2, s2, r2);
        c2_out[i] = c2;
        s2_out[i] = s2;
        const float e2v = add(mul(c2, new_ei), mul(s2, new_dip1));
        const float d2ip1 = add(mul(-s2, new_ei), mul(c2, new_dip1));
        d[i] = r2;
        d[i + 1] = d2ip1;
        e[i] = e2v;
        const bool has_next = i + 1 < m;
        const float e_next = e[min(i + 1, n - 2)];
        if (has_next) e[i + 1] = mul(c2, e_next);
        bz = has_next ? mul(s2, e_next) : 0.0f;
        x = e2v;
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

// lm: int32 (l, m); mu: one f32; d, d_out: (n,); e, e_out, c1, s1, c2, s2:
// (n-1,); all contiguous on the current device (the caller selects it),
// n >= 2. Returns the CUDA error of the launch (0 on success).
extern "C" int faer_bidiag_sweep(const int* lm, const float* mu, const float* d,
                                 const float* e, float* d_out, float* e_out,
                                 float* c1, float* s1, float* c2, float* s2,
                                 int n, void* stream) {
  if (n < 2) return cudaErrorInvalidValue;
  const int staged = n <= kMaxStagedN;
  const size_t smem = staged ? 2 * (size_t)n * sizeof(float) : 0;
  bidiag_sweep_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      lm, mu, d, e, d_out, e_out, c1, s1, c2, s2, n, staged);
  return cudaGetLastError();
}
