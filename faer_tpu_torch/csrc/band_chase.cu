// band_chase: `steps` serially dependent bulge-chase window steps over g
// independent strips of (4b, 2b) f32, b <= 1024.
//
// Replaces: faer_tpu/ops/pallas/band_chase.py `chase_probe` (:89, body
// `_chase_kernel` :73, step `_window_step` :39). Step i works on the
// (2b, 2b) window at rows (i mod 3) b of each strip: the Householder that
// zeroes rows 2..b of its column 0 (tau = 0 when that tail is zero), then
// u = tau W v, gamma = tau/2 v^T u, w~ = u - gamma v and the rank-2 update
// W <- W - v w~^T - w~ v^T. The windows of steps i and i + 1 share b rows,
// so the steps form a chain.
//
// What bounds it on the H100: the chain. A step is two reductions, a
// (2b x b) matvec and a (2b)^2 update, about 20 b^2 FLOPs, each needing the
// one before; bytes (the strip in and out once) and FLOPs are far below
// what the card can do. The Pallas kernel keeps the strips in VMEM and
// loops over the steps inside one program; so does this one.
//
// Design: one CTA of 512 threads per strip (strips never touch each other),
// the step loop inside the kernel, one launch a call. The strip lives in
// shared memory when it fits (b <= 84: (256, 128) floats, 128 KiB, at
// b = 64), else in place in the output in global memory (512 KiB a strip at
// b = 128, 4 MiB at g = 8, which stays in L2); v and u are in shared memory
// either way. Per step: warp 0 reduces |x|^2 and forms v and tau; a barrier;
// a warp per row forms u; a barrier; every warp reduces v^T u (the same sum
// in the same order, so every thread holds the same gamma) and the CTA
// applies the rank-2 update; a barrier. The scalar steps and the update are
// rounded one operation at a time (__fmul_rn and friends) in the order of
// `_window_step`, so a zero tail gives exactly tau = 0; the sums are FFMA
// chains and warp shuffles. FP32 only.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 1024;
constexpr size_t kSmemBytes = 232448;  // 227 KiB

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
chase_kernel(const float* __restrict__ in, float* out, int b, int steps,
             int staged) {
  extern __shared__ float smem[];
  const int tb = 2 * b;
  const size_t strip = (size_t)4 * b * tb;
  const float* src = in + blockIdx.x * strip;
  float* dst = out + blockIdx.x * strip;
  float* v = smem;        // tb
  float* u = smem + tb;   // tb
  float* s_tau = u + tb;  // 1 (padded to 4)
  float* band = staged ? s_tau + 4 : dst;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (size_t i = tid; i < strip; i += kThreads) band[i] = src[i];
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    float* w = band + (size_t)(step % 3) * b * tb;  // rows off .. off + 2b
    if (warp == 0) {  // the Householder of column 0, rows 1..b
      float sq = 0.0f;
      for (int r = 1 + lane; r <= b; r += 32) {
        const float x = w[(size_t)r * tb];
        sq = fmaf(x, x, sq);
      }
      sq = warp_sum(sq);
      const float alpha = w[tb];
      const float tail_sq = __fsub_rn(sq, __fmul_rn(alpha, alpha));
      const float norm = __fsqrt_rn(sq);
      const float beta = alpha >= 0.0f ? -norm : norm;
      const bool is_id = tail_sq <= 0.0f;
      const float safe_s = is_id ? 1.0f : __fsub_rn(alpha, beta);
      const float safe_b = is_id ? 1.0f : beta;
      const float tau = is_id ? 0.0f : __fdiv_rn(__fsub_rn(beta, alpha), safe_b);
      const float inv_s = __fdiv_rn(1.0f, safe_s);
      for (int r = lane; r < tb; r += 32)
        v[r] = r == 1 ? 1.0f
                      : (r >= 1 && r <= b ? __fmul_rn(w[(size_t)r * tb], inv_s) : 0.0f);
      if (lane == 0) *s_tau = tau;
    }
    __syncthreads();
    const float tau = *s_tau;
    for (int r = warp; r < tb; r += kWarps) {  // u = tau W v; v is 0 off 1..b
      const float* row = w + (size_t)r * tb;
      float acc = 0.0f;
      for (int c = 1 + lane; c <= b; c += 32) acc = fmaf(row[c], v[c], acc);
      acc = warp_sum(acc);
      if (lane == 0) u[r] = __fmul_rn(acc, tau);
    }
    __syncthreads();
    float vu = 0.0f;
    for (int r = 1 + lane; r <= b; r += 32) vu = fmaf(v[r], u[r], vu);
    const float gamma = __fmul_rn(__fmul_rn(0.5f, tau), warp_sum(vu));
    for (int idx = tid; idx < tb * tb; idx += kThreads) {
      const int r = idx / tb, c = idx - r * tb;
      const float wr = __fsub_rn(u[r], __fmul_rn(gamma, v[r]));
      const float wc = __fsub_rn(u[c], __fmul_rn(gamma, v[c]));
      w[idx] = __fsub_rn(__fsub_rn(w[idx], __fmul_rn(v[r], wc)), __fmul_rn(wr, v[c]));
    }
    __syncthreads();
  }

  if (staged)
    for (size_t i = tid; i < strip; i += kThreads) dst[i] = band[i];
}

}  // namespace

// in, out: (g * 4b, 2b) f32, contiguous, on the current device (the caller
// selects it). Returns the CUDA error of the launch (0 on success).
extern "C" int faer_chase_probe(const float* in, float* out, int b, int steps,
                                int g, void* stream) {
  if (b < 1 || b > kMaxB || steps < 0 || g < 1) return cudaErrorInvalidValue;
  const size_t base = (size_t)(4 * b + 4) * sizeof(float);
  const size_t strip = (size_t)8 * b * b * sizeof(float);
  const bool staged = base + strip <= kSmemBytes;
  const size_t smem = staged ? base + strip : base;
  cudaError_t err = cudaFuncSetAttribute(
      chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chase_kernel<<<g, kThreads, smem, (cudaStream_t)stream>>>(in, out, b, steps,
                                                            staged);
  return cudaGetLastError();
}
