// tridiag_sweep: the implicit-shift QR iteration of a symmetric tridiagonal
// (d (n,), e (n-1,)). Two entries share one sweep routine:
//
// * faer_tridiag_sweep: one Wilkinson-shifted bulge chase on the block
//   [l, m], its rotations out (the one-sweep contract of the Pallas kernel);
// * faer_tridiag_qr_batched: the whole iteration of every problem of a
//   batch, one CTA a problem, in one launch: what tridiag_evd's loop does
//   per iteration (zero the negligible e, find the block end, advance l or
//   shift and sweep) and the rotation of the eigenvector matrix Z, in
//   float32 (faer_tridiag_qr_batched) and in float64
//   (faer_tridiag_qr_batched_f64, the f64 spectral entry points' route).
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `tridiag_sweep_pallas`
// (:390, body `_tridiag_sweep_kernel` :322), which runs one sweep on
// VMEM-resident rows and emits the Givens coefficients; the JAX package
// runs the iteration around it as one device-resident lax.while_loop
// (faer_tpu/linalg/tridiag_evd.py:184-210).
//
// What bounds it on the H100: neither bytes nor FLOPs but the serial chain
// of each sweep: step i needs step i-1's (x, bulge) carry, and each step has
// a square root and two divides on it. A sweep per launch with the host
// deciding the next one costs a launch, a host read and some thirty small
// PyTorch launches an iteration, so the batched entry keeps the iteration
// on the card: a D&C call's 64 leaves run side by side, one CTA each, with
// d, e, the rotations and (when it fits, every D&C leaf) Z in shared memory,
// else Z in global memory, column-major so that a warp's rows are adjacent.
//
// Design of the chain (a template on the element type T): one thread runs it with d[i], e[i] and d[i+1] in
// registers and the next step's d[i+2], e[i+2] loaded a step ahead, so no
// store-to-load round trip through shared memory sits on it; only the
// final value of each d and e is stored. After the chain every thread owns
// rows of Z and applies the sweep's rotations in order, its running column
// in a register (rotate_row_chain). The block end is a CTA minimum. Every
// operation is rounded on its own in the plain versions' order
// (spectral_qr.cuh), so d, e and the iteration counts equal the plain
// version's bit for bit.
#include <cuda_runtime.h>

#include "spectral_qr.cuh"

namespace {

using namespace faer_qr;

constexpr int kThreads = 256;  // the one-sweep entry
constexpr int kMaxStagedN = 6144;  // 2n floats in 48 KB

// One sweep with shift mu on the block [l, m] (0 <= l < m <= n-1) of (d, e),
// by one thread; its rotations to c[i], s[i] for i in [l, m). The pointers
// may be shared or global.
template <typename T>
__device__ void sweep_chain(T* d, T* e, T* c_out, T* s_out, int l, int m, T mu) {
  T di = d[l], ei = e[l], dip1 = d[l + 1];
  T x = sub(di, mu), bz = ei;
  T e_next = l + 1 < m ? e[l + 1] : T(0);  // e[i+1] as the sweep found it
  for (int i = l; i < m; ++i) {
    const bool has_next = i + 1 < m;
    // the next step's inputs, off the chain
    const T dip2 = has_next ? d[i + 2] : T(0);
    const T e_next2 = i + 2 < m ? e[i + 2] : T(0);
    T c, s, r;
    givens_sqrt(x, bz, c, s, r);
    c_out[i] = c;
    s_out[i] = s;
    if (i > l) e[i - 1] = r;
    const T cc = mul(c, c), ss = mul(s, s);
    const T cs2 = mul(mul(T(2), c), s);
    const T new_di = add(add(mul(cc, di), mul(cs2, ei)), mul(ss, dip1));
    const T new_dip1 = add(sub(mul(ss, di), mul(cs2, ei)), mul(cc, dip1));
    const T new_ei = add(mul(mul(c, s), sub(dip1, di)), mul(sub(cc, ss), ei));
    d[i] = new_di;
    x = new_ei;
    di = new_dip1;
    if (has_next) {
      ei = mul(c, e_next);
      bz = mul(s, e_next);
    }
    dip1 = dip2;
    e_next = e_next2;
  }
  d[m] = di;
  e[m - 1] = x;
}

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
    if (0 <= l && l < m && m <= n - 1) sweep_chain(d, e, c_out, s_out, l, m, mu_p[0]);
  }  // else an identity sweep
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) d_out[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) e_out[i] = e[i];
  }
}

// Shared memory of a batched CTA: d, e, c, s (nmax each), 32 ints of
// reduction scratch (padded to 8 bytes' alignment), and Z (nmax²) when it
// is kept there.
template <typename T>
size_t qr_smem(int nmax, bool z_shared) {
  return (4 * (size_t)nmax + (z_shared ? (size_t)nmax * nmax : 0)) * sizeof(T) +
         32 * sizeof(int);
}

// Problem b = blockIdx.x: d_all (B, nmax), e_all (B, nmax-1), its size
// sizes[b]; Z column-major (B, nmax, nmax) in global memory; info (B, 3):
// iterations, converged, chain steps.
template <typename T, bool kVectors>
__global__ void __launch_bounds__(kMaxThreads)
tridiag_qr_kernel(T* __restrict__ d_all, T* __restrict__ e_all,
                  const int* __restrict__ sizes, T* __restrict__ z_all,
                  int* __restrict__ info, int nmax, int factor, int z_shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  T* d = smem;
  T* e = d + nmax;
  T* cs = e + nmax;
  T* sn = cs + nmax;
  int* red = reinterpret_cast<int*>(sn + nmax);
  const int n = sizes[b];
  int* out = info + 3 * b;
  if (n < 1 || n > nmax) {  // not a problem this batch holds: left as it is
    if (tid == 0) out[0] = out[1] = out[2] = 0;
    return;
  }
  T* dg = d_all + (size_t)b * nmax;
  T* eg = e_all + (size_t)b * (nmax - 1);
  T* zg = z_all + (size_t)b * nmax * nmax;
  T* z = z_shared ? reinterpret_cast<T*>(red + 32) : zg;
  for (int i = tid; i < n; i += nt) d[i] = dg[i];
  for (int i = tid; i < n - 1; i += nt) e[i] = eg[i];
  if (kVectors)
    for (size_t k = tid; k < (size_t)nmax * nmax; k += nt)
      z[k] = k % (nmax + 1) == 0 ? T(1) : T(0);
  __syncthreads();
  int l = 0, it = 0, steps = 0;
  const int max_iters = factor * n;
  while (l < n - 1 && it < max_iters) {
    ++it;
    for (int i = tid; i < n - 1; i += nt)
      if (absv(e[i]) <= mul(Limits<T>::eps, add(absv(d[i]), absv(d[i + 1])))) e[i] = T(0);
    __syncthreads();
    // the end of the unreduced block starting at l
    int cand = n - 1;
    for (int i = l + tid; i < n - 1; i += nt)
      if (e[i] == T(0)) {
        cand = i;
        break;
      }
    const int m = cta_min(cand, red);
    if (m <= l) {
      ++l;
      continue;
    }
    if (tid == 0) {
      sweep_chain(d, e, cs, sn, l, m, wilkinson_shift(d[m - 1], e[m - 1], d[m]));
      steps += m - l;
    }
    __syncthreads();
    // rows past n stay those of the identity: the rotations leave them be
    if (kVectors)
      for (int r = tid; r < n; r += nt) rotate_row_chain(z + r, nmax, l, m, cs, sn);
    // the next iteration's barriers keep the chain off cs, sn until every
    // row is rotated
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) dg[i] = d[i];
  for (int i = tid; i < n - 1; i += nt) eg[i] = e[i];
  if (kVectors && z_shared)
    for (size_t k = tid; k < (size_t)nmax * nmax; k += nt) zg[k] = z[k];
  if (tid == 0) {
    out[0] = it;
    out[1] = l >= n - 1;
    out[2] = steps;
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

namespace {

template <typename T>
int qr_route(int nmax, int vectors) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return vectors && qr_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int qr_batched(T* d, T* e, const int* sizes, T* z, int* info, int batch, int nmax,
               int factor, int vectors, void* stream) {
  const int route = qr_route<T>(nmax, vectors);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int z_shared = route == 0;
  const size_t smem = qr_smem<T>(nmax, z_shared);
  const int threads = cta_threads(nmax);
  cudaError_t err;
  if (vectors) {
    err = allow_smem(tridiag_qr_kernel<T, true>, smem);
    if (err != cudaSuccess) return err;
    tridiag_qr_kernel<T, true><<<batch, threads, smem, (cudaStream_t)stream>>>(
        d, e, sizes, z, info, nmax, factor, z_shared);
  } else {
    err = allow_smem(tridiag_qr_kernel<T, false>, smem);
    if (err != cudaSuccess) return err;
    tridiag_qr_kernel<T, false><<<batch, threads, smem, (cudaStream_t)stream>>>(
        d, e, sizes, z, info, nmax, factor, 0);
  }
  return cudaGetLastError();
}

}  // namespace

// Where the batched entry keeps Z for problems of up to nmax: 0 in shared
// memory, 1 in global memory (or no Z: vectors == 0), -1 refused (nmax
// outside [1, kMaxN]); float32 and float64 entries.
extern "C" int faer_tridiag_qr_route(int nmax, int vectors) {
  return qr_route<float>(nmax, vectors);
}
extern "C" int faer_tridiag_qr_route_f64(int nmax, int vectors) {
  return qr_route<double>(nmax, vectors);
}

// The iteration of `batch` problems: d (batch, nmax) and e (batch, nmax-1)
// in place, sizes (batch,) int32, z (batch, nmax, nmax) column-major (or
// null without vectors), info (batch, 3) int32; at most factor·n iterations
// a problem. All contiguous on the current device. Returns the CUDA error of
// the launch (0 on success). float32 and float64 entries.
extern "C" int faer_tridiag_qr_batched(float* d, float* e, const int* sizes, float* z,
                                       int* info, int batch, int nmax, int factor,
                                       int vectors, void* stream) {
  return qr_batched<float>(d, e, sizes, z, info, batch, nmax, factor, vectors, stream);
}
extern "C" int faer_tridiag_qr_batched_f64(double* d, double* e, const int* sizes,
                                           double* z, int* info, int batch, int nmax,
                                           int factor, int vectors, void* stream) {
  return qr_batched<double>(d, e, sizes, z, info, batch, nmax, factor, vectors, stream);
}
