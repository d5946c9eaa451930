// complex_schur: the single-shift complex Schur iteration of a complex upper
// Hessenberg H (linalg/complex_schur.py), for a batch of problems, one CTA a
// problem, in one launch: every iteration's deflation test (the negligible
// subdiagonal entries zeroed against a floor that loosens as the block
// stalls, the start lo of the unreduced block ending at hi), and each sweep
// (the Wilkinson shift from the trailing 2×2, the exceptional shift every
// 10 stalled sweeps, the chain of complex Givens rotations applied to H's
// rows and columns and to Q's columns), then the final negligible pass. T,
// Q, the iteration count, the convergence flag and the chase steps come back
// with no host read. complex64 and complex128 instantiations, H and Q as
// interleaved (re, im) pairs.
//
// Replaces: no Pallas kernel. The JAX package runs this iteration as one
// XLA lax.while_loop (faer_tpu/linalg/evd.py:277, `complex_schur`), its
// chase a fori_loop of whole-row and whole-column rotations; it is the
// window Schur of every aggressive-early-deflation round of the complex
// multishift driver (faer_tpu/linalg/schur_multishift_cpair.py:327) and
// the whole Schur step below n = 128. Driven from the host in PyTorch, a
// chase step would be a dozen small launches and each iteration a host
// read.
//
// What bounds it on the H100: the chain of chase steps. Step i's rotation
// comes from the bulge that step i-1 left in column i-1, so the steps of a
// sweep run one after another, each a few hundred flops spread over two
// rows (n-i+1 columns) and two columns (i+3 rows of H, n of Q) of the
// matrix: latency, not bytes or FLOPs.
//
// Design: real_schur.cu's. One CTA a problem, one thread a column (for the
// row updates) or a row (for the column updates). H and Q sit in shared
// memory, row-major with an odd leading dimension, while 2·nmax·ld complex
// entries fit the 227 KB a block can use; past that they stay in global
// memory, where the wrapper's output buffers are. A chase step is a row
// phase, a barrier, a column phase that also stores the next bulge (2
// entries of column i) in shared scratch, and a barrier: every thread then
// forms the next rotation from that scratch in its own registers. Scalar
// decisions (lo, the shift, the rotations) are made by every thread from the
// same shared values, or by CTA reductions, so control flow is uniform.
// Every operation is an IEEE operation on a real number rounded on its own
// (spectral_qr.cuh), a complex product spelled out as (ac − bd, ad + bc),
// in the order of complex_schur_plain, so T, Q and the counts equal the
// plain version's to the bit.
//
// Built with -DFAER_SCHUR_PROFILE (`tools/torch_profile.py complex_schur`
// does, into a library of its own), thread 0 of each CTA adds its cycles by
// phase into g_prof, read by faer_complex_schur_profile_read.
#include <cuda_runtime.h>

#include "complex_ops.cuh"
#include "spectral_qr.cuh"

#ifdef FAER_SCHUR_PROFILE
// 0 stage (H and Q in, ‖H‖), 1 deflation test (the negligible pass and lo),
// 2 shift, 3 row phase, 4 column phase, 5 out: thread 0's cycles, summed
// over CTAs and launches
constexpr int kProf = 6;
__device__ long long g_prof[kProf];
#define PROF_START long long t_prof = clock64(); long long prof[kProf] = {0};
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long t_ = clock64(); prof[k] += t_ - t_prof; t_prof = t_; }
#define PROF_END \
  if (threadIdx.x == 0) for (int k = 0; k < kProf; ++k) atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)prof[k]);
#define PROF_ARG , long long* prof, long long& t_prof
#define PROF_PASS , prof, t_prof
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_END
#define PROF_ARG
#define PROF_PASS
#endif

namespace {

using namespace faer_qr;
using namespace faer_cx;

// shared scratch ahead of H and Q: 32 ints and 32 T's of reduction, the
// next bulge (2 complex entries), padded to 16 bytes
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes() {
  return (32 * sizeof(int) + 36 * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
size_t schur_smem(int nmax, bool shared) {
  return scratch_bytes<T>() +
         (shared ? 2 * (size_t)nmax * shared_ld(nmax) * sizeof(Cx<T>) : 0);
}

// complex_schur._sweep: one single-shift sweep on the unreduced block
// [lo, hi] (hi > lo); returns its chase steps (rotations). Ends in a
// barrier.
template <typename T>
__device__ int sweep(Mat<Cx<T>> h, Mat<Cx<T>> q, int n, int lo, int hi, int stall,
                     Cx<T>* vbuf PROF_ARG) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Cx<T> a22 = h(hi, hi);
  T mr, mi;
  if (stall % 10 == 9) {  // exceptional shift (LAPACK zlahqr)
    const Cx<T> a21 = h(hi, hi - 1);
    mr = add(a22.re, mul(T(0.75), cabs(a21.re, a21.im)));
    mi = a22.im;
  } else {
    wilkinson(h(hi - 1, hi - 1), h(hi - 1, hi), h(hi, hi - 1), a22, mr, mi);
  }
  const Cx<T> h00 = h(lo, lo), h10 = h(lo + 1, lo);
  T xr = sub(h00.re, mr), xi = sub(h00.im, mi), zr = h10.re, zi = h10.im;
  __syncthreads();  // every thread has read H before the first rotation
  PROF_MARK(2)
  for (int i = lo; i < hi; ++i) {
    if (i > lo) {  // the bulge below the subdiagonal of column i-1
      xr = vbuf[0].re;
      xi = vbuf[0].im;
      zr = vbuf[1].re;
      zi = vbuf[1].im;
    }
    T c, sr, si, rr, ri;
    cgivens(xr, xi, zr, zi, c, sr, si, rr, ri);
    // rows i, i+1 from column max(i-1, lo) on: row i ← c·a + s̄·b,
    // row i+1 ← c·b − s·a
    for (int j = max(i - 1, lo) + tid; j < n; j += nt) {
      Cx<T> a = h(i, j), b = h(i + 1, j);
      rotate(a, b, c, sr, si);
      if (i > lo && j == i - 1) {  // the entry it clears: r and an exact zero
        a = Cx<T>{rr, ri};
        b = Cx<T>{T(0), T(0)};
      }
      h(i, j) = a;
      h(i + 1, j) = b;
    }
    __syncthreads();
    PROF_MARK(3)
    // columns i, i+1 of H (rows 0..min(i+2, hi)) and of Q (every row):
    // column i ← c·x + s·y, column i+1 ← c·y − s̄·x
    const int rend = min(i + 2, hi) + 1;
    const T msi = -si;
    for (int r = tid; r < n; r += nt) {
      if (r < rend) {
        Cx<T> x = h(r, i), y = h(r, i + 1);
        rotate(x, y, c, sr, msi);
        h(r, i) = x;
        h(r, i + 1) = y;
        if (r == i + 1 || r == i + 2) vbuf[r - i - 1] = x;  // the next bulge
      }
      Cx<T> x = q(r, i), y = q(r, i + 1);
      rotate(x, y, c, sr, msi);
      q(r, i) = x;
      q(r, i + 1) = y;
    }
    __syncthreads();
    PROF_MARK(4)
  }
  return hi - lo;
}

// Problem b = blockIdx.x: t_all and q_all (B, nmax, nmax) row-major
// interleaved complex, the problem in [:n, :n] with n = sizes[b], worked on
// in place (in shared memory when `shared`); info (B, 3): iterations,
// converged, chase steps.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
complex_schur_kernel(Cx<T>* t_all, Cx<T>* q_all, const int* __restrict__ sizes,
                     int* __restrict__ info, int nmax, int factor, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);
  T* fred = reinterpret_cast<T*>(smem_raw + 32 * sizeof(int));
  Cx<T>* vbuf = reinterpret_cast<Cx<T>*>(fred + 32);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = sizes[b];
  int* out = info + 3 * b;
  if (n < 1 || n > nmax) {  // not a problem this batch holds: left as it is
    if (tid == 0) out[0] = out[1] = out[2] = 0;
    return;
  }
  if (n == 1) {
    if (tid == 0) {
      out[0] = out[2] = 0;
      out[1] = 1;
    }
    return;
  }
  PROF_START
  Cx<T>* tg = t_all + (size_t)b * nmax * nmax;
  Cx<T>* qg = q_all + (size_t)b * nmax * nmax;
  Mat<Cx<T>> h{tg, nmax}, q{qg, nmax};
  if (shared) {
    const int ld = shared_ld(nmax);
    h = Mat<Cx<T>>{reinterpret_cast<Cx<T>*>(smem_raw + scratch_bytes<T>()), ld};
    q = Mat<Cx<T>>{h.p + (size_t)nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int r = k / n, c = k % n;
      h(r, c) = tg[(size_t)r * nmax + c];
      q(r, c) = qg[(size_t)r * nmax + c];
    }
    __syncthreads();
  }
  T hn = T(0);
  for (int k = tid; k < n * n; k += nt) {
    const Cx<T> x = h(k / n, k % n);
    hn = nan_max(hn, cabs(x.re, x.im));
  }
  hn = cta_max_val(hn, fred);
  const T smlnum = mul(Limits<T>::eps, nan_max(hn, Limits<T>::tiny));
  const int max_iters = factor * n;
  int hi = n - 1, it = 0, stall = 0, steps = 0;
  PROF_MARK(0)
  while (hi >= 1 && it < max_iters) {
    negligible_subdiag_c(h, n, mul(smlnum, T(1 << min(stall / 5, stall_cap<T>()))));
    // lo: the start of the unreduced block that ends at hi
    int cand = 0;
    for (int i = tid; i < hi; i += nt) {
      const Cx<T> s = h(i + 1, i);
      if (s.re == T(0) && s.im == T(0)) cand = i + 1;
    }
    const int lo = cta_max_int(cand, red);
    PROF_MARK(1)
    if (lo == hi) {
      hi -= 1;
      stall = 0;
    } else {
      steps += sweep(h, q, n, lo, hi, stall, vbuf PROF_PASS);
      stall += 1;
    }
    ++it;
  }
  // the final negligible pass against the unloosened floor (H is exactly
  // Hessenberg throughout)
  negligible_subdiag_c(h, n, smlnum);
  if (shared) {
    for (int k = tid; k < n * n; k += nt) {
      const int r = k / n, c = k % n;
      tg[(size_t)r * nmax + c] = h(r, c);
      qg[(size_t)r * nmax + c] = q(r, c);
    }
  }
  if (tid == 0) {
    out[0] = it;
    out[1] = hi < 1;
    out[2] = steps;
  }
  PROF_MARK(5)
  PROF_END
}

template <typename T>
int schur_route(int nmax) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return schur_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int schur_batched(void* t, void* q, const int* sizes, int* info, int batch, int nmax,
                  int factor, void* stream) {
  const int route = schur_route<T>(nmax);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = schur_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(complex_schur_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  complex_schur_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      static_cast<Cx<T>*>(t), static_cast<Cx<T>*>(q), sizes, info, nmax, factor, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H and Q for problems of up to nmax: 0 in shared
// memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]);
// complex64 and complex128 entries.
extern "C" int faer_complex_schur_route(int nmax) { return schur_route<float>(nmax); }
extern "C" int faer_complex_schur_route_c128(int nmax) { return schur_route<double>(nmax); }

// The iteration of `batch` problems: t and q (batch, nmax, nmax) row-major
// interleaved complex (complex64 or complex128), holding H and the
// accumulating Q on entry and T and Q on exit (in place), sizes (batch,)
// int32, info (batch, 3) int32 (iterations, converged, chase steps); at
// most factor·n iterations a problem; H and Q in shared memory where route
// 0 says they fit, else in global memory. All contiguous on the current
// device. Returns the CUDA error of the launch (0 on success).
extern "C" int faer_complex_schur_batched(void* t, void* q, const int* sizes, int* info,
                                          int batch, int nmax, int factor, void* stream) {
  return schur_batched<float>(t, q, sizes, info, batch, nmax, factor, stream);
}
extern "C" int faer_complex_schur_batched_c128(void* t, void* q, const int* sizes, int* info,
                                               int batch, int nmax, int factor,
                                               void* stream) {
  return schur_batched<double>(t, q, sizes, info, batch, nmax, factor, stream);
}

#ifdef FAER_SCHUR_PROFILE
// Copies the phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_complex_schur_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
