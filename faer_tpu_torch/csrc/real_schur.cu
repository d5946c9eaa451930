// real_schur: the Francis double-shift real Schur iteration of an upper
// Hessenberg H (linalg/real_schur.py), for a batch of problems, one CTA a
// problem, in one launch: every iteration's deflation test (the negligible
// subdiagonal entries zeroed against a floor that loosens as the block
// stalls, the start lo of the unreduced block ending at hi), the 2×2
// standardization on deflation, and each sweep (the shifts, the exceptional
// shift every 10 stalled sweeps, the sweep start, the chain of 3×3
// reflectors applied to H's rows and columns and to Q's columns), then the
// final negligible pass. T, Q, the iteration count and the convergence flag
// come back with no host read. float32 and float64 instantiations.
//
// Replaces: no Pallas kernel. The JAX package runs this iteration as one
// XLA lax.while_loop (faer_tpu/linalg/real_schur.py:74, `real_schur`), its
// chase a masked fori_loop of dynamic-slice reflector applications; it is
// the window Schur of every aggressive-early-deflation round of the
// multishift driver (faer_tpu/linalg/schur_multishift.py:257) and the whole
// Schur step below n = 128 (faer_tpu/linalg/evd.py:440-453). Driven from the
// host in PyTorch, a chase step would be a dozen small launches and each
// iteration a host read.
//
// What bounds it on the H100: the chain of chase steps. Step i's reflector
// comes from the bulge that step i-1 left in column i-1, so the steps of a
// sweep run one after another, each a few hundred flops spread over one
// row (n-i+1 columns) and one column (i+4 rows of H, n of Q) of the
// matrix: latency, not bytes or FLOPs.
//
// Design: one CTA a problem, one thread a column (for the row updates) or a
// row (for the column updates). H and Q sit in shared memory, row-major
// with an odd leading dimension so that a column is read without bank
// conflicts, while 2·nmax·ld entries fit the 227 KB a block can use; past
// that they stay in global memory, where the wrapper's output buffers are.
// A chase step is a row phase, a barrier, a column phase that also stores
// the next bulge (3 entries of column i) in shared scratch, and a barrier:
// every thread then forms the next reflector from that scratch in its own
// registers, so no thread reads an entry another one is about to write.
// Scalar decisions (lo, the sweep start, the shifts, the reflectors, the
// 2×2 rotation) are made by every thread from the same shared values, or
// by CTA reductions, so control flow is uniform. Every operation is an IEEE
// operation rounded on its own (spectral_qr.cuh) in the order of
// real_schur_plain, so T, Q and the counts equal the plain version's to the
// bit.
//
// Built with -DFAER_SCHUR_PROFILE (`tools/torch_profile.py real_schur`
// does, into a library of its own), thread 0 of each CTA adds its cycles by
// phase into g_prof, read by faer_real_schur_profile_read.
#include <cuda_runtime.h>

#include "spectral_qr.cuh"

#ifdef FAER_SCHUR_PROFILE
// 0 stage (H and Q in, ‖H‖), 1 deflation (the negligible pass, lo, the 2×2
// standardizations), 2 shifts and sweep start, 3 row phase, 4 column
// phase, 5 out: thread 0's cycles, summed over CTAs and launches
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

// shared scratch ahead of H and Q: 32 ints and 32 T's of reduction, the
// next bulge (3 T's), padded to 16 bytes
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes() {
  return (32 * sizeof(int) + 35 * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
size_t schur_smem(int nmax, bool shared) {
  return scratch_bytes<T>() +
         (shared ? 2 * (size_t)nmax * shared_ld(nmax) * sizeof(T) : 0);
}

// real_schur._standardize_2x2: the rotation (cs, sn) standardizing
// [[a, b], [c, d]]; returns whether its eigenvalues are real
template <typename T>
__device__ __forceinline__ bool standardize_2x2(T a, T b, T c, T d, T& cs, T& sn) {
  const T m = mul(T(0.5), add(a, d));
  const T pp = mul(T(0.5), sub(a, d));
  const T disc = add(mul(pp, pp), mul(b, c));
  if (disc >= T(0)) {
    const T sq = sqrt_rn(absv(disc));
    const T lam = add(m, pp >= T(0) ? sq : -sq);
    unit_pair(sub(lam, d), c, cs, sn);
    return true;
  }
  T c2, s2;
  unit_pair(add(b, c), sub(d, a), c2, s2);
  if (c2 >= T(0)) {
    const T big = sqrt_rn(mul(add(T(1), c2), T(0.5)));
    cs = big;
    sn = dvd(s2, mul(T(2), big));
  } else {
    const T small = copysign(sqrt_rn(mul(sub(T(1), c2), T(0.5))), s2);
    cs = dvd(s2, mul(T(2), small));
    sn = small;
  }
  return false;
}

// real_schur._standardize_block: the 2×2 diagonal block at (lo, lo)
// standardized by a rotation of H's rows lo, lo+1 (from column lo on), its
// columns (rows 0..lo+1) and Q's columns. Ends in a barrier.
template <typename T>
__device__ void standardize_block(Mat<T> h, Mat<T> q, int n, int lo) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T cs, sn;
  const bool real = standardize_2x2(h(lo, lo), h(lo, lo + 1), h(lo + 1, lo),
                                    h(lo + 1, lo + 1), cs, sn);
  __syncthreads();  // every thread has read the block
  for (int j = lo + tid; j < n; j += nt) {
    const T r0 = h(lo, j), r1 = h(lo + 1, j);
    h(lo, j) = add(mul(cs, r0), mul(sn, r1));
    h(lo + 1, j) = add(mul(-sn, r0), mul(cs, r1));
  }
  __syncthreads();
  for (int r = tid; r < n; r += nt) {
    if (r < lo + 2) {
      const T c0 = h(r, lo), c1 = h(r, lo + 1);
      h(r, lo) = add(mul(cs, c0), mul(sn, c1));
      h(r, lo + 1) = add(mul(-sn, c0), mul(cs, c1));
    }
    const T c0 = q(r, lo), c1 = q(r, lo + 1);
    q(r, lo) = add(mul(cs, c0), mul(sn, c1));
    q(r, lo + 1) = add(mul(-sn, c0), mul(cs, c1));
  }
  __syncthreads();
  if (tid == 0) {
    if (real) {
      h(lo + 1, lo) = T(0);
    } else {
      const T mean = mul(T(0.5), add(h(lo, lo), h(lo + 1, lo + 1)));
      h(lo, lo) = mean;
      h(lo + 1, lo + 1) = mean;
    }
  }
  __syncthreads();
}

// real_schur._sweep: one double-shift sweep on the unreduced block
// [lo, hi] (hi - lo >= 2); returns its chase steps (reflectors). Ends in a
// barrier.
template <typename T>
__device__ int sweep(Mat<T> h, Mat<T> q, int n, int lo, int hi, int stall, int* red,
                      T* vbuf PROF_ARG) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const T eps = Limits<T>::eps;
  T h11 = h(hi - 1, hi - 1), h12 = h(hi - 1, hi), h21 = h(hi, hi - 1), h22 = h(hi, hi);
  if (stall % 10 == 9) {  // exceptional shift (LAPACK dlahqr)
    const T se = add(absv(h21), absv(h(hi - 1, hi - 2)));
    h11 = add(mul(T(0.75), se), h22);
    h12 = mul(T(-0.4375), se);
    h21 = se;
    h22 = add(mul(T(0.75), se), h(hi, hi));
  }
  const T s = add(h11, h22);
  const T p = sub(mul(h11, h22), mul(h12, h21));
  // the sweep start: the largest m in (lo, hi-2] where the bulge's
  // introduction is negligible against H[m, m-1], else lo
  int mc = -1;
  for (int m = lo + 1 + tid; m <= hi - 2; m += nt) {
    const T h11m = h(m, m), h22m = h(m + 1, m + 1), h21m = h(m + 1, m);
    const T h12m = h(m, m + 1), h32m = h(m + 2, m + 1);
    T v1m = add(sub(add(mul(h11m, h11m), mul(h12m, h21m)), mul(s, h11m)), p);
    T v2m = mul(h21m, sub(add(h11m, h22m), s));
    T v3m = mul(h21m, h32m);
    // scaled by its largest magnitude: the test is homogeneous in it
    T vm = nan_max(nan_max(absv(v1m), absv(v2m)), absv(v3m));
    if (vm == T(0)) vm = T(1);
    v1m = dvd(v1m, vm);
    v2m = dvd(v2m, vm);
    v3m = dvd(v3m, vm);
    const T lhs = mul(absv(h(m, m - 1)), add(absv(v2m), absv(v3m)));
    const T rhs = mul(mul(eps, absv(v1m)),
                      add(add(absv(h(m - 1, m - 1)), absv(h11m)), absv(h22m)));
    if (lhs <= rhs) mc = m;  // m grows along a thread's loop
  }
  const int m0 = max(cta_max_int(mc, red), lo);
  // the first column of H² − sH + pI at the sweep start, scaled
  const T a0 = h(m0, m0), b0 = h(m0, m0 + 1), c0 = h(m0 + 1, m0);
  const T d0 = h(m0 + 1, m0 + 1), e0 = h(m0 + 2, m0 + 1);
  T v1 = add(sub(add(mul(a0, a0), mul(b0, c0)), mul(s, a0)), p);
  T v2 = mul(c0, sub(add(a0, d0), s));
  T v3 = mul(c0, e0);
  const T scale =
      nan_max(nan_max(absv(v1), absv(v2)), nan_max(absv(v3), Limits<T>::tiny));
  v1 = dvd(v1, scale);
  v2 = dvd(v2, scale);
  v3 = dvd(v3, scale);
  __syncthreads();  // every thread has read H before the first reflector
  PROF_MARK(2)
  for (int i = m0; i < hi; ++i) {
    const bool last = i == hi - 1;
    if (i > m0) {  // the bulge below the subdiagonal of column i-1
      v1 = vbuf[0];
      v2 = vbuf[1];
      v3 = vbuf[2];
    }
    if (last) v3 = T(0);
    T tau, u2, u3, beta;
    house3(v1, v2, v3, tau, u2, u3, beta);
    // rows i..i+2 (i..i+1 on the last step) from column i-1 on
    for (int j = max(i - 1, 0) + tid; j < n; j += nt) {
      T r0 = h(i, j), r1 = h(i + 1, j), r2 = T(0);
      T w = add(r0, mul(u2, r1));
      if (!last) {
        r2 = h(i + 2, j);
        w = add(w, mul(u3, r2));
      }
      r0 = sub(r0, mul(tau, w));
      r1 = sub(r1, mul(tau, mul(u2, w)));
      if (!last) r2 = sub(r2, mul(tau, mul(u3, w)));
      if (j == i - 1) {  // the column the reflector clears: β and exact zeros
        if (i > m0) r0 = beta;
        r1 = r2 = T(0);
      }
      h(i, j) = r0;
      h(i + 1, j) = r1;
      if (!last) h(i + 2, j) = r2;
    }
    __syncthreads();
    PROF_MARK(3)
    // columns i..i+2 of H (rows 0..min(i+3, hi)) and of Q (every row)
    const int rend = min(i + 3, hi) + 1;
    for (int r = tid; r < n; r += nt) {
      if (r < rend) {
        T x0 = h(r, i), x1 = h(r, i + 1), x2 = T(0);
        T w = add(x0, mul(u2, x1));
        if (!last) {
          x2 = h(r, i + 2);
          w = add(w, mul(u3, x2));
        }
        x0 = sub(x0, mul(tau, w));
        h(r, i) = x0;
        h(r, i + 1) = sub(x1, mul(tau, mul(u2, w)));
        if (!last) h(r, i + 2) = sub(x2, mul(tau, mul(u3, w)));
        if (r > i && r <= i + 3) vbuf[r - i - 1] = x0;  // the next bulge
      }
      const T y0 = q(r, i), y1 = q(r, i + 1);
      T y2 = T(0);
      T w = add(y0, mul(u2, y1));
      if (!last) {
        y2 = q(r, i + 2);
        w = add(w, mul(u3, y2));
      }
      q(r, i) = sub(y0, mul(tau, w));
      q(r, i + 1) = sub(y1, mul(tau, mul(u2, w)));
      if (!last) q(r, i + 2) = sub(y2, mul(tau, mul(u3, w)));
    }
    __syncthreads();
    PROF_MARK(4)
  }
  return hi - m0;
}

// Problem b = blockIdx.x: t_all and q_all (B, nmax, nmax) row-major, the
// problem in [:n, :n] with n = sizes[b], worked on in place (in shared
// memory when `shared`); info (B, 3): iterations, converged, chase steps.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
real_schur_kernel(T* t_all, T* q_all, const int* __restrict__ sizes, int* __restrict__ info,
                  int nmax, int factor, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);
  T* fred = reinterpret_cast<T*>(smem_raw + 32 * sizeof(int));
  T* vbuf = fred + 32;
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
  T* tg = t_all + (size_t)b * nmax * nmax;
  T* qg = q_all + (size_t)b * nmax * nmax;
  Mat<T> h{tg, nmax}, q{qg, nmax};
  if (shared) {
    const int ld = shared_ld(nmax);
    h = Mat<T>{reinterpret_cast<T*>(smem_raw + scratch_bytes<T>()), ld};
    q = Mat<T>{h.p + (size_t)nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int r = k / n, c = k % n;
      h(r, c) = tg[(size_t)r * nmax + c];
      q(r, c) = qg[(size_t)r * nmax + c];
    }
    __syncthreads();
  }
  T hn = T(0);
  for (int k = tid; k < n * n; k += nt) hn = nan_max(hn, absv(h(k / n, k % n)));
  hn = cta_max_val(hn, fred);
  const T smlnum = mul(Limits<T>::eps, nan_max(hn, Limits<T>::tiny));
  const int max_iters = factor * n;
  int hi = n - 1, it = 0, stall = 0, steps = 0;
  PROF_MARK(0)
  while (hi >= 1 && it < max_iters) {
    negligible_subdiag(h, n, mul(smlnum, T(1 << min(stall / 5, stall_cap<T>()))));
    // lo: the start of the unreduced block that ends at hi
    int cand = 0;
    for (int i = tid; i < hi; i += nt)
      if (h(i + 1, i) == T(0)) cand = i + 1;
    const int lo = cta_max_int(cand, red);
    const int nr = hi - lo + 1;
    if (nr == 1) {
      hi -= 1;
    } else if (nr == 2) {
      standardize_block(h, q, n, lo);
      hi = lo - 1;
    }
    PROF_MARK(1)
    if (nr > 2) steps += sweep(h, q, n, lo, hi, stall, red, vbuf PROF_PASS);
    stall = nr <= 2 ? 0 : stall + 1;
    ++it;
  }
  // exact zeros below the subdiagonal, then the final negligible pass
  // against the unloosened floor
  for (int k = tid; k < n * n; k += nt) {
    const int r = k / n, c = k % n;
    if (r > c + 1) h(r, c) = T(0);
  }
  __syncthreads();
  negligible_subdiag(h, n, smlnum);
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
int schur_batched(T* t, T* q, const int* sizes, int* info, int batch, int nmax, int factor,
                  void* stream) {
  const int route = schur_route<T>(nmax);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = schur_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(real_schur_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  real_schur_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      t, q, sizes, info, nmax, factor, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H and Q for problems of up to nmax: 0 in shared
// memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]); float32
// and float64 entries.
extern "C" int faer_real_schur_route(int nmax) { return schur_route<float>(nmax); }
extern "C" int faer_real_schur_route_f64(int nmax) { return schur_route<double>(nmax); }

// The iteration of `batch` problems: t and q (batch, nmax, nmax) row-major,
// holding H and the accumulating Q on entry and T and Q on exit (in place),
// sizes (batch,) int32, info (batch, 3) int32 (iterations, converged,
// chase steps); at
// most factor·n iterations a problem; H and Q in shared memory where route
// 0 says they fit, else in global memory. All contiguous on the current device. Returns the
// CUDA error of the launch (0 on success). float32 and float64 entries.
extern "C" int faer_real_schur_batched(float* t, float* q, const int* sizes, int* info,
                                       int batch, int nmax, int factor, void* stream) {
  return schur_batched<float>(t, q, sizes, info, batch, nmax, factor, stream);
}
extern "C" int faer_real_schur_batched_f64(double* t, double* q, const int* sizes, int* info,
                                           int batch, int nmax, int factor, void* stream) {
  return schur_batched<double>(t, q, sizes, info, batch, nmax, factor, stream);
}

#ifdef FAER_SCHUR_PROFILE
// Copies the phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_real_schur_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
