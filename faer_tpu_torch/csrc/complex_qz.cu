// complex_qz: the single-shift complex QZ iteration of a Hessenberg/triangular
// pencil (H, T) (linalg/complex_qz.py, qz_iteration_plain), for a batch of
// problems, one CTA a problem, in one launch: every iteration's deflation
// test (the negligible subdiagonal entries of H zeroed against a floor that
// loosens as the block stalls, the start lo of the unreduced block ending at
// hi), and each sweep (the shift from the trailing 2×2 of H T⁻¹, T's
// diagonal guarded, the exceptional shift every 10 stalled sweeps; the
// chain of a left complex rotation of H's and T's rows and Q's columns and
// a right one of H's, T's and Z's columns that clears T's bulge), then the
// final negligible pass. S, T, Q, Z, the iteration count, the convergence
// flag and the chase steps come back with no host read. complex64 and
// complex128 instantiations, the matrices as interleaved (re, im) pairs.
//
// Replaces: no Pallas kernel. The JAX package runs this iteration as one
// XLA lax.while_loop (faer_tpu/linalg/qz.py:111, `qz_iteration`;
// faer_tpu/linalg/qz_cpair.py:182 on (re, im) pairs), its chase a fori_loop
// of whole-row and whole-column rotations; it is the window QZ of every
// aggressive-early-deflation round of the complex multishift QZ
// (faer_tpu/linalg/qz_multishift_cpair.py:480) and the whole QZ below
// n = 128. Driven from the host in PyTorch, a chase step would be some two
// dozen small launches and each iteration a host read.
//
// What bounds it on the H100: the chain of chase steps. Step i's left
// rotation comes from the bulge that step i-1 left in column i-1 of H, and
// its right rotation from T's 2×2 that the left one just changed, so the
// steps of a sweep run one after another, each two scalar chains of a
// scaled complex rotation and a few hundred flops over two rows and two
// columns of H, T, Q and Z: latency, not bytes or FLOPs.
//
// Design: complex_schur.cu's, with hess_tri.cu's four matrices. One CTA a
// problem, one thread a column (for the row phase) or a row (for the column
// phase). H and T are row-major; Q and Z are held by columns (the wrapper
// hands over their transposes), so that every rotation of their columns is
// a coalesced pass over two rows. All four sit in shared memory with an odd
// leading dimension while 4·nmax·ld complex entries fit the 227 KB a block
// can use, else in global memory, where the wrapper's buffers are. A chase
// step is a row phase that also stores T's new T[i+1, i] and T[i+1, i+1] in
// shared scratch, a barrier, a column phase in which every thread forms the
// right rotation from that scratch and which stores the next bulge (two
// entries of H's column i), and a barrier. Scalar decisions (lo, the shift,
// the rotations) are made by every thread from the same shared values, or
// by CTA reductions, so control flow is uniform. Every operation is an IEEE
// operation on a real number rounded on its own (complex_ops.cuh), in the
// order of qz_iteration_plain, so S, T, Q, Z and the counts equal the plain
// version's to the bit.
//
// Built with -DFAER_CQZ_PROFILE (`tools/torch_profile.py complex_qz` does,
// into a library of its own), thread 0 of each CTA adds its cycles by phase
// into g_prof, read by faer_complex_qz_profile_read.
#include <cuda_runtime.h>

#include "complex_ops.cuh"
#include "spectral_qr.cuh"

#ifdef FAER_CQZ_PROFILE
// 0 stage (the matrices in, ‖H‖), 1 deflation test (the negligible pass and
// lo), 2 shift, 3 row phase, 4 column phase, 5 out: thread 0's cycles,
// summed over CTAs and launches
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

// shared scratch ahead of the matrices: 32 ints and 32 T's of reduction,
// T's new (i+1, i) and (i+1, i+1) and the next bulge (4 complex entries),
// padded to 16 bytes
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes() {
  return (32 * sizeof(int) + 40 * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
size_t qz_smem(int nmax, bool shared) {
  return scratch_bytes<T>() +
         (shared ? 4 * (size_t)nmax * shared_ld(nmax) * sizeof(Cx<T>) : 0);
}

// complex_qz._shift: the eigenvalue of the trailing 2×2 M of H T⁻¹ nearer
// m22, T's diagonal entries below smlnum in magnitude taken as smlnum; the
// exceptional m22 + 0.75·|m21| when stall % 10 == 9
template <typename T>
__device__ __forceinline__ void qz_shift(Mat<Cx<T>> h, Mat<Cx<T>> t, int hi, int stall,
                                         T smlnum, T& mr, T& mi) {
  Cx<T> r11 = t(hi - 1, hi - 1), r22 = t(hi, hi);
  if (cabs(r11.re, r11.im) < smlnum) r11 = Cx<T>{smlnum, T(0)};
  if (cabs(r22.re, r22.im) < smlnum) r22 = Cx<T>{smlnum, T(0)};
  const Cx<T> r12 = t(hi - 1, hi);
  const Cx<T> h11 = h(hi - 1, hi - 1), h21 = h(hi, hi - 1), h12 = h(hi - 1, hi),
              h22 = h(hi, hi);
  Cx<T> m11, m21, m12, m22;
  cdiv(h11.re, h11.im, r11.re, r11.im, m11.re, m11.im);
  cdiv(h21.re, h21.im, r11.re, r11.im, m21.re, m21.im);
  T pr, pi;
  cmul(m11.re, m11.im, r12.re, r12.im, pr, pi);
  cdiv(sub(h12.re, pr), sub(h12.im, pi), r22.re, r22.im, m12.re, m12.im);
  cmul(m21.re, m21.im, r12.re, r12.im, pr, pi);
  cdiv(sub(h22.re, pr), sub(h22.im, pi), r22.re, r22.im, m22.re, m22.im);
  if (stall % 10 == 9) {  // exceptional shift
    mr = add(m22.re, mul(T(0.75), cabs(m21.re, m21.im)));
    mi = m22.im;
  } else {
    wilkinson(m11, m12, m21, m22, mr, mi);
  }
}

// complex_qz._sweep: one single-shift sweep on the unreduced block [lo, hi]
// (hi > lo); returns its chase steps. buf: T's (i+1, i), (i+1, i+1), then
// the next bulge. Ends in a barrier.
template <typename T>
__device__ int sweep(Mat<Cx<T>> h, Mat<Cx<T>> t, Mat<Cx<T>> qt, Mat<Cx<T>> zt, int n, int lo,
                     int hi, int stall, T smlnum, Cx<T>* buf PROF_ARG) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Cx<T> zero{T(0), T(0)};
  T mr, mi;
  qz_shift(h, t, hi, stall, smlnum, mr, mi);
  const Cx<T> h00 = h(lo, lo), r00 = t(lo, lo), h10 = h(lo + 1, lo);
  T pr, pi;
  cmul(mr, mi, r00.re, r00.im, pr, pi);
  T xr = sub(h00.re, pr), xi = sub(h00.im, pi), zr = h10.re, zi = h10.im;
  __syncthreads();  // every thread has read the pencil before the first rotation
  PROF_MARK(2)
  for (int i = lo; i < hi; ++i) {
    if (i > lo) {  // the bulge below the subdiagonal of column i-1
      xr = buf[2].re;
      xi = buf[2].im;
      zr = buf[3].re;
      zi = buf[3].im;
    }
    T c, sr, si, rr, ri;
    cgivens(xr, xi, zr, zi, c, sr, si, rr, ri);
    // rows i, i+1 take Gᴴ (H from column max(i-1, lo), T from column i);
    // Q's columns (Qᵀ's rows) take G
    const int h_from = max(i - 1, lo);
    const T msi = -si;
    for (int k = tid; k < n; k += nt) {
      if (k >= h_from) {
        Cx<T> a = h(i, k), b = h(i + 1, k);
        rotate(a, b, c, sr, si);
        if (i > lo && k == i - 1) {  // the entry it clears: r and an exact zero
          a = Cx<T>{rr, ri};
          b = zero;
        }
        h(i, k) = a;
        h(i + 1, k) = b;
      }
      if (k >= i) {
        Cx<T> a = t(i, k), b = t(i + 1, k);
        rotate(a, b, c, sr, si);
        t(i, k) = a;
        t(i + 1, k) = b;
        if (k <= i + 1) buf[k - i] = b;  // T[i+1, i], T[i+1, i+1]
      }
      Cx<T> q0 = qt(i, k), q1 = qt(i + 1, k);
      rotate(q0, q1, c, sr, msi);
      qt(i, k) = q0;
      qt(i + 1, k) = q1;
    }
    __syncthreads();
    PROF_MARK(3)
    // columns (i+1, i) clear T[i+1, i] against T[i+1, i+1]: H's rows
    // 0..min(i+2, hi), T's rows 0..i+1, Z's columns (Zᵀ's rows)
    T c2, s2r, s2i, t0, t1;
    {
      const Cx<T> bq = buf[0], aq = buf[1];
      cgivens(aq.re, -aq.im, bq.re, -bq.im, c2, s2r, s2i, t0, t1);
    }
    const T ms2i = -s2i;
    const int rend = min(i + 2, hi) + 1;
    for (int k = tid; k < n; k += nt) {
      if (k < rend) {
        Cx<T> a1 = h(k, i + 1), a0 = h(k, i);
        rotate(a1, a0, c2, s2r, ms2i);
        h(k, i + 1) = a1;
        h(k, i) = a0;
        if (k == i + 1 || k == i + 2) buf[k - i + 1] = a0;  // the next bulge
      }
      if (k <= i + 1) {
        Cx<T> a1 = t(k, i + 1), a0 = t(k, i);
        rotate(a1, a0, c2, s2r, ms2i);
        t(k, i + 1) = a1;
        t(k, i) = k == i + 1 ? zero : a0;
      }
      Cx<T> z1 = zt(i + 1, k), z0 = zt(i, k);
      rotate(z1, z0, c2, s2r, ms2i);
      zt(i + 1, k) = z1;
      zt(i, k) = z0;
    }
    __syncthreads();
    PROF_MARK(4)
  }
  return hi - lo;
}

// Problem b = blockIdx.x: s_all and t_all (B, nmax, nmax) row-major
// interleaved complex, qt_all and zt_all the transposes of Q and Z, the
// problem in [:n, :n] with n = sizes[b], worked on in place (in shared
// memory when `shared`); info (B, 3): iterations, converged, chase steps.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
complex_qz_kernel(Cx<T>* s_all, Cx<T>* t_all, Cx<T>* qt_all, Cx<T>* zt_all,
                  const int* __restrict__ sizes, int* __restrict__ info, int nmax, int factor,
                  int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);
  T* fred = reinterpret_cast<T*>(smem_raw + 32 * sizeof(int));
  Cx<T>* buf = reinterpret_cast<Cx<T>*>(fred + 32);
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
  const size_t off = (size_t)b * nmax * nmax;
  Cx<T>* const g[4] = {s_all + off, t_all + off, qt_all + off, zt_all + off};
  Mat<Cx<T>> m[4] = {{g[0], nmax}, {g[1], nmax}, {g[2], nmax}, {g[3], nmax}};
  if (shared) {
    const int ld = shared_ld(nmax);
    Cx<T>* base = reinterpret_cast<Cx<T>*>(smem_raw + scratch_bytes<T>());
    for (int x = 0; x < 4; ++x) m[x] = Mat<Cx<T>>{base + (size_t)x * nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) m[x](row, col) = g[x][(size_t)row * nmax + col];
    }
    __syncthreads();
  }
  const Mat<Cx<T>> h = m[0], t = m[1], qt = m[2], zt = m[3];
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
      steps += sweep(h, t, qt, zt, n, lo, hi, stall, smlnum, buf PROF_PASS);
      stall += 1;
    }
    ++it;
  }
  // the final negligible pass against the unloosened floor
  negligible_subdiag_c(h, n, smlnum);
  if (shared) {
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) g[x][(size_t)row * nmax + col] = m[x](row, col);
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
int qz_route(int nmax) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return qz_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int qz_batched(void* s, void* t, void* qt, void* zt, const int* sizes, int* info, int batch,
               int nmax, int factor, void* stream) {
  const int route = qz_route<T>(nmax);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = qz_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(complex_qz_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  complex_qz_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      static_cast<Cx<T>*>(s), static_cast<Cx<T>*>(t), static_cast<Cx<T>*>(qt),
      static_cast<Cx<T>*>(zt), sizes, info, nmax, factor, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H, T, Q and Z for problems of up to nmax: 0 in
// shared memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]);
// complex64 and complex128 entries.
extern "C" int faer_complex_qz_route(int nmax) { return qz_route<float>(nmax); }
extern "C" int faer_complex_qz_route_c128(int nmax) { return qz_route<double>(nmax); }

// The iteration of `batch` problems: s and t (batch, nmax, nmax) row-major
// interleaved complex (complex64 or complex128), holding H and T on entry
// and S and T on exit, and qt, zt the transposes of Q and Z (in place);
// sizes (batch,) int32, info (batch, 3) int32 (iterations, converged, chase
// steps); at most factor·n iterations a problem; the matrices in shared
// memory where route 0 says they fit, else in global memory. All contiguous
// on the current device. Returns the CUDA error of the launch (0 on
// success).
extern "C" int faer_complex_qz_batched(void* s, void* t, void* qt, void* zt, const int* sizes,
                                       int* info, int batch, int nmax, int factor,
                                       void* stream) {
  return qz_batched<float>(s, t, qt, zt, sizes, info, batch, nmax, factor, stream);
}
extern "C" int faer_complex_qz_batched_c128(void* s, void* t, void* qt, void* zt,
                                            const int* sizes, int* info, int batch, int nmax,
                                            int factor, void* stream) {
  return qz_batched<double>(s, t, qt, zt, sizes, info, batch, nmax, factor, stream);
}

#ifdef FAER_CQZ_PROFILE
// Copies the phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_complex_qz_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
