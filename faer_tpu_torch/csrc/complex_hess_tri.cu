// complex_hess_tri: the complex Givens chain of the Hessenberg–triangular
// reduction of a pencil (linalg/complex_qz.py, hessenberg_triangular_plain),
// for a batch of problems, one CTA a problem, in one launch. On entry H is
// any square matrix and R upper triangular (the QR of B and A ← Q₀ᴴA run
// before it, in PyTorch); for each column j, bottom up, a pair of complex
// rotations G = [[c, −s̄], [s, c]]: Gᴴ on rows (i, i+1) zeroes H[i+1, j] (on
// H, R and Q's columns) and leaves a bulge at R[i+1, i]; a rotation of
// columns (i+1, i), formed from conj(R[i+1, i+1]) and conj(R[i+1, i]),
// zeroes it (on R, H and Z's columns). H comes back exactly Hessenberg and R
// exactly triangular. complex64 and complex128 instantiations, the matrices
// as interleaved (re, im) pairs.
//
// Replaces: no Pallas kernel. The JAX package runs this chain as two nested
// XLA fori_loops (faer_tpu/linalg/qz.py:45, `hessenberg_triangular`;
// faer_tpu/linalg/qz_cpair.py:133 on (re, im) pairs), each pair a masked
// rotation of whole rows and columns. Driven from the host in PyTorch, each
// of the (n-1)(n-2)/2 pairs would be some twenty small launches. The
// multishift QZ (linalg/qz_multishift.py) also runs it on each AED window's
// kept block, whose Givens phase is this chain.
//
// What bounds it on the H100: the chain of pairs. A pair's column rotation
// comes from R's diagonal 2×2 that its row rotation just changed, and the
// next pair's rows overlap it, so the pairs run one after another, each a
// complex rotation of 2·(5n − j) entries of H, R, Q and Z after a scalar
// chain of two scaled rotations: latency, not bytes or FLOPs.
//
// Design: hess_tri.cu's, with complex_schur.cu's arithmetic. One CTA a
// problem, one thread a column (for the row rotations) or a row (for the
// column rotations). H and R are row-major; Q and Z are held by columns
// (the wrapper hands over their transposes), so that every rotation of
// their columns is a coalesced pass over two rows. All four sit in shared
// memory with an odd leading dimension while 4·nmax·ld entries fit the 227
// KB a block can use, else in global memory, where the wrapper's buffers
// are. A pair is a row phase that also stores R's new R[i+1, i] and R[i+1,
// i+1] in shared scratch, a barrier, a column phase in which every thread
// forms the column rotation from that scratch (and the next pair's row
// rotation from column j of H, which no column rotation of this column's
// pass touches), and a barrier. Every operation is an IEEE operation on a
// real number rounded on its own (complex_ops.cuh), in the order of
// hessenberg_triangular_plain, so H, R, Q and Z equal the plain version's to
// the bit.
//
// Built with -DFAER_CHT_PROFILE (`tools/torch_profile.py complex_hess_tri`
// does, into a library of its own), thread 0 of each CTA adds its cycles by
// phase into g_prof, read by faer_complex_hess_tri_profile_read.
#include <cuda_runtime.h>

#include "complex_ops.cuh"
#include "spectral_qr.cuh"

#ifdef FAER_CHT_PROFILE
// 0 stage (the matrices in), 1 row phase, 2 column phase, 3 out: thread 0's
// cycles, summed over CTAs and launches
constexpr int kProf = 4;
__device__ long long g_prof[kProf];
#define PROF_START long long t_prof = clock64(); long long prof[kProf] = {0};
#define PROF_MARK(k) \
  if (threadIdx.x == 0) { const long long t_ = clock64(); prof[k] += t_ - t_prof; t_prof = t_; }
#define PROF_END \
  if (threadIdx.x == 0) for (int k = 0; k < kProf; ++k) atomicAdd((unsigned long long*)&g_prof[k], (unsigned long long)prof[k]);
#else
#define PROF_START
#define PROF_MARK(k)
#define PROF_END
#endif

namespace {

using namespace faer_qr;
using namespace faer_cx;

// shared scratch ahead of the matrices: R's new (i+1, i) and (i+1, i+1)
constexpr size_t kScratch = 32;

template <typename T>
size_t hess_tri_smem(int nmax, bool shared) {
  return kScratch + (shared ? 4 * (size_t)nmax * shared_ld(nmax) * sizeof(Cx<T>) : 0);
}

// Problem b = blockIdx.x: h_all and r_all (B, nmax, nmax) row-major
// interleaved complex, qt_all and zt_all the transposes of Q and Z, the
// problem in [:n, :n] with n = sizes[b], worked on in place (in shared
// memory when `shared`).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
complex_hess_tri_kernel(Cx<T>* h_all, Cx<T>* r_all, Cx<T>* qt_all, Cx<T>* zt_all,
                        const int* __restrict__ sizes, int nmax, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* rbuf = reinterpret_cast<Cx<T>*>(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = sizes[b];
  if (n < 3 || n > nmax) return;  // nothing to reduce, or not a problem of this batch
  PROF_START
  const size_t off = (size_t)b * nmax * nmax;
  Cx<T>* const g[4] = {h_all + off, r_all + off, qt_all + off, zt_all + off};
  Mat<Cx<T>> m[4] = {{g[0], nmax}, {g[1], nmax}, {g[2], nmax}, {g[3], nmax}};
  if (shared) {
    const int ld = shared_ld(nmax);
    Cx<T>* base = reinterpret_cast<Cx<T>*>(smem_raw + kScratch);
    for (int x = 0; x < 4; ++x) m[x] = Mat<Cx<T>>{base + (size_t)x * nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) m[x](row, col) = g[x][(size_t)row * nmax + col];
    }
    __syncthreads();
  }
  const Mat<Cx<T>> h = m[0], r = m[1], qt = m[2], zt = m[3];
  const Cx<T> zero{T(0), T(0)};
  PROF_MARK(0)
  for (int j = 0; j < n - 2; ++j) {
    T c, sr, si, rr, ri;
    {
      const Cx<T> x = h(n - 2, j), y = h(n - 1, j);
      cgivens(x.re, x.im, y.re, y.im, c, sr, si, rr, ri);
    }
    __syncthreads();  // every thread has read the column's first pair
    for (int i = n - 2; i > j; --i) {
      // rows (i, i+1) take Gᴴ: H from column j (H[i+1, j] becomes 0), R
      // from column i; Q's columns (Qᵀ's rows) take G
      const T msi = -si;
      for (int k = tid; k < n; k += nt) {
        if (k >= j) {
          Cx<T> x0 = h(i, k), x1 = h(i + 1, k);
          rotate(x0, x1, c, sr, si);
          h(i, k) = x0;
          h(i + 1, k) = k == j ? zero : x1;
        }
        if (k >= i) {
          Cx<T> y0 = r(i, k), y1 = r(i + 1, k);
          rotate(y0, y1, c, sr, si);
          r(i, k) = y0;
          r(i + 1, k) = y1;
          if (k <= i + 1) rbuf[k - i] = y1;  // R[i+1, i], R[i+1, i+1]
        }
        Cx<T> q0 = qt(i, k), q1 = qt(i + 1, k);
        rotate(q0, q1, c, sr, msi);
        qt(i, k) = q0;
        qt(i + 1, k) = q1;
      }
      __syncthreads();
      PROF_MARK(1)
      // columns (i+1, i) clear R[i+1, i] against R[i+1, i+1]: R's rows
      // 0..i+1, every row of H, Z's columns (Zᵀ's rows); column i+1 ←
      // c·col_{i+1} + s·col_i, column i ← c·col_i − s̄·col_{i+1}
      T c2, s2r, s2i, t0, t1;
      {
        const Cx<T> bq = rbuf[0], aq = rbuf[1];
        cgivens(aq.re, -aq.im, bq.re, -bq.im, c2, s2r, s2i, t0, t1);
      }
      const T ms2i = -s2i;
      if (i - 1 > j) {  // the next pair's rows
        const Cx<T> x = h(i - 1, j), y = h(i, j);
        cgivens(x.re, x.im, y.re, y.im, c, sr, si, rr, ri);
      }
      for (int k = tid; k < n; k += nt) {
        if (k <= i + 1) {
          Cx<T> a1 = r(k, i + 1), a0 = r(k, i);
          rotate(a1, a0, c2, s2r, ms2i);
          r(k, i + 1) = a1;
          r(k, i) = k == i + 1 ? zero : a0;
        }
        Cx<T> b1 = h(k, i + 1), b0 = h(k, i);
        rotate(b1, b0, c2, s2r, ms2i);
        h(k, i + 1) = b1;
        h(k, i) = b0;
        Cx<T> z1 = zt(i + 1, k), z0 = zt(i, k);
        rotate(z1, z0, c2, s2r, ms2i);
        zt(i + 1, k) = z1;
        zt(i, k) = z0;
      }
      __syncthreads();
      PROF_MARK(2)
    }
  }
  if (shared) {
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) g[x][(size_t)row * nmax + col] = m[x](row, col);
    }
  }
  PROF_MARK(3)
  PROF_END
}

template <typename T>
int hess_tri_route(int nmax) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return hess_tri_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int hess_tri_batched(void* h, void* r, void* qt, void* zt, const int* sizes, int batch,
                     int nmax, void* stream) {
  const int route = hess_tri_route<T>(nmax);
  if (route < 0 || batch < 1) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = hess_tri_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(complex_hess_tri_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  complex_hess_tri_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      static_cast<Cx<T>*>(h), static_cast<Cx<T>*>(r), static_cast<Cx<T>*>(qt),
      static_cast<Cx<T>*>(zt), sizes, nmax, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H, R, Q and Z for problems of up to nmax: 0 in
// shared memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]);
// complex64 and complex128 entries.
extern "C" int faer_complex_hess_tri_route(int nmax) { return hess_tri_route<float>(nmax); }
extern "C" int faer_complex_hess_tri_route_c128(int nmax) {
  return hess_tri_route<double>(nmax);
}

// The Givens chain of `batch` problems: h, r (batch, nmax, nmax) row-major
// interleaved complex (complex64 or complex128) and qt, zt the transposes of
// Q and Z, worked on in place; sizes (batch,) int32. All contiguous on the
// current device. Returns the CUDA error of the launch (0 on success).
extern "C" int faer_complex_hess_tri_batched(void* h, void* r, void* qt, void* zt,
                                             const int* sizes, int batch, int nmax,
                                             void* stream) {
  return hess_tri_batched<float>(h, r, qt, zt, sizes, batch, nmax, stream);
}
extern "C" int faer_complex_hess_tri_batched_c128(void* h, void* r, void* qt, void* zt,
                                                  const int* sizes, int batch, int nmax,
                                                  void* stream) {
  return hess_tri_batched<double>(h, r, qt, zt, sizes, batch, nmax, stream);
}

#ifdef FAER_CHT_PROFILE
// Copies the phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_complex_hess_tri_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[kProf] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
