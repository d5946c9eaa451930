// hess_tri: the Givens chain of the Hessenberg–triangular reduction of a
// pencil (linalg/qz.py, hessenberg_triangular), for a batch of problems, one
// CTA a problem, in one launch. On entry H is any square matrix and R upper
// triangular (the QR of B and A ← Q₀ᵀA run before it, in PyTorch); for each
// column j, bottom up, a pair of rotations: one of rows (i, i+1) zeroes
// H[i+1, j] (on H, R and Q's columns) and leaves a bulge at R[i+1, i], one of
// columns (i, i+1) zeroes it (on R, H and Z's columns). H comes back exactly
// Hessenberg and R exactly triangular. float32 and float64 instantiations.
//
// Replaces: no Pallas kernel. The JAX package runs this chain as two nested
// XLA fori_loops (faer_tpu/linalg/qz.py:45, `hessenberg_triangular`), each
// pair a masked rotation of whole rows and columns. Driven from the host in
// PyTorch, each of the (n-1)(n-2)/2 pairs would be some fifteen small
// launches: about 10⁷ at n = 1024.
//
// What bounds it on the H100: the chain of pairs. A pair's column rotation
// comes from R's diagonal 2×2 that its row rotation just changed, and the
// next pair's rows overlap it, so the pairs run one after another, each a
// few dozen flops on each of 2·n entries of H, R, Q and Z: latency (two
// barriers and an L2 round trip a pair past shared memory), not bytes or
// FLOPs.
//
// Design: one CTA a problem, one thread a column (for the row rotations) or
// a row (for the column rotations). H and R are row-major; Q and Z are held
// by columns (the wrapper hands over their transposes), so that every
// rotation of their columns is a coalesced pass over two rows. All four sit
// in shared memory with an odd leading dimension while 4·nmax·ld entries
// fit the 227 KB a block can use, else in global memory, where the
// wrapper's buffers are. A pair is a row phase that also stores R's new
// R[i+1, i] and R[i+1, i+1] in shared scratch, a barrier, a column phase in
// which every thread forms the column rotation from that scratch (and the
// next pair's row rotation from column j of H, which no column rotation of
// this column's pass touches), and a barrier. Every operation is an IEEE
// operation rounded on its own (spectral_qr.cuh) in the order of
// hessenberg_triangular_plain, so H, R, Q and Z equal the plain version's to
// the bit.
//
// A lever left for later: within column j the row rotations depend on
// column j alone; only the column rotations chain through R's diagonal.
#include <cuda_runtime.h>

#include "spectral_qr.cuh"

namespace {

using namespace faer_qr;

// shared scratch ahead of the matrices: R's new (i+1, i) and (i+1, i+1)
constexpr size_t kScratch = 16;

template <typename T>
size_t hess_tri_smem(int nmax, bool shared) {
  return kScratch + (shared ? 4 * (size_t)nmax * shared_ld(nmax) * sizeof(T) : 0);
}

// qz._rotation: c = |x|/r, s = sign(x)·z/r (sign(0) = 1) from the pair
// scaled by its larger magnitude; (1, 0) when z = 0
template <typename T>
__device__ __forceinline__ void rotation(T x, T z, T& c, T& s) {
  if (z == T(0)) {
    c = T(1);
    s = T(0);
    return;
  }
  const T m = nan_max(absv(x), absv(z));
  const T xs = dvd(x, m), zs = dvd(z, m);
  const T r = sqrt_rn(add(mul(xs, xs), mul(zs, zs)));
  c = dvd(absv(xs), r);
  s = dvd(xs >= T(0) ? zs : -zs, r);
}

// Problem b = blockIdx.x: h_all and r_all (B, nmax, nmax) row-major, qt_all
// and zt_all the transposes of Q and Z, the problem in [:n, :n] with
// n = sizes[b], worked on in place (in shared memory when `shared`).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
hess_tri_kernel(T* h_all, T* r_all, T* qt_all, T* zt_all, const int* __restrict__ sizes,
                int nmax, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rbuf = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = sizes[b];
  if (n < 3 || n > nmax) return;  // nothing to reduce, or not a problem of this batch
  const size_t off = (size_t)b * nmax * nmax;
  T* const g[4] = {h_all + off, r_all + off, qt_all + off, zt_all + off};
  Mat<T> m[4] = {{g[0], nmax}, {g[1], nmax}, {g[2], nmax}, {g[3], nmax}};
  if (shared) {
    const int ld = shared_ld(nmax);
    T* base = reinterpret_cast<T*>(smem_raw + kScratch);
    for (int x = 0; x < 4; ++x) m[x] = Mat<T>{base + (size_t)x * nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) m[x](row, col) = g[x][(size_t)row * nmax + col];
    }
    __syncthreads();
  }
  const Mat<T> h = m[0], r = m[1], qt = m[2], zt = m[3];
  for (int j = 0; j < n - 2; ++j) {
    T c, s;
    rotation(h(n - 2, j), h(n - 1, j), c, s);
    __syncthreads();  // every thread has read the column's first pair
    for (int i = n - 2; i > j; --i) {
      // rows (i, i+1): H from column j (H[i+1, j] becomes 0), R from column
      // i, and Q's columns (Qᵀ's rows)
      for (int k = tid; k < n; k += nt) {
        if (k >= j) {
          T x0 = h(i, k), x1 = h(i + 1, k);
          rot_pair(x0, x1, c, s);
          h(i, k) = x0;
          h(i + 1, k) = k == j ? T(0) : x1;
        }
        if (k >= i) {
          T y0 = r(i, k), y1 = r(i + 1, k);
          rot_pair(y0, y1, c, s);
          r(i, k) = y0;
          r(i + 1, k) = y1;
          if (k <= i + 1) rbuf[k - i] = y1;  // R[i+1, i], R[i+1, i+1]
        }
        T q0 = qt(i, k), q1 = qt(i + 1, k);
        rot_pair(q0, q1, c, s);
        qt(i, k) = q0;
        qt(i + 1, k) = q1;
      }
      __syncthreads();
      // columns (i+1, i) clear R[i+1, i] against R[i+1, i+1]: R's rows
      // 0..i+1, every row of H, Z's columns (Zᵀ's rows)
      T c2, s2;
      rotation(rbuf[1], rbuf[0], c2, s2);
      if (i - 1 > j) rotation(h(i - 1, j), h(i, j), c, s);  // the next pair's rows
      for (int k = tid; k < n; k += nt) {
        if (k <= i + 1) {
          T a1 = r(k, i + 1), a0 = r(k, i);
          rot_pair(a1, a0, c2, s2);
          r(k, i + 1) = a1;
          r(k, i) = k == i + 1 ? T(0) : a0;
        }
        T b1 = h(k, i + 1), b0 = h(k, i);
        rot_pair(b1, b0, c2, s2);
        h(k, i + 1) = b1;
        h(k, i) = b0;
        T z1 = zt(i + 1, k), z0 = zt(i, k);
        rot_pair(z1, z0, c2, s2);
        zt(i + 1, k) = z1;
        zt(i, k) = z0;
      }
      __syncthreads();
    }
  }
  if (shared) {
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) g[x][(size_t)row * nmax + col] = m[x](row, col);
    }
  }
}

template <typename T>
int hess_tri_route(int nmax) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return hess_tri_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int hess_tri_batched(T* h, T* r, T* qt, T* zt, const int* sizes, int batch, int nmax,
                     void* stream) {
  const int route = hess_tri_route<T>(nmax);
  if (route < 0 || batch < 1) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = hess_tri_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(hess_tri_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  hess_tri_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      h, r, qt, zt, sizes, nmax, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H, R, Q and Z for problems of up to nmax: 0 in
// shared memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]);
// float32 and float64 entries.
extern "C" int faer_hess_tri_route(int nmax) { return hess_tri_route<float>(nmax); }
extern "C" int faer_hess_tri_route_f64(int nmax) { return hess_tri_route<double>(nmax); }

// The Givens chain of `batch` problems: h, r (batch, nmax, nmax) row-major
// and qt, zt the transposes of Q and Z, worked on in place; sizes (batch,)
// int32. All contiguous on the current device. Returns the CUDA error of
// the launch (0 on success). float32 and float64 entries.
extern "C" int faer_hess_tri_batched(float* h, float* r, float* qt, float* zt,
                                     const int* sizes, int batch, int nmax, void* stream) {
  return hess_tri_batched<float>(h, r, qt, zt, sizes, batch, nmax, stream);
}
extern "C" int faer_hess_tri_batched_f64(double* h, double* r, double* qt, double* zt,
                                         const int* sizes, int batch, int nmax,
                                         void* stream) {
  return hess_tri_batched<double>(h, r, qt, zt, sizes, batch, nmax, stream);
}
