// spectral_qr.cuh: what the implicit-QR kernels of tridiag_sweep.cu,
// bidiag_sweep.cu, real_schur.cu, hess_tri.cu and real_qz.cu share.
//
// * IEEE operations rounded one at a time (no FMA contraction), so that a
//   kernel repeats the rounding of its plain PyTorch version, one PyTorch
//   launch an operation: __fmul_rn and friends, __fsqrt_rn, __fdiv_rn, and
//   hypotf where the plain code calls torch.hypot; the same names take
//   double (__dmul_rn, __dsqrt_rn, __ddiv_rn, hypot), so that every routine
//   below is a template on the element type T, float or double;
// * the element types' eps and smallest normal number;
// * the Wilkinson shift and the two Givens forms of the plain versions;
// * CTA reductions (a minimum index, NaN-propagating maxima as torch.max);
// * the rotation of one row of a column-major matrix by a chain of Givens
//   rotations, its running column carried in a register;
// * the Schur and QZ kernels' pieces: a row-major matrix view, the odd
//   leading dimension of a matrix in shared memory, the 3-vector reflector
//   and the rotations from scaled entries, the loosened deflation floor's
//   cap and the negligible-subdiagonal pass.
#pragma once

#include <cuda_runtime.h>

namespace faer_qr {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 8192;  // the largest problem the batched kernels take
constexpr size_t kMaxSmem = 232448;  // 227 KB: what one block can opt into

// the element type's machine epsilon (torch.finfo(dtype).eps) and smallest
// normal number (torch.finfo(dtype).tiny)
template <typename T> struct Limits;
template <> struct Limits<float> {
  static constexpr float eps = 1.1920928955078125e-07f;  // 2^-23
  static constexpr float tiny = 1.1754943508222875e-38f;  // 2^-126
};
template <> struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;  // 2^-52
  static constexpr double tiny = 2.2250738585072014e-308;  // 2^-1022
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float absv(float a) { return fabsf(a); }
__device__ __forceinline__ float hypot_of(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double absv(double a) { return fabs(a); }
__device__ __forceinline__ double hypot_of(double a, double b) { return hypot(a, b); }

// The eigenvalue of [[a, b], [b, c]] closest to c, in the order of
// tridiag_evd._wilkinson_shift (PyTorch divides by the CPU scalar 2 as a
// product with 0.5, which rounds as the division does).
template <typename T>
__device__ __forceinline__ T wilkinson_shift(T a, T b, T c) {
  const T delta = mul(sub(a, c), T(0.5));
  const T sq = sqrt_rn(add(mul(delta, delta), mul(b, b)));
  T denom = add(delta, delta >= T(0) ? sq : -sq);
  if (denom == T(0)) denom = T(1);
  return b == T(0) ? c : sub(c, dvd(mul(b, b), denom));
}

// c, s, r with [[c, -s], [s, c]]^T [x, z]^T = [r, 0]^T, r = sqrt(x² + z²):
// the sweeps' form (and the extra-column chase's)
template <typename T>
__device__ __forceinline__ void givens_sqrt(T x, T z, T& c, T& s, T& r) {
  r = sqrt_rn(add(mul(x, x), mul(z, z)));
  c = (r == T(0)) ? T(1) : dvd(x, r);
  s = (r == T(0)) ? T(0) : dvd(z, r);
}

// the same with r = hypot(x, z): the zero-diagonal chases' form
// (tridiag_evd._givens_real)
template <typename T>
__device__ __forceinline__ void givens_hypot(T x, T z, T& c, T& s, T& r) {
  r = hypot_of(x, z);
  c = (r == T(0)) ? T(1) : dvd(x, r);
  s = (r == T(0)) ? T(0) : dvd(z, r);
}

// max that keeps a NaN, as torch.max does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The minimum of v over the CTA (blockDim.x a multiple of 32), in every
// thread. red: 32 ints of shared scratch. Ends in a barrier, so every
// thread's reads before the call are done when any thread returns.
__device__ __forceinline__ int cta_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = min(v, red[w]);
  __syncthreads();
  return v;
}

// Bytes of the reduction scratch of cta_min_max_max: 32 ints and 64 T's.
template <typename T>
__host__ __device__ constexpr size_t red_bytes() {
  return 32 * sizeof(int) + 64 * sizeof(T);
}

// The minimum of v and the NaN-propagating maxima of x and y over the CTA,
// in every thread; red: red_bytes<T>() of shared scratch (its start 8-byte
// aligned). Ends in a barrier.
template <typename T>
__device__ __forceinline__ void cta_min_max_max(int& v, T& x, T& y, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  for (int o = 16; o > 0; o >>= 1) {
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
    y = nan_max(y, __shfl_xor_sync(0xffffffffu, y, o));
  }
  T* fred = reinterpret_cast<T*>(red + 32);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = v;
    fred[threadIdx.x >> 5] = x;
    fred[32 + (threadIdx.x >> 5)] = y;
  }
  __syncthreads();
  v = red[0];
  x = fred[0];
  y = fred[32];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    v = min(v, red[w]);
    x = nan_max(x, fred[w]);
    y = nan_max(y, fred[32 + w]);
  }
  __syncthreads();
}

// One row of a column-major matrix (z points at its entry in column 0,
// columns ld apart) times G_lo G_{lo+1} ⋯ G_{hi-1}, G_i the rotation
// [[c_i, -s_i], [s_i, c_i]] of columns (i, i+1): columns (i, i+1) ←
// (c·z_i + s·z_{i+1}, −s·z_i + c·z_{i+1}), rounded as the plain
// versions' column rotations. The running column i stays in a register;
// the next kAhead columns are loaded before they are needed, which hides
// the latency of a matrix in global memory.
template <typename T>
__device__ __forceinline__ void rotate_row_chain(T* z, int ld, int lo, int hi, const T* c,
                                                 const T* s) {
  constexpr int kAhead = 8;
  T a = z[(size_t)lo * ld];
  int i = lo;
  for (; i + kAhead <= hi; i += kAhead) {
    T b[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) b[k] = z[(size_t)(i + 1 + k) * ld];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const T ck = c[i + k], sk = s[i + k];
      z[(size_t)(i + k) * ld] = add(mul(ck, a), mul(sk, b[k]));
      a = add(mul(-sk, a), mul(ck, b[k]));
    }
  }
  for (; i < hi; ++i) {
    const T b = z[(size_t)(i + 1) * ld];
    z[(size_t)i * ld] = add(mul(c[i], a), mul(s[i], b));
    a = add(mul(-s[i], a), mul(c[i], b));
  }
  z[(size_t)hi * ld] = a;
}

// One row of a column-major matrix rotated in the column pairs (k, p) for
// k = first, first + step, …, last (step ±1), with (c_k, s_k): column k ←
// c·z_k + s·z_p, column p ← −s·z_k + c·z_p, the pivot column p carried in
// a register. The zero-diagonal chases and the extra-column chase.
template <typename T>
__device__ __forceinline__ void rotate_row_pivot(T* z, int ld, int p, int first, int last,
                                                 int step, const T* c, const T* s) {
  T zp = z[(size_t)p * ld];
  for (int k = first; step > 0 ? k <= last : k >= last; k += step) {
    const T zk = z[(size_t)k * ld];
    z[(size_t)k * ld] = add(mul(c[k], zk), mul(s[k], zp));
    zp = add(mul(-s[k], zk), mul(c[k], zp));
  }
  z[(size_t)p * ld] = zp;
}

// the leading dimension of a matrix in shared memory: odd, so that a column
// is read without bank conflicts
__host__ __device__ __forceinline__ int shared_ld(int nmax) { return nmax | 1; }

// the exponent cap of the loosened deflation floor 2^(stall / 5)
// (dtypes.deflation_stall_cap): min(24, ⌊−½·log2 eps⌋)
template <typename T>
__host__ __device__ constexpr int stall_cap() {
  return sizeof(T) == 4 ? 11 : 24;
}

// The maximum of v over the CTA, in every thread; ends in a barrier.
__device__ __forceinline__ int cta_max_int(int v, int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = max(v, red[w]);
  __syncthreads();
  return v;
}

// The NaN-propagating maximum of v over the CTA, in every thread; ends in a
// barrier.
template <typename T>
__device__ __forceinline__ T cta_max_val(T v, T* fred) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) fred[threadIdx.x >> 5] = v;
  __syncthreads();
  v = fred[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = nan_max(v, fred[w]);
  __syncthreads();
  return v;
}

// real_schur._house3: (tau, u2, u3, beta) of the reflector clearing (v2, v3)
// against v1, from the vector scaled by its largest magnitude
template <typename T>
__device__ __forceinline__ void house3(T v1, T v2, T v3, T& tau, T& u2, T& u3, T& beta) {
  T sc = nan_max(nan_max(absv(v1), absv(v2)), absv(v3));
  if (sc == T(0)) sc = T(1);
  const T w1 = dvd(v1, sc), w2 = dvd(v2, sc), w3 = dvd(v3, sc);
  const T tail2 = add(mul(w2, w2), mul(w3, w3));
  const T nrm = sqrt_rn(add(mul(w1, w1), tail2));
  if (tail2 == T(0)) {
    tau = u2 = u3 = T(0);
    beta = v1;
    return;
  }
  const T bs = w1 >= T(0) ? -nrm : nrm;
  const T denom = sub(w1, bs);
  u2 = dvd(w2, denom);
  u3 = dvd(w3, denom);
  tau = dvd(sub(bs, w1), bs);
  beta = mul(bs, sc);
}

// real_schur._unit_pair: (x, y)/‖(x, y)‖ from the pair scaled by its larger
// magnitude; (1, 0) for (0, 0)
template <typename T>
__device__ __forceinline__ void unit_pair(T x, T y, T& c, T& s) {
  const T sc = nan_max(absv(x), absv(y));
  const bool zero = sc == T(0);
  const T scs = zero ? T(1) : sc;
  const T xs = dvd(x, scs), ys = dvd(y, scs);
  const T r = sqrt_rn(add(mul(xs, xs), mul(ys, ys)));
  c = zero ? T(1) : dvd(xs, r);
  s = zero ? T(0) : dvd(ys, r);
}

// A rotation of the pair (x0, x1): (c·x0 + s·x1, −s·x0 + c·x1), rounded as
// the plain versions' row and column rotations
template <typename T>
__device__ __forceinline__ void rot_pair(T& x0, T& x1, T c, T s) {
  const T a = x0, b = x1;
  x0 = add(mul(c, a), mul(s, b));
  x1 = add(mul(-s, a), mul(c, b));
}

template <typename T>
struct Mat {
  T* p;
  int ld;
  __device__ __forceinline__ T& operator()(int r, int c) const { return p[(size_t)r * ld + c]; }
};

// real_schur._negligible_subdiag: zero each H[i+1, i] at most
// max(eps·(|H[i,i]| + |H[i+1,i+1]|), floor). Ends in a barrier.
template <typename T>
__device__ __forceinline__ void negligible_subdiag(Mat<T> h, int n, T floor) {
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    const T tol = nan_max(mul(Limits<T>::eps, add(absv(h(i, i)), absv(h(i + 1, i + 1)))),
                          floor);
    if (absv(h(i + 1, i)) <= tol) h(i + 1, i) = T(0);
  }
  __syncthreads();
}

// Threads of a batched CTA: every row of the largest matrix, in warps
__host__ __forceinline__ int cta_threads(int rows) {
  const int t = (rows + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// Opt a kernel into ``bytes`` of dynamic shared memory where it needs more
// than the 48 KB every launch gets.
template <typename Kernel>
__host__ __forceinline__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace faer_qr
