// real_qz: the real double-shift QZ iteration of a Hessenberg/triangular
// pencil (H, T) (linalg/qz_real.py), for a batch of problems, one CTA a
// problem, in one launch: every iteration's deflation test (H's negligible
// subdiagonal entries zeroed against a floor that loosens as the block
// stalls, T's negligible diagonal entries against one that does not, the
// start lo of the unreduced block ending at hi), and one of its four cases:
// a 1×1 deflation; the infinite-eigenvalue step at a zero diagonal entry of
// T (the push-down of a row rotation, or the deflation of a column rotation
// at hi); the 2×2 standardization; or a double-shift sweep from lo (the
// shifts from the trailing 2×2 of H T⁻¹, the exceptional shift every 10
// stalled sweeps, the chain of chase steps). Then the final negligible
// pass. S, T, Q, Z, the iteration count, the convergence flag and the chase
// steps come back with no host read. float32 and float64 instantiations.
//
// Replaces: no Pallas kernel. The JAX package runs this iteration as one
// XLA lax.while_loop (faer_tpu/linalg/qz_real.py:56, `real_qz_iteration`),
// its chase a masked fori_loop of dynamic-slice reflectors and rotations on
// zero-padded carries. Driven from the host in PyTorch, a chase step would be
// some thirty small launches and each iteration a host read: minutes a call
// at n = 1024.
//
// What bounds it on the H100: the chain of chase steps. Step i's left
// reflector comes from the bulge that step i-1 left in column i-1, and its
// right transforms from the fill that its own left reflector made in T, so
// the steps of a sweep run one after another, each a few hundred flops on
// three rows (of H and T, n - i + 1 columns; of Qᵀ, n) and three columns (of
// H and T, i + 4 rows; of Zᵀ, n): latency, not bytes or FLOPs.
//
// Design: one CTA a problem, one thread a column (for the row updates) or a
// row (for the column updates). H and T are row-major; Q and Z are held by
// columns (the wrapper hands over their transposes), so that every update
// of their columns is a coalesced pass over rows. All four sit in shared
// memory with an odd leading dimension while 4·nmax·ld entries fit the
// 227 KB a block can use, else in global memory, where the wrapper's buffers
// are. A chase step is two phases, each ended by a barrier:
// * the row phase applies the left 3-row reflector to H's and T's rows and
//   Qᵀ's rows, writes β and exact zeros into the column it clears, and
//   stores T's new rows i+1 and i+2 over columns i..i+2 in shared scratch;
// * the column phase: every thread forms the reversed 3-column reflector
//   from that scratch row i+2, applies it to row i+1 in its own registers to
//   find the 2-column rotation that clears T[i+1, i], and then applies both
//   transforms to its rows of H, T and Zᵀ in one pass; the threads of rows
//   i+1..i+3 store the next bulge (column i) in shared scratch.
// So no thread reads an entry another one is about to write, and the chase
// step's three transforms take two barriers, not three. Scalar decisions
// (lo, the zero of T, the case, the shifts, the reflectors, the rotations)
// are made by every thread from the same shared values, or by CTA
// reductions, so control flow is uniform. Every operation is an IEEE
// operation rounded on its own (spectral_qr.cuh) in the order of
// real_qz_iteration_plain, so S, T, Q, Z and the counts equal the plain
// version's to the bit.
#include <cuda_runtime.h>

#include "spectral_qr.cuh"

namespace {

using namespace faer_qr;

// shared scratch ahead of the matrices: 32 ints and 64 T's of reduction,
// the next bulge (3 T's), T's rows i+1 and i+2 over the step's columns
// (6 T's), padded to 16 bytes
template <typename T>
__host__ __device__ constexpr size_t scratch_bytes() {
  return (32 * sizeof(int) + 73 * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
size_t qz_smem(int nmax, bool shared) {
  return scratch_bytes<T>() + (shared ? 4 * (size_t)nmax * shared_ld(nmax) * sizeof(T) : 0);
}

// qz_real._safe: x, or ±ref where |x| < ref
template <typename T>
__device__ __forceinline__ T safe(T x, T ref) {
  return absv(x) < ref ? (x < T(0) ? -ref : ref) : x;
}

// The reflector (I − τ u uᵀ), u = (1, u2, u3) (u = (1, u2) when `two`), on
// (x0, x1, x2), rounded as qz_real._reflect_rows and _reflect_cols.
template <typename T>
__device__ __forceinline__ void reflect3(T& x0, T& x1, T& x2, bool two, T tau, T u2, T u3) {
  T w = add(x0, mul(u2, x1));
  if (!two) w = add(w, mul(u3, x2));
  x0 = sub(x0, mul(tau, w));
  x1 = sub(x1, mul(tau, mul(u2, w)));
  if (!two) x2 = sub(x2, mul(tau, mul(u3, w)));
}

// The reversed reflector (I − τ u uᵀ), u = (r1, r2, 1), on (x0, x1, x2),
// rounded as qz_real._reflect_cols_rev.
template <typename T>
__device__ __forceinline__ void reflect3_rev(T& x0, T& x1, T& x2, T tau, T r1, T r2) {
  const T wc = add(add(mul(x0, r1), mul(x1, r2)), x2);
  x0 = sub(x0, mul(tau, mul(wc, r1)));
  x1 = sub(x1, mul(tau, mul(wc, r2)));
  x2 = sub(x2, mul(tau, wc));
}

// qz_real._deflate2: the 2×2 block at (lo, lo) standardized where its
// eigenvalues are real, left coupled where complex. Ends in a barrier.
template <typename T>
__device__ void deflate2(Mat<T> h, Mat<T> t, Mat<T> qt, Mat<T> zt, int n, int lo, T* pbuf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T a11 = h(lo, lo), a12 = h(lo, lo + 1), a21 = h(lo + 1, lo), a22 = h(lo + 1, lo + 1);
  T b11 = t(lo, lo), b12 = t(lo, lo + 1), b22 = t(lo + 1, lo + 1);
  // each block scaled by its largest magnitude (neither the eigenvectors of
  // A B⁻¹ nor the sign of the discriminant change), so that the products
  // below do not underflow where the pencil is small
  T sa = nan_max(nan_max(absv(a11), absv(a12)), nan_max(absv(a21), absv(a22)));
  T sb = nan_max(nan_max(absv(b11), absv(b12)), absv(b22));
  if (sa == T(0)) sa = T(1);
  if (sb == T(0)) sb = T(1);
  a11 = dvd(a11, sa);
  a12 = dvd(a12, sa);
  a21 = dvd(a21, sa);
  a22 = dvd(a22, sa);
  b11 = dvd(b11, sb);
  b12 = dvd(b12, sb);
  b22 = dvd(b22, sb);
  // C = A adj(B): the eigenvectors of A B⁻¹
  const T c11 = mul(a11, b22);
  const T c12 = add(mul(-a11, b12), mul(a12, b11));
  const T c21 = mul(a21, b22);
  const T c22 = add(mul(-a21, b12), mul(a22, b11));
  const T m = mul(T(0.5), add(c11, c22));
  const T pp = mul(T(0.5), sub(c11, c22));
  const T disc = add(mul(pp, pp), mul(c12, c21));
  __syncthreads();  // every thread has read the block
  if (disc >= T(0)) {
    const T sq = sqrt_rn(absv(disc));
    const T lam = add(m, pp >= T(0) ? sq : -sq);
    T cl, sl;
    unit_pair(sub(lam, c22), c21, cl, sl);
    for (int k = tid; k < n; k += nt) {
      if (k >= lo) {
        rot_pair(h(lo, k), h(lo + 1, k), cl, sl);
        rot_pair(t(lo, k), t(lo + 1, k), cl, sl);
        if (k <= lo + 1) pbuf[k - lo] = t(lo + 1, k);
      }
      rot_pair(qt(lo, k), qt(lo + 1, k), cl, sl);
    }
    __syncthreads();
    T cr, sr;
    unit_pair(pbuf[1], pbuf[0], cr, sr);
    for (int k = tid; k < n; k += nt) {
      if (k <= lo + 1) {
        rot_pair(h(k, lo), h(k, lo + 1), cr, -sr);
        rot_pair(t(k, lo), t(k, lo + 1), cr, -sr);
        if (k == lo + 1) h(lo + 1, lo) = t(lo + 1, lo) = T(0);
      }
      rot_pair(zt(lo, k), zt(lo + 1, k), cr, -sr);
    }
  } else if (tid == 0) {
    t(lo + 1, lo) = T(0);
  }
  __syncthreads();
}

// qz_real._inf_step: the zero diagonal entry T[jz, jz] (jz in [lo, hi]).
// Ends in a barrier.
template <typename T>
__device__ void inf_step(Mat<T> h, Mat<T> t, Mat<T> qt, Mat<T> zt, int n, int lo, int hi,
                         int jz) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (jz >= hi) {
    // columns (hi-1, hi) zero H[hi, hi-1]: H's and T's rows 0..hi, Zᵀ's rows
    T c2, s2;
    unit_pair(h(hi, hi), h(hi, hi - 1), c2, s2);
    __syncthreads();  // every thread has read them
    for (int k = tid; k < n; k += nt) {
      if (k <= hi) {
        rot_pair(h(k, hi - 1), h(k, hi), c2, -s2);
        if (k == hi) h(hi, hi - 1) = T(0);
        rot_pair(t(k, hi - 1), t(k, hi), c2, -s2);
      }
      rot_pair(zt(hi - 1, k), zt(hi, k), c2, -s2);
    }
    __syncthreads();
    return;
  }
  // rows (jz, jz+1) zero H[jz+1, jz]: H from column jz-1, T from column jz,
  // Qᵀ's rows; the fill at (jz+1, jz-1) dropped below lo's row
  T cc, ss;
  unit_pair(h(jz, jz), h(jz + 1, jz), cc, ss);
  __syncthreads();  // every thread has read them
  for (int k = tid; k < n; k += nt) {
    if (k >= max(jz - 1, 0)) {
      rot_pair(h(jz, k), h(jz + 1, k), cc, ss);
      if (k == jz || (k == jz - 1 && jz > lo)) h(jz + 1, k) = T(0);
    }
    if (k >= jz) {
      rot_pair(t(jz, k), t(jz + 1, k), cc, ss);
      if (k == jz) t(jz, jz) = T(0);
    }
    rot_pair(qt(jz, k), qt(jz + 1, k), cc, ss);
  }
  __syncthreads();
}

// qz_real._sweep: one double-shift sweep on the unreduced block [lo, hi]
// (hi - lo >= 2); returns its chase steps. Ends in a barrier.
template <typename T>
__device__ int sweep(Mat<T> h, Mat<T> t, Mat<T> qt, Mat<T> zt, int n, int lo, int hi,
                     int stall, T smlnum_t, T* vbuf, T* pbuf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // the shifts: the eigenvalues of the trailing 2×2 of H T⁻¹
  const T t11 = safe(t(hi - 1, hi - 1), smlnum_t), t22 = safe(t(hi, hi), smlnum_t);
  const T t12 = t(hi - 1, hi);
  T m11 = dvd(h(hi - 1, hi - 1), t11);
  T m21 = dvd(h(hi, hi - 1), t11);
  T m12 = dvd(sub(h(hi - 1, hi), mul(m11, t12)), t22);
  const T m22 = dvd(sub(h(hi, hi), mul(m21, t12)), t22);
  if (stall % 10 == 9) {  // the exceptional shift
    const T se = add(absv(m21), absv(m12));
    m11 = add(mul(T(0.75), se), m22);
    m12 = mul(T(-0.4375), se);
    m21 = se;
  }
  const T s = add(m11, m22);
  const T p = sub(mul(m11, m22), mul(m12, m21));
  // the first column of W² − sW + pI, W = H T⁻¹: rows lo..lo+2, scaled
  const T s11 = safe(t(lo, lo), smlnum_t), s22 = safe(t(lo + 1, lo + 1), smlnum_t);
  const T s12 = t(lo, lo + 1);
  const T a0 = h(lo, lo), b0 = h(lo, lo + 1), c0 = h(lo + 1, lo), d0 = h(lo + 1, lo + 1);
  const T e0 = h(lo + 2, lo + 1);
  const T u1 = dvd(a0, s11), u2 = dvd(c0, s11);
  const T y2 = dvd(u2, s22);
  const T y1 = dvd(sub(u1, mul(s12, y2)), s11);
  T v1 = add(sub(add(mul(a0, y1), mul(b0, y2)), mul(s, u1)), p);
  T v2 = sub(add(mul(c0, y1), mul(d0, y2)), mul(s, u2));
  T v3 = mul(e0, y2);
  const T scale = nan_max(nan_max(absv(v1), absv(v2)), nan_max(absv(v3), Limits<T>::tiny));
  v1 = dvd(v1, scale);
  v2 = dvd(v2, scale);
  v3 = dvd(v3, scale);
  __syncthreads();  // every thread has read the pencil before the first step
  for (int i = lo; i < hi; ++i) {
    const bool last = i == hi - 1;
    if (i > lo) {  // the bulge below the subdiagonal of column i-1
      v1 = vbuf[0];
      v2 = vbuf[1];
      v3 = vbuf[2];
    }
    if (last) v3 = T(0);
    T tau, r2u, r3u, beta;
    house3(v1, v2, v3, tau, r2u, r3u, beta);
    // rows i..i+2 (i..i+1 on the last step): H from column i-1 (lo on the
    // first step), T from column i, Qᵀ
    const int ch = i > lo ? i - 1 : lo;
    for (int k = tid; k < n; k += nt) {
      T x2 = T(0);
      if (k >= ch) {
        T x0 = h(i, k), x1 = h(i + 1, k);
        if (!last) x2 = h(i + 2, k);
        reflect3(x0, x1, x2, last, tau, r2u, r3u);
        if (k == i - 1 && i > lo) {  // the column it clears: β and exact zeros
          x0 = beta;
          x1 = x2 = T(0);
        }
        h(i, k) = x0;
        h(i + 1, k) = x1;
        if (!last) h(i + 2, k) = x2;
      }
      if (k >= i) {
        T y0 = t(i, k), y1 = t(i + 1, k), y2_ = T(0);
        if (!last) y2_ = t(i + 2, k);
        reflect3(y0, y1, y2_, last, tau, r2u, r3u);
        t(i, k) = y0;
        t(i + 1, k) = y1;
        if (!last) t(i + 2, k) = y2_;
        if (k <= i + 2) {
          pbuf[k - i] = y1;
          pbuf[3 + k - i] = y2_;
        }
      }
      T q2 = T(0);
      T q0 = qt(i, k), q1 = qt(i + 1, k);
      if (!last) q2 = qt(i + 2, k);
      reflect3(q0, q1, q2, last, tau, r2u, r3u);
      qt(i, k) = q0;
      qt(i + 1, k) = q1;
      if (!last) qt(i + 2, k) = q2;
    }
    __syncthreads();
    // the reversed reflector clearing T[i+2, i:i+2], and the rotation of
    // columns (i, i+1) clearing T[i+1, i] after it (row i+1 in registers)
    T tau2 = T(0), rr1 = T(0), rr2 = T(0);
    T x10 = pbuf[0], x11 = pbuf[1];
    if (!last) {
      T beta2;
      house3(pbuf[5], pbuf[4], pbuf[3], tau2, rr2, rr1, beta2);
      T x12 = pbuf[2];
      reflect3_rev(x10, x11, x12, tau2, rr1, rr2);
    }
    T cg, sg;
    unit_pair(x11, x10, cg, sg);
    const int rend = min(i + 3, hi);  // H's last row in these columns
    for (int k = tid; k < n; k += nt) {
      if (k <= rend) {
        T a0_ = h(k, i), a1 = h(k, i + 1);
        if (!last) {
          T a2 = h(k, i + 2);
          reflect3_rev(a0_, a1, a2, tau2, rr1, rr2);
          h(k, i + 2) = a2;
        }
        rot_pair(a0_, a1, cg, -sg);
        h(k, i) = a0_;
        h(k, i + 1) = a1;
        if (k > i && k <= i + 3) vbuf[k - i - 1] = a0_;  // the next bulge
      }
      if (k <= i + 2) {
        T b0_ = t(k, i), b1 = t(k, i + 1);
        if (!last) {
          T b2 = t(k, i + 2);
          reflect3_rev(b0_, b1, b2, tau2, rr1, rr2);
          t(k, i + 2) = b2;
          if (k == i + 2 && tau2 != T(0)) b0_ = b1 = T(0);
        }
        rot_pair(b0_, b1, cg, -sg);
        t(k, i) = k == i + 1 ? T(0) : b0_;
        t(k, i + 1) = b1;
      }
      T z0 = zt(i, k), z1 = zt(i + 1, k);
      if (!last) {
        T z2 = zt(i + 2, k);
        reflect3_rev(z0, z1, z2, tau2, rr1, rr2);
        zt(i + 2, k) = z2;
      }
      rot_pair(z0, z1, cg, -sg);
      zt(i, k) = z0;
      zt(i + 1, k) = z1;
    }
    __syncthreads();
  }
  return hi - lo;
}

// Problem b = blockIdx.x: h_all and t_all (B, nmax, nmax) row-major, qt_all
// and zt_all the transposes of Q and Z, the problem in [:n, :n] with
// n = sizes[b], worked on in place (in shared memory when `shared`); info
// (B, 3): iterations, converged, chase steps.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
real_qz_kernel(T* h_all, T* t_all, T* qt_all, T* zt_all, const int* __restrict__ sizes,
               int* __restrict__ info, int nmax, int factor, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* red = reinterpret_cast<int*>(smem_raw);
  T* fred = reinterpret_cast<T*>(smem_raw + 32 * sizeof(int));
  T* vbuf = fred + 64;
  T* pbuf = vbuf + 3;
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
  const size_t off = (size_t)b * nmax * nmax;
  T* const g[4] = {h_all + off, t_all + off, qt_all + off, zt_all + off};
  Mat<T> m[4] = {{g[0], nmax}, {g[1], nmax}, {g[2], nmax}, {g[3], nmax}};
  if (shared) {
    const int ld = shared_ld(nmax);
    T* base = reinterpret_cast<T*>(smem_raw + scratch_bytes<T>());
    for (int x = 0; x < 4; ++x) m[x] = Mat<T>{base + (size_t)x * nmax * ld, ld};
    for (int k = tid; k < n * n; k += nt) {
      const int row = k / n, col = k % n;
      for (int x = 0; x < 4; ++x) m[x](row, col) = g[x][(size_t)row * nmax + col];
    }
    __syncthreads();
  }
  const Mat<T> h = m[0], t = m[1], qt = m[2], zt = m[3];
  T hn = T(0), tn = T(0);
  for (int k = tid; k < n * n; k += nt) {
    hn = nan_max(hn, absv(h(k / n, k % n)));
    tn = nan_max(tn, absv(t(k / n, k % n)));
  }
  hn = cta_max_val(hn, fred);
  tn = cta_max_val(tn, fred);
  const T eps = Limits<T>::eps;
  const T smlnum = mul(eps, nan_max(hn, Limits<T>::tiny));
  const T smlnum_t = mul(eps, nan_max(tn, Limits<T>::tiny));
  const int max_iters = factor * n;
  int hi = n - 1, it = 0, stall = 0, steps = 0;
  while (hi >= 1 && it < max_iters) {
    const T floor = mul(smlnum, T(1 << min(stall / 5, stall_cap<T>())));
    // H's negligible subdiagonal entries and T's negligible diagonal ones
    for (int i = tid; i < n; i += nt) {
      if (i < n - 1) {
        const T tol = nan_max(mul(eps, add(absv(h(i, i)), absv(h(i + 1, i + 1)))), floor);
        if (absv(h(i + 1, i)) <= tol) h(i + 1, i) = T(0);
      }
      if (absv(t(i, i)) <= smlnum_t) t(i, i) = T(0);
    }
    __syncthreads();
    // lo: the start of the unreduced block that ends at hi
    int cand = 0;
    for (int i = tid; i < hi; i += nt)
      if (h(i + 1, i) == T(0)) cand = i + 1;
    const int lo = cta_max_int(cand, red);
    const int nr = hi - lo + 1;
    bool progressed = true;
    if (nr == 1) {
      hi -= 1;
    } else {
      // the first zero of T's diagonal in [lo, hi] where the block can split
      int jc = n;
      for (int j = lo + tid; j <= hi; j += nt)
        if (t(j, j) == T(0) && (j == hi || j == lo || absv(h(j, j - 1)) <= floor))
          jc = min(jc, j);
      const int jz = cta_min(jc, red);
      if (jz < n) {
        inf_step(h, t, qt, zt, n, lo, hi, jz);
        if (jz >= hi)
          hi -= 1;
        else
          progressed = false;
      } else if (nr == 2) {
        deflate2(h, t, qt, zt, n, lo, pbuf);
        hi = lo - 1;
      } else {
        steps += sweep(h, t, qt, zt, n, lo, hi, stall, smlnum_t, vbuf, pbuf);
        progressed = false;
      }
    }
    stall = progressed ? 0 : stall + 1;
    ++it;
  }
  // exact zeros below S's subdiagonal and T's diagonal, then the final
  // negligible pass against the unloosened floor
  for (int k = tid; k < n * n; k += nt) {
    const int row = k / n, col = k % n;
    if (row > col + 1) h(row, col) = T(0);
    if (row > col) t(row, col) = T(0);
  }
  __syncthreads();
  negligible_subdiag(h, n, smlnum);
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
}

template <typename T>
int qz_route(int nmax) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return qz_smem<T>(nmax, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int qz_batched(T* h, T* t, T* qt, T* zt, const int* sizes, int* info, int batch, int nmax,
               int factor, void* stream) {
  const int route = qz_route<T>(nmax);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const size_t smem = qz_smem<T>(nmax, shared);
  const cudaError_t err = allow_smem(real_qz_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  real_qz_kernel<T><<<batch, cta_threads(nmax), smem, (cudaStream_t)stream>>>(
      h, t, qt, zt, sizes, info, nmax, factor, shared);
  return cudaGetLastError();
}

}  // namespace

// Where the kernel keeps H, T, Q and Z for problems of up to nmax: 0 in
// shared memory, 1 in global memory, -1 refused (nmax outside [1, kMaxN]);
// float32 and float64 entries.
extern "C" int faer_real_qz_route(int nmax) { return qz_route<float>(nmax); }
extern "C" int faer_real_qz_route_f64(int nmax) { return qz_route<double>(nmax); }

// The iteration of `batch` problems: h, t (batch, nmax, nmax) row-major and
// qt, zt the transposes of Q and Z, holding the pencil and the accumulating
// transforms on entry and S, T, Qᵀ, Zᵀ on exit (in place); sizes (batch,)
// int32, info (batch, 3) int32 (iterations, converged, chase steps); at most
// factor·n iterations a problem. All contiguous on the current device.
// Returns the CUDA error of the launch (0 on success). float32 and float64
// entries.
extern "C" int faer_real_qz_batched(float* h, float* t, float* qt, float* zt, const int* sizes,
                                    int* info, int batch, int nmax, int factor, void* stream) {
  return qz_batched<float>(h, t, qt, zt, sizes, info, batch, nmax, factor, stream);
}
extern "C" int faer_real_qz_batched_f64(double* h, double* t, double* qt, double* zt,
                                        const int* sizes, int* info, int batch, int nmax,
                                        int factor, void* stream) {
  return qz_batched<double>(h, t, qt, zt, sizes, info, batch, nmax, factor, stream);
}
