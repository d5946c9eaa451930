// complex_ops.cuh: what the complex one-CTA kernels of complex_schur.cu,
// complex_hess_tri.cu and complex_qz.cu share: an interleaved (re, im)
// entry, and the scalar pieces of linalg/complex_schur.py (the scaled
// magnitude, the spelled-out product, Smith's quotient, the principal
// square root by its real formula, the complex Givens rotation, the 2×2
// eigenvalue nearer the corner in zlahqr's scaled form), the rotation of a
// pair of entries and the negligible-subdiagonal pass, each an IEEE
// operation on a real number rounded on its own (spectral_qr.cuh), in the
// order of the plain versions, so that the kernels equal them to the bit.
#pragma once

#include "spectral_qr.cuh"

namespace faer_cx {

using namespace faer_qr;

// one complex entry, interleaved (re, im)
template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

// complex_schur._cabs: |re + i·im| from the pair scaled by its larger
// magnitude
template <typename T>
__device__ __forceinline__ T cabs(T re, T im) {
  const T m = nan_max(absv(re), absv(im));
  if (m == T(0)) return m;
  const T a = dvd(re, m), b = dvd(im, m);
  return mul(m, sqrt_rn(add(mul(a, a), mul(b, b))));
}

// complex_schur._cmul: (ar + i·ai)(br + i·bi)
template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& pr, T& pi) {
  pr = sub(mul(ar, br), mul(ai, bi));
  pi = add(mul(ar, bi), mul(ai, br));
}

// complex_schur._cdiv: Smith's algorithm
template <typename T>
__device__ __forceinline__ void cdiv(T ar, T ai, T br, T bi, T& qr, T& qi) {
  if (absv(br) >= absv(bi)) {
    const T r = dvd(bi, br);
    const T d = add(br, mul(bi, r));
    qr = dvd(add(ar, mul(ai, r)), d);
    qi = dvd(sub(ai, mul(ar, r)), d);
  } else {
    const T r = dvd(br, bi);
    const T d = add(bi, mul(br, r));
    qr = dvd(add(mul(ar, r), ai), d);
    qi = dvd(sub(mul(ai, r), ar), d);
  }
}

// complex_schur._csqrt: the principal square root by its real formula
template <typename T>
__device__ __forceinline__ void csqrt(T re, T im, T& sr, T& si) {
  if (re == T(0) && im == T(0)) {
    sr = si = T(0);
    return;
  }
  const T m = cabs(re, im);
  if (re >= T(0)) {
    const T t = sqrt_rn(mul(T(0.5), add(m, re)));
    sr = t;
    si = dvd(im, mul(T(2), t));
  } else {
    const T t = sqrt_rn(mul(T(0.5), sub(m, re)));
    sr = dvd(absv(im), mul(T(2), t));
    si = copysign(t, im);
  }
}

// complex_schur._cgivens: c real, s = sr + i·si, (rr, ri) = r with
// Gᴴ (x, z)ᵀ = (r, 0)ᵀ; the identity with r = x when z = 0
template <typename T>
__device__ __forceinline__ void cgivens(T xr, T xi, T zr, T zi, T& c, T& sr, T& si, T& rr,
                                        T& ri) {
  const T az = cabs(zr, zi);
  if (az == T(0)) {
    c = T(1);
    sr = si = T(0);
    rr = xr;
    ri = xi;
    return;
  }
  const T ax = cabs(xr, xi);
  const T m = nan_max(ax, az);
  const T a = dvd(ax, m), b = dvd(az, m);
  const T r = mul(m, sqrt_rn(add(mul(a, a), mul(b, b))));
  c = dvd(ax, r);
  T pr = T(1), pi = T(0);
  if (ax != T(0)) {
    pr = dvd(xr, ax);
    pi = dvd(xi, ax);
  }
  const T tr = add(mul(pr, zr), mul(pi, zi));
  const T ti = sub(mul(pr, zi), mul(pi, zr));
  sr = dvd(tr, r);
  si = dvd(ti, r);
  rr = mul(pr, r);
  ri = mul(pi, r);
}

// complex_schur._wilkinson: the eigenvalue of [[a11, a12], [a21, a22]]
// nearer a22, a22 − u²/(x + y) from scaled values (zlahqr's form)
template <typename T>
__device__ __forceinline__ void wilkinson(Cx<T> a11, Cx<T> a12, Cx<T> a21, Cx<T> a22, T& mr,
                                          T& mi) {
  T s12r, s12i, s21r, s21i, ur, ui;
  csqrt(a12.re, a12.im, s12r, s12i);
  csqrt(a21.re, a21.im, s21r, s21i);
  cmul(s12r, s12i, s21r, s21i, ur, ui);
  T xr = mul(T(0.5), sub(a11.re, a22.re)), xi = mul(T(0.5), sub(a11.im, a22.im));
  const T s = nan_max(nan_max(absv(ur), absv(ui)), nan_max(absv(xr), absv(xi)));
  mr = a22.re;
  mi = a22.im;
  if (s == T(0)) return;
  xr = dvd(xr, s);
  xi = dvd(xi, s);
  ur = dvd(ur, s);
  ui = dvd(ui, s);
  T zr, zi, u2r, u2i, yr, yi;
  cmul(xr, xi, xr, xi, zr, zi);
  cmul(ur, ui, ur, ui, u2r, u2i);
  csqrt(add(zr, u2r), add(zi, u2i), yr, yi);
  if (add(mul(xr, yr), mul(xi, yi)) < T(0)) {
    yr = -yr;
    yi = -yi;
  }
  const T dr = add(xr, yr), di = add(xi, yi);
  if (dr == T(0) && di == T(0)) return;
  T qr, qi, pr, pi;
  cdiv(ur, ui, dr, di, qr, qi);
  cmul(ur, ui, qr, qi, pr, pi);
  mr = sub(a22.re, mul(s, pr));
  mi = sub(a22.im, mul(s, pi));
}

// complex_schur._Problem._rotate: p0 ← c·p0 + (s1·p1 + s2·sw(p1)),
// p1 ← c·p1 + ((−s1)·p0 + s2·sw(p0)), sw(x) = −i·x = (x.im, −x.re): the
// rows take (s1, s2) = (sr, si) (Gᴴ from the left), the columns (sr, −si)
// (G from the right)
template <typename T>
__device__ __forceinline__ void rotate(Cx<T>& p0, Cx<T>& p1, T c, T s1, T s2) {
  const Cx<T> a = p0, b = p1;
  const T ms1 = -s1;
  p0.re = add(mul(c, a.re), add(mul(s1, b.re), mul(s2, b.im)));
  p0.im = add(mul(c, a.im), add(mul(s1, b.im), mul(s2, -b.re)));
  p1.re = add(mul(c, b.re), add(mul(ms1, a.re), mul(s2, a.im)));
  p1.im = add(mul(c, b.im), add(mul(ms1, a.im), mul(s2, -a.re)));
}

// complex_schur._Problem.negligible_subdiag: zero each H[i+1, i] with |h|
// at most max(eps·(|H[i,i]| + |H[i+1,i+1]|), floor). Ends in a barrier.
template <typename T>
__device__ __forceinline__ void negligible_subdiag_c(Mat<Cx<T>> h, int n, T floor) {
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    const Cx<T> d0 = h(i, i), d1 = h(i + 1, i + 1), s = h(i + 1, i);
    const T tol = nan_max(mul(Limits<T>::eps, add(cabs(d0.re, d0.im), cabs(d1.re, d1.im))),
                          floor);
    if (cabs(s.re, s.im) <= tol) h(i + 1, i) = Cx<T>{T(0), T(0)};
  }
  __syncthreads();
}

}  // namespace faer_cx
