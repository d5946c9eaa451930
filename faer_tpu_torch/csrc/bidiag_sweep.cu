// bidiag_sweep: the implicit-shift Golub-Kahan QR iteration of an upper
// bidiagonal (d (n,), e (n-1,)). Two entries share one sweep routine:
//
// * faer_bidiag_sweep: one shifted sweep on the block [l, m], its right
//   rotations (c1, s1, for V) and left ones (c2, s2, for U) out (the
//   one-sweep contract of the Pallas kernel);
// * faer_bidiag_qr_batched: the whole iteration of every problem of a
//   batch, one CTA a problem, in one launch: what bidiag_svd's loop does per
//   iteration (zero the negligible e and d, find the block end, chase a
//   zero diagonal out by rows or by columns, advance l, or shift and sweep)
//   with U and V rotated alongside. A wide problem (n, n+1) (sqre = 1, the
//   D&C's upper leaves) first has its extra column chased to zero, and its
//   right-vector matrix W starts from that chase's rotations, so the kernel
//   returns W = w0 · blkdiag(V, 1). float32 (faer_bidiag_qr_batched) and
//   float64 (faer_bidiag_qr_batched_f64, the f64 svd's route).
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `bidiag_sweep_pallas`
// (:502, body `_bidiag_sweep_kernel` :423), which runs one sweep on
// VMEM-resident rows; the JAX package runs the iteration around it as one
// device-resident lax.while_loop (faer_tpu/linalg/bidiag_svd.py:185-232).
//
// What bounds it on the H100: the serial chain, as in tridiag_sweep.cu:
// step i needs the (x, bulge) carry of step i-1, and each step has two
// square roots and four divides on it. Bytes and FLOPs are negligible
// beside that latency.
//
// Design: as tridiag_sweep.cu, a template on the element type T. One CTA a problem; d, e, the four rotation
// arrays and, when they fit (every D&C leaf), U and W in shared memory, else
// U and W column-major in global memory. One thread runs each chain (the
// sweep with d[i], e[i], d[i+1] in registers and the next step's inputs
// loaded a step ahead; the chases), then every thread applies the
// rotations to its rows of U and W, the running or pivot column in a
// register. The block end, the zero diagonal and max|d| + max|e| are CTA
// reductions. Every operation is rounded on its own in the plain versions'
// order (spectral_qr.cuh), so d, e and the iteration counts equal the
// plain version's bit for bit.
#include <climits>

#include <cuda_runtime.h>

#include "spectral_qr.cuh"

namespace {

using namespace faer_qr;

constexpr int kThreads = 256;  // the one-sweep entry
constexpr int kMaxStagedN = 6144;  // 2n floats in 48 KB

// One Golub-Kahan sweep with shift mu on the block [l, m] of (d, e), by one
// thread; the right rotations to c1, s1 and the left ones to c2, s2 at
// [l, m). The pointers may be shared or global.
template <typename T>
__device__ void sweep_chain(T* d, T* e, T* c1_out, T* s1_out, T* c2_out, T* s2_out, int l,
                            int m, T mu) {
  T di = d[l], ei = e[l], dip1 = d[l + 1];
  T x = sub(mul(di, di), mu), bz = mul(di, ei);
  T e_next = l + 1 < m ? e[l + 1] : T(0);  // e[i+1] as the sweep found it
  for (int i = l; i < m; ++i) {
    const bool has_next = i + 1 < m;
    // the next step's inputs, off the chain
    const T dip2 = has_next ? d[i + 2] : T(0);
    const T e_next2 = i + 2 < m ? e[i + 2] : T(0);
    T c1, s1, r1;
    givens_sqrt(x, bz, c1, s1, r1);
    c1_out[i] = c1;
    s1_out[i] = s1;
    if (i > l) e[i - 1] = r1;
    const T new_di = add(mul(c1, di), mul(s1, ei));
    const T new_ei = add(mul(-s1, di), mul(c1, ei));
    const T bulge = mul(s1, dip1);
    const T new_dip1 = mul(c1, dip1);
    T c2, s2, r2;
    givens_sqrt(new_di, bulge, c2, s2, r2);
    c2_out[i] = c2;
    s2_out[i] = s2;
    d[i] = r2;
    x = add(mul(c2, new_ei), mul(s2, new_dip1));
    di = add(mul(-s2, new_ei), mul(c2, new_dip1));
    if (has_next) {
      ei = mul(c2, e_next);
      bz = mul(s2, e_next);
    }
    dip1 = dip2;
    e_next = e_next2;
  }
  d[m] = di;
  e[m - 1] = x;
}

// The trailing 2×2 of BᵀB's Wilkinson shift at block end m (bidiag_svd._shift)
template <typename T>
__device__ __forceinline__ T shift(const T* d, const T* e, int m) {
  const T dm = d[m], dm1 = d[m - 1], em1 = e[m - 1];
  const T em2 = m >= 2 ? e[m - 2] : T(0);
  return wilkinson_shift(add(mul(dm1, dm1), mul(em2, em2)), mul(dm1, em1),
                         add(mul(dm, dm), mul(em1, em1)));
}

// d[i0] == 0 with e[i0] != 0: left rotations push row i0's off-diagonal
// rightwards out of the block (bidiag_svd._row_chase); (c, s) at [i0+1, m]
template <typename T>
__device__ void row_chase(T* d, T* e, T* c, T* s, int i0, int m, int n) {
  T b = e[i0];
  e[i0] = T(0);
  for (int k = i0 + 1; k <= m; ++k) {
    T r;
    givens_hypot(d[k], b, c[k], s[k], r);
    d[k] = r;
    const int kk = min(k, n - 2);
    const T ek = e[kk];
    if (k < m) {
      e[kk] = mul(c[k], ek);
      b = mul(-s[k], ek);
    }
  }
}

// d[m] == 0 with e[m-1] != 0: right rotations push column m's off-diagonal
// upwards out of the block (bidiag_svd._col_chase); (c, s) at [l, m)
template <typename T>
__device__ void col_chase(T* d, T* e, T* c, T* s, int l, int m) {
  T b = e[m - 1];
  e[m - 1] = T(0);
  for (int k = m - 1; k >= l; --k) {
    T r;
    givens_hypot(d[k], b, c[k], s[k], r);
    d[k] = r;
    if (k > l) {
      const T ek = e[k - 1];
      e[k - 1] = mul(c[k], ek);
      b = mul(-s[k], ek);
    }
  }
}

// A wide (n, n+1) bidiagonal's last column zeroed bottom-up by right
// rotations of columns (j, n) (bidiag_dnc._chase_extra_column); (c, s) at
// [0, n); e[n-1] is dropped
template <typename T>
__device__ void extra_column_chase(T* d, T* e, T* c, T* s, int n) {
  T f = e[n - 1];
  for (int j = n - 1; j >= 0; --j) {
    T r;
    givens_sqrt(d[j], f, c[j], s[j], r);
    d[j] = r;
    if (j > 0) {
      const T ej = e[j - 1];
      e[j - 1] = mul(c[j], ej);
      f = mul(-s[j], ej);
    }
  }
  e[n - 1] = T(0);
}

__global__ void __launch_bounds__(kThreads)
bidiag_sweep_kernel(const int* __restrict__ lm, const float* __restrict__ mu_p,
                    const float* __restrict__ d_in,
                    const float* __restrict__ e_in, float* d_out, float* e_out,
                    float* c1_out, float* s1_out, float* c2_out, float* s2_out,
                    int n, int staged) {
  extern __shared__ float smem[];
  float* d = staged ? smem : d_out;
  float* e = staged ? smem + n : e_out;
  for (int i = threadIdx.x; i < n; i += blockDim.x) d[i] = d_in[i];
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    e[i] = e_in[i];
    c1_out[i] = 1.0f;
    s1_out[i] = 0.0f;
    c2_out[i] = 1.0f;
    s2_out[i] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int l = lm[0], m = lm[1];
    if (0 <= l && l < m && m <= n - 1)
      sweep_chain(d, e, c1_out, s1_out, c2_out, s2_out, l, m, mu_p[0]);
  }  // else an identity sweep
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) d_out[i] = d[i];
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) e_out[i] = e[i];
  }
}

// Shared memory of a batched CTA: d, e and four rotation arrays (nmax + 1
// each), the reduction scratch (red_bytes), and U (nmax²) and W
// ((nmax+1)²) when they are kept there.
template <typename T>
size_t qr_smem(int nmax, bool want_u, bool want_w, bool shared) {
  size_t words = 6 * ((size_t)nmax + 1);
  if (shared) {
    if (want_u) words += (size_t)nmax * nmax;
    if (want_w) words += ((size_t)nmax + 1) * (nmax + 1);
  }
  return words * sizeof(T) + red_bytes<T>();
}

// Problem b = blockIdx.x: d_all (B, nmax), e_all (B, nmax), its size
// sizes[b] and sqre[b] (the bidiagonal is (n, n + sqre), e[:n - 1 + sqre]);
// U column-major (B, nmax, nmax), W column-major (B, nmax+1, nmax+1);
// info (B, 3): iterations, converged, sweep chain steps.
template <typename T, bool kU, bool kW>
__global__ void __launch_bounds__(kMaxThreads)
bidiag_qr_kernel(T* __restrict__ d_all, T* __restrict__ e_all,
                 const int* __restrict__ sizes, const int* __restrict__ sqre_all,
                 T* __restrict__ u_all, T* __restrict__ w_all,
                 int* __restrict__ info, int nmax, int factor, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int nv = nmax + 1;
  T* d = smem;
  T* e = d + nv;
  T* c1 = e + nv;
  T* s1 = c1 + nv;
  T* c2 = s1 + nv;
  T* s2 = c2 + nv;
  int* red = reinterpret_cast<int*>(s2 + nv);
  const int n = sizes[b];
  const int sq = sqre_all[b] != 0;
  int* out = info + 3 * b;
  if (n < 1 || n > nmax) {  // not a problem this batch holds: left as it is
    if (tid == 0) out[0] = out[1] = out[2] = 0;
    return;
  }
  T* dg = d_all + (size_t)b * nmax;
  T* eg = e_all + (size_t)b * nmax;
  T* ug = kU ? u_all + (size_t)b * nmax * nmax : nullptr;
  T* wg = kW ? w_all + (size_t)b * nv * nv : nullptr;
  T* u = ug;
  T* w = wg;
  if (shared) {
    T* next = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(red) + red_bytes<T>());
    if (kU) {
      u = next;
      next += (size_t)nmax * nmax;
    }
    if (kW) w = next;
  }
  for (int i = tid; i < n; i += nt) d[i] = dg[i];
  for (int i = tid; i < n - 1 + sq; i += nt) e[i] = eg[i];
  if (kU)
    for (size_t k = tid; k < (size_t)nmax * nmax; k += nt)
      u[k] = k % (nmax + 1) == 0 ? T(1) : T(0);
  if (kW)
    for (size_t k = tid; k < (size_t)nv * nv; k += nt) w[k] = k % (nv + 1) == 0 ? T(1) : T(0);
  __syncthreads();
  if (sq) {
    if (tid == 0) extra_column_chase(d, e, c1, s1, n);
    __syncthreads();
    if (kW)
      for (int r = tid; r < n + 1; r += nt) rotate_row_pivot(w + r, nv, n, n - 1, 0, -1, c1, s1);
    // the next barriers keep every thread's rotations ahead of the next chain
  }
  int l = 0, it = 0, steps = 0;
  const int max_iters = factor * n;
  while (l < n - 1 && it < max_iters) {
    ++it;
    for (int i = tid; i < n - 1; i += nt)
      if (absv(e[i]) <= mul(Limits<T>::eps, add(absv(d[i]), absv(d[i + 1])))) e[i] = T(0);
    __syncthreads();
    // the block end, and max|d| + max|e| (after e's zeroing)
    int m = n - 1;
    T dmax = T(0), emax = T(0);
    bool found = false;
    for (int i = tid; i < n; i += nt) {
      dmax = nan_max(dmax, absv(d[i]));
      if (i < n - 1) {
        emax = nan_max(emax, absv(e[i]));
        if (!found && i >= l && e[i] == T(0)) {
          m = i;
          found = true;
        }
      }
    }
    cta_min_max_max(m, dmax, emax, red);
    const T thr = mul(Limits<T>::eps, add(dmax, emax));
    for (int i = tid; i < n; i += nt)
      if (absv(d[i]) <= thr) d[i] = T(0);
    __syncthreads();
    // the first zero diagonal in [l, m]
    int cand = INT_MAX;
    for (int i = l + tid; i <= m; i += nt)
      if (d[i] == T(0)) {
        cand = i;
        break;
      }
    const int i0 = cta_min(cand, red);
    if (i0 <= m && m > l) {
      if (i0 == m) {
        if (tid == 0) col_chase(d, e, c1, s1, l, m);
        __syncthreads();
        if (kW)
          for (int r = tid; r < n + sq; r += nt)
            rotate_row_pivot(w + r, nv, m, m - 1, l, -1, c1, s1);
      } else {
        if (tid == 0) row_chase(d, e, c2, s2, i0, m, n);
        __syncthreads();
        if (kU)
          for (int r = tid; r < n; r += nt)
            rotate_row_pivot(u + r, nmax, i0, i0 + 1, m, 1, c2, s2);
      }
    } else if (m <= l) {
      ++l;
    } else {
      if (tid == 0) {
        sweep_chain(d, e, c1, s1, c2, s2, l, m, shift(d, e, m));
        steps += m - l;
      }
      __syncthreads();
      // rows past n (n + sqre of W) stay those of the identity
      if (kW)
        for (int r = tid; r < n + sq; r += nt) rotate_row_chain(w + r, nv, l, m, c1, s1);
      if (kU)
        for (int r = tid; r < n; r += nt) rotate_row_chain(u + r, nmax, l, m, c2, s2);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) dg[i] = d[i];
  for (int i = tid; i < n - 1 + sq; i += nt) eg[i] = e[i];
  if (shared) {
    if (kU)
      for (size_t k = tid; k < (size_t)nmax * nmax; k += nt) ug[k] = u[k];
    if (kW)
      for (size_t k = tid; k < (size_t)nv * nv; k += nt) wg[k] = w[k];
  }
  if (tid == 0) {
    out[0] = it;
    out[1] = l >= n - 1;
    out[2] = steps;
  }
}

template <typename T, bool kU, bool kW>
cudaError_t launch_qr(T* d, T* e, const int* sizes, const int* sqre, T* u, T* w,
                      int* info, int batch, int nmax, int factor, int shared,
                      cudaStream_t stream) {
  const size_t smem = qr_smem<T>(nmax, kU, kW, shared);
  const cudaError_t err = allow_smem(bidiag_qr_kernel<T, kU, kW>, smem);
  if (err != cudaSuccess) return err;
  bidiag_qr_kernel<T, kU, kW><<<batch, cta_threads(nmax + 1), smem, stream>>>(
      d, e, sizes, sqre, u, w, info, nmax, factor, shared);
  return cudaGetLastError();
}

}  // namespace

// lm: int32 (l, m); mu: one f32; d, d_out: (n,); e, e_out, c1, s1, c2, s2:
// (n-1,); all contiguous on the current device (the caller selects it),
// n >= 2. Returns the CUDA error of the launch (0 on success).
extern "C" int faer_bidiag_sweep(const int* lm, const float* mu, const float* d,
                                 const float* e, float* d_out, float* e_out,
                                 float* c1, float* s1, float* c2, float* s2,
                                 int n, void* stream) {
  if (n < 2) return cudaErrorInvalidValue;
  const int staged = n <= kMaxStagedN;
  const size_t smem = staged ? 2 * (size_t)n * sizeof(float) : 0;
  bidiag_sweep_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      lm, mu, d, e, d_out, e_out, c1, s1, c2, s2, n, staged);
  return cudaGetLastError();
}

namespace {

template <typename T>
int qr_route(int nmax, int want_u, int want_w) {
  if (nmax < 1 || nmax > kMaxN) return -1;
  return (want_u || want_w) && qr_smem<T>(nmax, want_u, want_w, true) <= kMaxSmem ? 0 : 1;
}

template <typename T>
int qr_batched(T* d, T* e, const int* sizes, const int* sqre, T* u, T* w, int* info,
               int batch, int nmax, int factor, void* stream) {
  const int want_u = u != nullptr, want_w = w != nullptr;
  const int route = qr_route<T>(nmax, want_u, want_w);
  if (route < 0 || batch < 1 || factor < 0) return cudaErrorInvalidValue;
  const int shared = route == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (want_u && want_w)
    return launch_qr<T, true, true>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, shared, s);
  if (want_u)
    return launch_qr<T, true, false>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, shared, s);
  if (want_w)
    return launch_qr<T, false, true>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, shared, s);
  return launch_qr<T, false, false>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, shared, s);
}

}  // namespace

// Where the batched entry keeps U and W for problems of up to nmax: 0 in
// shared memory, 1 in global memory (or neither is wanted), -1 refused
// (nmax outside [1, kMaxN]); float32 and float64 entries.
extern "C" int faer_bidiag_qr_route(int nmax, int want_u, int want_w) {
  return qr_route<float>(nmax, want_u, want_w);
}
extern "C" int faer_bidiag_qr_route_f64(int nmax, int want_u, int want_w) {
  return qr_route<double>(nmax, want_u, want_w);
}

// The iteration of `batch` problems: d (batch, nmax) and e (batch, nmax) in
// place, sizes and sqre (batch,) int32, u (batch, nmax, nmax) and w (batch,
// nmax+1, nmax+1) column-major (either null when not wanted), info (batch,
// 3) int32; at most factor·n iterations a problem. All contiguous on the
// current device. Returns the CUDA error of the launch (0 on success).
// float32 and float64 entries.
extern "C" int faer_bidiag_qr_batched(float* d, float* e, const int* sizes,
                                      const int* sqre, float* u, float* w, int* info,
                                      int batch, int nmax, int factor, void* stream) {
  return qr_batched<float>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, stream);
}
extern "C" int faer_bidiag_qr_batched_f64(double* d, double* e, const int* sizes,
                                          const int* sqre, double* u, double* w, int* info,
                                          int batch, int nmax, int factor, void* stream) {
  return qr_batched<double>(d, e, sizes, sqre, u, w, info, batch, nmax, factor, stream);
}
