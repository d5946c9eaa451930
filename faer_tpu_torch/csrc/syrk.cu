// syrk_lower_sub: C - A * A^T on the lower tiles of an (m, m) f32 matrix.
//
// Replaces: faer_tpu/ops/pallas/syrk_kernel.py `syrk_lower_sub` (:108; bodies
// `_syrk_padded` :71 and `_syrk_kernel` :51), which computes only the lower
// (i >= j) tile pairs of a Cholesky trailing update with the numerics of
// `pallas_matmul`. Like the JAX package, no driver calls it.
//
// Design: the tile product of tile_mma.cuh with B = A^T read through A's
// swapped strides (no transpose copy). The grid runs over the lower tile
// pairs only: CTA t decodes its (i, j), t = i (i + 1) / 2 + j, from
// blockIdx.x, where Pallas had them by scalar prefetch. The output buffer
// holds a copy of C on entry; a CTA reads its tile's C values, subtracts
// A_i * A_j^T and writes back the elements on and below the diagonal, so the
// upper tiles and the strict upper part of the diagonal tiles keep C's
// values. Ragged edges are masked, not padded.
//
// What bounds it on the H100: in FP32, operations. The work is the
// nt = T (T + 1) / 2 tiles of 128 x 128 over k (T = ceil(m / 128)): 2 nt
// 128^2 k flops (the Pallas cost estimate's count), at (3840, 256) 465 tiles,
// 3.9 GFLOP: 0.058 ms at 67 TFLOP/s; the bytes (C read, the result written,
// A read) are 0.036 ms at 3.35 TB/s. The three bf16 passes of "high" take
// 0.012 ms on the tensor cores, so there the bytes bound it.
#include "tile_mma.cuh"

namespace {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
syrk_kernel(const float* a, long long sam, long long sak, float* c, int M,
            int K) {
  const int t = blockIdx.x;
  int ti = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;  // guard the rounding of sqrt
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int m0 = ti * kTile, n0 = tj * kTile;
  float acc[kAcc];
  // B = A^T: B(k, n) = A(n, k) = a[n sam + k sak]
  tile_product<MODE>(a, sam, sak, a, sak, sam, m0, n0, M, M, K, acc);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, col;
    acc_coords<MODE>(i, r, col);
    const int gr = m0 + r, gc = n0 + col;
    if (gr < M && gc <= gr) {
      float* p = c + (long long)gr * M + gc;
      *p = *p - acc[i];
    }
  }
}

}  // namespace

// a: (m, k) f32 with element (i, j) at a + i*sam + j*sak; c: (m, m) row-major
// contiguous f32 holding C, updated in place on and below the diagonal.
// mode 0 = FP32, 1 = bf16x3. Launches on the current device. Returns the CUDA
// error of the launch (0 on success).
extern "C" int faer_syrk_lower_sub(const float* a, long long sam, long long sak,
                                   float* c, int m, int k, int mode,
                                   void* stream) {
  if (m < 1 || k < 0 || mode < 0 || mode > 1) return cudaErrorInvalidValue;
  const long long tiles = (m + kTile - 1) / kTile;
  const long long pairs = tiles * (tiles + 1) / 2;
  if (pairs > 2147483647LL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    syrk_kernel<kFp32><<<(unsigned)pairs, kThreads, 0, s>>>(a, sam, sak, c, m, k);
  else
    syrk_kernel<kBf16x3><<<(unsigned)pairs, kThreads, 0, s>>>(a, sam, sak, c, m, k);
  return cudaGetLastError();
}
