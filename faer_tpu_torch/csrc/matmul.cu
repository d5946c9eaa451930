// tile_matmul: C = A * B for 2-D f32 or bf16 operands of any strides.
//
// Replaces: faer_tpu/ops/pallas/matmul_kernel.py `pallas_matmul` (:92; bodies
// `_mm_padded` :59 and `_mm_kernel` :20), the tile GEMM that the JAX front
// door sends every 2-D f32/bf16 product above 128^3 to when its switch is on.
// The Pallas grid's sequential k dimension with its VMEM accumulator becomes
// a k loop inside one CTA; see tile_mma.cuh for the tile design and the three
// modes. Ragged edges are masked in the kernel (the Pallas wrapper pads with
// zeros), and each operand is read through its own strides (the port's call
// sites pass transposed views).
//
// What bounds it on the H100: operations. At 4096^3, 2 * 4096^3 flops are
// 2.05 ms at the 67 TFLOP/s FP32 peak ("highest"), and the three bf16 passes
// of "high" 3 * 2 * 4096^3 / 989 TFLOP/s = 0.42 ms on the tensor cores; the
// bytes (two 64 MiB operands in, one out) are 0.06 ms at 3.35 TB/s. This
// first version stages through registers and shared memory with plain loads
// and uses mma.sync, not TMA and wgmma, so it reaches a fraction of either
// peak; the times are in PERF.md.
#include "tile_mma.cuh"

namespace {

template <int MODE, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TIn* a, long long sam, long long sak, const TIn* b,
              long long sbk, long long sbn, TOut* c, int M, int N, int K) {
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[kAcc];
  tile_product<MODE>(a, sam, sak, b, sbk, sbn, m0, n0, M, N, K, acc);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    int r, col;
    acc_coords<MODE>(i, r, col);
    const int gr = m0 + r, gc = n0 + col;
    if (gr < M && gc < N) store_as(c + (long long)gr * N + gc, acc[i]);
  }
}

template <int MODE, typename TIn, typename TOut>
void launch(const void* a, long long sam, long long sak, const void* b,
            long long sbk, long long sbn, void* c, int m, int n, int k,
            dim3 grid, cudaStream_t stream) {
  matmul_kernel<MODE, TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), sam, sak, static_cast<const TIn*>(b), sbk,
      sbn, static_cast<TOut*>(c), m, n, k);
}

}  // namespace

// a: (m, k) with element (i, j) at a + i*sam + j*sak; b: (k, n) likewise with
// strides (sbk, sbn); c: (m, n) row-major contiguous. mode 0 = FP32, 1 =
// bf16x3 (both with f32 a and b), 2 = bf16 a and b; out_bf16 selects a bf16
// (else f32) c. Launches on the current device. Returns the CUDA error of the
// launch (0 on success).
extern "C" int faer_tile_matmul(const void* a, long long sam, long long sak,
                                const void* b, long long sbk, long long sbn,
                                void* c, int m, int n, int k, int mode,
                                int out_bf16, void* stream) {
  if (m < 1 || n < 1 || k < 0 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (mode * 2 + (out_bf16 ? 1 : 0)) {
    case 0: launch<kFp32, float, float>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
    case 1: launch<kFp32, float, bf16>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
    case 2: launch<kBf16x3, float, float>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
    case 3: launch<kBf16x3, float, bf16>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
    case 4: launch<kBf16, bf16, float>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
    default: launch<kBf16, bf16, bf16>(a, sam, sak, b, sbk, sbn, c, m, n, k, grid, s); break;
  }
  return cudaGetLastError();
}
