// tile_mma.cuh: the 128 x 128 output-tile product that matmul.cu and syrk.cu
// share.
//
// One CTA of 256 threads owns one 128 x 128 tile of C = A * B and walks the
// whole k range in a loop, in slabs of 32: the loop takes the place of the
// Pallas grid's sequential k dimension and its VMEM accumulator, and the sum
// stays in f32 registers (64 a thread). Each slab of A (128 x 32) and of B
// (32 x 128) is read from device memory with the operand's own row and column
// strides (a transposed view costs no copy), masked to zero outside the
// matrices (no padding copy), converted to f32 and staged in shared memory;
// the next slab's loads are issued into registers before the current slab is
// multiplied, so they overlap the arithmetic.
//
// Three modes, as the Pallas body `_mm_kernel` has them:
//   kFp32   FP32 FFMA, an 8 x 8 micro-tile a thread ("highest");
//   kBf16x3 every staged f32 element split into bf16 hi and lo, and three
//           mma.sync.m16n8k16 bf16 products, ah*bl + al*bh + ah*bh, summed in
//           f32 ("high"; each product of two bf16 values is exact in f32);
//   kBf16   bf16 operands (staged as exact f32), one mma pass.
// In the mma modes the 8 warps form a 2 x 4 grid of 64 x 32 warp tiles, each
// 4 x 4 m16n8 fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // output tile side
constexpr int kSlab = 32;       // k depth staged per step
constexpr int kThreads = 256;   // 8 warps
constexpr int kLd = kTile + 4;  // padded shared row: conflict-free fragment reads
constexpr int kAcc = kTile * kTile / kThreads;  // 64 accumulators a thread
constexpr int kPer = kTile * kSlab / kThreads;  // 16 slab elements a thread

enum Mode { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// (row, col) of element `idx` of a rows x cols slab, walked along the
// operand's unit-stride direction so that a warp reads consecutive addresses.
__device__ __forceinline__ void slab_coords(int idx, int rows, int cols,
                                            bool col_fast, int& r, int& c) {
  if (col_fast) {
    r = idx / cols;
    c = idx % cols;
  } else {
    r = idx % rows;
    c = idx / rows;
  }
}

// Registers <- the A slab (rows m0.., cols k0..) and the B slab (rows k0..,
// cols n0..), zero outside the matrices.
template <typename T>
__device__ __forceinline__ void load_slab(const T* a, long long sam,
                                          long long sak, const T* b,
                                          long long sbk, long long sbn, int m0,
                                          int n0, int k0, int M, int N, int K,
                                          float (&ra)[kPer], float (&rb)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    int r, c;
    slab_coords(idx, kTile, kSlab, sak == 1, r, c);
    const int gm = m0 + r, gk = k0 + c;
    ra[i] = (gm < M && gk < K) ? to_f32(a[gm * sam + gk * sak]) : 0.0f;
    slab_coords(idx, kSlab, kTile, sbn == 1, r, c);
    const int gk2 = k0 + r, gn = n0 + c;
    rb[i] = (gk2 < K && gn < N) ? to_f32(b[gk2 * sbk + gn * sbn]) : 0.0f;
  }
}

// Shared memory <- registers: As[k][m] and Bs[k][n], rows of kLd floats.
__device__ __forceinline__ void store_slab(float* As, float* Bs,
                                           const float (&ra)[kPer],
                                           const float (&rb)[kPer],
                                           bool a_k_fast, bool b_n_fast) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    int r, c;
    slab_coords(idx, kTile, kSlab, a_k_fast, r, c);
    As[c * kLd + r] = ra[i];
    slab_coords(idx, kSlab, kTile, b_n_fast, r, c);
    Bs[r * kLd + c] = rb[i];
  }
}

// FP32: thread (tx, ty) owns rows {4ty..4ty+3, 64+4ty..} and columns
// {4tx..4tx+3, 64+4tx..}; the split halves keep the float4 reads of a
// half-warp on distinct banks.
__device__ __forceinline__ void fma_slab(const float* As, const float* Bs,
                                         float (&acc)[kAcc]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < kSlab; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLd + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * kLd + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLd + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * kLd + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  // the element of lower index goes in the lower 16 bits
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two f32 values -> the packed bf16 hi pair and the packed bf16 lo pair:
// x = hi + lo + O(2^-17 |x|), as `_mm_kernel` splits its operands.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma modes: warp w owns rows 64 (w / 4).. and columns 32 (w % 4)..; its
// fragment (mi, ni) holds accumulators acc[4 (4 mi + ni) .. + 3] in the
// m16n8 C layout. A fragment register q holds (row g + 8 (q & 1), columns
// 2t + 8 (q >> 1) + {0, 1}); B register q holds (rows 2t + 8 q + {0, 1},
// column g), with g = lane / 4 and t = lane % 4.
template <int MODE>
__device__ __forceinline__ void mma_slab(const float* As, const float* Bs,
                                         float (&acc)[kAcc]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
  for (int ks = 0; ks < kSlab; ks += 16) {
    const float* a_lo = As + (ks + 2 * t) * kLd;  // rows k = ks + 2t, + 1
    const float* a_hi = As + (ks + 2 * t + 8) * kLd;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn + ni * 8 + g;
      const float* bp = Bs + (ks + 2 * t) * kLd + col;
      split_pack(bp[0], bp[kLd], bh[ni][0], bl[ni][0]);
      split_pack(bp[8 * kLd], bp[9 * kLd], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = wm + mi * 16 + g;
      uint32_t ah[4], al[4];
      split_pack(a_lo[row], a_lo[kLd + row], ah[0], al[0]);
      split_pack(a_lo[row + 8], a_lo[kLd + row + 8], ah[1], al[1]);
      split_pack(a_hi[row], a_hi[kLd + row], ah[2], al[2]);
      split_pack(a_hi[row + 8], a_hi[kLd + row + 8], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float* c = acc + (mi * 4 + ni) * 4;
        if constexpr (MODE == kBf16x3) {
          // the small terms first
          mma_bf16(c, ah, bl[ni]);
          mma_bf16(c, al, bh[ni]);
        }
        mma_bf16(c, ah, bh[ni]);
      }
    }
  }
}

// Tile-local (row, col) of accumulator i.
template <int MODE>
__device__ __forceinline__ void acc_coords(int i, int& r, int& c) {
  if constexpr (MODE == kFp32) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int ii = i / 8, jj = i % 8;
    r = (ii < 4) ? ty * 4 + ii : 64 + ty * 4 + ii - 4;
    c = (jj < 4) ? tx * 4 + jj : 64 + tx * 4 + jj - 4;
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int frag = i / 4, q = i % 4;
    r = (warp / 4) * 64 + (frag / 4) * 16 + (lane >> 2) + ((q >= 2) ? 8 : 0);
    c = (warp % 4) * 32 + (frag % 4) * 8 + 2 * (lane & 3) + (q & 1);
  }
}

// acc <- A[m0:m0+128, :] * B[:, n0:n0+128] over the whole k range, where
// A(i, j) = a[i sam + j sak] is M x K and B(i, j) = b[i sbk + j sbn] is K x N.
// Every thread of the CTA must call it (it synchronises the block).
template <int MODE, typename T>
__device__ __forceinline__ void tile_product(const T* a, long long sam,
                                             long long sak, const T* b,
                                             long long sbk, long long sbn,
                                             int m0, int n0, int M, int N,
                                             int K, float (&acc)[kAcc]) {
  __shared__ __align__(16) float As[kSlab * kLd];
  __shared__ __align__(16) float Bs[kSlab * kLd];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  float ra[kPer], rb[kPer];
  if (K > 0) load_slab(a, sam, sak, b, sbk, sbn, m0, n0, 0, M, N, K, ra, rb);
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    store_slab(As, Bs, ra, rb, sak == 1, sbn == 1);
    __syncthreads();
    if (k0 + kSlab < K)  // in flight while this slab is multiplied
      load_slab(a, sam, sak, b, sbk, sbn, m0, n0, k0 + kSlab, M, N, K, ra, rb);
    if constexpr (MODE == kFp32) {
      fma_slab(As, Bs, acc);
    } else {
      mma_slab<MODE>(As, Bs, acc);
    }
    __syncthreads();
  }
}

}  // namespace
