// gemm_tile.cuh: the output-tile mainloops that matmul.cu (tile_matmul) and
// syrk.cu (syrk_lower_sub) share, with the bf16 split pass and the host
// helpers around them. Each kernel keeps its own grid and epilogue; a
// mainloop leaves one tile's f32 sums in registers.
//
//   FP32  ffma_mainloop: 256 threads a 128 x 128 tile, an 8 x 8 register
//         micro-tile a thread, a 3-stage cp.async ring of 32-deep slabs (one
//         barrier a slab), two CTAs an SM. Shared memory holds both slabs
//         k-major ([k][m], [k][n]), rows padded by 4 floats, so neither the
//         copies (8 k x 4 m a warp when transposing) nor the float4 reads of
//         the micro-tile conflict, and the inner loop does no address
//         arithmetic. An operand whose unit stride runs along m (n) is
//         copied 16 bytes at a time when aligned; any other 4 bytes at a
//         time, lanes walking its smaller stride (a K-major one is so
//         transposed: cp.async cannot transpose 16 bytes).
//   bf16x3 and bf16  wgmma_mainloop: TMA + wgmma, warp-specialised: one
//         producer thread keeps a ring of stages (BK = 64, 128-byte swizzle)
//         filled by TMA, each completing on an mbarrier; two consumer
//         warpgroups run wgmma on their 64-row halves of the tile, the sums
//         in registers (setmaxnreg moves registers from the producer to
//         them). bf16x3 (NPROD = 3): a 128 x 128 tile, 3 stages of (ah, al,
//         bh, bl), three products a k-step, the small terms first: ah*bl,
//         al*bh, ah*bh (each product of bf16 values is exact, summed in f32).
//         bf16 (NPROD = 1): a 128 x 256 tile, 4 stages.
//   stage_kernel: the split pass of bf16x3, hi = bf16(x), lo = bf16(x - hi)
//         of an f32 operand read through its strides into aligned K-major
//         scratch (the split of the Pallas `_mm_kernel` :35-40), or the copy
//         of a bf16 operand that TMA cannot address.
//
// Everything here has internal linkage: each including source gets its own
// copies of the kernels.
#pragma once

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// how an operand is read: the plan's codes (ops/kernels/matmul.py _READS)
enum Read { kTmaK = 0, kTmaMN = 1, kStaged = 2, kCp16MN = 3, kCp4K = 4, kCp4MN = 5 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__host__ __device__ inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// ---- staging: hi (and lo) = the bf16 split of a strided operand ------------

// x: rows x cols with element (r, c) at x[r s_r + c s_c] -> hi, lo: rows x cols
// row-major with leading dimension ld (K-major scratch). One block a 32 x 32
// tile, read along the operand's unit stride and written along ld's.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(256)
stage_kernel(const T* x, long long s_r, long long s_c, int rows, int cols, bf16* hi,
             bf16* lo, int ld) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const bool c_fast = s_c <= s_r;
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = c_fast ? i : threadIdx.x, c = c_fast ? threadIdx.x : i;
    const int gr = r0 + r, gc = c0 + c;
    tile[r][c] = (gr < rows && gc < cols) ? to_f32(x[gr * s_r + gc * s_c]) : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int gr = r0 + i, gc = c0 + threadIdx.x;
    if (gr < rows && gc < cols) {
      const float v = tile[i][threadIdx.x];
      const bf16 h = __float2bfloat16_rn(v);
      hi[(long long)gr * ld + gc] = h;
      if (SPLIT) lo[(long long)gr * ld + gc] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
  }
}

// hi (and lo) <- the operand's bf16 split (or copy), rows x k K-major.
template <typename T>
cudaError_t stage(const void* x, long long s_r, long long s_k, int rows, int k, void* hi,
                  void* lo, int ldk, cudaStream_t s) {
  const dim3 grid(cdiv(k, 32), cdiv(rows, 32)), block(32, 8);
  if (lo != nullptr)
    stage_kernel<T, true><<<grid, block, 0, s>>>(static_cast<const T*>(x), s_r, s_k, rows, k,
                                                 static_cast<bf16*>(hi), static_cast<bf16*>(lo), ldk);
  else
    stage_kernel<T, false><<<grid, block, 0, s>>>(static_cast<const T*>(x), s_r, s_k, rows, k,
                                                  static_cast<bf16*>(hi), nullptr, ldk);
  return cudaGetLastError();
}

// ---- bf16 and bf16x3: TMA + wgmma ------------------------------------------

constexpr int kWgBM = 128, kWgBK = 64;
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr uint32_t kHalfTile = 64 * 128;  // bytes of 64 rows of 128 B

// NPROD products a k-step: 1 (bf16) on a 128 x 256 tile with 4 stages, 3
// (bf16x3) on a 128 x 128 tile with 3; either way 192 KiB of stages.
template <int NPROD>
struct WgLayout {
  static constexpr int BN = NPROD == 3 ? 128 : 256, ST = NPROD == 3 ? 3 : 4;
  static constexpr int NT = NPROD == 3 ? 2 : 1;  // tiles of each operand a stage (hi, lo)
  static constexpr uint32_t A_BYTES = kWgBM * kWgBK * 2, B_BYTES = BN * kWgBK * 2;
  static constexpr uint32_t STAGE = NT * (A_BYTES + B_BYTES);
  static constexpr int SMEM = ST * STAGE + 1024;  // + the 1024-byte alignment
};

// A's tile (128 rows of m, 64 of k) at dst: K-major one box {64 k, 128 m};
// M-major two boxes {64 m, 64 k}, the second 8 KB on. Either way rows
// 64.. of m start kHalfTile on.
template <bool A_MN>
__device__ __forceinline__ void load_a(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                       int m0, int k0) {
  if (A_MN) {
    tma_load(dst, map, bar, m0, k0);
    tma_load(dst + kHalfTile, map, bar, m0 + 64, k0);
  } else {
    tma_load(dst, map, bar, k0, m0);
  }
}

// B's tile (64 of k, BN of n): K-major one box {64 k, BN n}; N-major BN / 64
// boxes {64 n, 64 k}, 8 KB apart.
template <bool B_MN, int BN>
__device__ __forceinline__ void load_b(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                       int n0, int k0) {
  if (B_MN) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) tma_load(dst + j * kHalfTile, map, bar, n0 + 64 * j, k0);
  } else {
    tma_load(dst, map, bar, k0, n0);
  }
}

// Descriptors of k-step kk (16 deep) of a tile at shared address `base`:
// K-major rows of 128 B, the k-step 32 B along a row; MN-major rows of k, the
// k-step 16 rows (2048 B) down, atoms of 64 along M or N 8 KB apart.
template <bool MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t base, int kk) {
  return MN ? desc_sw128(base + kk * 2048, kHalfTile, 1024)
            : desc_sw128(base + kk * 32, 16, 1024);
}

// The shared memory of a wgmma kernel's ring, aligned to 1024 bytes.
__device__ __forceinline__ uint8_t* wg_ring(uint8_t* smem_raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                    ~uintptr_t(1023));
}

// The sums of the tile at (m0, n0) over the k tiles [kt0, kt0 + nt), for
// all kWgThreads threads of the CTA (each calls it once; full and empty are
// ST mbarriers in shared memory). Returns true in the consumer threads
// (warpgroups 0 and 1), whose acc then holds their 64-row half of the
// tile's sums: accumulator i of warp w, lane l at row 16 w + l / 4 +
// 8 ((i / 2) % 2) of the half, column 8 (i / 4) + 2 (l % 4) + i % 2.
// Returns false in the producer warpgroup, whose registers it has cut.
template <int NPROD, bool A_MN, bool B_MN>
__device__ __forceinline__ bool wgmma_mainloop(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                               const CUtensorMap* ta, const CUtensorMap* ta_lo,
                                               const CUtensorMap* tb, const CUtensorMap* tb_lo,
                                               int m0, int n0, int kt0, int nt,
                                               float (&acc)[WgLayout<NPROD>::BN / 2]) {
  using L = WgLayout<NPROD>;
  constexpr int BN = L::BN, ST = L::ST;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive from each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: the whole warpgroup gives up registers, one thread works
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < nt; ++t) {
        mbar_wait(&empty[s], ph ^ 1);  // the first round passes: the ring starts empty
        uint8_t* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE);
        const int k0 = (kt0 + t) * kWgBK;
        load_a<A_MN>(st, ta, &full[s], m0, k0);
        if constexpr (NPROD == 3) load_a<A_MN>(st + L::A_BYTES, ta_lo, &full[s], m0, k0);
        uint8_t* sb = st + L::NT * L::A_BYTES;
        load_b<B_MN, BN>(sb, tb, &full[s], n0, k0);
        if constexpr (NPROD == 3) load_b<B_MN, BN>(sb + L::B_BYTES, tb_lo, &full[s], n0, k0);
        if (++s == ST) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return false;
  }
  // consumers: rows 64 wg .. 64 wg + 63 of the tile
  setmaxnreg_inc<232>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int t = 0; t < nt; ++t) {
    mbar_wait(&full[s], ph);
    const uint32_t st = smem_addr(smem + s * L::STAGE);
    const uint32_t a_hi = st + wg * kHalfTile, a_lo = a_hi + L::A_BYTES;
    const uint32_t b_hi = st + L::NT * L::A_BYTES, b_lo = b_hi + L::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      const uint64_t dah = tile_desc<A_MN>(a_hi, kk), dbh = tile_desc<B_MN>(b_hi, kk);
      if constexpr (NPROD == 3) {  // the small terms first
        Wgmma<BN>::template mma<A_MN, B_MN>(acc, dah, tile_desc<B_MN>(b_lo, kk));
        Wgmma<BN>::template mma<A_MN, B_MN>(acc, tile_desc<A_MN>(a_lo, kk), dbh);
      }
      Wgmma<BN>::template mma<A_MN, B_MN>(acc, dah, dbh);
    }
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == ST) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  return true;
}

// ---- FP32: FFMA over a cp.async ring ---------------------------------------

constexpr int kFT = 128, kFBK = 32, kFST = 3, kFThreads = 256;
constexpr int kFLd = kFT + 4;         // a slab row: 128 floats and 4 of padding
constexpr int kFTile = kFBK * kFLd;   // floats of one operand's slab
constexpr int kFSmem = 2 * kFST * kFTile * (int)sizeof(float);  // 99 KiB

// Element (k, r) of a slab. The padding puts row k + 1 four banks on, so
// the 8 k x 4 r of a transposing warp's copies fill 32 banks.
__device__ __forceinline__ int fidx(int k, int r) { return k * kFLd + r; }

// One operand's copies into a slab: element (r, k) of the operand, r < R the
// tile's rows (m of A, n of B), at x[r s_r + k s_k]. Each thread keeps its
// pointers and row masks from slab to slab; only the k bound is tested per
// slab. Out-of-bounds elements are zero-filled and read nothing.
template <int READ>
struct FLoader;

template <>
struct FLoader<kCp16MN> {  // unit stride along r, 16-byte aligned: 4 chunks a thread
  const float* x;
  const float* p;
  long long step, adv;
  int r, k, bytes;
  __device__ void init(const float* x_, long long s_r, long long s_k, int row0, int R,
                       int kstart) {
    (void)s_r;
    x = x_;
    r = 4 * (threadIdx.x & 31);
    k = threadIdx.x >> 5;
    p = x + row0 + r + (long long)(kstart + k) * s_k;
    step = 8 * s_k;
    adv = kFBK * s_k;
    bytes = 4 * max(0, min(4, R - row0 - r));
  }
  __device__ void load(float* dst, int kb, int K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = bytes > 0 && kb + k + 8 * i < K;
      cp_async16(dst + fidx(k + 8 * i, r), ok ? p + i * step : x, ok ? bytes : 0);
    }
    p += adv;
  }
};

template <>
struct FLoader<kCp4MN> {  // 4 bytes, lanes walking r: 16 elements a thread
  const float* x;
  const float* p;
  long long step, adv;
  int r, k;
  bool rok;
  __device__ void init(const float* x_, long long s_r, long long s_k, int row0, int R,
                       int kstart) {
    x = x_;
    r = threadIdx.x & 127;
    k = threadIdx.x >> 7;
    p = x + (long long)(row0 + r) * s_r + (long long)(kstart + k) * s_k;
    step = 2 * s_k;
    adv = kFBK * s_k;
    rok = row0 + r < R;
  }
  __device__ void load(float* dst, int kb, int K) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool ok = rok && kb + k + 2 * i < K;
      cp_async4(dst + fidx(k + 2 * i, r), ok ? p + i * step : x, ok);
    }
    p += adv;
  }
};

template <>
struct FLoader<kCp4K> {  // 4 bytes, lanes walking k (transposing): 4 rows x 4 a thread
  const float* x;
  const float* p[4];
  long long step, adv;
  int r, k;
  bool rok[4];
  __device__ void init(const float* x_, long long s_r, long long s_k, int row0, int R,
                       int kstart) {
    x = x_;
    r = threadIdx.x >> 3;
    k = threadIdx.x & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = x + (long long)(row0 + r + 32 * j) * s_r + (long long)(kstart + k) * s_k;
      rok[j] = row0 + r + 32 * j < R;
    }
    step = 8 * s_k;
    adv = kFBK * s_k;
  }
  __device__ void load(float* dst, int kb, int K) {
    if (step == 8) {  // K-major: the four k of a row are immediate offsets
      copies<true>(dst, kb, K);
    } else {
      copies<false>(dst, kb, K);
    }
  }
  template <bool UNIT>
  __device__ __forceinline__ void copies(float* dst, int kb, int K) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = rok[j] && kb + k + 8 * q < K;
        cp_async4(dst + fidx(k + 8 * q, r + 32 * j), ok ? p[j] + (UNIT ? 8 * q : q * step) : x, ok);
      }
      p[j] += adv;
    }
  }
};

// Thread (tx, ty) of the 16 x 16 grid owns rows {4ty.., 64 + 4ty..} and
// columns {4tx.., 64 + 4tx..} of the tile. A warp is 4 x 8 threads (the
// warps 2 x 4), so its fragment reads of a slab row touch 4 (A) and 8 (B)
// distinct float4 (chosen over 2 x 16 and 8 x 4 threads by timing on an H100).
__device__ __forceinline__ void micro_tile(int& tx, int& ty) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  tx = (w % 2) * 8 + l % 8;
  ty = (w / 2) * 4 + l / 8;
}

// Row (column) i of a thread's micro-tile, t its ty (tx).
__device__ __forceinline__ int micro_rc(int t, int i) { return i < 4 ? 4 * t + i : 60 + 4 * t + i; }

// acc += the slab's product, each of the thread's rows and columns a float4
// read of a slab row: acc[8 i + j] is row micro_rc(ty, i), column
// micro_rc(tx, j).
__device__ __forceinline__ void fma_slab(const float* As, const float* Bs, float (&acc)[64]) {
  int tx, ty;
  micro_tile(tx, ty);
  const float* ap = As + 4 * ty;
  const float* bp = Bs + 4 * tx;
#pragma unroll
  for (int kk = 0; kk < kFBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + kk * kFLd);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + kk * kFLd + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(bp + kk * kFLd);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + kk * kFLd + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(av[i], bv[j], acc[i * 8 + j]);
  }
}

// acc = the sums of the tile at (m0, n0) of A(M, K) B(K, N) over the k slabs
// [kt0, kt0 + nt), by all kFThreads threads; smem: kFSmem bytes. A's
// element (i, k) at a[i sam + k sak], B's (k, j) at b[k sbk + j sbn]; RA,
// RB how each is read. On return every copy has landed, but other threads
// may still read the ring: __syncthreads() before reusing it.
template <int RA, int RB>
__device__ __forceinline__ void ffma_mainloop(float* smem, const float* a, long long sam,
                                              long long sak, const float* b, long long sbk,
                                              long long sbn, int M, int N, int K, int m0,
                                              int n0, int kt0, int nt, float (&acc)[64]) {
  float* As = smem;
  float* Bs = As + kFST * kFTile;
  const int kstart = kt0 * kFBK;
  FLoader<RA> la;
  FLoader<RB> lb;
  la.init(a, sam, sak, m0, M, kstart);
  lb.init(b, sbn, sbk, n0, N, kstart);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kFST - 1; ++s) {
    if (s < nt) {
      la.load(As + s * kFTile, kstart + s * kFBK, K);
      lb.load(Bs + s * kFTile, kstart + s * kFBK, K);
    }
    cp_async_commit();  // a group even when empty: the waits count groups
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kFST - 2>();  // slab t has landed (this thread's copies) ...
    __syncthreads();  // ... everyone's, and everyone is done with slab t - 1
    const int tn = t + kFST - 1;
    if (tn < nt) {  // into slab t - 1's buffers
      la.load(As + (tn % kFST) * kFTile, kstart + tn * kFBK, K);
      lb.load(Bs + (tn % kFST) * kFTile, kstart + tn * kFBK, K);
    }
    cp_async_commit();
    fma_slab(As + (t % kFST) * kFTile, Bs + (t % kFST) * kFTile, acc);
  }
  cp_async_wait<0>();
}

// ---- host side --------------------------------------------------------------

constexpr int kMaxRaised = 64;

// Raise a kernel's dynamic shared-memory ceiling once per device.
cudaError_t raise_smem(const void* kern, int bytes) {
  static const void* fns[kMaxRaised];
  static int devs[kMaxRaised];
  static int count = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < count; ++i)
    if (fns[i] == kern && devs[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && count < kMaxRaised) {
    fns[count] = kern;
    devs[count++] = dev;
  }
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over an (outer, inner) array, inner contiguous, rows
// stride_bytes apart, boxes of box_outer x box_inner (64: 128 bytes) in the
// 128-byte swizzle; out-of-bounds boxes read zeros.
bool tensor_map(CUtensorMap* map, const void* base, long long inner, long long outer,
                long long stride_bytes, int box_inner, int box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the FP32 read `read` can take an operand of rows x k, element
// (r, k) at x[r s_r + k s_k]: 16-byte copies need the unit stride along
// m (n), the other stride a multiple of 4 and an aligned base.
bool ffma_read_ok(int read, const void* x, long long s_r, long long s_k) {
  if (!aligned(x, 4)) return false;
  if (read == kCp16MN) return s_r == 1 && s_k % 4 == 0 && aligned(x, 16);
  return read == kCp4K || read == kCp4MN;
}

}  // namespace
