// tile_matmul: C = A * B for 2-D f32 or bf16 operands of any strides.
//
// Replaces: faer_tpu/ops/pallas/matmul_kernel.py `pallas_matmul` (:92; bodies
// `_mm_padded` :59 and `_mm_kernel` :20), the tile GEMM that the JAX front
// door sends every 2-D f32/bf16 product above 128^3 to when its switch is on.
// The Pallas grid's sequential k dimension with its VMEM accumulator becomes
// a k loop inside one CTA, or, for thin products, `split` CTAs over slices of
// k whose f32 partials a second kernel sums in the fixed order 0..split-1 (no
// atomics, so a result does not depend on the schedule).
//
// What bounds it on the H100: operations. At 4096^3, 2 * 4096^3 flops are
// 2.05 ms at the 67 TFLOP/s FP32 peak ("highest"), 0.139 ms at the 989
// TFLOP/s bf16 tensor-core peak ("bf16") and 0.417 ms for the three bf16
// passes of "high"; the bytes (two 64 MiB operands in, one out) are 0.06 ms
// at 3.35 TB/s. So each mode is built around its arithmetic unit:
//
//   "bf16"  TMA + wgmma, warp-specialised: one producer thread keeps a ring of
//           4 shared-memory stages (BK = 64, 128-byte swizzle) filled by TMA,
//           each stage completing on an mbarrier; two consumer warpgroups run
//           wgmma m64n256k16 on their 64-row halves of a 128 x 256 tile, the
//           sums in registers (setmaxnreg moves registers from the producer to
//           them). wgmma's transpose bits read either major order of A and B,
//           so a transposed view costs no copy; TMA zero-fills the ragged
//           edges. An operand TMA cannot address (an unaligned base, or no
//           unit stride with a 16-byte-multiple other stride) is first packed
//           into aligned K-major scratch, as the Pallas wrapper pads.
//   "high"  bf16x3: a staging pass splits each f32 operand through its strides
//           into hi = bf16(x) and lo = bf16(x - hi) in aligned K-major scratch
//           (the split of `_mm_kernel` :35-40); then the same mainloop on a
//           128 x 128 tile, 3 stages of (ah, al, bh, bl), three wgmma a k-step,
//           the small terms first: ah*bl, al*bh, ah*bh (each product of bf16
//           values is exact, summed in f32).
//   FP32    ("highest"; TF32 stays refused) FFMA on the CUDA cores: 256 threads
//           a 128 x 128 tile, an 8 x 8 register micro-tile a thread, a 3-stage
//           cp.async ring of 32-deep slabs (one barrier a slab), two CTAs an
//           SM. Shared memory holds both slabs k-major ([k][m], [k][n]), rows
//           padded by 4 floats, so neither the copies (8 k x 4 m a warp when
//           transposing) nor the float4 reads of the micro-tile conflict, and
//           the inner loop does no address arithmetic. An operand whose
//           unit stride runs along m (n) is copied 16 bytes at a time when
//           aligned; one whose unit stride runs along k is copied (and so
//           transposed) 4 bytes at a time, lanes walking k: cp.async cannot
//           transpose, and a [m][k] layout would need 32 more registers a
//           thread than two CTAs an SM leave.
//
// The plan (route, tile, split, how each operand is read) is made in Python
// (ops/kernels/matmul.py plan_tile_matmul) and checked here against the
// operands before anything is launched; there is no fallback route.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

enum Mode { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };
// how an operand is read: the plan's codes (ops/kernels/matmul.py _READS)
enum Read { kTmaK = 0, kTmaMN = 1, kStaged = 2, kCp16MN = 3, kCp4K = 4, kCp4MN = 5 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Row `row`, columns col..col+3 of the (M, N) row-major C, f32 or bf16; the
// 16-byte (8-byte) store where the four are in bounds and aligned.
__device__ __forceinline__ void store4(void* c, bool out_bf16, int M, int N, int row,
                                       int col, float4 v) {
  if (row >= M || col >= N) return;
  const long long off = (long long)row * N + col;
  const bool whole = col + 3 < N && (N & 3) == 0;
  const float x[4] = {v.x, v.y, v.z, v.w};
  if (out_bf16) {
    bf16* p = static_cast<bf16*>(c) + off;
    if (whole) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = u;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < N) p[i] = __float2bfloat16_rn(x[i]);
    }
  } else {
    float* p = static_cast<float*>(c) + off;
    if (whole) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < N) p[i] = x[i];
    }
  }
}

// The output of slice blockIdx.z: C itself, or its f32 partial in the
// (split, M, N) workspace.
__device__ __forceinline__ void* slice_out(void* c, int M, int N) {
  return gridDim.z > 1 ? static_cast<void*>(static_cast<float*>(c) +
                                            (long long)blockIdx.z * M * N)
                       : c;
}

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

// ---- split-k: the partials summed in slice order ---------------------------

__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* work, int split, int M, int N, void* c, int out_bf16) {
  const long long mn = (long long)M * N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = work[i];
    for (int z = 1; z < split; ++z) s += work[z * mn + i];
    if (out_bf16)
      static_cast<bf16*>(c)[i] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(c)[i] = s;
  }
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

template <int NPROD, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap ta_lo,
             const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tb_lo,
             void* c, int M, int N, int K, int tiles_per_slice, int out_bf16) {
  using L = WgLayout<NPROD>;
  constexpr int BN = L::BN, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int kt0 = blockIdx.z * tiles_per_slice;
  const int nt = max(0, min(tiles_per_slice, ktiles - kt0));
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
        load_a<A_MN>(st, &ta, &full[s], m0, k0);
        if constexpr (NPROD == 3) load_a<A_MN>(st + L::A_BYTES, &ta_lo, &full[s], m0, k0);
        uint8_t* sb = st + L::NT * L::A_BYTES;
        load_b<B_MN, BN>(sb, &tb, &full[s], n0, k0);
        if constexpr (NPROD == 3) load_b<B_MN, BN>(sb + L::B_BYTES, &tb_lo, &full[s], n0, k0);
        if (++s == ST) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {  // consumers: rows 64 wg .. 64 wg + 63 of the tile
    setmaxnreg_inc<232>();
    float acc[BN / 2];
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
    // accumulator i of warp w, lane l: row 16 w + l / 4 + 8 ((i / 2) % 2),
    // column 8 (i / 4) + 2 (l % 4) + i % 2. Lane pairs swap halves so that
    // each lane holds four consecutive columns of one row.
    const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool odd = lane & 1;
    const int row = m0 + wg * 64 + w * 16 + lane / 4 + (odd ? 8 : 0);
    void* out = slice_out(c, M, N);
    const bool bf = out_bf16 && gridDim.z == 1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float d0 = acc[4 * j], d1 = acc[4 * j + 1], d2 = acc[4 * j + 2], d3 = acc[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d0 : d2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d1 : d3, 1);
      const float4 v = odd ? make_float4(r0, r1, d2, d3) : make_float4(d0, d1, r0, r1);
      store4(out, bf, M, N, row, n0 + 8 * j + (lane & 2) * 2, v);
    }
  }
}

// ---- FP32: FFMA over a cp.async ring ---------------------------------------

constexpr int kFT = 128, kFBK = 32, kFST = 3, kFThreads = 256;
constexpr int kFLd = kFT + 4;         // a slab row: 128 floats and 4 of padding
constexpr int kFTile = kFBK * kFLd;   // floats of one operand's slab
constexpr int kFSmem = 2 * kFST * kFTile * (int)sizeof(float);  // 99 KiB

// Element (k, r) of a [k][128] slab. The padding puts row k + 1 four banks
// on, so the 8 k x 4 r of a transposing warp's copies fill 32 banks.
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

// acc += the slab's product, each of the thread's rows and columns a float4
// read of a slab row.
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

template <int RA, int RB>
__global__ void __launch_bounds__(kFThreads, 2)
ffma_kernel(const float* a, long long sam, long long sak, const float* b, long long sbk,
            long long sbn, void* c, int M, int N, int K, int tiles_per_slice, int out_bf16) {
  extern __shared__ float4 fsmem[];
  float* As = reinterpret_cast<float*>(fsmem);
  float* Bs = As + kFST * kFTile;
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int ktiles = (K + kFBK - 1) / kFBK;
  const int kt0 = blockIdx.z * tiles_per_slice;
  const int nt = max(0, min(tiles_per_slice, ktiles - kt0));
  const int kstart = kt0 * kFBK;
  FLoader<RA> la;
  FLoader<RB> lb;
  la.init(a, sam, sak, m0, M, kstart);
  lb.init(b, sbn, sbk, n0, N, kstart);
  float acc[64];
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
  int tx, ty;
  micro_tile(tx, ty);
  void* out = slice_out(c, M, N);
  const bool bf = out_bf16 && gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    const float* v = acc + 8 * i;
    store4(out, bf, M, N, row, n0 + 4 * tx, make_float4(v[0], v[1], v[2], v[3]));
    store4(out, bf, M, N, row, n0 + 64 + 4 * tx, make_float4(v[4], v[5], v[6], v[7]));
  }
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

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Whether `read` is a valid way to read an operand of `rows` x k (rows: m of
// A, n of B), element (r, k) at x[r s_r + k s_k], in `mode`.
bool read_ok(int mode, int read, const void* x, long long s_r, long long s_k, int rows, int k,
             const void* hi, const void* lo, int ldk) {
  const bool staged_ok = hi != nullptr && aligned(hi, 16) && ldk >= k && ldk % 8 == 0;
  switch (mode) {
    case kFp32:
      if (!aligned(x, 4)) return false;
      if (read == kCp16MN) return s_r == 1 && s_k % 4 == 0 && aligned(x, 16);
      return read == kCp4K || read == kCp4MN;
    case kBf16x3:
      return read == kStaged && staged_ok && lo != nullptr && aligned(lo, 16);
    default:
      if (read == kTmaK) return s_k == 1 && s_r % 8 == 0 && s_r >= k && aligned(x, 16);
      if (read == kTmaMN) return s_r == 1 && s_k % 8 == 0 && s_k >= rows && aligned(x, 16);
      return read == kStaged && staged_ok && aligned(x, 2);
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

template <int NPROD, bool A_MN, bool B_MN>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& ta_lo, const CUtensorMap& tb,
                         const CUtensorMap& tb_lo, void* c, int m, int n, int k, int split,
                         int out_bf16, cudaStream_t s) {
  using L = WgLayout<NPROD>;
  auto kern = wgmma_kernel<NPROD, A_MN, B_MN>;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(kern), L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, L::BN), cdiv(m, kWgBM), split);
  kern<<<grid, kWgThreads, L::SMEM, s>>>(ta, ta_lo, tb, tb_lo, c, m, n, k,
                                         cdiv(cdiv(k, kWgBK), split), out_bf16);
  return cudaGetLastError();
}

template <int RA, int RB>
cudaError_t launch_ffma(const float* a, long long sam, long long sak, const float* b,
                        long long sbk, long long sbn, void* c, int m, int n, int k, int split,
                        int out_bf16, cudaStream_t s) {
  auto kern = ffma_kernel<RA, RB>;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(kern), kFSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kFT), cdiv(m, kFT), split);
  kern<<<grid, kFThreads, kFSmem, s>>>(a, sam, sak, b, sbk, sbn, c, m, n, k,
                                       cdiv(cdiv(k, kFBK), split), out_bf16);
  return cudaGetLastError();
}

template <int RA>
cudaError_t ffma_b(int rb, const float* a, long long sam, long long sak, const float* b,
                   long long sbk, long long sbn, void* c, int m, int n, int k, int split,
                   int out_bf16, cudaStream_t s) {
  switch (rb) {
    case kCp16MN: return launch_ffma<RA, kCp16MN>(a, sam, sak, b, sbk, sbn, c, m, n, k, split, out_bf16, s);
    case kCp4K: return launch_ffma<RA, kCp4K>(a, sam, sak, b, sbk, sbn, c, m, n, k, split, out_bf16, s);
    default: return launch_ffma<RA, kCp4MN>(a, sam, sak, b, sbk, sbn, c, m, n, k, split, out_bf16, s);
  }
}

}  // namespace

// C = A * B. a: (m, k) with element (i, j) at a + i*sam + j*sak; b: (k, n)
// likewise with strides (sbk, sbn); c: (m, n) row-major contiguous, bf16 if
// out_bf16 else f32. mode 0 = FP32, 1 = bf16x3 (both f32 a and b), 2 = bf16
// a and b. The plan: read_a, read_b (enum Read), split (k slices; > 1 needs
// work, a (split, m, n) f32 workspace), and for staged operands the scratch
// ah, al: (m, ldk) and bh, bl: (n, ldk) bf16 (al, bl for bf16x3 only).
// Launches on the current device: the staging passes, the product, the
// split-k sum. Returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue, launching nothing, for a plan that does not fit the
// operands.
extern "C" int faer_tile_matmul(const void* a, long long sam, long long sak, const void* b,
                                long long sbk, long long sbn, void* c, int m, int n, int k,
                                int mode, int out_bf16, int read_a, int read_b, int split,
                                void* work, void* ah, void* al, void* bh, void* bl, int ldk,
                                void* stream) {
  if (m < 1 || n < 1 || k < 0 || mode < 0 || mode > 2 || split < 1 || split > 65535)
    return cudaErrorInvalidValue;
  if (!read_ok(mode, read_a, a, sam, sak, m, k, ah, al, ldk) ||
      !read_ok(mode, read_b, b, sbn, sbk, n, k, bh, bl, ldk))
    return cudaErrorInvalidValue;
  const int bk = mode == kFp32 ? kFBK : kWgBK;
  if (split > 1 && (work == nullptr || !aligned(work, 16) || split > cdiv(k, bk)))
    return cudaErrorInvalidValue;
  // grid rows: the product's 128-row tiles, the staging pass's 32-row tiles
  if (cdiv(m, 128) > 65535 || (mode != kFp32 && (cdiv(m, 32) > 65535 || cdiv(n, 32) > 65535)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = (size_t)m * n * (out_bf16 ? 2 : 4);
  if (k == 0) return cudaMemsetAsync(c, 0, out_bytes, s);  // an empty sum
  void* dst = split > 1 ? work : c;
  cudaError_t err = cudaSuccess;
  if (mode == kFp32) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    switch (read_a) {
      case kCp16MN: err = ffma_b<kCp16MN>(read_b, fa, sam, sak, fb, sbk, sbn, dst, m, n, k, split, out_bf16, s); break;
      case kCp4K: err = ffma_b<kCp4K>(read_b, fa, sam, sak, fb, sbk, sbn, dst, m, n, k, split, out_bf16, s); break;
      default: err = ffma_b<kCp4MN>(read_b, fa, sam, sak, fb, sbk, sbn, dst, m, n, k, split, out_bf16, s); break;
    }
  } else {
    // staged operands first, then tensor maps over what the mainloop reads
    const bool split3 = mode == kBf16x3;
    const int bn = split3 ? WgLayout<3>::BN : WgLayout<1>::BN;
    if (read_a == kStaged)
      err = split3 ? stage<float>(a, sam, sak, m, k, ah, al, ldk, s)
                   : stage<bf16>(a, sam, sak, m, k, ah, nullptr, ldk, s);
    if (err == cudaSuccess && read_b == kStaged)
      err = split3 ? stage<float>(b, sbn, sbk, n, k, bh, bl, ldk, s)
                   : stage<bf16>(b, sbn, sbk, n, k, bh, nullptr, ldk, s);
    if (err != cudaSuccess) return err;
    CUtensorMap ta, ta_lo, tb, tb_lo;
    bool ok = true;
    if (read_a == kStaged) {
      ok = tensor_map(&ta, ah, k, m, 2LL * ldk, 64, kWgBM) &&
           (!split3 || tensor_map(&ta_lo, al, k, m, 2LL * ldk, 64, kWgBM));
    } else if (read_a == kTmaK) {
      ok = tensor_map(&ta, a, k, m, 2 * sam, 64, kWgBM);
    } else {
      ok = tensor_map(&ta, a, m, k, 2 * sak, 64, 64);
    }
    if (ok && read_b == kStaged) {
      ok = tensor_map(&tb, bh, k, n, 2LL * ldk, 64, bn) &&
           (!split3 || tensor_map(&tb_lo, bl, k, n, 2LL * ldk, 64, bn));
    } else if (ok && read_b == kTmaK) {
      ok = tensor_map(&tb, b, k, n, 2 * sbn, 64, bn);
    } else if (ok) {
      ok = tensor_map(&tb, b, n, k, 2 * sbk, 64, 64);
    }
    if (!ok) return cudaErrorInvalidValue;
    if (split3) {
      err = launch_wgmma<3, false, false>(ta, ta_lo, tb, tb_lo, dst, m, n, k, split, out_bf16, s);
    } else {
      const bool amn = read_a == kTmaMN, bmn = read_b == kTmaMN;
      if (!amn && !bmn) err = launch_wgmma<1, false, false>(ta, ta, tb, tb, dst, m, n, k, split, out_bf16, s);
      else if (!amn) err = launch_wgmma<1, false, true>(ta, ta, tb, tb, dst, m, n, k, split, out_bf16, s);
      else if (!bmn) err = launch_wgmma<1, true, false>(ta, ta, tb, tb, dst, m, n, k, split, out_bf16, s);
      else err = launch_wgmma<1, true, true>(ta, ta, tb, tb, dst, m, n, k, split, out_bf16, s);
    }
  }
  if (err != cudaSuccess || split == 1) return err;
  const long long mn = (long long)m * n;
  const long long want = (mn + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  splitk_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(work), split, m, n, c,
                                              out_bf16);
  return cudaGetLastError();
}
