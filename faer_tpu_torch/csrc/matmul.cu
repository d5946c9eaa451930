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
//           SM. An operand whose unit stride runs along m (n) is copied 16
//           bytes at a time when aligned; any other 4 bytes at a time, lanes
//           walking its smaller stride (a K-major one is transposed so).
//
// The mainloops, the split pass and the tensor maps are gemm_tile.cuh's,
// shared with syrk.cu; this file has the grid, the split-k sum and the
// epilogues.
//
// The plan (route, tile, split, how each operand is read) is made in Python
// (ops/kernels/matmul.py plan_tile_matmul) and checked here against the
// operands before anything is launched; there is no fallback route.
#include "gemm_tile.cuh"

namespace {

enum Mode { kFp32 = 0, kBf16x3 = 1, kBf16 = 2 };

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

// ---- bf16 and bf16x3: TMA + wgmma (gemm_tile.cuh's mainloop) ---------------

template <int NPROD, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap ta_lo,
             const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tb_lo,
             void* c, int M, int N, int K, int tiles_per_slice, int out_bf16) {
  using L = WgLayout<NPROD>;
  constexpr int BN = L::BN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[L::ST], empty[L::ST];
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int kt0 = blockIdx.z * tiles_per_slice;
  const int nt = max(0, min(tiles_per_slice, ktiles - kt0));
  float acc[BN / 2];
  if (!wgmma_mainloop<NPROD, A_MN, B_MN>(wg_ring(smem_raw), full, empty, &ta, &ta_lo, &tb, &tb_lo,
                                         m0, n0, kt0, nt, acc))
    return;
  // accumulator i of warp w, lane l: row 16 w + l / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (l % 4) + i % 2. Lane pairs swap halves so that
  // each lane holds four consecutive columns of one row.
  const int wg = threadIdx.x / 128;
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

// ---- FP32: FFMA over a cp.async ring (gemm_tile.cuh's mainloop) -------------

template <int RA, int RB>
__global__ void __launch_bounds__(kFThreads, 2)
ffma_kernel(const float* a, long long sam, long long sak, const float* b, long long sbk,
            long long sbn, void* c, int M, int N, int K, int tiles_per_slice, int out_bf16) {
  extern __shared__ float4 fsmem[];
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int ktiles = (K + kFBK - 1) / kFBK;
  const int kt0 = blockIdx.z * tiles_per_slice;
  const int nt = max(0, min(tiles_per_slice, ktiles - kt0));
  float acc[64];
  ffma_mainloop<RA, RB>(reinterpret_cast<float*>(fsmem), a, sam, sak, b, sbk, sbn, M, N, K, m0,
                        n0, kt0, nt, acc);
  int tx, ty;
  micro_tile(tx, ty);
  void* out = slice_out(c, M, N);
  const bool bf = out_bf16 && gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + micro_rc(ty, i);
    const float* v = acc + 8 * i;
    store4(out, bf, M, N, row, n0 + 4 * tx, make_float4(v[0], v[1], v[2], v[3]));
    store4(out, bf, M, N, row, n0 + 64 + 4 * tx, make_float4(v[4], v[5], v[6], v[7]));
  }
}

// ---- host side --------------------------------------------------------------

// Whether `read` is a valid way to read an operand of `rows` x k (rows: m of
// A, n of B), element (r, k) at x[r s_r + k s_k], in `mode`.
bool read_ok(int mode, int read, const void* x, long long s_r, long long s_k, int rows, int k,
             const void* hi, const void* lo, int ldk) {
  const bool staged_ok = hi != nullptr && aligned(hi, 16) && ldk >= k && ldk % 8 == 0;
  switch (mode) {
    case kFp32:
      return ffma_read_ok(read, x, s_r, s_k);
    case kBf16x3:
      return read == kStaged && staged_ok && lo != nullptr && aligned(lo, 16);
    default:
      if (read == kTmaK) return s_k == 1 && s_r % 8 == 0 && s_r >= k && aligned(x, 16);
      if (read == kTmaMN) return s_r == 1 && s_k % 8 == 0 && s_k >= rows && aligned(x, 16);
      return read == kStaged && staged_ok && aligned(x, 2);
  }
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
