// syrk_lower_sub: C - A * A^T on the lower tiles of an (m, m) f32 matrix,
// the whole result written in one pass over C.
//
// Replaces: faer_tpu/ops/pallas/syrk_kernel.py `syrk_lower_sub` (:108; bodies
// `_syrk_padded` :71 and `_syrk_kernel` :51), which computes only the lower
// (i >= j) tile pairs of a Cholesky trailing update with the numerics of
// `pallas_matmul`. Like the JAX package, no driver calls it.
//
// What bounds it on the H100: in FP32, operations. The work is the lower
// triangle's m (m + 1) / 2 dot products of length k, m (m + 1) k flops: at
// (3840, 256) 3.78 GFLOP, 0.056 ms at 67 TFLOP/s. The bytes are the whole C
// read and the whole result written (the result is the whole matrix) and A
// read once: 2 m^2 + m k floats, 122 MB, 0.036 ms at 3.35 TB/s. The three
// bf16 passes of "high" take 0.011 ms on the tensor cores, so there the
// bytes bound it.
//
// Design: gemm_tile.cuh's mainloops on the lower tile pairs only, B = A^T
// read through A's swapped strides (no transpose copy). One launch of T^2
// CTAs (T = ceil(m / 128)): CTA t < T (T + 1) / 2 takes lower pair (i, j),
// t = i (i + 1) / 2 + j, decoded from blockIdx.x where Pallas had it by
// scalar prefetch; the T (T - 1) / 2 CTAs after them copy one upper tile of
// C each. Blocks start in index order, so the copies fill the slots the
// last wave of products leaves idle, and every SM moves bytes to the end.
//   FP32 ("highest")  ffma_mainloop, two CTAs an SM. A row-major A (both A_i
//        and A_j = B are then K-major, the main path's layout) goes through
//        a transposing pass first, 16 bytes a thread both ways, into M-major
//        scratch (at (3840, 256) 3.9 MB each way); the mainloop then copies
//        it 16 bytes at a time along m. cp.async cannot transpose 16 bytes,
//        and reading K-major slabs inside the mainloop cost more (H100,
//        (3840, 256), ms on the device: 16-byte copies of k-quads read by the
//        products as they lie 0.150-0.157, turned into [k][m] slabs in shared
//        memory 0.138-0.152, 4-byte transposing copies 0.129, against 0.113
//        for an M-major A). An M-major A is read 16 bytes at a time along m
//        directly; anything else (unaligned) 4 bytes at a time.
//   bf16x3 ("high")  the split pass turns A once into bf16 hi and lo (K-major
//        scratch), which serve as both operands; then wgmma_mainloop with
//        its three products a k-step in matmul.cu's order, ah*bl, al*bh,
//        ah*bh.
// The epilogue stages the tile's sums in the freed ring (rows padded to 136
// floats) and each warp then takes its rows, 16 bytes a lane: it loads its
// rows of C eight at a time before storing them, writing C - A_i A_j^T, or
// C's value above the diagonal of a diagonal tile. A copy CTA loads all of
// a warp's rows before its first store. Each element is read and written once; no copy of C
// precedes the launch. Ragged edges are masked, not padded.
#include "gemm_tile.cuh"

namespace {

enum Mode { kFp32 = 0, kBf16x3 = 1 };
// the read of a K-major A with 16-byte aligned rows: a transposing pass into
// M-major scratch (ops/kernels/syrk.py "cp16_k"), after gemm_tile.cuh's reads
constexpr int kTransposeK = 6;

constexpr int kT = 128;           // output tile side of both mainloops
constexpr int kStageLd = kT + 8;  // a staged row: float2 fragment stores meet in 2 wavefronts
constexpr int kBatch = 8;         // rows of C a warp of an epilogue loads before it stores

static_assert(kT * kStageLd * 4 <= kFSmem, "the staged tile fits the FFMA ring");

// (i, j), i >= j, of pair t = i (i + 1) / 2 + j of a lower triangle of tiles.
__device__ __forceinline__ void lower_pair(int t, int& i, int& j) {
  i = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;  // guard the rounding of sqrt
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

struct Out {
  const float* c;  // C, rows ldc apart
  long long ldc;
  float* out;      // the result, (M, M) contiguous
  int M;
  bool vec;        // 16-byte accesses: C's and the result's rows are 16-byte aligned
};

// The result's row gr, columns gc.. gc + 3 from C's (c4, loaded when v4)
// and the sums s: C - s on and below the diagonal (all of a tile below it,
// `below`), C above it.
__device__ __forceinline__ void write4(const Out& o, int gr, int gc, float4 c4, float4 s,
                                       bool below, bool v4) {
  float* orow = o.out + (long long)gr * o.M;
  if (v4) {
    float4 v;
    v.x = below || gc <= gr ? __fsub_rn(c4.x, s.x) : c4.x;
    v.y = below || gc + 1 <= gr ? __fsub_rn(c4.y, s.y) : c4.y;
    v.z = below || gc + 2 <= gr ? __fsub_rn(c4.z, s.z) : c4.z;
    v.w = below || gc + 3 <= gr ? __fsub_rn(c4.w, s.w) : c4.w;
    *reinterpret_cast<float4*>(orow + gc) = v;
    return;
  }
  const float* cr = o.c + (long long)gr * o.ldc;
  const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = gc + e;
    if (col < o.M) orow[col] = below || col <= gr ? __fsub_rn(cr[col], sv[e]) : cr[col];
  }
}

// The epilogue of lower tile (ti, tj) from its sums staged in S (kT rows of
// kStageLd floats), by NT threads: a warp a row at a time, lane l on columns
// 4 l .. 4 l + 3, kBatch of the warp's rows of C loaded before their first
// store.
template <int NT>
__device__ __forceinline__ void write_tile(const float* S, const Out& o, int ti, int tj) {
  constexpr int kWarpsT = NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gc = tj * kT + 4 * lane;
  if (gc >= o.M) return;
  const bool v4 = o.vec && gc + 3 < o.M;
  for (int r0 = warp; r0 < kT; r0 += kWarpsT * kBatch) {
    float4 cv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = r0 + q * kWarpsT, gr = ti * kT + r;
      if (r < kT && gr < o.M && v4)
        cv[q] = __ldcs(reinterpret_cast<const float4*>(o.c + (long long)gr * o.ldc + gc));
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = r0 + q * kWarpsT, gr = ti * kT + r;
      if (r >= kT || gr >= o.M) break;
      write4(o, gr, gc, cv[q], *reinterpret_cast<const float4*>(S + r * kStageLd + 4 * lane),
             ti > tj, v4);
    }
  }
}

// Upper tile u (0 <= u < T (T - 1) / 2): C's values, by NT threads, every
// one of a warp's rows loaded before the first store.
template <int NT>
__device__ __forceinline__ void copy_tile(const Out& o, int u) {
  constexpr int kRows = (kT + NT / 32 - 1) / (NT / 32);  // rows a warp, at most
  int a, b;
  lower_pair(u, a, b);  // the tile at row b, column a + 1: above the diagonal
  const int ti = b, tj = a + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gc = tj * kT + 4 * lane;
  if (gc >= o.M) return;
  const bool v4 = o.vec && gc + 3 < o.M;
  float4 x[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = warp + q * (NT / 32), gr = ti * kT + r;
    const float* cr = o.c + (long long)gr * o.ldc + gc;
    if (r < kT && gr < o.M) {
      if (v4) {
        x[q] = __ldcs(reinterpret_cast<const float4*>(cr));
      } else {
        x[q].x = cr[0];
        x[q].y = gc + 1 < o.M ? cr[1] : 0.0f;
        x[q].z = gc + 2 < o.M ? cr[2] : 0.0f;
        x[q].w = gc + 3 < o.M ? cr[3] : 0.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = warp + q * (NT / 32), gr = ti * kT + r;
    if (r >= kT || gr >= o.M) break;
    float* orow = o.out + (long long)gr * o.M + gc;
    if (v4) {
      *reinterpret_cast<float4*>(orow) = x[q];
    } else {
      const float xv[4] = {x[q].x, x[q].y, x[q].z, x[q].w};
      for (int e = 0; e < 4 && gc + e < o.M; ++e) orow[e] = xv[e];
    }
  }
}

template <int READ>
__global__ void __launch_bounds__(kFThreads, 2)
syrk_ffma_kernel(const float* a, long long sam, long long sak, Out o, int K, int pairs) {
  extern __shared__ float4 fsmem[];
  float* smem = reinterpret_cast<float*>(fsmem);
  const int t = blockIdx.x;
  if (t >= pairs) {
    copy_tile<kFThreads>(o, t - pairs);
    return;
  }
  int ti, tj;
  lower_pair(t, ti, tj);
  float acc[64];
  // B = A^T: B(k, n) = A(n, k), so B's strides (sbk, sbn) are (sak, sam)
  ffma_mainloop<READ, READ>(smem, a, sam, sak, a, sak, sam, o.M, o.M, K, ti * kT, tj * kT, 0,
                            cdiv(K, kFBK), acc);
  __syncthreads();  // every thread is done with the ring
  int tx, ty;
  micro_tile(tx, ty);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = smem + micro_rc(ty, i) * kStageLd;
    const float* v = acc + 8 * i;
    *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();
  write_tile<kFThreads>(smem, o, ti, tj);
}

// A (m, k), rows sam apart, unit stride along k, rows 16-byte aligned ->
// At (k, m), rows ldt apart (a multiple of 4, At 16-byte aligned): one block
// a 32 x 32 tile through shared memory, 16 bytes a thread both ways (8
// threads a 128-byte row segment), every access conflict-free (rows of 33).
__global__ void __launch_bounds__(256)
k_to_m_major(const float* a, long long sam, int m, int k, float* at, long long ldt) {
  __shared__ float tile[32][33];  // [k][m]
  const int m0 = blockIdx.y * 32, k0 = blockIdx.x * 32, t = threadIdx.x;
  {
    const int rr = t >> 3, kq = t & 7, gr = m0 + rr, gk = k0 + 4 * kq;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (gr < m) {
      const float* src = a + (long long)gr * sam + gk;
      if (gk + 3 < k) {
        const float4 x = *reinterpret_cast<const float4*>(src);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
        for (int e = 0; e < 4; ++e)
          if (gk + e < k) v[e] = src[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[4 * kq + e][rr] = v[e];
  }
  __syncthreads();
  const int kk = t >> 3, mq = t & 7, gk = k0 + kk, gm = m0 + 4 * mq;
  if (gk >= k) return;
  float* dst = at + (long long)gk * ldt + gm;
  const float v[4] = {tile[kk][4 * mq], tile[kk][4 * mq + 1], tile[kk][4 * mq + 2],
                      tile[kk][4 * mq + 3]};
  if (gm + 3 < m) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < 4; ++e)
      if (gm + e < m) dst[e] = v[e];
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // warpgroups 0 and 1 only
}

__global__ void __launch_bounds__(kWgThreads, 1)
syrk_wgmma_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tl,
                  Out o, int K, int pairs) {
  using L = WgLayout<3>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[L::ST], empty[L::ST];
  uint8_t* ring = wg_ring(smem_raw);
  const int t = blockIdx.x;
  if (t >= pairs) {
    copy_tile<kWgThreads>(o, t - pairs);
    return;
  }
  int ti, tj;
  lower_pair(t, ti, tj);
  float acc[L::BN / 2];
  // hi and lo of A serve as both operands: B's K-major tile at n0 is A's
  if (!wgmma_mainloop<3, false, false>(ring, full, empty, &th, &tl, &th, &tl, ti * kT, tj * kT, 0,
                                       cdiv(K, kWgBK), acc))
    return;
  consumers_sync();  // both warpgroups are done reading the ring
  // accumulator 4 j + 2 h + e of warp w, lane l: row 16 w + l / 4 + 8 h of
  // the warpgroup's half, column 8 j + 2 (l % 4) + e
  float* S = reinterpret_cast<float*>(ring);
  const int wg = threadIdx.x / 128, w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < L::BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * w + lane / 4 + 8 * h;
      *reinterpret_cast<float2*>(S + row * kStageLd + 8 * j + 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  consumers_sync();
  write_tile<256>(S, o, ti, tj);
}

template <int READ>
cudaError_t launch_ffma(const float* a, long long sam, long long sak, const Out& o, int k,
                        int pairs, int blocks, cudaStream_t s) {
  auto kern = syrk_ffma_kernel<READ>;
  const cudaError_t err = raise_smem(reinterpret_cast<const void*>(kern), kFSmem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kFThreads, kFSmem, s>>>(a, sam, sak, o, k, pairs);
  return cudaGetLastError();
}

}  // namespace

// a: (m, k) f32 with element (i, j) at a + i*sam + j*sak; c: (m, m) f32 with
// unit column stride, rows ldc apart; out: (m, m) contiguous f32, written
// whole: C - A A^T on and below the diagonal, C above it. mode 0 = FP32,
// 1 = bf16x3. read: how the FP32 mainloop reads A (gemm_tile.cuh enum Read:
// 3 16 bytes along m, 4 or 5 4 bytes), or kTransposeK: A K-major with
// 16-byte aligned rows, read 16 bytes at a time into at, its (k, ldt)
// M-major f32 copy (ldt >= m, a multiple of 4), which the mainloop reads 16
// bytes at a time along m. hi, lo: (m, ldk) bf16 scratch for bf16x3 (ldk >=
// k, a multiple of 8). Scratch is unused in FP32 or when k = 0 as its
// route does not need it. Launches on the current device. Returns the CUDA
// error (0 on success), or cudaErrorInvalidValue, launching nothing, for
// arguments the kernels cannot take.
extern "C" int faer_syrk_lower_sub(const float* a, long long sam, long long sak, const float* c,
                                   long long ldc, float* out, int m, int k, int mode, int read,
                                   void* hi, void* lo, int ldk, float* at, long long ldt,
                                   void* stream) {
  if (m < 1 || k < 0 || mode < 0 || mode > 1 || ldc < m || !aligned(c, 4)) return cudaErrorInvalidValue;
  const long long tiles = (m + kT - 1) / kT;
  if (tiles * tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int pairs = (int)(tiles * (tiles + 1) / 2), blocks = (int)(tiles * tiles);
  const Out o{c, ldc, out, m,
              ldc % 4 == 0 && m % 4 == 0 && aligned(c, 16) && aligned(out, 16)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (mode == kBf16x3 && k > 0) {
    if (hi == nullptr || lo == nullptr || !aligned(hi, 16) || !aligned(lo, 16) || ldk < k ||
        ldk % 8 != 0 || !aligned(a, 4) || cdiv(m, 32) > 65535)
      return cudaErrorInvalidValue;
    err = stage<float>(a, sam, sak, m, k, hi, lo, ldk, s);
    if (err != cudaSuccess) return err;
    CUtensorMap th, tl;
    if (!tensor_map(&th, hi, k, m, 2LL * ldk, 64, kT) || !tensor_map(&tl, lo, k, m, 2LL * ldk, 64, kT))
      return cudaErrorInvalidValue;
    err = raise_smem(reinterpret_cast<const void*>(syrk_wgmma_kernel), WgLayout<3>::SMEM);
    if (err != cudaSuccess) return err;
    syrk_wgmma_kernel<<<blocks, kWgThreads, WgLayout<3>::SMEM, s>>>(th, tl, o, k, pairs);
    return cudaGetLastError();
  }
  // FP32, and an empty sum in either mode (the result is then C)
  if (read == kTransposeK) {
    if (k == 0) return launch_ffma<kCp4K>(a, sam, sak, o, k, pairs, blocks, s);
    if (sak != 1 || sam % 4 != 0 || !aligned(a, 16) || at == nullptr || !aligned(at, 16) ||
        ldt < m || ldt % 4 != 0 || cdiv(m, 32) > 65535)
      return cudaErrorInvalidValue;
    k_to_m_major<<<dim3(cdiv(k, 32), cdiv(m, 32)), 256, 0, s>>>(a, sam, m, k, at, ldt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_ffma<kCp16MN>(at, 1, ldt, o, k, pairs, blocks, s);
  }
  if (!ffma_read_ok(read, a, sam, sak)) return cudaErrorInvalidValue;
  switch (read) {
    case kCp16MN: return launch_ffma<kCp16MN>(a, sam, sak, o, k, pairs, blocks, s);
    case kCp4K: return launch_ffma<kCp4K>(a, sam, sak, o, k, pairs, blocks, s);
    default: return launch_ffma<kCp4MN>(a, sam, sak, o, k, pairs, blocks, s);
  }
}
