// trtri: inverses of (n <= 128) lower-triangular f32 diagonal blocks, unit
// or not, one CTA a block, any number of blocks in one launch.
//
// Replaces: faer_tpu/ops/pallas/panel_kernels.py `trtri_pallas` (:302, body
// `_trtri_kernel` :255), which forms inv(L) by Neumann doubling plus one
// Newton-Schulz step on the MXU.
//
// What bounds it on the H100: not bytes (64 KB in, 64 KB out at n = 128) and
// not FLOPs (n^3/3 = 0.7 M FMA), but latency: the dependent chain of a
// substitution and one SM's FFMA and shared-memory rate, and at the call
// sites the launches (a triangular solve needs one inverse per 128-row block,
// a large inverse one per leaf of its halving).
//
// Design: one CTA of 16 warps a block, its body compiled for each padded
// side p = 16 * 2^k >= n (the identity fills the padding). The block is
// staged in shared memory through its row and column strides (a transposed
// view is read as it lies, no copy): 16-byte loads, all in flight, where
// the rows or columns are aligned, else one cp.async an element. Its 16 x 16
// diagonal sub-blocks are inverted by substitution all at once, one warp
// each (lane j column j): a 16-step chain. Then log2(p / 16) levels of the
// 2 x 2 combine of ops/triangular.py, X21 = -(X22 L21) X11, each level's
// pairs at once: two register-tiled (4 x 2 a thread, 512 tiles at p = 128)
// FFMA products from shared memory with one barrier each, skipping the zero
// triangles of X22 and X11. FP32 FFMA only: no TF32, no tensor cores. One
// launch takes up to kMaxBatch blocks, given by value in the kernel's
// parameters, so a CUDA graph replays them; the computation of a block
// depends on nothing but its entries and n, so it comes out bit for bit the
// same alone or in a batch.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kSub = 16;  // diagonal sub-block side, one warp each
constexpr int kThreads = 512;
constexpr int kMaxBatch = 64;
constexpr int kMaxDevices = 64;
constexpr int kStageVec = 8;  // 16-byte loads a thread in flight: all of them at p = 128

// Built with -DFAER_TRTRI_PROFILE (`tools/torch_profile.py trtri` does, into a
// library of its own), the kernel adds the SM cycles of its phases as thread
// 0 of each CTA sees them into g_prof (0 stage, 1 diagonal sub-blocks, 2-4
// the combine levels w = 16, 32, 64, 5 out), read by
// faer_trtri_profile_read. The default build has no marks.
#ifdef FAER_TRTRI_PROFILE
__device__ long long g_prof[6];
#define PROF_START long long t_prof = clock64();
#define PROF_MARK(k)                                                     \
  if (threadIdx.x == 0) {                                                \
    const long long u = clock64();                                       \
    atomicAdd(reinterpret_cast<unsigned long long*>(&g_prof[k]),         \
              static_cast<unsigned long long>(u - t_prof));              \
    t_prof = u;                                                          \
  }
#else
#define PROF_START
#define PROF_MARK(k)
#endif

struct Blocks {
  int off[kMaxBatch];   // the block's first row and column in the matrix
  int size[kMaxBatch];  // its side n
};

// side of the padded block: 16 * 2^k >= n
__host__ __device__ inline int padded(int n) {
  int p = kSub;
  while (p < n) p *= 2;
  return p;
}

// L and X (p x (p + 4) each), then the products' scratch: one (w, w + 4)
// tile per pair at the last level, w = p / 2, the largest
inline size_t smem_bytes(int p) {
  const int w = p / 2;
  const size_t scratch = w >= kSub ? (size_t)w * (w + 4) : 0;
  return (2 * (size_t)p * (p + 4) + scratch) * sizeof(float);
}

// acc[i][j] += sum_k a[i].k * b[k].j, k ascending: a 4 x 2 tile of a product
__device__ inline void fma_tile(float (&acc)[4][2], const float4 (&a)[4],
                                const float2 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ai[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[i][0] = fmaf(ai[k], b[k].x, acc[i][0]);
      acc[i][1] = fmaf(ai[k], b[k].y, acc[i][1]);
    }
  }
}

// one f32 from global to shared memory, asynchronously; zero when !read,
// which then reads nothing (src is any valid address)
__device__ inline void cp_async4(float* dst, const float* src, bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(read ? 4 : 0)
               : "memory");
}

// Stages the block with 16-byte loads of 4 elements of a line: a row
// (kRows) or a column of a transposed view, lines line_stride apart, those
// above the diagonal or past n dropped, the diagonal past n (and all of it
// if unit) the identity's. The lanes of a warp walk along a row (coalesced)
// or across columns (conflict-free stores); each thread has all its loads in
// flight before it stores any.
template <int P, bool kRows>
__device__ inline void stage_vec(const float* __restrict__ src, long long line_stride,
                                 float* sl, float* sx, int n, int unit) {
  constexpr int ld = P + 4, q = P / 4;  // q float4 a line
  for (int base = 0; base < P * q; base += kThreads * kStageVec) {
    float4 v[kStageVec];
#pragma unroll
    for (int s = 0; s < kStageVec; ++s) {
      const int idx = base + s * kThreads + threadIdx.x;
      const int line = kRows ? idx / q : idx % P;
      const int u = (kRows ? idx % q : idx / P) * 4;
      const bool live = idx < P * q && line < n && u < n &&
                        (kRows ? u <= line : u + 3 >= line);
      v[s] = live ? __ldg(reinterpret_cast<const float4*>(src + line * line_stride + u))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int s = 0; s < kStageVec; ++s) {
      const int idx = base + s * kThreads + threadIdx.x;
      if (idx >= P * q) break;
      const int line = kRows ? idx / q : idx % P;
      const int u = (kRows ? idx % q : idx / P) * 4;
      float e[4] = {v[s].x, v[s].y, v[s].z, v[s].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = kRows ? line : u + k, c = kRows ? u + k : line;
        e[k] = (r == c && (r >= n || unit)) ? 1.0f : (r < n && c <= r ? e[k] : 0.0f);
      }
      if (kRows) {
        *reinterpret_cast<float4*>(sl + line * ld + u) = make_float4(e[0], e[1], e[2], e[3]);
        *reinterpret_cast<float4*>(sx + line * ld + u) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sl[(u + k) * ld + line] = e[k];
          sx[(u + k) * ld + line] = 0.0f;
        }
      }
    }
  }
}

// Any strides, any n: one cp.async a element, every copy in flight at once,
// the unit-stride index fastest.
template <int P>
__device__ inline void stage_any(const float* src, long long rs, long long cs,
                                 float* sl, float* sx, int n, int unit) {
  constexpr int ld = P + 4;
  const bool rows_fast = rs == 1 && cs != 1;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < P * P; idx += kThreads) {
    const int a = idx / P, b = idx % P;
    const int r = rows_fast ? b : a, c = rows_fast ? a : b;
    sx[r * ld + c] = 0.0f;
    if (r == c && (r >= n || unit)) {
      sl[r * ld + c] = 1.0f;
    } else {
      const bool read = r < n && c <= r;
      cp_async4(sl + r * ld + c, read ? src + r * rs + c * cs : src, read);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One level of the combine: the P / (2 W) pairs (X11, X22) of side W, each
// X21 = -(X22 L21) X11, a thread a 4 x 2 tile of a pair's W x W product.
template <int P, int W>
__device__ inline void combine_level(const float* sl, float* sx, float* sw) {
  constexpr int ld = P + 4, lw = W + 4;
  constexpr int side_r = W / 4, side_c = W / 2;  // tiles down and across
  constexpr int per_pair = side_r * side_c;
  constexpr int ntiles = (P / (2 * W)) * per_pair;
  static_assert(ntiles <= kThreads, "a tile a thread");
  const int tid = threadIdx.x;
  const int pr = tid / per_pair, q = tid % per_pair;
  const int o = pr * 2 * W;
  if (tid < ntiles) {
    // W = X22 L21: rows r0..r0+3 of X22 vanish past column r0 + 3; a warp
    // shares r0, so X22's float4 are broadcasts
    const int r0 = (q / side_c) * 4, c0 = (q % side_c) * 2;
    const float* a = sx + (o + W) * ld + (o + W);
    const float* b = sl + (o + W) * ld + o;
    float acc[4][2] = {};
#pragma unroll 2
    for (int k = 0; k <= r0; k += 4) {
      float4 av[4];
      float2 bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * ld + k);
        bv[i] = *reinterpret_cast<const float2*>(b + (k + i) * ld + c0);
      }
      fma_tile(acc, av, bv);
    }
    float* wo = sw + pr * W * lw;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(wo + (r0 + i) * lw + c0) = make_float2(acc[i][0], acc[i][1]);
  }
  __syncthreads();
  if (tid < ntiles) {
    // X21 = -W X11: columns c0, c0+1 of X11 vanish above row c0; a tile's
    // rows are side_r apart, so the 8 lanes of a quarter warp read 8 rows
    const int rt = q % side_r, c0 = (q / side_r) * 2;
    const float* a = sw + pr * W * lw;
    const float* b = sx + o * ld + o;
    float acc[4][2] = {};
#pragma unroll 2
    for (int k = c0 & ~3; k < W; k += 4) {
      float4 av[4];
      float2 bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + (rt + side_r * i) * lw + k);
        bv[i] = *reinterpret_cast<const float2*>(b + (k + i) * ld + c0);
      }
      fma_tile(acc, av, bv);
    }
    float* xo = sx + (o + W) * ld + o;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(xo + (rt + side_r * i) * ld + c0) =
          make_float2(-acc[i][0], -acc[i][1]);
  }
  __syncthreads();
}

// inv of one (n, n) block, n <= P, padded with the identity to P, into its
// (out_n, out_n) slot dst; src: the block's element (0, 0)
template <int P>
__device__ void invert_block(const float* __restrict__ src, long long rs, long long cs,
                             int n, int unit, float* smem, float* __restrict__ dst,
                             int out_n) {
  constexpr int ld = P + 4;  // 4 banks a row: 8 rows of float4 meet no conflict
  float* sl = smem;          // L, lower triangle, identity past n
  float* sx = sl + P * ld;   // X = inv(L), zero above the diagonal
  float* sw = sx + P * ld;   // the first product of a level
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  PROF_START

  // stage: element (r, c) of the block at src[r * rs + c * cs]. The
  // diagonal past n (and all of it if unit) is the identity's, stored, not
  // read; so is everything above the diagonal or past n.
  const bool aligned = (n & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0;
  if (aligned && cs == 1 && (rs & 3) == 0)
    stage_vec<P, true>(src, rs, sl, sx, n, unit);
  else if (aligned && rs == 1 && (cs & 3) == 0)
    stage_vec<P, false>(src, cs, sl, sx, n, unit);  // a transposed view
  else
    stage_any<P>(src, rs, cs, sl, sx, n, unit);
  __syncthreads();
  PROF_MARK(0)

  // the 16 x 16 diagonal sub-blocks: warp s inverts sub-block s by forward
  // substitution, lane j solving for column j (L's entries are broadcasts),
  // each row scaled by 1 / L_ii, formed once by lane i and shuffled
  if (warp < P / kSub) {
    const int o = warp * kSub, j = lane;
    const float* lb = sl + o * ld + o;
    const float inv_own = 1.0f / lb[(lane % kSub) * (ld + 1)];
    float dinv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) dinv[i] = __shfl_sync(0xffffffffu, inv_own, i);
    if (j < kSub) {
      float x[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        float s = (i == j) ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < i; ++k) s = fmaf(-lb[i * ld + k], x[k], s);
        x[i] = (i < j) ? 0.0f : s * dinv[i];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) sx[(o + i) * ld + o + j] = x[i];
    }
  }
  __syncthreads();
  PROF_MARK(1)

  if constexpr (P >= 32) {
    combine_level<P, 16>(sl, sx, sw);
    PROF_MARK(2)
  }
  if constexpr (P >= 64) {
    combine_level<P, 32>(sl, sx, sw);
    PROF_MARK(3)
  }
  if constexpr (P >= 128) {
    combine_level<P, 64>(sl, sx, sw);
    PROF_MARK(4)
  }

  // out: X's lower triangle, zero elsewhere; a warp writes a row, as float4
  // where the rows allow it
  if ((out_n & 3) == 0) {
    for (int i = warp; i < out_n; i += kThreads / 32)
      for (int j = 4 * lane; j < out_n; j += 4 * 32) {
        // X is zero past column i < n, so past n too
        const float4 v = (i < n && j <= i)
                             ? *reinterpret_cast<const float4*>(sx + i * ld + j)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *reinterpret_cast<float4*>(dst + i * out_n + j) = v;
      }
  } else {
    for (int i = warp; i < out_n; i += kThreads / 32)
      for (int j = lane; j < out_n; j += 32)
        dst[i * out_n + j] = (j <= i && i < n) ? sx[i * ld + j] : 0.0f;
  }
  PROF_MARK(5)
}

__global__ void __launch_bounds__(kThreads, 1)
trtri_kernel(const float* __restrict__ t, long long rs, long long cs,
             Blocks blocks, float* __restrict__ out, int out_n, int unit) {
  extern __shared__ __align__(16) float smem[];
  const int n = blocks.size[blockIdx.x];
  const long long off = blocks.off[blockIdx.x];
  const float* src = t + off * rs + off * cs;
  float* dst = out + (size_t)blockIdx.x * out_n * out_n;
  switch (padded(n)) {  // the same for every thread of the CTA
    case 16: invert_block<16>(src, rs, cs, n, unit, smem, dst, out_n); break;
    case 32: invert_block<32>(src, rs, cs, n, unit, smem, dst, out_n); break;
    case 64: invert_block<64>(src, rs, cs, n, unit, smem, dst, out_n); break;
    default: invert_block<128>(src, rs, cs, n, unit, smem, dst, out_n); break;
  }
}

}  // namespace

// t: f32 on the current device (the caller selects it), element (r, c) at
// t[r * rs + c * cs]; blocks: count (offset, size) pairs on the host, block i
// the diagonal block t[off:off+size, off:off+size] with 1 <= size <= out_n;
// out: count contiguous (out_n, out_n) slots, slot i inv(block i) in its
// leading size x size, zero past it. Only the lower triangle is read, and
// not the diagonal if unit. Returns the CUDA error of the launch (0 on
// success).
extern "C" int faer_trtri_batched(const float* t, long long rs, long long cs,
                                  const int* blocks, int count, float* out,
                                  int out_n, int unit, void* stream) {
  if (count < 1 || count > kMaxBatch || out_n < 1 || out_n > kMaxN)
    return cudaErrorInvalidValue;
  Blocks b = {};
  int pmax = kSub;
  for (int i = 0; i < count; ++i) {
    const int off = blocks[2 * i], size = blocks[2 * i + 1];
    if (off < 0 || size < 1 || size > out_n) return cudaErrorInvalidValue;
    b.off[i] = off;
    b.size[i] = size;
    if (padded(size) > pmax) pmax = padded(size);
  }
  // the dynamic shared-memory ceiling is raised to the largest block's need
  // once per device, not on every call
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(trtri_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxN));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  trtri_kernel<<<count, kThreads, smem_bytes(pmax), (cudaStream_t)stream>>>(
      t, rs, cs, b, out, out_n, unit);
  return cudaGetLastError();
}

#ifdef FAER_TRTRI_PROFILE
// Copies the 6 phase counters (SM cycles summed over CTAs and launches) to
// the host and zeroes them. Returns the CUDA error (0 on success).
extern "C" int faer_trtri_profile_read(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  const long long zero[6] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)err;
}
#endif
