// Pivot search shared by the LU panel kernels (lu_panel_batched.cu,
// lu_panel_swap.cu): an argmax of (value, index) pairs
// in which a tie goes to the lowest index, as jax.lax.argmax and
// torch.argmax break it. Every CTA that reduces the same candidates in the
// same order gets the same winner.
#pragma once

#include <climits>

namespace faer_pivot {

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide argmax over kThreads threads (a multiple of 32, at most 1024);
// the result is valid in thread 0. wv / wi: kThreads / 32 shared slots.
template <int kThreads>
__device__ void block_argmax(float& v, int& i, float* wv, int* wi) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  warp_argmax(v, i);
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? wv[lane] : -2.0f;
    i = lane < kWarps ? wi[lane] : INT_MAX;
    warp_argmax(v, i);
  }
  __syncthreads();
}

}  // namespace faer_pivot
