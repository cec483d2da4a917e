// Shared helpers of the engine's CUDA kernels (built for sm_90a into one
// shared library with a plain C interface; see ops/_native.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define CHTT_SIGN (1ull << 63)

// Element types a kernel reads, as the Python wrappers number them.
enum ChttDtype {
  DT_BOOL = 0,
  DT_I8 = 1,
  DT_U8 = 2,
  DT_I16 = 3,
  DT_I32 = 4,
  DT_I64 = 5,
  DT_F32 = 6,
  DT_F64 = 7,
};

// IEEE double -> u64 whose unsigned order is the float total order
// (-0.0 below +0.0; NaN is handled by the callers).
__device__ __forceinline__ u64 f64_order_key(double d) {
  u64 b = (u64)__double_as_longlong(d);
  return (b >> 63) ? ~b : (b | CHTT_SIGN);
}

__device__ __forceinline__ double f64_order_unkey(u64 k) {
  u64 b = (k >> 63) ? (k & ~CHTT_SIGN) : ~k;
  return __longlong_as_double((long long)b);
}

// Exclusive prefix sum of one int a thread over a block of THREADS threads
// (a multiple of 32, at most 1024), in thread order; *total gets the
// block's sum.  warp_sums holds 32 ints of shared memory.  Every thread of
// the block must call it; it synchronises the block.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;               // inclusive sums of the warps
  }
  __syncthreads();
  const int out = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[THREADS / 32 - 1];
  __syncthreads();                     // warp_sums may be reused
  return out;
}

inline int chtt_last_error() { return (int)cudaGetLastError(); }
