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

inline int chtt_last_error() { return (int)cudaGetLastError(); }
