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

// Integer element widened to 64 bits: signed types sign-extend, unsigned
// types zero-extend.  Sums of the widened bits wrap mod 2^64, which is the
// reference's integer-sum semantics for signed and unsigned alike.
__device__ __forceinline__ u64 load_int_u64(const void* p, int dtype,
                                            long long i) {
  switch (dtype) {
    case DT_BOOL:
    case DT_U8: return (u64)((const uint8_t*)p)[i];
    case DT_I8: return (u64)(long long)((const int8_t*)p)[i];
    case DT_I16: return (u64)(long long)((const int16_t*)p)[i];
    case DT_I32: return (u64)(long long)((const int32_t*)p)[i];
    default: return (u64)((const long long*)p)[i];
  }
}

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
