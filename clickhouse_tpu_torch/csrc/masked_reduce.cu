// K1: masked whole-column reduction (GROUP BY () aggregates and counts).
//
// Replaces the reference's Grouping._reduce_trivial
// (clickhouse_tpu/ops/agg_ops.py:131) and filter_ops.count_mask
// (clickhouse_tpu/ops/filter_ops.py:21), and computes the function of every
// Pallas kernel of the round-2 experiments in scratch/ (q1_*.py,
// r2_profile*.py): a count or sum of the selected rows of one column.
//
// Bound on the card: bytes read.  One pass reads the column (1-8 bytes a
// row) and the optional bool mask (1 byte a row) once; nothing is written
// but a few words.  At 100M rows that is 100-900 MB, tens to hundreds of
// microseconds at the H100's 3.35 TB/s.  The design keeps every byte read
// once: a grid-stride loop over the rows, a warp-shuffle and block
// reduction in registers and shared memory, and ONE 64-bit atomic per
// block.  Integer sums accumulate in unsigned 64 bits (wrap mod 2^64, as the
// reference widens ints to 64 bits); min/max run on an order-preserving
// unsigned key (floats by the IEEE total-order map, so -0.0 < +0.0 and the
// result does not depend on the order blocks finish in), with NaN tracked
// by a flag because the reference's min/max propagate NaN; `any` takes the
// atomic minimum of the selected row index, which is the FIRST selected
// row, as the reference's argmax(mask).  Float sums never use float
// atomics: each block writes its partial (in f64) and a second one-block
// pass adds the partials in a fixed order, so the result is the same from
// run to run.
#include <type_traits>

#include "common.cuh"

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_ANY = 3, OP_BOR = 4,
       OP_BAND = 5, OP_BXOR = 6 };

constexpr int kThreads = 256;

template <int OP>
__device__ __forceinline__ u64 ident(long long n) {
  if (OP == OP_MIN || OP == OP_BAND) return ~0ull;
  if (OP == OP_ANY) return (u64)n;
  return 0ull;
}

template <int OP>
__device__ __forceinline__ u64 combine(u64 a, u64 b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_MIN || OP == OP_ANY) return a < b ? a : b;
  if (OP == OP_MAX) return a > b ? a : b;
  if (OP == OP_BOR) return a | b;
  if (OP == OP_BAND) return a & b;
  return a ^ b;
}

template <int OP>
__device__ __forceinline__ void atomic_combine(u64* p, u64 v) {
  if (OP == OP_SUM) atomicAdd(p, v);
  else if (OP == OP_MIN || OP == OP_ANY) atomicMin(p, v);
  else if (OP == OP_MAX) atomicMax(p, v);
  else if (OP == OP_BOR) atomicOr(p, v);
  else if (OP == OP_BAND) atomicAnd(p, v);
  else atomicXor(p, v);
}

// integer bits widened to 64: sign-extend signed types, zero-extend others
template <typename T>
__device__ __forceinline__ u64 int_bits(T v) {
  if constexpr (std::is_floating_point<T>::value) return 0ull;
  else if constexpr (std::is_signed<T>::value) return (u64)(long long)v;
  else return (u64)v;
}

// unsigned key whose order is the value order (uns: int64 holds u64 bits)
template <typename T>
__device__ __forceinline__ u64 order_key(T v, int uns) {
  if constexpr (std::is_floating_point<T>::value)
    return f64_order_key((double)v);
  else if constexpr (std::is_signed<T>::value)
    return uns ? (u64)(long long)v : ((u64)(long long)v ^ CHTT_SIGN);
  else return (u64)v;
}

template <int OP>
__device__ __forceinline__ u64 warp_combine(u64 a) {
  for (int off = 16; off > 0; off >>= 1)
    a = combine<OP>(a, __shfl_down_sync(0xffffffffu, a, off));
  return a;
}

// acc[0]: accumulator; acc[1]: some row selected; acc[2]: a NaN selected
template <int OP>
__global__ void k_init(u64* acc, long long n) {
  acc[0] = ident<OP>(n);
  acc[1] = 0ull;
  acc[2] = 0ull;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
k_masked_reduce(const T* __restrict__ data, const uint8_t* __restrict__ mask,
                long long n, int uns, u64* __restrict__ acc) {
  u64 a = ident<OP>(n);
  int sel = 0, nan = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask != nullptr && mask[i] == 0) continue;
    sel = 1;
    if (OP == OP_ANY) {            // later rows of this thread come after i
      a = (u64)i;
      break;
    }
    T v = data[i];
    if (OP == OP_MIN || OP == OP_MAX) {
      if constexpr (std::is_floating_point<T>::value) {
        if (v != v) {
          nan = 1;
          continue;
        }
      }
      a = combine<OP>(a, order_key<T>(v, uns));
    } else {
      a = combine<OP>(a, int_bits<T>(v));
    }
  }
  a = warp_combine<OP>(a);
  sel = __any_sync(0xffffffffu, sel);
  nan = __any_sync(0xffffffffu, nan);

  __shared__ u64 ws[32];
  __shared__ int wsel[32], wnan[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    ws[w] = a;
    wsel[w] = sel;
    wnan[w] = nan;
  }
  __syncthreads();
  if (w == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    a = lane < nw ? ws[lane] : ident<OP>(n);
    sel = lane < nw ? wsel[lane] : 0;
    nan = lane < nw ? wnan[lane] : 0;
    a = warp_combine<OP>(a);
    sel = __any_sync(0xffffffffu, sel);
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0 && sel) {
      atomic_combine<OP>(&acc[0], a);
      atomicOr(&acc[1], 1ull);
      if (nan) atomicOr(&acc[2], 1ull);
    }
  }
}

// one thread: the reduced key back to a value (0 when no row is selected)
template <typename T, int OP>
__global__ void k_finish(const T* __restrict__ data, int uns,
                         const u64* __restrict__ acc, void* out) {
  if (OP == OP_SUM) {
    *(long long*)out = (long long)acc[0];
    return;
  }
  T r = (T)0;
  if (acc[1] != 0ull) {
    if (OP == OP_ANY) {
      r = data[acc[0]];
    } else if (OP == OP_MIN || OP == OP_MAX) {
      if constexpr (std::is_floating_point<T>::value) {
        r = acc[2] ? (T)__longlong_as_double(0x7ff8000000000000LL)
                   : (T)f64_order_unkey(acc[0]);
      } else if constexpr (std::is_signed<T>::value) {
        r = (T)(long long)(uns ? acc[0] : (acc[0] ^ CHTT_SIGN));
      } else {
        r = (T)acc[0];
      }
    } else {
      r = (T)acc[0];
    }
  }
  *(T*)out = r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k_fsum_partial(const T* __restrict__ data, const uint8_t* __restrict__ mask,
               long long n, double* __restrict__ partials) {
  double a = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (mask == nullptr || mask[i] != 0) a += (double)data[i];
  }
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  __shared__ double ws[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) ws[w] = a;
  __syncthreads();
  if (w == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    a = lane < nw ? ws[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) partials[blockIdx.x] = a;
  }
}

// one block adds the per-block partials in a fixed order
__global__ void __launch_bounds__(kThreads)
k_fsum_finish(const double* __restrict__ partials, int nb, double* out) {
  double a = 0.0;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) a += partials[j];
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  __shared__ double ws[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) ws[w] = a;
  __syncthreads();
  if (w == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    a = lane < nw ? ws[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) *out = a;
  }
}

template <typename T, int OP>
static void run_int(const T* data, const uint8_t* mask, long long n, int uns,
                    void* out, u64* acc, int nb, cudaStream_t st) {
  k_init<OP><<<1, 1, 0, st>>>(acc, n);
  if (n > 0) k_masked_reduce<T, OP><<<nb, kThreads, 0, st>>>(data, mask, n,
                                                             uns, acc);
  k_finish<T, OP><<<1, 1, 0, st>>>(data, uns, acc, out);
}

template <typename T>
static int dispatch_op(int op, const void* data_, const uint8_t* mask,
                       long long n, int uns, void* out, u64* acc,
                       double* partials, int nb, cudaStream_t st) {
  const T* data = (const T*)data_;
  constexpr bool is_float = std::is_floating_point<T>::value;
  switch (op) {
    case OP_SUM:
      if constexpr (is_float) {
        k_fsum_partial<T><<<nb, kThreads, 0, st>>>(data, mask, n, partials);
        k_fsum_finish<<<1, kThreads, 0, st>>>(partials, nb, (double*)out);
      } else {
        run_int<T, OP_SUM>(data, mask, n, uns, out, acc, nb, st);
      }
      break;
    case OP_MIN: run_int<T, OP_MIN>(data, mask, n, uns, out, acc, nb, st); break;
    case OP_MAX: run_int<T, OP_MAX>(data, mask, n, uns, out, acc, nb, st); break;
    case OP_ANY: run_int<T, OP_ANY>(data, mask, n, uns, out, acc, nb, st); break;
    case OP_BOR:
    case OP_BAND:
    case OP_BXOR:
      if constexpr (is_float) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (op == OP_BOR) run_int<T, OP_BOR>(data, mask, n, uns, out, acc, nb, st);
        else if (op == OP_BAND) run_int<T, OP_BAND>(data, mask, n, uns, out, acc, nb, st);
        else run_int<T, OP_BXOR>(data, mask, n, uns, out, acc, nb, st);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return chtt_last_error();
}

// data: n elements of `dtype`; mask: n bytes (0 = skip) or NULL;
// out: one int64 (integer sum), one double (float sum) or one element of
// the data's type; acc: 3 u64 of scratch; partials: nb doubles of scratch.
extern "C" int chtt_masked_reduce(const void* data, int dtype,
                                  const void* mask, long long n, int op,
                                  int uns, void* out, void* acc,
                                  void* partials, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  u64* a = (u64*)acc;
  double* p = (double*)partials;
  switch (dtype) {
    case DT_BOOL:
    case DT_U8: return dispatch_op<uint8_t>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_I8: return dispatch_op<int8_t>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_I16: return dispatch_op<int16_t>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_I32: return dispatch_op<int32_t>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_I64: return dispatch_op<long long>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_F32: return dispatch_op<float>(op, data, m, n, uns, out, a, p, nb, st);
    case DT_F64: return dispatch_op<double>(op, data, m, n, uns, out, a, p, nb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
