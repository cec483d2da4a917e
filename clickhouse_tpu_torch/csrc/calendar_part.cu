// K12: one civil-calendar op over a Date or DateTime column, one answer a
// row.
//
// Replaces the calendar math of the reference's scalar functions:
// _civil_from_days (clickhouse_tpu/exprs/functions.py:1043),
// _days_from_civil (:1059) and _days_in_month (:230), Howard Hinnant's
// integer algorithms, with the floor divisions of the time around them
// (toHour, toStartOfMinute, ...).  Under the reference's whole-query jit
// XLA fuses their ≈25 int64 operations into one pass; eager torch would
// make each one a pass over the column.  Here each row is read once, the
// op runs in registers and the result is written once.
//
//   out[i] = wrap(op(x[i]))   x: seconds (seconds = 1) or days, stored as
//                             int8/int16/int32/int64; wrap: the int64
//                             result masked to mask_bits (an unsigned
//                             result type), then cast to the output type
//
// Bound on the card: bytes (each value read once, each result written
// once).  In this first version the ops of the civil calendar (year,
// month, YYYYMMDD, the month step, ...) are bound instead by their ≈8
// int64 floor divisions a row, which the card emulates; the time-of-day
// ops take two (PERF.md).
// Design (a first version, right before fast):
//   * grid-stride over groups of 8 rows: where the column starts on a
//     16-byte boundary, a group's 8 values come in 8-32 bytes of vector
//     loads and its 8 results leave in 8-64 bytes of vector stores; the
//     last n % 8 rows, and a column that does not align, go a row at a
//     time;
//   * the op is a switch on a value uniform over the launch, so every
//     thread takes the same branch;
//   * division and modulo floor (floor_div, floor_mod), as
//     jnp.floor_divide: C's truncate toward zero, which is wrong for days
//     before 1970;
//     integers only, no float anywhere;
//   * one template instance for each (input, output) storage pair.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum CalOp {
  OP_YEAR = 0,
  OP_QUARTER = 1,
  OP_MONTH = 2,
  OP_DAY_OF_MONTH = 3,
  OP_DAY_OF_YEAR = 4,
  OP_DAY_OF_WEEK = 5,
  OP_ISO_YEAR = 6,
  OP_ISO_WEEK = 7,
  OP_HOUR = 8,
  OP_MINUTE = 9,
  OP_SECOND = 10,
  OP_YYYYMM = 11,
  OP_YYYYMMDD = 12,
  OP_YYYYMMDDHHMMSS = 13,
  OP_REL_QUARTER = 14,
  OP_REL_MONTH = 15,
  OP_REL_WEEK = 16,
  OP_FLOOR_SECONDS = 17,
  OP_DAY_NUMBER = 18,
  OP_START_OF_MONTHS = 19,
  OP_START_OF_DAYS = 20,
  OP_LAST_DAY_OF_WEEK = 21,
  OP_START_OF_SECONDS = 22,
  OP_LAST_DAY_OF_MONTH = 23,
  OP_ADD_MONTHS = 24,
  OP_COUNT = 25,
};

struct ChttCalArgs {
  const void* x;
  void* out;
  long long n, c0, c1;
  int in_dtype, out_dtype, op, seconds, mask_bits, vec;
};

typedef long long i64;

// floor(a / b) and a - b * floor(a / b) for b > 0
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return q - ((a % b) < 0 ? 1 : 0);
}

__device__ __forceinline__ i64 floor_mod(i64 a, i64 b) {
  const i64 r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ void civil_from_days(i64 z, i64& y, i64& m,
                                                i64& d) {
  z += 719468;
  const i64 era = floor_div(z, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = floor_div(doe - floor_div(doe, 1460) +
                                floor_div(doe, 36524) - floor_div(doe, 146096),
                            365);
  const i64 doy =
      doe - (365 * yoe + floor_div(yoe, 4) - floor_div(yoe, 100));
  const i64 mp = floor_div(5 * doy + 2, 153);
  d = doy - floor_div(153 * mp + 2, 5) + 1;
  m = mp < 10 ? mp + 3 : mp - 9;
  y = yoe + era * 400 + (m <= 2 ? 1 : 0);
}

__device__ __forceinline__ i64 days_from_civil(i64 y, i64 m, i64 d) {
  y -= m <= 2 ? 1 : 0;
  const i64 era = floor_div(y, 400);
  const i64 yoe = y - era * 400;
  const i64 mp = m > 2 ? m - 3 : m + 9;
  const i64 doy = floor_div(153 * mp + 2, 5) + d - 1;
  const i64 doe = yoe * 365 + floor_div(yoe, 4) - floor_div(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ i64 days_in_month(i64 y, i64 m) {
  const bool leap = (floor_mod(y, 4) == 0 && floor_mod(y, 100) != 0) ||
                    floor_mod(y, 400) == 0;
  const i64 mc = m < 1 ? 1 : (m > 12 ? 12 : m);
  if (mc == 2) return leap ? 29 : 28;
  return (mc == 4 || mc == 6 || mc == 9 || mc == 11) ? 30 : 31;
}

__device__ __forceinline__ i64 cal_op(i64 v, int op, bool seconds, i64 c0,
                                      i64 c1) {
  const i64 secs = seconds ? v : v * 86400;
  const i64 days = seconds ? floor_div(v, 86400) : v;
  switch (op) {
    case OP_HOUR: return floor_mod(floor_div(secs, 3600), 24);
    case OP_MINUTE: return floor_mod(floor_div(secs, 60), 60);
    case OP_SECOND: return floor_mod(secs, 60);
    case OP_FLOOR_SECONDS: return floor_div(secs, c0);
    case OP_DAY_NUMBER: return days + c0;
    case OP_DAY_OF_WEEK: return floor_mod(days + 3, 7) + 1;
    case OP_REL_WEEK: return floor_div(days + 4, 7);
    case OP_START_OF_DAYS: return days - floor_mod(days + c1, c0);
    case OP_LAST_DAY_OF_WEEK: return days - floor_mod(days + c0, 7) + 6;
    case OP_START_OF_SECONDS: return secs - floor_mod(secs + c1, c0);
    case OP_ISO_YEAR:
    case OP_ISO_WEEK: {
      const i64 thursday = days - floor_mod(days + 3, 7) + 3;
      i64 y, m, d;
      civil_from_days(thursday, y, m, d);
      if (op == OP_ISO_YEAR) return y;
      return floor_div(thursday - days_from_civil(y, 1, 1), 7) + 1;
    }
    default: break;
  }
  i64 y, m, d;
  civil_from_days(days, y, m, d);
  switch (op) {
    case OP_YEAR: return y;
    case OP_QUARTER: return floor_div(m + 2, 3);
    case OP_MONTH: return m;
    case OP_DAY_OF_MONTH: return d;
    case OP_DAY_OF_YEAR: return days - days_from_civil(y, 1, 1) + 1;
    case OP_YYYYMM: return y * 100 + m;
    case OP_YYYYMMDD: return y * 10000 + m * 100 + d;
    case OP_YYYYMMDDHHMMSS: {
      const i64 rem = secs - days * 86400;
      const i64 hms = floor_div(rem, 3600) * 10000 +
                      floor_mod(floor_div(rem, 60), 60) * 100 +
                      floor_mod(rem, 60);
      // the int64 bits of the reference's uint64 arithmetic
      return (i64)((u64)(y * 10000 + m * 100 + d) * 1000000ull + (u64)hms);
    }
    case OP_REL_QUARTER: return y * 4 + floor_div(m - 1, 3);
    case OP_REL_MONTH: return y * 12 + m;
    case OP_START_OF_MONTHS: {
      const i64 months = floor_div(y * 12 + (m - 1), c0) * c0;
      const i64 ny = floor_div(months, 12);
      return days_from_civil(ny, months - ny * 12 + 1, 1);
    }
    case OP_LAST_DAY_OF_MONTH:
      return days_from_civil(m == 12 ? y + 1 : y, m == 12 ? 1 : m + 1, 1) -
             1;
    case OP_ADD_MONTHS: {
      const i64 tot = y * 12 + (m - 1) + c0;
      const i64 ny = floor_div(tot, 12);
      const i64 nm = tot - ny * 12 + 1;
      const i64 ml = days_in_month(ny, nm);
      const i64 out = days_from_civil(ny, nm, d < ml ? d : ml);
      return seconds ? out * 86400 + (secs - days * 86400) : out;
    }
    default: return 0;
  }
}

template <typename Out>
__device__ __forceinline__ Out wrap(i64 r, int mask_bits) {
  if (mask_bits) r &= (1ll << mask_bits) - 1;
  return (Out)r;
}

// 8 values of type E as whole 8- or 16-byte words
template <typename E>
struct Group8 {
  static constexpr int kBytes = 8 * (int)sizeof(E);
  typedef typename std::conditional<(kBytes >= 16), uint4, uint2>::type W;
  static constexpr int kWords = kBytes / (int)sizeof(W);
  union {
    E e[8];
    W w[kWords];
  };
};

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    k_calendar_part(const In* __restrict__ x, Out* __restrict__ out,
                    long long n, int op, int seconds, long long c0,
                    long long c1, int mask_bits, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool s = seconds != 0;
  long long done = 0;
  if (vec) {
    typedef Group8<In> GI;
    typedef Group8<Out> GO;
    const long long groups = n / 8;
    for (long long g = tid; g < groups; g += stride) {
      GI a;
      const typename GI::W* src =
          reinterpret_cast<const typename GI::W*>(x + g * 8);
#pragma unroll
      for (int k = 0; k < GI::kWords; ++k) a.w[k] = __ldg(src + k);
      GO b;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b.e[j] = wrap<Out>(cal_op((i64)a.e[j], op, s, c0, c1), mask_bits);
      typename GO::W* dst = reinterpret_cast<typename GO::W*>(out + g * 8);
#pragma unroll
      for (int k = 0; k < GO::kWords; ++k) dst[k] = b.w[k];
    }
    done = groups * 8;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = wrap<Out>(cal_op((i64)__ldg(x + i), op, s, c0, c1), mask_bits);
}

template <typename In, typename Out>
void launch(const ChttCalArgs& A, int blocks, cudaStream_t st) {
  k_calendar_part<In, Out><<<blocks, kThreads, 0, st>>>(
      static_cast<const In*>(A.x), static_cast<Out*>(A.out), A.n, A.op,
      A.seconds, A.c0, A.c1, A.mask_bits, A.vec);
}

template <typename In>
int launch_out(const ChttCalArgs& A, int blocks, cudaStream_t st) {
  switch (A.out_dtype) {
    case DT_U8: launch<In, unsigned char>(A, blocks, st); break;
    case DT_I32: launch<In, int>(A, blocks, st); break;
    case DT_I64: launch<In, long long>(A, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// One launch of op A->op over A->n values of A->x (int8/16/32/64) into
// A->out (uint8, int32 or int64); vec: both pointers start on a 16-byte
// boundary.
extern "C" int chtt_calendar_part(const void* args, int blocks,
                                  void* stream) {
  const ChttCalArgs& A = *static_cast<const ChttCalArgs*>(args);
  if (A.n < 0 || blocks < 1 || A.op < 0 || A.op >= OP_COUNT ||
      A.mask_bits < 0 || A.mask_bits > 32 ||
      ((A.op == OP_FLOOR_SECONDS || A.op == OP_START_OF_DAYS ||
        A.op == OP_START_OF_SECONDS) && A.c0 <= 0))
    return (int)cudaErrorInvalidValue;
  if (A.n == 0) return 0;
  if (A.vec && (((uintptr_t)A.x | (uintptr_t)A.out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (A.in_dtype) {
    case DT_I8: rc = launch_out<signed char>(A, blocks, st); break;
    case DT_I16: rc = launch_out<short>(A, blocks, st); break;
    case DT_I32: rc = launch_out<int>(A, blocks, st); break;
    case DT_I64: rc = launch_out<long long>(A, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return chtt_last_error();
}
