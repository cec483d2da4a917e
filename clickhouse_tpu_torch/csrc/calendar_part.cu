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
//                             int8/int16/int32/int64; wrap: the op's
//                             int64 value masked to mask_bits (an
//                             unsigned result type), then cast to the
//                             output type
//
// Bound on the card: bytes (each value read once, each result written
// once).  Hopper has no 64-bit integer divide and no 64-bit multiply-high:
// each int64 division costs a chain of 32-bit multiplies, and one by a
// divisor known only at run time a subroutine call.  So (PERF.md §6):
//   * the op is a template parameter: each (op, output type) pair the
//     functions use (K12_INSTANCES, calendar_ops.INSTANCES) is a kernel
//     of its own, with no switch over the ops in the row loop;
//   * int8/int16/int32 storage runs in 32-bit arithmetic: a day count in
//     int32, the time of day in [0, 86400), every division an unsigned
//     32-bit one by a constant (one multiply-high and a shift); only a
//     result that needs more bits (an int64 output, a Date's seconds) is
//     composed in 64 bits, by adds and multiplies;
//   * int64 storage follows the plain version's int64 formulas as they
//     stand (they wrap where torch's do), with constant divisors;
//   * a divisor c0 known only at run time (floor_seconds, start_of_days,
//     start_of_seconds, start_of_months) comes with its multiplier,
//     computed on the host once a launch (calendar_ops.magic: Granlund and
//     Montgomery's round-up method, the N + 1-bit multiplier's case
//     included): one multiply-high, an add and two shifts;
//   * every division floors (as jnp.floor_divide): a signed value a is
//     divided as b = a ^ (a >> 31), which is a for a >= 0 and -a - 1
//     otherwise, and floor(a / d) = (b / d) ^ (a >> 31);
//   * a warp's every load and store covers consecutive bytes: a lane
//     takes a pack of V consecutive rows, V = 16 bytes over the wider of
//     the input and output types, as one load and one store of up to 16
//     bytes, so each 32-byte sector is read or written whole by one
//     instruction.  (Groups of 8 rows a thread store an int64 result as
//     four 16-byte words at a 64-byte pitch, half a sector an
//     instruction: such int64 outputs ran at ≈1.2 TB/s.)  A thread issues
//     the loads of 8 rows (or one pack) before it computes;
//   * grid-stride over steps of those packs; the last n % V rows, and a
//     column that does not start on a 16-byte boundary (a view), go a row
//     at a time in the same pattern.
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

// The (op, output storage) pairs the engine's functions use: one kernel
// for each and each input storage.  calendar_ops.INSTANCES lists the same.
#define K12_INSTANCES(X)                                                    \
  X(OP_YEAR, DT_I32) X(OP_QUARTER, DT_U8) X(OP_MONTH, DT_U8)                \
  X(OP_DAY_OF_MONTH, DT_U8) X(OP_DAY_OF_YEAR, DT_I32)                       \
  X(OP_DAY_OF_WEEK, DT_U8) X(OP_ISO_YEAR, DT_I32) X(OP_ISO_WEEK, DT_U8)    \
  X(OP_HOUR, DT_U8) X(OP_MINUTE, DT_U8) X(OP_SECOND, DT_U8)                \
  X(OP_YYYYMM, DT_I64) X(OP_YYYYMMDD, DT_I64)                               \
  X(OP_YYYYMMDDHHMMSS, DT_I64) X(OP_REL_QUARTER, DT_I64)                    \
  X(OP_REL_MONTH, DT_I64) X(OP_REL_WEEK, DT_I64)                            \
  X(OP_FLOOR_SECONDS, DT_I64) X(OP_DAY_NUMBER, DT_I32)                      \
  X(OP_DAY_NUMBER, DT_I64) X(OP_START_OF_MONTHS, DT_I32)                    \
  X(OP_START_OF_DAYS, DT_I32) X(OP_LAST_DAY_OF_WEEK, DT_I32)                \
  X(OP_START_OF_SECONDS, DT_I64) X(OP_LAST_DAY_OF_MONTH, DT_I32)            \
  X(OP_ADD_MONTHS, DT_I32) X(OP_ADD_MONTHS, DT_I64)

struct ChttCalArgs {
  const void* x;
  void* out;
  long long n, c0, c1;
  long long f0, f1;           // the 32-bit path's constants (see Consts)
  u64 div64, mul64;           // c0 and its multiplier, 64-bit numerators
  unsigned int div32, mul32;  // min(c0, 2^31) and its multiplier, 32-bit
  int log32, log64;           // ceil(log2(divisor)) of each
  int in_dtype, out_dtype, op, seconds, mask_bits, vec;
};

typedef long long i64;
typedef unsigned int u32;

// A divisor d with Granlund and Montgomery's multiplier m and l =
// ceil(log2 d): for every N-bit n, with t = (m * n) >> N,
// n / d = (t + ((n - t) >> s1)) >> s2, s1 = min(l, 1), s2 = max(l - 1, 0).
template <typename U>
struct Div {
  U d, m;
  int s1, s2;
  __device__ Div(U d_, U m_, int l)
      : d(d_), m(m_), s1(l > 0 ? 1 : 0), s2(l > 0 ? l - 1 : 0) {}
};

__device__ __forceinline__ u32 mulhi(u32 a, u32 b) { return __umulhi(a, b); }
__device__ __forceinline__ u64 mulhi(u64 a, u64 b) {
  return __umul64hi(a, b);
}

template <typename U>
__device__ __forceinline__ U udiv(U n, const Div<U>& v) {
  const U t = mulhi(v.m, n);
  return (t + ((n - t) >> v.s1)) >> v.s2;
}

// floor(a / d) and a - d * floor(a / d) of a signed a by a run-time d
template <typename S, typename U>
__device__ __forceinline__ S fdivmod(S a, const Div<U>& v, U& r) {
  const S s = a >> (8 * sizeof(S) - 1);
  const U b = (U)(a ^ s);
  const U q = udiv(b, v);
  const U rb = b - q * v.d;
  r = s ? v.d - 1 - rb : rb;
  return (S)(q ^ (U)s);
}

// the same by a constant C (the compiler's multiply-high and shift)
template <u64 C, typename S>
__device__ __forceinline__ S fdivmod_c(
    S a, typename std::make_unsigned<S>::type& r) {
  typedef typename std::make_unsigned<S>::type U;
  const S s = a >> (8 * sizeof(S) - 1);
  const U b = (U)(a ^ s);
  const U q = b / (U)C;
  const U rb = b - q * (U)C;
  r = s ? (U)C - 1 - rb : rb;
  return (S)(q ^ (U)s);
}

// -- the civil calendar within one 400-year era (Hinnant) -------------------

struct Civil {
  int y;      // the year
  u32 m, d;   // month 1-12, day 1-31
  u32 yday;   // day of the year, 1-366
};

// yoe, m, d and the day of the year of the doe-th day (0 <= doe < 146097)
// of an era that starts on a 1st of March; yoe counts years from March
__device__ __forceinline__ void era_civil(u32 doe, u32& yoe, u32& m, u32& d,
                                          u32& yday) {
  yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const u32 doy = doe - (365 * yoe + yoe / 4 - yoe / 100);  // from March 1
  const u32 mp = (5 * doy + 2) / 153;
  d = doy - (153 * mp + 2) / 5 + 1;
  m = mp < 10 ? mp + 3 : mp - 9;
  // January and February close the March-based year; from March on the
  // civil year is yoe, leap as yoe is (an era is 400 years)
  const u32 leap = (yoe % 4 == 0 && yoe % 100 != 0) || yoe == 0;
  yday = doy >= 306 ? doy - 305 : doy + 60 + leap;
}

// days from the era's 1st of March to (yoe, m, d)
__device__ __forceinline__ u32 era_day(u32 yoe, u32 m, u32 d) {
  const u32 mp = m > 2 ? m - 3 : m + 9;
  return yoe * 365 + yoe / 4 - yoe / 100 + (153 * mp + 2) / 5 + d - 1;
}

// -- the 32-bit path: int8/int16/int32 storage -------------------------------
//
// z + 719468 (days from 0000-03-01) for the int32 day z, with u = z + 2^31
// as u32: z + 719468 = (u / 146097 - kEraBias) * 146097 + u % 146097 +
// kDoeBias, where kEraBias * 146097 - kDoeBias = 2^31 - 719468.
constexpr u32 kEraDays = 146097;
constexpr u32 kEraBias = 14695;
constexpr u32 kDoeBias = 131235;
static_assert((u64)kEraBias * kEraDays - kDoeBias == (1ull << 31) - 719468,
              "the era shift");

// (y, m, d, yday) of the day z + off, z any int32, -3 <= off <= 3
__device__ __forceinline__ Civil civil32(int z, int off) {
  const u32 u = (u32)z ^ 0x80000000u;
  u32 q = u / kEraDays;
  u32 doe = u - q * kEraDays + kDoeBias + off;
  if (doe >= kEraDays) {
    doe -= kEraDays;
    q += 1;
  }
  const int era = (int)q - (int)kEraBias;
  Civil c;
  u32 yoe;
  era_civil(doe, yoe, c.m, c.d, c.yday);
  c.y = (int)yoe + era * 400 + (c.m <= 2 ? 1 : 0);
  return c;
}

// the day number of (y, m, d), composed in R (u32: modulo 2^32; u64: the
// int64 value's bits)
template <typename R>
__device__ __forceinline__ R days_from_civil32(int y, u32 m, u32 d) {
  u32 r;
  const int era = fdivmod_c<400>(y - (m <= 2 ? 1 : 0), r);
  return (R)era * (R)kEraDays + (R)era_day(r, m, d) - (R)719468;
}

__device__ __forceinline__ u32 days_in_month32(int y, u32 m) {
  // a year divisible by 100 is leap when it is divisible by 400, that is
  // by 16
  const bool leap = (y % 100 == 0) ? (y & 15) == 0 : (y & 3) == 0;
  if (m == 2) return leap ? 29 : 28;
  return 30 + ((m ^ (m >> 3)) & 1);
}

// The launch's constants: the 32-bit path reads the folded f0, f1
// (calendar_ops.fold), the 64-bit path c0, c1 as the plain version does.
struct Consts {
  i64 c0, c1, f0, f1;
  Div<u32> d32;
  Div<u64> d64;
  int seconds;
  u64 mask;
};

template <int OP, typename R>
__device__ __forceinline__ R op32(int v, const Consts& k) {
  // the day and the time of day: a Date is its midnight
  int z = v;
  u32 tod = 0;
  if (k.seconds) z = fdivmod_c<86400>(v, tod);
  if constexpr (OP == OP_HOUR) return (R)(tod / 3600);
  if constexpr (OP == OP_MINUTE) return (R)(tod / 60 % 60);
  if constexpr (OP == OP_SECOND) return (R)(tod % 60);
  if constexpr (OP == OP_DAY_NUMBER) return (R)z + (R)k.c0;
  if constexpr (OP == OP_DAY_OF_WEEK) {
    u32 r;
    fdivmod_c<7>(z, r);
    return (R)((r + 3) % 7 + 1);
  }
  if constexpr (OP == OP_REL_WEEK) {
    u32 r;
    const int q = fdivmod_c<7>(z, r);
    return (R)q + (R)(r >= 3 ? 1 : 0);           // floor((z + 4) / 7)
  }
  if constexpr (OP == OP_LAST_DAY_OF_WEEK) {
    u32 r;
    fdivmod_c<7>(z, r);
    return (R)z - (R)((r + (u32)k.f0) % 7) + (R)6;
  }
  if constexpr (OP == OP_FLOOR_SECONDS || OP == OP_START_OF_SECONDS ||
                OP == OP_START_OF_DAYS) {
    // floor(x / c0) or mod(x + c1, c0), with c1 folded into [0, c0)
    const u32 f1 = (u32)k.f1;
    if (OP == OP_START_OF_DAYS || k.seconds) {
      const int x = OP == OP_START_OF_DAYS ? z : v;
      u32 r;
      const int q = fdivmod(x, k.d32, r);
      if constexpr (OP == OP_FLOOR_SECONDS) return (R)q;
      const u32 m = r >= k.d32.d - f1 ? r - (k.d32.d - f1) : r + f1;
      return (R)x - (R)m;
    } else {
      // a Date's seconds need 64 bits
      const i64 x = (i64)z * 86400;
      u64 r;
      const i64 q = fdivmod(x, k.d64, r);
      if constexpr (OP == OP_FLOOR_SECONDS) return (R)q;
      const u64 m = r >= k.d64.d - f1 ? r - (k.d64.d - f1) : r + f1;
      return (R)(x - (i64)m);
    }
  }
  if constexpr (OP == OP_ISO_YEAR || OP == OP_ISO_WEEK) {
    u32 r;
    fdivmod_c<7>(z, r);
    // the week's Thursday: z + 3 - mod(z + 3, 7)
    const Civil c = civil32(z, 3 - (int)((r + 3) % 7));
    if constexpr (OP == OP_ISO_YEAR) return (R)c.y;
    return (R)((c.yday - 1) / 7 + 1);
  }
  const Civil c = civil32(z, 0);
  if constexpr (OP == OP_YEAR) return (R)c.y;
  if constexpr (OP == OP_QUARTER) return (R)((c.m + 2) / 3);
  if constexpr (OP == OP_MONTH) return (R)c.m;
  if constexpr (OP == OP_DAY_OF_MONTH) return (R)c.d;
  if constexpr (OP == OP_DAY_OF_YEAR) return (R)c.yday;
  if constexpr (OP == OP_YYYYMM) return (R)c.y * 100 + c.m;
  if constexpr (OP == OP_YYYYMMDD) return (R)c.y * 10000 + c.m * 100 + c.d;
  if constexpr (OP == OP_YYYYMMDDHHMMSS) {
    const u32 hms = tod / 3600 * 10000 + tod / 60 % 60 * 100 + tod % 60;
    return ((R)c.y * 10000 + c.m * 100 + c.d) * (R)1000000 + hms;
  }
  if constexpr (OP == OP_REL_QUARTER) return (R)c.y * 4 + (c.m - 1) / 3;
  if constexpr (OP == OP_REL_MONTH) return (R)c.y * 12 + c.m;
  if constexpr (OP == OP_LAST_DAY_OF_MONTH)
    return (R)z + (R)(days_in_month32(c.y, c.m) - c.d);
  if constexpr (OP == OP_START_OF_MONTHS) {
    // |months| < 2^27 and c0 <= 2^30 (calendar_ops.narrow_ok)
    u32 r;
    const int start = fdivmod(c.y * 12 + (int)c.m - 1, k.d32, r) *
                      (int)k.d32.d;
    const int ny = fdivmod_c<12>(start, r);
    return days_from_civil32<R>(ny, r + 1, 1);
  }
  if constexpr (OP == OP_ADD_MONTHS) {
    // c0 = 12 * f0 + f1, 0 <= f1 < 12, |f0| <= 2^30
    const u32 t = c.m - 1 + (u32)k.f1;
    const u32 carry = t >= 12 ? 1 : 0;
    const u32 nm = t - 12 * carry + 1;
    const int ny = c.y + (int)k.f0 + (int)carry;
    const u32 ml = days_in_month32(ny, nm);
    const R out = days_from_civil32<R>(ny, nm, c.d < ml ? c.d : ml);
    return k.seconds ? out * (R)86400 + tod : out;
  }
  return 0;
}

// -- the 64-bit path: int64 storage, the plain version's formulas -----------

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}

template <u64 C>
__device__ __forceinline__ i64 fdiv64(i64 a) {
  u64 r;
  return fdivmod_c<C>(a, r);
}
template <u64 C>
__device__ __forceinline__ i64 fmod64(i64 a) {
  u64 r;
  fdivmod_c<C>(a, r);
  return (i64)r;
}

__device__ __forceinline__ void civil64(i64 z, i64& y, u32& m, u32& d,
                                        u32& yday) {
  u64 doe;
  const i64 era = fdivmod_c<kEraDays>(wadd(z, 719468), doe);
  u32 yoe;
  era_civil((u32)doe, yoe, m, d, yday);
  y = wadd(wadd((i64)yoe, wmul(era, 400)), m <= 2 ? 1 : 0);
}

__device__ __forceinline__ i64 days_from_civil64(i64 y, u32 m, u32 d) {
  u64 yoe;
  const i64 era = fdivmod_c<400>(wadd(y, m <= 2 ? -1 : 0), yoe);
  return wadd(wmul(era, kEraDays), (i64)era_day((u32)yoe, m, d) - 719468);
}

__device__ __forceinline__ u32 days_in_month64(i64 y, u32 m) {
  const bool leap = (y % 100 == 0) ? (y & 15) == 0 : (y & 3) == 0;
  if (m == 2) return leap ? 29 : 28;
  return 30 + ((m ^ (m >> 3)) & 1);
}

template <int OP>
__device__ __forceinline__ i64 op64(i64 v, const Consts& k) {
  const i64 secs = k.seconds ? v : wmul(v, 86400);
  const i64 days = k.seconds ? fdiv64<86400>(v) : v;
  if constexpr (OP == OP_HOUR) return fmod64<24>(fdiv64<3600>(secs));
  if constexpr (OP == OP_MINUTE) return fmod64<60>(fdiv64<60>(secs));
  if constexpr (OP == OP_SECOND) return fmod64<60>(secs);
  if constexpr (OP == OP_FLOOR_SECONDS) {
    u64 r;
    return fdivmod(secs, k.d64, r);
  }
  if constexpr (OP == OP_DAY_NUMBER) return wadd(days, k.c0);
  if constexpr (OP == OP_DAY_OF_WEEK) return fmod64<7>(wadd(days, 3)) + 1;
  if constexpr (OP == OP_REL_WEEK) return fdiv64<7>(wadd(days, 4));
  if constexpr (OP == OP_START_OF_DAYS || OP == OP_START_OF_SECONDS) {
    const i64 x = OP == OP_START_OF_DAYS ? days : secs;
    u64 r;
    fdivmod(wadd(x, k.c1), k.d64, r);
    return wadd(x, -(i64)r);
  }
  if constexpr (OP == OP_LAST_DAY_OF_WEEK)
    return wadd(wadd(days, -fmod64<7>(wadd(days, k.c0))), 6);
  if constexpr (OP == OP_ISO_YEAR || OP == OP_ISO_WEEK) {
    const i64 thursday = wadd(wadd(days, -fmod64<7>(wadd(days, 3))), 3);
    i64 y;
    u32 m, d, yday;
    civil64(thursday, y, m, d, yday);
    if constexpr (OP == OP_ISO_YEAR) return y;
    return fdiv64<7>(wadd(thursday, -days_from_civil64(y, 1, 1))) + 1;
  }
  i64 y;
  u32 m, d, yday;
  civil64(days, y, m, d, yday);
  if constexpr (OP == OP_YEAR) return y;
  if constexpr (OP == OP_QUARTER) return (m + 2) / 3;
  if constexpr (OP == OP_MONTH) return m;
  if constexpr (OP == OP_DAY_OF_MONTH) return d;
  if constexpr (OP == OP_DAY_OF_YEAR)
    return wadd(wadd(days, -days_from_civil64(y, 1, 1)), 1);
  if constexpr (OP == OP_YYYYMM) return wadd(wmul(y, 100), m);
  if constexpr (OP == OP_YYYYMMDD)
    return wadd(wmul(y, 10000), m * 100 + d);
  if constexpr (OP == OP_YYYYMMDDHHMMSS) {
    const i64 rem = wadd(secs, -wmul(days, 86400));
    const i64 hms = fdiv64<3600>(rem) * 10000 +
                    fmod64<60>(fdiv64<60>(rem)) * 100 + fmod64<60>(rem);
    return wadd(wmul(wadd(wmul(y, 10000), m * 100 + d), 1000000), hms);
  }
  if constexpr (OP == OP_REL_QUARTER) return wadd(wmul(y, 4), (m - 1) / 3);
  if constexpr (OP == OP_REL_MONTH) return wadd(wmul(y, 12), m);
  if constexpr (OP == OP_START_OF_MONTHS) {
    u64 r;
    const i64 months =
        wmul(fdivmod(wadd(wmul(y, 12), m - 1), k.d64, r), k.c0);
    u64 mr;
    const i64 ny = fdivmod_c<12>(months, mr);
    return days_from_civil64(ny, (u32)mr + 1, 1);
  }
  if constexpr (OP == OP_LAST_DAY_OF_MONTH)
    return wadd(days_from_civil64(m == 12 ? wadd(y, 1) : y,
                                  m == 12 ? 1 : m + 1, 1),
                -1);
  if constexpr (OP == OP_ADD_MONTHS) {
    u64 r;
    const i64 ny = fdivmod_c<12>(wadd(wadd(wmul(y, 12), m - 1), k.c0), r);
    const u32 nm = (u32)r + 1;
    const u32 ml = days_in_month64(ny, nm);
    const i64 out = days_from_civil64(ny, nm, d < ml ? d : ml);
    return k.seconds ? wadd(wmul(out, 86400), wadd(secs, -wmul(days, 86400)))
                     : out;
  }
  return 0;
}

template <int OP, typename In, typename Out>
__device__ __forceinline__ Out cal(In v, const Consts& k) {
  u64 r;
  if constexpr (sizeof(In) == 8) {
    r = (u64)op64<OP>((i64)v, k);
  } else {
    // an output of 32 bits or fewer needs the value modulo 2^32 alone
    typedef typename std::conditional<(sizeof(Out) == 8), u64, u32>::type R;
    r = (u64)op32<OP, R>((int)v, k);
  }
  return (Out)(r & k.mask);
}

template <int Bytes> struct WordOf;
template <> struct WordOf<1> { typedef unsigned char T; };
template <> struct WordOf<2> { typedef unsigned short T; };
template <> struct WordOf<4> { typedef unsigned int T; };
template <> struct WordOf<8> { typedef uint2 T; };
template <> struct WordOf<16> { typedef uint4 T; };

// V consecutive values of type E as one word
template <typename E, int V>
union Pack {
  typename WordOf<V * (int)sizeof(E)>::T w;
  E e[V];
};

// The op over `packs` packs of V rows: each lane takes the packs b + j *
// kThreads, j < G, of its block's step, loading all G before it computes.
template <int OP, int V, typename In, typename Out>
__device__ __forceinline__ void run(const In* __restrict__ x,
                                    Out* __restrict__ out, long long packs,
                                    const Consts& k) {
  constexpr int G = V >= 8 ? 1 : 8 / V;
  typedef Pack<In, V> PI;
  typedef Pack<Out, V> PO;
  const PI* xs = reinterpret_cast<const PI*>(x);
  PO* os = reinterpret_cast<PO*>(out);
  const long long step = (long long)gridDim.x * kThreads * G;
  for (long long b = (long long)blockIdx.x * kThreads * G + threadIdx.x;
       b < packs; b += step) {
    PI a[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long g = b + (long long)j * kThreads;
      if (g < packs) a[j].w = __ldg(&xs[g].w);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long g = b + (long long)j * kThreads;
      if (g < packs) {
        PO r;
#pragma unroll
        for (int e = 0; e < V; ++e) r.e[e] = cal<OP, In, Out>(a[j].e[e], k);
        os[g].w = r.w;
      }
    }
  }
}

struct KParams {
  i64 c0, c1, f0, f1;
  u64 div64, mul64;
  u32 div32, mul32;
  int log32, log64, seconds, mask_bits;
};

template <int OP, typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    k_calendar_part(const In* __restrict__ x, Out* __restrict__ out,
                    long long n, KParams p, int vec) {
  const Consts k{p.c0,
                 p.c1,
                 p.f0,
                 p.f1,
                 Div<u32>(p.div32, p.mul32, p.log32),
                 Div<u64>(p.div64, p.mul64, p.log64),
                 p.seconds,
                 p.mask_bits ? (1ull << p.mask_bits) - 1 : ~0ull};
  constexpr int V = 16 / (int)(sizeof(In) > sizeof(Out) ? sizeof(In)
                                                         : sizeof(Out));
  long long done = 0;
  if (vec) {
    run<OP, V>(x, out, n / V, k);
    done = n / V * V;
  }
  run<OP, 1>(x + done, out + done, n - done, k);
}

template <int D> struct OutOf;
template <> struct OutOf<DT_U8> { typedef unsigned char T; };
template <> struct OutOf<DT_I32> { typedef int T; };
template <> struct OutOf<DT_I64> { typedef long long T; };

template <int OP, typename In, typename Out>
void launch(const ChttCalArgs& A, int blocks, cudaStream_t st) {
  const KParams p{A.c0,    A.c1,    A.f0,    A.f1,      A.div64,
                  A.mul64, A.div32, A.mul32, A.log32,   A.log64,
                  A.seconds, A.mask_bits};
  k_calendar_part<OP, In, Out><<<blocks, kThreads, 0, st>>>(
      static_cast<const In*>(A.x), static_cast<Out*>(A.out), A.n, p, A.vec);
}

template <int OP, int D>
int launch_in(const ChttCalArgs& A, int blocks, cudaStream_t st) {
  typedef typename OutOf<D>::T Out;
  switch (A.in_dtype) {
    case DT_I8: launch<OP, signed char, Out>(A, blocks, st); break;
    case DT_I16: launch<OP, short, Out>(A, blocks, st); break;
    case DT_I32: launch<OP, int, Out>(A, blocks, st); break;
    case DT_I64: launch<OP, long long, Out>(A, blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// One launch of op A->op over A->n values of A->x (int8/16/32/64) into
// A->out (uint8, int32 or int64; the pairs of K12_INSTANCES); vec: both
// pointers start on a 16-byte boundary.
extern "C" int chtt_calendar_part(const void* args, int blocks,
                                  void* stream) {
  const ChttCalArgs& A = *static_cast<const ChttCalArgs*>(args);
  const bool divides = A.op == OP_FLOOR_SECONDS ||
                       A.op == OP_START_OF_DAYS ||
                       A.op == OP_START_OF_SECONDS ||
                       A.op == OP_START_OF_MONTHS;
  if (A.n < 0 || blocks < 1 || A.op < 0 || A.op >= OP_COUNT ||
      A.mask_bits < 0 || A.mask_bits > 32 || A.div32 < 1 || A.div64 < 1 ||
      (divides && A.c0 <= 0))
    return (int)cudaErrorInvalidValue;
  if (A.n == 0) return 0;
  if (A.vec && (((uintptr_t)A.x | (uintptr_t)A.out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = -1;
#define K12_CASE(O, D)                            \
  if (rc < 0 && A.op == O && A.out_dtype == D) \
    rc = launch_in<O, D>(A, blocks, st);
  K12_INSTANCES(K12_CASE)
#undef K12_CASE
  if (rc < 0) return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return chtt_last_error();
}
