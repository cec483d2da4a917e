// K1: masked whole-column reduction (GROUP BY () aggregates and counts),
// with the filter's `column CMP constant` terms evaluated in registers.
//
// Replaces the reference's Grouping._reduce_trivial
// (clickhouse_tpu/ops/agg_ops.py:131) and filter_ops.count_mask
// (clickhouse_tpu/ops/filter_ops.py:21), and computes the function of every
// Pallas kernel of the round-2 experiments in scratch/ (q1_*.py,
// r2_profile*.py): each reads the column itself, applies `x > t` in its body
// and counts (or sums) the rows that pass, in one pass.
//
// Bound on the card: bytes read.  A call reads each input once: the data
// column (when the op has one), the optional bool mask, and each term's
// column in its narrow storage type with its validity bytes; it writes a
// few words.  Q1 (`count() WHERE x > c`, x stored as int32) is 4 bytes a
// row: 0.119 ms at 100M rows at the H100's 3.35 TB/s.  What the design does
// about it:
//   * one launch a call: each block writes its partial, and the last block
//     to finish (a completion ticket: __threadfence + atomicAdd) combines
//     the partials in block order, writes the result and resets the ticket,
//     so float sums are the same from run to run and no init or finish
//     kernel sits between the caller and the result;
//   * 16-byte loads: a thread takes runs of 16 rows, reading each column's
//     run with sizeof(type) uint4 loads (keeping more runs in flight a
//     thread measured no faster); the kernel reads the ragged head (rows
//     before the widest column's first 16-byte boundary), the ragged tail
//     and any column that the head does not align with scalar loads, so no
//     caller copies a column to align it;
//   * the selection of a run lives in registers as 16 bytes of 0/1 (four
//     words): the bool mask and validity bytes AND in directly, a term ANDs
//     in its result bytes, and a count is __popc of the four words;
//   * a term compares in the type _cmp_exec promotes to
//     (clickhouse_tpu_torch/exprs/functions.py): the host turns `CMP c` into
//     a range of order keys (plus a negation, and the answer for NaN), so a
//     row costs a widening, a key and one unsigned range test; narrow
//     integer columns test in 32 bits.  The count kernel inlines the
//     terms; the other ops share them in one out-of-line function, so the
//     library stays small (a call per run costs those kernels spills).
// Integer sums accumulate in unsigned 64 bits (wrap mod 2^64, as the
// reference widens ints to 64 bits); min/max run on an order-preserving
// unsigned key (floats by the IEEE total-order map, so -0.0 < +0.0 and the
// result does not depend on the order blocks finish in), with NaN tracked by
// a flag because the reference's min/max propagate NaN; `any` is the FIRST
// selected row, as the reference's argmax(mask).  Float sums add in f64.
#include <type_traits>

#include "common.cuh"

enum { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_ANY = 3, OP_BOR = 4,
       OP_BAND = 5, OP_BXOR = 6, OP_COUNT = 7 };

// how a term turns a value into the key its range is tested on
enum { TM_I32 = 0,    // narrow integer storage, signed 32-bit range test
       TM_K64 = 1,    // 64-bit integer key: bits ^ xorv
       TM_F32 = 2,    // float order key of the value rounded to float32
       TM_F64 = 3 };  // float order key of the value as float64

constexpr int kThreads = 256;
constexpr int kRun = 16;       // rows a thread takes at a time
constexpr int kMaxTerms = 4;

// One `column CMP constant` term (ops/agg_ops.py builds it).  A row passes
// when its key k (see the modes) satisfies ((k - lo) <= span) != neg, a
// NaN value when nan_pass, and its validity byte (if any) is non-zero.
struct ChttK1Term {
  const void* col;
  const uint8_t* valid;
  u64 lo, span, xorv;
  int dtype, mode, neg, nan_pass;
  int u64src;          // TM_F64 of UInt64 bits: add 2^64 to negative bits
  int vec, valid_vec;  // 16-byte loads allowed in the body
  int pad;
};

struct ChttK1Args {
  const void* data;     // NULL for a count of the selected rows
  const uint8_t* mask;  // NULL: no mask
  void* out;
  u64* partials;        // 2 words a block
  unsigned* ticket;     // 0 between calls
  long long n;          // rows to read (the row bound applied)
  long long head;       // rows before the aligned body
  int dtype, data_vec, mask_vec, uns, n_terms, pad;
  ChttK1Term terms[kMaxTerms];
};

struct Sel {           // byte i of w[i / 4]: row i of the run selected (0/1)
  unsigned w[4];
};

__device__ __forceinline__ Sel sel_and(Sel a, const Sel& b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.w[j] &= b.w[j];
  return a;
}

__device__ __forceinline__ Sel first_rows(int cnt) {
  Sel s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = cnt - 4 * j;   // rows of word j inside the run
    s.w[j] = k >= 4 ? 0x01010101u
                    : k <= 0 ? 0u : (0x01010101u >> (8 * (4 - k)));
  }
  return s;
}

__device__ __forceinline__ bool sel_byte(const Sel& s, int i) {
  return (s.w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// 16 rows of a column (zero past cnt); vec: one 16-byte aligned full run
template <typename S>
__device__ __forceinline__ void load_run(const S* __restrict__ p, bool vec,
                                         int cnt, S (&v)[kRun]) {
  if (vec) {
    union {
      uint4 u[sizeof(S)];
      S s[kRun];
    } r;
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < (int)sizeof(S); ++j) r.u[j] = __ldg(q + j);
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = r.s[i];
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = i < cnt ? p[i] : (S)0;
  }
}

// bytes -> 0/1 selection bytes (non-zero selects)
__device__ __forceinline__ Sel byte_sel(const uint8_t* __restrict__ p,
                                        bool vec, int cnt) {
  Sel s;
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    s.w[0] = __vcmpne4(u.x, 0u) & 0x01010101u;
    s.w[1] = __vcmpne4(u.y, 0u) & 0x01010101u;
    s.w[2] = __vcmpne4(u.z, 0u) & 0x01010101u;
    s.w[3] = __vcmpne4(u.w, 0u) & 0x01010101u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s.w[j] = 0u;
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < cnt && p[i] != 0) s.w[i >> 2] |= 1u << (8 * (i & 3));
  }
  return s;
}

__device__ __forceinline__ bool in_range(const ChttK1Term& t, u64 key) {
  return ((key - t.lo) <= t.span) != (t.neg != 0);
}

// float order key with -0.0 read as +0.0 (they compare equal)
__device__ __forceinline__ u64 cmp_key(double d) {
  return f64_order_key(d == 0.0 ? 0.0 : d);
}

template <typename S>
__device__ __forceinline__ bool term_pass(const ChttK1Term& t, S v) {
  if constexpr (std::is_floating_point<S>::value) {
    const double d = t.mode == TM_F32 ? (double)(float)v : (double)v;
    if (d != d) return t.nan_pass != 0;
    return in_range(t, cmp_key(d));
  } else {
    const long long x = (long long)v;     // sign- or zero-extends
    if (t.mode == TM_I32) {
      const unsigned k = (unsigned)(int)x - (unsigned)t.lo;
      return (k <= (unsigned)t.span) != (t.neg != 0);
    }
    if (t.mode == TM_K64) return in_range(t, (u64)x ^ t.xorv);
    if (t.mode == TM_F32) return in_range(t, cmp_key((double)(float)x));
    double d = (double)x;
    if (t.u64src && x < 0) d = d + 18446744073709551616.0;
    return in_range(t, cmp_key(d));
  }
}

template <typename S>
__device__ __forceinline__ Sel term_run(const ChttK1Term& t, long long start,
                                        int cnt, bool body) {
  S v[kRun];
  load_run<S>(static_cast<const S*>(t.col) + start, body && t.vec, cnt, v);
  Sel s;
#pragma unroll
  for (int j = 0; j < 4; ++j) s.w[j] = 0u;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    s.w[i >> 2] |= (unsigned)term_pass<S>(t, v[i]) << (8 * (i & 3));
  return s;
}

__device__ __forceinline__ Sel term_sel_in(const ChttK1Term* t,
                                           long long start, int cnt,
                                           bool body) {
  Sel s;
  switch (t->dtype) {
    case DT_I8: s = term_run<int8_t>(*t, start, cnt, body); break;
    case DT_I16: s = term_run<int16_t>(*t, start, cnt, body); break;
    case DT_I32: s = term_run<int32_t>(*t, start, cnt, body); break;
    case DT_I64: s = term_run<long long>(*t, start, cnt, body); break;
    case DT_F32: s = term_run<float>(*t, start, cnt, body); break;
    case DT_F64: s = term_run<double>(*t, start, cnt, body); break;
    default: s = term_run<uint8_t>(*t, start, cnt, body); break;
  }
  if (t->valid != nullptr)
    s = sel_and(s, byte_sel(t->valid + start, body && t->valid_vec, cnt));
  return s;
}

// one term over one run, out of line: the kernels of every op and type but
// the count share this code (the count, on the filter's path, inlines it)
__device__ __noinline__ Sel term_sel(const ChttK1Term* t, long long start,
                                     int cnt, bool body) {
  return term_sel_in(t, start, cnt, body);
}

template <typename T, int OP>
struct Red {
  static constexpr bool kFloat = std::is_floating_point<T>::value;
  static constexpr bool kFsum = OP == OP_SUM && kFloat;

  __device__ static u64 ident() {
    // min, and/any (no row yet): all ones; else 0 (+0.0 for float sums)
    if (OP == OP_MIN || OP == OP_BAND || OP == OP_ANY) return ~0ull;
    return 0ull;
  }

  __device__ static u64 combine(u64 a, u64 b) {
    if (kFsum)
      return (u64)__double_as_longlong(__longlong_as_double((long long)a) +
                                       __longlong_as_double((long long)b));
    if (OP == OP_SUM || OP == OP_COUNT) return a + b;
    if (OP == OP_MIN || OP == OP_ANY) return a < b ? a : b;
    if (OP == OP_MAX) return a > b ? a : b;
    if (OP == OP_BOR) return a | b;
    if (OP == OP_BAND) return a & b;
    return a ^ b;
  }

  // integer bits widened to 64: sign-extend signed types, zero-extend others
  __device__ static u64 int_bits(T v) {
    if constexpr (kFloat) return 0ull;
    else if constexpr (std::is_signed<T>::value) return (u64)(long long)v;
    else return (u64)v;
  }

  // unsigned key whose order is the value order (uns: int64 holds u64 bits)
  __device__ static u64 order_key(T v, int uns) {
    if constexpr (kFloat) return f64_order_key((double)v);
    else if constexpr (std::is_signed<T>::value)
      return uns ? (u64)(long long)v : ((u64)(long long)v ^ CHTT_SIGN);
    else return (u64)v;
  }

  // one run into (acc, sel, nan); true when the thread may stop (`any`)
  __device__ static bool run(const ChttK1Args& A, const Sel& s,
                             long long start, int cnt, bool body, u64& acc,
                             int& sel, int& nan) {
    if (OP == OP_COUNT) {
      acc += (u64)(__popc(s.w[0]) + __popc(s.w[1]) + __popc(s.w[2]) +
                   __popc(s.w[3]));
      return false;
    }
    if ((s.w[0] | s.w[1] | s.w[2] | s.w[3]) == 0u) return false;
    sel = 1;
    if (OP == OP_ANY) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s.w[j] != 0u) {
          acc = (u64)(start + 4 * j + ((__ffs(s.w[j]) - 1) >> 3));
          return true;
        }
    }
    T v[kRun];
    load_run<T>(static_cast<const T*>(A.data) + start, body && A.data_vec,
                cnt, v);
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (!sel_byte(s, i)) continue;
      if (kFsum) {
        acc = combine(acc, (u64)__double_as_longlong((double)v[i]));
      } else if (OP == OP_MIN || OP == OP_MAX) {
        if constexpr (kFloat) {
          if (v[i] != v[i]) {
            nan = 1;
            continue;
          }
        }
        acc = combine(acc, order_key(v[i], A.uns));
      } else {
        acc = combine(acc, int_bits(v[i]));
      }
    }
    return false;
  }

  // the reduced key back to a value (0 when no row is selected)
  __device__ static void finish(const ChttK1Args& A, u64 acc, int sel,
                                int nan) {
    if (OP == OP_COUNT || (OP == OP_SUM && !kFloat)) {
      *static_cast<long long*>(A.out) = (long long)acc;
      return;
    }
    if (kFsum) {
      *static_cast<double*>(A.out) = __longlong_as_double((long long)acc);
      return;
    }
    T r = (T)0;
    if (sel) {
      if (OP == OP_ANY) {
        r = static_cast<const T*>(A.data)[acc];
      } else if (OP == OP_MIN || OP == OP_MAX) {
        if constexpr (kFloat) {
          r = nan ? (T)__longlong_as_double(0x7ff8000000000000LL)
                  : (T)f64_order_unkey(acc);
        } else if constexpr (std::is_signed<T>::value) {
          r = (T)(long long)(A.uns ? acc : (acc ^ CHTT_SIGN));
        } else {
          r = (T)acc;
        }
      } else {
        r = (T)acc;
      }
    }
    *static_cast<T*>(A.out) = r;
  }
};

// (acc, sel, nan) of the block, in thread 0 (a fixed tree: the same inputs
// give the same float sum)
template <typename T, int OP>
__device__ __forceinline__ void block_reduce(u64& acc, int& sel, int& nan) {
  using R = Red<T, OP>;
  __shared__ u64 ws[kThreads / 32];
  __shared__ int wf[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    acc = R::combine(acc, __shfl_down_sync(0xffffffffu, acc, off));
  sel = __any_sync(0xffffffffu, sel);
  nan = __any_sync(0xffffffffu, nan);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    ws[w] = acc;
    wf[w] = sel | (nan << 1);
  }
  __syncthreads();
  if (w == 0) {
    acc = lane < kThreads / 32 ? ws[lane] : R::ident();
    const int f = lane < kThreads / 32 ? wf[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc = R::combine(acc, __shfl_down_sync(0xffffffffu, acc, off));
    sel = __any_sync(0xffffffffu, f & 1);
    nan = __any_sync(0xffffffffu, f & 2);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, 4)
k_masked_reduce(const __grid_constant__ ChttK1Args A) {
  using R = Red<T, OP>;
  u64 acc = R::ident();
  int sel = 0, nan = 0;

  const long long hb = A.head > 0 ? 1 : 0;
  const long long runs = A.n > 0 ? hb + (A.n - A.head + kRun - 1) / kRun : 0;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < runs; r += (long long)gridDim.x * kThreads) {
    const long long start = r < hb ? 0 : A.head + (r - hb) * kRun;
    const int cnt = r < hb ? (int)A.head
                           : (int)min((long long)kRun, A.n - start);
    const bool body = cnt == kRun && start >= A.head;
    Sel s = first_rows(cnt);
    if (A.mask != nullptr)
      s = sel_and(s, byte_sel(A.mask + start, body && A.mask_vec, cnt));
    for (int k = 0; k < A.n_terms; ++k)
      s = sel_and(s, OP == OP_COUNT
                         ? term_sel_in(&A.terms[k], start, cnt, body)
                         : term_sel(&A.terms[k], start, cnt, body));
    if (R::run(A, s, start, cnt, body, acc, sel, nan)) break;
  }

  block_reduce<T, OP>(acc, sel, nan);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    A.partials[2 * blockIdx.x] = acc;
    A.partials[2 * blockIdx.x + 1] = (u64)(sel | (nan << 1));
    __threadfence();
    last = atomicAdd(A.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every partial is written; add them in block order
  __threadfence();
  acc = R::ident();
  sel = 0;
  nan = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    acc = R::combine(acc, __ldcg(A.partials + 2 * b));
    const u64 f = __ldcg(A.partials + 2 * b + 1);
    sel |= (int)(f & 1ull);
    nan |= (int)((f >> 1) & 1ull);
  }
  block_reduce<T, OP>(acc, sel, nan);
  if (threadIdx.x == 0) {
    R::finish(A, acc, sel, nan);
    *A.ticket = 0u;
  }
}

template <typename T, int OP>
static int launch(const ChttK1Args& a, int nb, cudaStream_t st) {
  k_masked_reduce<T, OP><<<nb, kThreads, 0, st>>>(a);
  return chtt_last_error();
}

template <typename T>
static int dispatch_op(int op, const ChttK1Args& a, int nb, cudaStream_t st) {
  constexpr bool is_float = std::is_floating_point<T>::value;
  switch (op) {
    case OP_SUM: return launch<T, OP_SUM>(a, nb, st);
    case OP_MIN: return launch<T, OP_MIN>(a, nb, st);
    case OP_MAX: return launch<T, OP_MAX>(a, nb, st);
    case OP_ANY: return launch<T, OP_ANY>(a, nb, st);
    case OP_BOR:
    case OP_BAND:
    case OP_BXOR:
      if constexpr (is_float) {
        return (int)cudaErrorInvalidValue;
      } else {
        if (op == OP_BOR) return launch<T, OP_BOR>(a, nb, st);
        if (op == OP_BAND) return launch<T, OP_BAND>(a, nb, st);
        return launch<T, OP_BXOR>(a, nb, st);
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One launch of nb blocks.  op OP_COUNT counts the selected rows (data
// unused); out: one int64 (count, integer sum), one double (float sum) or
// one element of the data's type.  partials: 2 * nb words of scratch;
// ticket: one word that is 0 before the call and is 0 again after it.
extern "C" int chtt_masked_reduce(const ChttK1Args* args, int op, int nb,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const ChttK1Args& a = *args;
  if (a.n_terms < 0 || a.n_terms > kMaxTerms || nb < 1)
    return (int)cudaErrorInvalidValue;
  if (op == OP_COUNT) return launch<uint8_t, OP_COUNT>(a, nb, st);
  switch (a.dtype) {
    case DT_BOOL:
    case DT_U8: return dispatch_op<uint8_t>(op, a, nb, st);
    case DT_I8: return dispatch_op<int8_t>(op, a, nb, st);
    case DT_I16: return dispatch_op<int16_t>(op, a, nb, st);
    case DT_I32: return dispatch_op<int32_t>(op, a, nb, st);
    case DT_I64: return dispatch_op<long long>(op, a, nb, st);
    case DT_F32: return dispatch_op<float>(op, a, nb, st);
    case DT_F64: return dispatch_op<double>(op, a, nb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
