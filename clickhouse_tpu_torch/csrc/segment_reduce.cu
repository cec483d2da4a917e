// K6: per-group sum, min, max, any, bit ops and masked counts over
// key-sorted rows: every reduction of a GROUP BY in one launch.
//
// Replaces the reference's seg_reduce_sorted and _masked_counts
// (clickhouse_tpu/ops/scan_ops.py:147 and :286) and the Grouping.take that
// feeds them (clickhouse_tpu/ops/agg_ops.py:65).  On the TPU, sums were
// differences of prefix sums over all rows, min/max/any an extra sort of
// (group, order token) pairs, and take an inverse-permutation sort, all to
// avoid scatter.  Here the kernel walks the sorted rows, reads each row's
// values and masks through the permutation itself (data[perm[i]]: a gather
// from the column's narrow storage), and reduces each group directly.
//
// Bound on the card: bytes, and for the permuted entry the gather
// sectors.  Each sorted row reads its group id and permutation entry (4
// bytes each), each distinct source column's value and each distinct mask
// byte once; each group slot takes each op's state (8 bytes) and each
// count kept (8 more: min, max, any and band tell a group without a
// masked-in row by its count; over the grouping's own rows that count is
// ends - starts and no count is kept).  The value and mask reads are
// gathers: a 32-byte sector for 1-8 useful bytes where the groups' rows lie
// far apart in the table, so 100M rows of one gathered int32 column cost
// 3.2 GB of sectors (0.96 ms at 3.35 TB/s) where the useful bytes are
// 0.4 GB.
// Design:
//   * one launch takes up to kMaxSpecs reductions over up to kMaxData
//     source columns, kMaxForms forms of them and kMaxMasks masks (the
//     wrapper splits longer lists): each row's group id and permutation
//     entry are read once for all of them, each source column gathered
//     once and each mask byte read once;
//   * a form is what a reduction reads of a source: its integer value
//     (sign- or zero-extended), its order key (min/max) or its double
//     (float sums and the statistics' terms), of the column as stored or
//     of intDiv/modulo of it by an integer constant (a term: Q2s2's
//     `x % 7`), the term computed in registers, a run-time divisor by the
//     host's multiplier (scan_ops.Term; calendar_ops.magic; PERF.md has
//     its time against a 32-bit division).  Each gathered value is converted
//     once into each form, the type switch outside the row loop; the
//     reductions then read forms only;
//   * every warp reduces 256 sorted rows on its own, whatever the groups:
//     no shared memory and no barrier, so an SM's warps keep their loads
//     in flight while others reduce, and a group holding 40 % of the rows
//     spreads over every SM.  A warp first loads its group ids and
//     permutation entries (16-byte loads: a lane holds runs of 4 rows),
//     then issues all of its gathers, and only then reduces;
//   * the lanes reduce the runs of equal group id with a segmented shuffle
//     reduction (ids ascend with the lane, so a run is a range of lanes),
//     one for a 128-row chunk where each lane's 4 rows share a group, else
//     one a row slot, and each run's first lane adds the run into the
//     group's state in device memory with one atomic (u64 add, which
//     wraps; min/max on u64 order keys; min on the row id for `any`;
//     double add for float sums, whose order then varies from run to
//     run).  The wrapper fills the states with each op's identity first;
//   * a float sum of x^p (p 1-4) or of x * y (OP_FSUMX: the variance
//     family's, the covariance's and the moments' terms) is formed in
//     registers from the forms, so those aggregates read their arguments'
//     narrow storage like any other reduction;
//   * the sorted-order entry (perm null; reference agg_ops.py:109,
//     Grouping.reduce_sorted) takes data and masks that are already in
//     sorted order, as the holistic aggregates make them (uniqExact's
//     first-occurrence flags, argMin's rows at the best token), and the
//     groups' bounds (K5's starts and ends) in place of a group id a row:
//     persistent warps each walk a contiguous run of steps, the first
//     step's group found by a 32-way search over `starts`, the next
//     group's start kept in a register, and a step that holds a boundary
//     reads the starts after its group 32 at a time into the lanes and
//     finds each row's group by a search over them with shuffles; rows
//     read at i, so no permutation, no group id and no gather;
//   * min/max compare order keys (sort_ops.order_value: signed ints with
//     the sign bit flipped, floats as their tokens: -0.0 below +0.0, a
//     positive NaN above every number, a negative NaN below), as the
//     reference's sort by order token does; `any` keeps the smallest row
//     id among the masked-in rows (the rows of a group are in row order).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W power
// limit: see PERF.md's K6 rows (Q2m's four reductions, Q2s2's seven over
// x and x % 7 with one gather a row, the sorted entry at Q2ug and Q2s2).
#include "common.cuh"

constexpr int kMaxSpecs = 8;       // reductions a launch
constexpr int kMaxData = 4;        // distinct source columns a launch
constexpr int kMaxForms = 4;       // distinct forms of them a launch
constexpr int kMaxMasks = 4;       // distinct masks a launch
constexpr int kMaxCounts = kMaxMasks + 1;

// What a reduction reads of a source column, per row.
enum FormKind {
  FORM_INT = 0,    // the integer value, sign- or zero-extended to 64 bits
  FORM_KEY = 1,    // its order key (min/max)
  FORM_DBL = 2,    // its double's bits
};

// The term of a form: the source as stored, or intDiv/modulo of a signed
// int8/16/32 source by the constant c (truncating; the remainder takes the
// dividend's sign), by the host's multiplier.
enum TermOp {
  TERM_NONE = 0,
  TERM_DIV = 1,
  TERM_MOD = 2,
};

// One form: of source slot `data`, kind and term as above.  `magic`,
// `shift1` and `shift2` divide by |c| (calendar_ops.magic(|c|, 32): m, then
// min(l, 1) and max(l - 1, 0)).
struct ChttSegForm {
  int data;
  int kind;
  int term;
  int uns;                   // int64 source holds UInt64 bits
  int c;
  unsigned magic;
  int shift1;
  int shift2;
};

// One reduction: op (SegOp) of form slot `form` (-1 for `any`, which keeps
// a row id and reads no value) over the rows where mask slot `mask` holds
// (-1: every row of a group).  OP_FSUMX sums the double of form `form`
// raised to `pow` (1-4), times the double of form `form2` where form2 >= 0.
struct ChttSegSpec {
  int op;
  int form;
  int mask;
  int form2;
  int pow;
  int pad;
  void* acc;                 // cap_g u64 states (double bits for OP_FSUM*)
};

// One masked-in row count: of mask slot `mask` (-1: every row).
struct ChttSegCount {
  int mask;
  int pad;
  void* out;                 // cap_g u64 counts
};

struct ChttSegArgs {
  const int* perm;           // sorted position -> raw row; null: the
                             // sorted-order entry (row i is i)
  const int* gid;            // permuted entry: sorted order; >= cap_g: no
                             // slot
  const long long* starts;   // sorted entry: each slot's first row (not
                             // decreasing; slots past the last group hold
                             // the valid row count)
  const long long* ends;     // sorted entry: each slot's end (rows from
                             // ends[cap_g - 1] on have no slot)
  long long n;
  int cap_g;
  int n_specs;
  int n_data;
  int n_forms;
  int n_masks;
  int n_counts;
  const void* data[kMaxData];          // raw row order (sorted: sorted)
  int dtype[kMaxData];                 // ChttDtype of each column
  ChttSegForm form[kMaxForms];
  const uint8_t* mask[kMaxMasks];      // raw row order (sorted: sorted)
  ChttSegCount count[kMaxCounts];
  ChttSegSpec spec[kMaxSpecs];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 256;                // rows a warp step
constexpr int kSlots = kWarpRows / 32;        // 8 rows a lane
constexpr unsigned kFull = 0xffffffffu;

// ops, as ops/scan_ops.py numbers them
enum SegOp {
  OP_SUM = 0,      // integer sum, wrapping mod 2^64
  OP_MIN = 1,
  OP_MAX = 2,
  OP_ANY = 3,
  OP_BOR = 4,
  OP_BAND = 5,
  OP_BXOR = 6,
  OP_FSUM = 8,     // float sum in double
  OP_FSUMX = 9,    // float sum in double of x^pow (* y)
};

__device__ __forceinline__ u64 identity(int op) {
  return (op == OP_MIN || op == OP_ANY || op == OP_BAND) ? ~0ull : 0ull;
}

template <int OP> __device__ __forceinline__ u64 combine(u64 a, u64 b) {
  switch (OP) {
    case OP_SUM: return a + b;
    case OP_FSUM: case OP_FSUMX:
      return (u64)__double_as_longlong(__longlong_as_double((long long)a) +
                                       __longlong_as_double((long long)b));
    case OP_MIN: case OP_ANY: return a < b ? a : b;
    case OP_MAX: return a > b ? a : b;
    case OP_BOR: return a | b;
    case OP_BAND: return a & b;
    case OP_BXOR: return a ^ b;
    default: return 0ull;
  }
}

// *p = combine(*p, v), atomically (shared or device memory).
__device__ __forceinline__ void atomic_combine(int op, u64* p, u64 v) {
  auto* q = reinterpret_cast<unsigned long long*>(p);
  switch (op) {
    case OP_SUM: atomicAdd(q, v); break;
    case OP_FSUM: case OP_FSUMX:
      atomicAdd(reinterpret_cast<double*>(p),
                __longlong_as_double((long long)v));
      break;
    case OP_MIN: case OP_ANY: atomicMin(q, v); break;
    case OP_MAX: atomicMax(q, v); break;
    case OP_BOR: atomicOr(q, v); break;
    case OP_BAND: atomicAnd(q, v); break;
    case OP_BXOR: atomicXor(q, v); break;
    default: break;
  }
}

// The element's bits as stored, zero-extended.
__device__ __forceinline__ u64 load_raw(const void* p, int dtype, int r) {
  switch (dtype) {
    case DT_BOOL: case DT_U8: case DT_I8:
      return static_cast<const uint8_t*>(p)[r];
    case DT_I16: return static_cast<const uint16_t*>(p)[r];
    case DT_I32: case DT_F32: return static_cast<const unsigned*>(p)[r];
    default: return static_cast<const u64*>(p)[r];
  }
}

__device__ __forceinline__ u64 dbits(double d) {
  return (u64)__double_as_longlong(d);
}

__device__ __forceinline__ double as_double(u64 b) {
  return __longlong_as_double((long long)b);
}

// A signed narrow source's value (int8/16/32 bits, zero-extended).
__device__ __forceinline__ int narrow_value(u64 raw, int dtype) {
  return dtype == DT_I8 ? (int)(int8_t)raw
         : dtype == DT_I16 ? (int)(int16_t)raw : (int)(unsigned)raw;
}

// intDiv (TERM_DIV) or modulo (TERM_MOD) of v by f.c, truncating; the
// remainder takes v's sign (torch.div(rounding_mode="trunc"), torch.fmod).
// c is neither 0 nor -1, so nothing overflows.
__device__ __forceinline__ int apply_term(int v, const ChttSegForm& f) {
  const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;  // |v| <= 2^31
  const unsigned d = f.c < 0 ? 0u - (unsigned)f.c : (unsigned)f.c;
  const unsigned t = __umulhi(f.magic, a);
  const unsigned q = (t + ((a - t) >> f.shift1)) >> f.shift2;   // a / d
  if (f.term == TERM_DIV)
    return (int)(((v < 0) != (f.c < 0)) ? 0u - q : q);
  const unsigned r = a - q * d;
  return (int)(v < 0 ? 0u - r : r);
}

template <typename Fn>
__device__ __forceinline__ void each_row(const u64 (&raw)[kSlots],
                                         u64 (&out)[kSlots], Fn fn) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) out[s] = fn(raw[s]);
}

// Form f of one source's kSlots gathered values (bits as stored): the type
// and kind switch once, outside the row loop.
__device__ __forceinline__ void form_rows(const u64 (&raw)[kSlots],
                                          int dtype, const ChttSegForm& f,
                                          u64 (&out)[kSlots]) {
  if (f.term != TERM_NONE) {
    const int kind = f.kind;
    each_row(raw, out, [&](u64 b) {
      const long long t = apply_term(narrow_value(b, dtype), f);
      return kind == FORM_DBL ? dbits((double)t)
             : kind == FORM_KEY ? (u64)t ^ CHTT_SIGN : (u64)t;
    });
    return;
  }
  const bool uns = f.uns != 0;
  switch (f.kind) {
    case FORM_INT:
      switch (dtype) {
        case DT_BOOL: each_row(raw, out, [](u64 b) { return (u64)(b != 0); });
          break;
        case DT_I8: case DT_I16: case DT_I32:
          each_row(raw, out, [&](u64 b) {
            return (u64)(long long)narrow_value(b, dtype);
          });
          break;
        default: each_row(raw, out, [](u64 b) { return b; }); break;
      }
      break;
    case FORM_KEY:
      switch (dtype) {
        case DT_BOOL: each_row(raw, out, [](u64 b) { return (u64)(b != 0); });
          break;
        case DT_U8: each_row(raw, out, [](u64 b) { return b; }); break;
        case DT_I8: case DT_I16: case DT_I32:
          each_row(raw, out, [&](u64 b) {
            return (u64)(long long)narrow_value(b, dtype) ^ CHTT_SIGN;
          });
          break;
        case DT_I64:
          each_row(raw, out, [&](u64 b) { return uns ? b : b ^ CHTT_SIGN; });
          break;
        case DT_F32:
          // the f32 token (hash_ops.f32_token): total-order bits, high half
          each_row(raw, out, [](u64 b) {
            const unsigned v = (unsigned)b;
            return (u64)((v >> 31) ? ~v : (v | 0x80000000u)) << 32;
          });
          break;
        default:
          each_row(raw, out, [](u64 b) { return f64_order_key(as_double(b)); });
          break;
      }
      break;
    default:                                   // FORM_DBL
      switch (dtype) {
        case DT_BOOL:
          each_row(raw, out, [](u64 b) { return dbits(b != 0 ? 1.0 : 0.0); });
          break;
        case DT_U8: each_row(raw, out, [](u64 b) { return dbits((double)b); });
          break;
        case DT_I8: case DT_I16: case DT_I32:
          each_row(raw, out, [&](u64 b) {
            return dbits((double)narrow_value(b, dtype));
          });
          break;
        case DT_I64:
          each_row(raw, out, [&](u64 b) {
            return dbits(uns ? (double)b : (double)(long long)b);
          });
          break;
        case DT_F32:
          each_row(raw, out, [](u64 b) {
            return dbits((double)__uint_as_float((unsigned)b));
          });
          break;
        default: each_row(raw, out, [](u64 b) { return b; }); break;
      }
      break;
  }
}

// OP_FSUMX's term from the forms' doubles: x^pow (x*x, (x*x)*x,
// (x*x)*(x*x), as the plain version multiplies), times y where has_y.
__device__ __forceinline__ u64 fsumx_term(u64 x, u64 y, int pow, bool has_y) {
  const double a = as_double(x);
  const double a2 = a * a;
  double t = pow == 1 ? a : pow == 2 ? a2 : pow == 3 ? a2 * a : a2 * a2;
  if (has_y) t = t * as_double(y);
  return dbits(t);
}

// Reduce K rows a lane (bit k of `in`: row k is masked in) of op OP over
// the warp's runs of equal group id (bit k of `same`: the lane 2^k above
// has this lane's group; the K rows of a lane share its group) and add
// each run into `slot` (`write`: this lane heads a run with a slot).  x
// and y: the rows' forms; pow and has_y: OP_FSUMX's.
template <int OP, int K>
__device__ __forceinline__ void reduce_rows(const u64 (&x)[K],
                                            const u64 (&y)[K],
                                            const int (&r)[K], unsigned in,
                                            int pow, bool has_y,
                                            unsigned same, bool write,
                                            u64* slot) {
  u64 v = identity(OP);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((in >> k) & 1u)
      v = combine<OP>(v, OP == OP_ANY ? (u64)r[k]
                         : OP == OP_FSUMX ? fsumx_term(x[k], y[k], pow, has_y)
                                          : x[k]);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const u64 v2 = __shfl_down_sync(kFull, v, 1 << k);
    if ((same >> k) & 1u) v = combine<OP>(v, v2);
  }
  if (write && v != identity(OP)) atomic_combine(OP, slot, v);
}

template <int K, bool XF>
__device__ __forceinline__ void reduce_op(int op, const u64 (&x)[K],
                                          const u64 (&y)[K],
                                          const int (&r)[K], unsigned in,
                                          int pow, bool has_y, unsigned same,
                                          bool write, u64* slot) {
#define CHTT_REDUCE(OPC) \
  reduce_rows<OPC, K>(x, y, r, in, pow, has_y, same, write, slot)
  switch (op) {
    case OP_SUM: CHTT_REDUCE(OP_SUM); break;
    case OP_FSUM: CHTT_REDUCE(OP_FSUM); break;
    case OP_FSUMX:
      if constexpr (XF) CHTT_REDUCE(OP_FSUMX);
      break;
    case OP_MIN: CHTT_REDUCE(OP_MIN); break;
    case OP_MAX: CHTT_REDUCE(OP_MAX); break;
    case OP_ANY: CHTT_REDUCE(OP_ANY); break;
    case OP_BOR: CHTT_REDUCE(OP_BOR); break;
    case OP_BAND: CHTT_REDUCE(OP_BAND); break;
    case OP_BXOR: CHTT_REDUCE(OP_BXOR); break;
    default: break;
  }
#undef CHTT_REDUCE
}

// Rows S0 .. S0 + K - 1 of each lane, which share the lane's group gs:
// every count and spec, each run of the warp added by its first lane into
// the group's state in device memory.  Every lane of the warp must call it.
template <int NF, int S0, int K, bool XF>
__device__ __forceinline__ void reduce_lane_rows(
    const ChttSegArgs& a, int gs, const int (&r)[kSlots],
    const u64 (&fv)[NF > 0 ? NF : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks]) {
  const int lane = threadIdx.x & 31;
  const bool live = gs < a.cap_g;
  unsigned same = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int g2 = __shfl_down_sync(kFull, gs, 1 << k);
    if (lane + (1 << k) < 32 && g2 == gs) same |= 1u << k;
  }
  // every lane takes part in the shuffle (lane 0's result is unused)
  const int prev = __shfl_up_sync(kFull, gs, 1);
  const bool write = (lane == 0 || prev != gs) && live;
  constexpr unsigned kRowsMask = (1u << K) - 1u;
  // the rows that pass mask slot m (-1: every live row)
  auto passing = [&](int m) {
    unsigned in = live ? kRowsMask : 0u;
#pragma unroll
    for (int mm = 0; mm < kMaxMasks; ++mm)
      if (mm == m) in = (mbits[mm] >> S0) & kRowsMask;
    return in;
  };
  for (int c = 0; c < a.n_counts; ++c) {
    unsigned v = __popc(passing(a.count[c].mask));
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const unsigned v2 = __shfl_down_sync(kFull, v, 1 << k);
      if ((same >> k) & 1u) v += v2;
    }
    if (write && v)
      atomicAdd(static_cast<unsigned long long*>(a.count[c].out) + gs,
                (unsigned long long)v);
  }
  int rr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rr[k] = r[S0 + k];
  for (int q = 0; q < a.n_specs; ++q) {
    const ChttSegSpec& sp = a.spec[q];
    const int qf = sp.form, qf2 = XF ? sp.form2 : -1;
    u64 x[K], y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = 0;
      y[k] = 0;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f == qf) x[k] = fv[f][S0 + k];
        if (XF && f == qf2) y[k] = fv[f][S0 + k];
      }
    }
    reduce_op<K, XF>(sp.op, x, y, rr, passing(sp.mask), sp.pow, qf2 >= 0,
                     same, write, static_cast<u64*>(sp.acc) + gs);
  }
}

// Row slots S0 .. S0 + 3 (one 128-row chunk of the warp): where every
// lane's four rows share its group, one segmented reduction for all four
// rows; else one a row slot.
template <int NF, int S0, bool XF>
__device__ __forceinline__ void reduce_chunk(
    const ChttSegArgs& a, const int (&g)[kSlots], const int (&r)[kSlots],
    const u64 (&fv)[NF > 0 ? NF : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks]) {
  if (__all_sync(kFull, g[S0] == g[S0 + 3])) {
    reduce_lane_rows<NF, S0, 4, XF>(a, g[S0], r, fv, mbits);
  } else {
    reduce_lane_rows<NF, S0, 1, XF>(a, g[S0], r, fv, mbits);
    reduce_lane_rows<NF, S0 + 1, 1, XF>(a, g[S0 + 1], r, fv, mbits);
    reduce_lane_rows<NF, S0 + 2, 1, XF>(a, g[S0 + 2], r, fv, mbits);
    reduce_lane_rows<NF, S0 + 3, 1, XF>(a, g[S0 + 3], r, fv, mbits);
  }
}

// combine(a, b) of a run-time op.
__device__ __forceinline__ u64 combine_op(int op, u64 a, u64 b) {
  switch (op) {
    case OP_SUM: return combine<OP_SUM>(a, b);
    case OP_FSUM: case OP_FSUMX: return combine<OP_FSUM>(a, b);
    case OP_MIN: case OP_ANY: return combine<OP_MIN>(a, b);
    case OP_MAX: return combine<OP_MAX>(a, b);
    case OP_BOR: return combine<OP_BOR>(a, b);
    case OP_BAND: return combine<OP_BAND>(a, b);
    case OP_BXOR: return combine<OP_BXOR>(a, b);
    default: return 0ull;
  }
}

// A spec of the warp's 256 rows when they are all of one group: combined
// over a lane's 8 rows, then over the warp; every lane gets the total.
template <int OP, int NF, bool XF>
__device__ __forceinline__ u64 one_group_spec(
    const ChttSegSpec& sp, const int (&r)[kSlots],
    const u64 (&fv)[NF > 0 ? NF : 1][kSlots], unsigned in) {
  const int qf = sp.form, qf2 = XF ? sp.form2 : -1;
  u64 v = identity(OP);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    u64 x = 0, y = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (f == qf) x = fv[f][s];
      if (XF && f == qf2) y = fv[f][s];
    }
    if ((in >> s) & 1u)
      v = combine<OP>(v, OP == OP_ANY ? (u64)r[s]
                         : OP == OP_FSUMX ? fsumx_term(x, y, sp.pow, qf2 >= 0)
                                          : x);
  }
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(kFull, v, k));
  return v;
}

// A warp's running states of one group (the sorted entry's persistent
// warps carry a group's totals over their steps and add them into device
// memory once, when the group ends).
struct Held {
  int g;                     // the group held; -1: none
  u64 spec[kMaxSpecs];
  unsigned count[kMaxCounts];
};

// Add the held states into device memory (lane 0) and hold nothing.
__device__ __forceinline__ void flush(const ChttSegArgs& a, Held& h) {
  if (h.g >= 0 && (threadIdx.x & 31) == 0) {
    for (int q = 0; q < a.n_specs; ++q)
      if (h.spec[q] != identity(a.spec[q].op))
        atomic_combine(a.spec[q].op, static_cast<u64*>(a.spec[q].acc) + h.g,
                       h.spec[q]);
    for (int c = 0; c < a.n_counts; ++c)
      if (h.count[c])
        atomicAdd(static_cast<unsigned long long*>(a.count[c].out) + h.g,
                  (unsigned long long)h.count[c]);
  }
  h.g = -1;
}

// The warp's 256 rows when they are all of group gs: every count and spec
// combined over the warp, then added by lane 0 into device memory, or,
// with `held`, into the warp's running states of gs.
template <int NF, bool XF>
__device__ __forceinline__ void reduce_one_group(
    const ChttSegArgs& a, int gs, const int (&r)[kSlots],
    const u64 (&fv)[NF > 0 ? NF : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks], Held* held) {
  auto passing = [&](int m) {
    unsigned in = (1u << kSlots) - 1u;
#pragma unroll
    for (int mm = 0; mm < kMaxMasks; ++mm)
      if (mm == m) in = mbits[mm];
    return in;
  };
  if (held != nullptr && held->g != gs) {
    flush(a, *held);
    held->g = gs;
    for (int q = 0; q < a.n_specs; ++q) held->spec[q] = identity(a.spec[q].op);
    for (int c = 0; c < a.n_counts; ++c) held->count[c] = 0;
  }
  const bool lead = (threadIdx.x & 31) == 0;
  for (int c = 0; c < a.n_counts; ++c) {
    const unsigned v =
        __reduce_add_sync(kFull, __popc(passing(a.count[c].mask)));
    if (held != nullptr) held->count[c] += v;
    else if (lead && v)
      atomicAdd(static_cast<unsigned long long*>(a.count[c].out) + gs,
                (unsigned long long)v);
  }
  for (int q = 0; q < a.n_specs; ++q) {
    const ChttSegSpec& sp = a.spec[q];
    const unsigned in = passing(sp.mask);
    u64 v = 0;
#define CHTT_ONE(OPC) v = one_group_spec<OPC, NF, XF>(sp, r, fv, in)
    switch (sp.op) {
      case OP_SUM: CHTT_ONE(OP_SUM); break;
      case OP_FSUM: CHTT_ONE(OP_FSUM); break;
      case OP_FSUMX:
        if constexpr (XF) CHTT_ONE(OP_FSUMX);
        break;
      case OP_MIN: CHTT_ONE(OP_MIN); break;
      case OP_MAX: CHTT_ONE(OP_MAX); break;
      case OP_ANY: CHTT_ONE(OP_ANY); break;
      case OP_BOR: CHTT_ONE(OP_BOR); break;
      case OP_BAND: CHTT_ONE(OP_BAND); break;
      case OP_BXOR: CHTT_ONE(OP_BXOR); break;
      default: break;
    }
#undef CHTT_ONE
    if (held != nullptr) held->spec[q] = combine_op(sp.op, held->spec[q], v);
    else if (lead && v != identity(sp.op))
      atomic_combine(sp.op, static_cast<u64*>(sp.acc) + gs, v);
  }
}

// The group holding row t (a slotted row): the last slot whose start is at
// most t, by a 32-way search of the warp over `starts` (not decreasing).
// Every lane of the warp must call it; each gets the answer.
__device__ __forceinline__ int find_group(const ChttSegArgs& a, long long t) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = a.cap_g;             // starts[lo] <= t < starts[hi]
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long idx = lo + lane * step;
    const bool ok = idx < hi && a.starts[idx] <= t;
    const unsigned b = __ballot_sync(kFull, ok);
    const int last = 31 - __clz(b);           // lane 0 holds: starts[lo] <= t
    lo = lo + last * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  return (int)lo;
}

// The element width of a ChttDtype, in bytes.
__device__ __forceinline__ int dtype_bytes(int dtype) {
  return dtype <= DT_U8 ? 1 : dtype == DT_I16 ? 2
         : (dtype == DT_I32 || dtype == DT_F32) ? 4 : 8;
}

// p holds 4 elements of `width` bytes at each multiple of 4 rows on a
// boundary their vector load needs.
__device__ __forceinline__ bool aligned4(const void* p, int width) {
  return reinterpret_cast<uintptr_t>(p) % (4 * width) == 0;
}

// Rows i .. i + 3 (i a multiple of 4, p aligned4) as stored, zero-extended,
// into raw[s0 .. s0 + 3]: one vector load (two for 8-byte types).
__device__ __forceinline__ void load_rows4(const void* p, int dtype, int i,
                                           u64 (&raw)[kSlots], int s0) {
  switch (dtype_bytes(dtype)) {
    case 1: {
      const unsigned w = *reinterpret_cast<const unsigned*>(
          static_cast<const uint8_t*>(p) + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[s0 + k] = (w >> (8 * k)) & 0xffu;
      break;
    }
    case 2: {
      const u64 w = *reinterpret_cast<const u64*>(
          static_cast<const uint16_t*>(p) + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[s0 + k] = (w >> (16 * k)) & 0xffffu;
      break;
    }
    case 4: {
      const uint4 w = *reinterpret_cast<const uint4*>(
          static_cast<const unsigned*>(p) + i);
      raw[s0] = w.x; raw[s0 + 1] = w.y; raw[s0 + 2] = w.z; raw[s0 + 3] = w.w;
      break;
    }
    default: {
      const ulonglong2* q = reinterpret_cast<const ulonglong2*>(
          static_cast<const u64*>(p) + i);
      const ulonglong2 w0 = q[0], w1 = q[1];
      raw[s0] = w0.x; raw[s0 + 1] = w0.y; raw[s0 + 2] = w1.x;
      raw[s0 + 3] = w1.y;
      break;
    }
  }
}

// Slot g's start where g is a slotted group starting before R, else R.
__device__ __forceinline__ long long start_of(const ChttSegArgs& a,
                                              long long g, long long R) {
  if (g >= a.cap_g) return R;
  const long long st = a.starts[g];
  return st < R ? st : R;
}

// The sorted entry's groups of a warp step whose first row lies in group
// gc and in which a group starts: each live row's group is gc and the
// number of groups after gc that start at or before it, those starts
// read 32 at a time into the lanes and searched with shuffles; -> the
// group holding row `end` (the next step's first row).
__device__ __forceinline__ int step_groups(const ChttSegArgs& a, int gc,
                                           long long base, long long end,
                                           long long R, int (&g)[kSlots]) {
  const int lane = threadIdx.x & 31;
  int cnt[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) cnt[s] = 0;
  int n_end = 0;
  for (long long j0 = (long long)gc + 1;; j0 += 32) {
    const long long st = start_of(a, j0 + lane, R);   // ascends with lane
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const long long i = base + 128 * (s / 4) + 4 * lane + s % 4;
      int pos = 0;                              // starts at or before i
#pragma unroll
      for (int b = 16; b >= 1; b >>= 1)
        if (__shfl_sync(kFull, st, pos + b - 1) <= i) pos += b;
      if (__shfl_sync(kFull, st, 31) <= i) pos = 32;
      cnt[s] += pos;
    }
    n_end += __popc(__ballot_sync(kFull, st <= end && st < R));
    if (!(__shfl_sync(kFull, st, 31) <= end &&
          __shfl_sync(kFull, st, 31) < R))
      break;
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (g[s] < a.cap_g) g[s] = gc + cnt[s];
  return gc + n_end;
}

// NF: forms the launch holds (at most).  XF: some spec is OP_FSUMX (its
// second form and power are read; the other launches compile without
// them).  SORTED: the sorted-order entry (no permutation, no group ids:
// each warp walks steps_per_warp steps of kWarpRows rows, row i at sorted
// position i, its groups from `starts`).  Every warp reduces on its own:
// no shared memory and no barrier.
template <int NF, bool XF, bool SORTED>
__global__ void __launch_bounds__(kThreads) k_segment_reduce(
    const __grid_constant__ ChttSegArgs a, long long steps_per_warp) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_steps = (a.n + kWarpRows - 1) / kWarpRows;
  long long step = SORTED ? gw * steps_per_warp : gw;
  const long long stop =
      SORTED ? (step + steps_per_warp < n_steps ? step + steps_per_warp
                                                : n_steps)
             : (step + 1 < n_steps ? step + 1 : n_steps);
  // the sorted entry: rows from R on have no slot; gc holds the step's
  // first row, and the group after it starts at nxt
  long long R = a.n, nxt = 0;
  int gc = 0;
  Held held;
  held.g = -1;
  if constexpr (SORTED) {
    R = a.ends[a.cap_g - 1];
    if (step >= stop || step * kWarpRows >= R) return;
    gc = find_group(a, step * kWarpRows);
    nxt = start_of(a, (long long)gc + 1, R);
  }
  for (; step < stop; ++step) {
    // phase 1: the warp's row positions and group ids; lane l holds rows
    // base + 128 c + 4 l + k in slot 4 c + k
    const long long base = step * kWarpRows;
    const long long end = base + kWarpRows < a.n ? base + kWarpRows : a.n;
    if (SORTED && base >= R) break;
    const long long live_end = end < R ? end : R;
    int g[kSlots], r[kSlots];
#pragma unroll
    for (int c = 0; c < kSlots / 4; ++c) {
      const long long i0 = base + 128 * c + 4 * lane;
      if constexpr (SORTED) {
        // rows below 2^31: 32-bit arithmetic
        const int j0 = (int)i0, le = (int)live_end, e = (int)end;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          g[4 * c + k] = j0 + k < le ? gc : a.cap_g;
          r[4 * c + k] = j0 + k < e ? j0 + k : 0;
        }
      } else if (i0 + 3 < end) {
        const int4 gv = *reinterpret_cast<const int4*>(a.gid + i0);
        g[4 * c] = gv.x; g[4 * c + 1] = gv.y;
        g[4 * c + 2] = gv.z; g[4 * c + 3] = gv.w;
        const int4 pv = *reinterpret_cast<const int4*>(a.perm + i0);
        r[4 * c] = pv.x; r[4 * c + 1] = pv.y;
        r[4 * c + 2] = pv.z; r[4 * c + 3] = pv.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const long long i = i0 + k;
          g[4 * c + k] = i < end ? a.gid[i] : a.cap_g;
          r[4 * c + k] = i < end ? a.perm[i] : 0;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      if (g[s] > a.cap_g) g[s] = a.cap_g;      // no slot: one sentinel

    // phase 2: every gather of the warp (each source once, each mask
    // once), each source's values converted once into each of its forms;
    // the sorted entry's lane reads its 4 contiguous rows with one vector
    // load where its 8 rows are all live
    const bool vec = SORTED && g[kSlots - 1] < a.cap_g;
    u64 fv[NF > 0 ? NF : 1][kSlots];
#pragma unroll
    for (int f = 0; f < (NF > 0 ? NF : 1); ++f)
#pragma unroll
      for (int s = 0; s < kSlots; ++s) fv[f][s] = 0;
    for (int d = 0; d < a.n_data; ++d) {
      const void* p = a.data[d];
      const int dt = a.dtype[d];
      u64 raw[kSlots];
      if (vec && aligned4(p, dtype_bytes(dt))) {
        load_rows4(p, dt, r[0], raw, 0);      // a lane's 4 rows contiguous
        load_rows4(p, dt, r[4], raw, 4);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          raw[s] = g[s] < a.cap_g ? load_raw(p, dt, r[s]) : 0ull;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
        if (f < a.n_forms && a.form[f].data == d)
          form_rows(raw, dt, a.form[f], fv[f]);
    }
    unsigned mbits[kMaxMasks];                // bit s: slot s passes mask m
#pragma unroll
    for (int m = 0; m < kMaxMasks; ++m) {
      mbits[m] = 0;
      if (m < a.n_masks) {
        const uint8_t* mp = a.mask[m];
        if (vec && aligned4(mp, 1)) {
          // a lane's 4 rows of a chunk: one 4-byte load, its nonzero bytes
          // packed into 4 bits by one multiply
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            unsigned w = *reinterpret_cast<const unsigned*>(mp + r[4 * c]);
            w |= w >> 4;
            w |= w >> 2;
            w |= w >> 1;
            mbits[m] |= (((w & 0x01010101u) * 0x01020408u) >> 24) << (4 * c);
          }
        } else {
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (g[s] < a.cap_g && mp[r[s]]) mbits[m] |= 1u << s;
        }
      }
    }

    // the sorted entry's groups: the step's rows are all in gc unless the
    // next group starts before its end
    if constexpr (SORTED) {
      if (nxt < live_end) {
        gc = step_groups(a, gc, base, end, R, g);
        nxt = start_of(a, (long long)gc + 1, R);
      } else if (nxt == end) {
        gc += 1;
        nxt = start_of(a, (long long)gc + 1, R);
      }
    }

    // phase 3: the reductions: one warp reduction where the warp's rows
    // are all of one group, else a 128-row chunk of the warp at a time
    static_assert(kSlots == 8, "two chunks of four row slots");
    const int g_first = __shfl_sync(kFull, g[0], 0);
    bool same_group = g_first < a.cap_g;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) same_group = same_group && g[s] == g_first;
    if (__all_sync(kFull, same_group)) {
      reduce_one_group<NF, XF>(a, g_first, r, fv, mbits,
                               SORTED ? &held : nullptr);
    } else {
      reduce_chunk<NF, 0, XF>(a, g, r, fv, mbits);
      reduce_chunk<NF, 4, XF>(a, g, r, fv, mbits);
    }
  }
  if constexpr (SORTED) flush(a, held);
}

template <int NF, bool XF, bool SORTED>
int launch(const ChttSegArgs& a, cudaStream_t s) {
  const long long steps = (a.n + kWarpRows - 1) / kWarpRows;
  auto* kernel = k_segment_reduce<NF, XF, SORTED>;
  long long warps = steps, per_warp = 1;
  if (SORTED) {
    // persistent warps, as many as the card holds at once, each over a
    // contiguous run of steps
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const long long slots =
        (long long)sms * (per_sm > 0 ? per_sm : 1) * kWarps;
    per_warp = (steps + slots - 1) / slots;
    warps = (steps + per_warp - 1) / per_warp;
  }
  const long long blocks = (warps + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a, per_warp);
  return chtt_last_error();
}

template <bool SORTED>
int dispatch(const ChttSegArgs& a, bool xf, cudaStream_t s) {
  if (a.n_forms == 0) return launch<0, false, SORTED>(a, s);
  if (a.n_forms == 1)
    return xf ? launch<1, true, SORTED>(a, s) : launch<1, false, SORTED>(a, s);
  if (a.n_forms == 2)
    return xf ? launch<2, true, SORTED>(a, s) : launch<2, false, SORTED>(a, s);
  return xf ? launch<4, true, SORTED>(a, s) : launch<4, false, SORTED>(a, s);
}

}  // namespace

// Reduce n key-sorted rows into cap_g group slots: every spec and count of
// *args in one launch.  Each spec's acc holds its op's identity and each
// count's out zeros on entry.  With perm given (the permuted entry) each
// sorted row's group id is gid[i]; perm and gid start on 16-byte
// boundaries.  With perm null (the sorted-order entry) row i of the data
// and masks is sorted position i and the groups are starts/ends (K5's): no
// permutation and no group id is read, the reads are contiguous, and
// `any` keeps the smallest sorted position.
extern "C" int chtt_segment_reduce(const ChttSegArgs* args, void* stream) {
  const ChttSegArgs& a = *args;
  const bool sorted = a.perm == nullptr;
  if (a.n < 1 || a.n >= (1ll << 31) || a.cap_g < 1 || a.n_specs < 0 ||
      a.n_specs > kMaxSpecs || a.n_data < 0 || a.n_data > kMaxData ||
      a.n_forms < 0 || a.n_forms > kMaxForms ||
      a.n_masks < 0 || a.n_masks > kMaxMasks || a.n_counts < 0 ||
      a.n_counts > kMaxCounts || a.n_specs + a.n_counts == 0 ||
      (sorted ? (a.starts == nullptr || a.ends == nullptr)
              : (a.gid == nullptr ||
                 reinterpret_cast<uintptr_t>(a.perm) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(a.gid) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < a.n_forms; ++f) {
    const ChttSegForm& fm = a.form[f];
    if (fm.data < 0 || fm.data >= a.n_data || fm.kind < FORM_INT ||
        fm.kind > FORM_DBL || fm.term < TERM_NONE || fm.term > TERM_MOD)
      return (int)cudaErrorInvalidValue;
    const int dt = a.dtype[fm.data];
    if (fm.term != TERM_NONE &&
        (fm.c == 0 || fm.c == -1 ||
         (dt != DT_I8 && dt != DT_I16 && dt != DT_I32)))
      return (int)cudaErrorInvalidValue;
  }
  bool xf = false;
  for (int q = 0; q < a.n_specs; ++q) {
    const ChttSegSpec& sp = a.spec[q];
    xf = xf || sp.op == OP_FSUMX;
    if (sp.acc == nullptr || sp.form < -1 || sp.form >= a.n_forms ||
        (sp.form < 0 && sp.op != OP_ANY) ||
        sp.mask < -1 || sp.mask >= a.n_masks || sp.op < OP_SUM ||
        sp.op > OP_FSUMX || sp.op == 7 ||
        (sp.op == OP_FSUMX &&
         (sp.pow < 1 || sp.pow > 4 || sp.form2 < -1 ||
          sp.form2 >= a.n_forms)))
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a.n_counts; ++c)
    if (a.count[c].out == nullptr || a.count[c].mask < -1 ||
        a.count[c].mask >= a.n_masks)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return sorted ? dispatch<true>(a, xf, s) : dispatch<false>(a, xf, s);
}
