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
// Bound on the card: bytes.  Each sorted row reads its group id and
// permutation entry (4 bytes each), each distinct column's value and each
// distinct mask byte once; each group slot writes each op's state (8
// bytes) and each count kept (8 more: min, max, any and band tell a group
// without a masked-in row by its count; over the grouping's own rows that
// count is ends - starts and no count is written).  The value and mask
// reads are gathers: 32-byte sectors for 1-8 useful bytes where the
// groups' rows lie far apart in the table, and they dominate.
// Design:
//   * one launch takes up to kMaxSpecs reductions over up to kMaxData
//     columns and kMaxMasks masks (the wrapper splits longer lists): each
//     row's group id and permutation entry are read once for all of them,
//     each column gathered once and each mask byte read once;
//   * a block takes a fixed tile of 2,048 sorted rows, whatever the groups:
//     no group is given to one warp or block, so a group holding 40 % of
//     the rows spreads over every SM;
//   * memory-level parallelism: a warp first loads all 256 of its group ids
//     and permutation entries (16-byte loads: a lane holds runs of 4
//     rows), then issues all of its gathers, and only then reduces; the
//     lanes reduce the runs of equal group id with a segmented shuffle
//     reduction (ids ascend with the lane, so a run is a range of lanes),
//     one for a 128-row chunk where each lane's 4 rows share a group, else
//     one a row slot, and each run's first lane adds the run into the
//     tile's shared slot of that group (group id less the tile's first id:
//     a tile holds at most 2,048 groups), one slot array an op;
//   * at the end the block writes each group that lies wholly inside the
//     tile with plain stores; only the tile's first and last groups, which
//     other tiles may share, are combined into device memory with atomics
//     (u64 add, which wraps; min/max on u64 order keys; min on the row id
//     for `any`; double add for float sums, whose order then varies from
//     run to run).  The wrapper fills the outputs with each op's identity
//     first;
//   * a float sum of x^p (p 1-4) or of x * y (OP_FSUMX: the variance
//     family's, the covariance's and the moments' terms) is formed in
//     registers from the columns as stored, so those aggregates read
//     their arguments' narrow storage like any other reduction and no
//     float64 column of their terms is built;
//   * the sorted-order entry (perm null; reference agg_ops.py:109,
//     Grouping.reduce_sorted) takes data and masks that are already in
//     sorted order, as the holistic aggregates make them (uniqExact's
//     first-occurrence flags, argMin's rows at the best token): the same
//     body with row i read at i, so no permutation is read and no gather
//     is made;
//   * min/max compare order keys (sort_ops.order_value: signed ints with
//     the sign bit flipped, floats as their tokens: -0.0 below +0.0, a
//     positive NaN above every number, a negative NaN below), as the
//     reference's sort by order token does; `any` keeps the smallest row
//     id among the masked-in rows (the rows of a group are in row order).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W power
// limit, at Q2m's inputs (100M sorted rows, x's int32 storage, 4,194,304
// group slots): sum, min, max and any in one launch 4.35 ms, against
// 10.0 ms for the four launches of the first version (one an op).
#include "common.cuh"

constexpr int kMaxSpecs = 8;       // reductions a launch
constexpr int kMaxData = 4;        // distinct columns a launch
constexpr int kMaxMasks = 4;       // distinct masks a launch
constexpr int kMaxCounts = kMaxMasks + 1;

// One reduction: op (SegOp) of column `data` (a slot of ChttSegArgs.data;
// -1 for `any`, which keeps a row id and reads no value) over the rows
// where mask slot `mask` holds (-1: every row of a group).  OP_FSUMX sums
// a term formed in registers from the columns as stored: the value of
// `data` in double raised to `pow` (1-4), times the value of column
// `data2` where data2 >= 0.
struct ChttSegSpec {
  int op;
  int data;
  int mask;
  int uns;                   // int64 data holds UInt64 bits
  int data2;                 // OP_FSUMX's second column, or -1
  int pow;                   // OP_FSUMX's power of `data`
  int uns2;                  // int64 data2 holds UInt64 bits
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
  const int* perm;           // sorted position -> raw row; null: the data
                             // and masks are in sorted order (row i is i)
  const int* gid;            // sorted order; >= cap_g: no slot
  long long n;
  int cap_g;
  int n_specs;
  int n_data;
  int n_masks;
  int n_counts;
  int pad;
  const void* data[kMaxData];          // raw row order
  int dtype[kMaxData];                 // ChttDtype of each column
  const uint8_t* mask[kMaxMasks];      // raw row order
  ChttSegCount count[kMaxCounts];
  ChttSegSpec spec[kMaxSpecs];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                   // rows a block
constexpr int kWarpRows = kTile / kWarps;     // 256 rows a warp
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

// The row's contribution from its stored bits: bits for integer ops
// (sign- or zero-extended), double bits for OP_FSUM, an order key for
// min/max, the row id for `any`.
template <int OP>
__device__ __forceinline__ u64 contribution(u64 raw, int dtype, int uns,
                                            int r) {
  if (OP == OP_ANY) return (u64)r;
  u64 bits = 0;
  double f = 0.0;
  bool is_float = false, is_signed = false;
  switch (dtype) {
    case DT_BOOL: bits = raw != 0; break;
    case DT_U8: bits = raw; break;
    case DT_I8: bits = (u64)(long long)(int8_t)raw; is_signed = true; break;
    case DT_I16:
      bits = (u64)(long long)(int16_t)raw;
      is_signed = true;
      break;
    case DT_I32: bits = (u64)(long long)(int)raw; is_signed = true; break;
    case DT_I64: bits = raw; is_signed = !uns; break;
    case DT_F32: {
      const unsigned b = (unsigned)raw;
      if (OP == OP_MIN || OP == OP_MAX)
        // the f32 token (hash_ops.f32_token): total-order bits, high half
        return (u64)((b >> 31) ? ~b : (b | 0x80000000u)) << 32;
      f = (double)__uint_as_float(b);
      is_float = true;
      break;
    }
    case DT_F64:
      f = __longlong_as_double((long long)raw);
      is_float = true;
      break;
    default: break;
  }
  if (OP == OP_FSUM) return (u64)__double_as_longlong(f);
  if (OP == OP_MIN || OP == OP_MAX) {
    if (is_float) return f64_order_key(f);
    return is_signed ? bits ^ CHTT_SIGN : bits;
  }
  return bits;
}

// A stored value as a double (UInt64 bits read unsigned).
__device__ __forceinline__ double to_double(u64 raw, int dtype, int uns) {
  switch (dtype) {
    case DT_BOOL: return raw != 0 ? 1.0 : 0.0;
    case DT_U8: return (double)(unsigned)raw;
    case DT_I8: return (double)(int8_t)raw;
    case DT_I16: return (double)(int16_t)raw;
    case DT_I32: return (double)(int)raw;
    case DT_I64: return uns ? (double)raw : (double)(long long)raw;
    case DT_F32: return (double)__uint_as_float((unsigned)raw);
    default: return __longlong_as_double((long long)raw);
  }
}

// OP_FSUMX's second column and power, as a spec states them.
struct Xform {
  int dtype2;                // ChttDtype of the second column; -1: none
  int uns2;
  int pow;                   // 1-4
};

// OP_FSUMX's term: x^pow (x*x, (x*x)*x, (x*x)*(x*x), as the plain
// version multiplies), times y where there is a second column.
__device__ __forceinline__ u64 fsumx_term(u64 x, int dtype, int uns, u64 y,
                                          const Xform& xf) {
  const double a = to_double(x, dtype, uns);
  const double a2 = a * a;
  double t = xf.pow == 1 ? a : xf.pow == 2 ? a2 : xf.pow == 3 ? a2 * a
                                                              : a2 * a2;
  if (xf.dtype2 >= 0) t = t * to_double(y, xf.dtype2, xf.uns2);
  return (u64)__double_as_longlong(t);
}

// Reduce K rows a lane (bit k of `in`: row k is masked in) of op OP over
// the warp's runs of equal group id (bit k of `same`: the lane 2^k above
// has this lane's group; the K rows of a lane share its group) and add
// each run into its shared slot (`write`: this lane heads a run with a
// slot).  y and xf: OP_FSUMX's second column and power.
template <int OP, int K>
__device__ __forceinline__ void reduce_rows(const u64 (&x)[K],
                                            const u64 (&y)[K],
                                            const int (&r)[K], unsigned in,
                                            int dtype, int uns,
                                            const Xform& xf, unsigned same,
                                            bool write, u64* slot) {
  u64 v = identity(OP);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((in >> k) & 1u)
      v = combine<OP>(v, OP == OP_FSUMX
                             ? fsumx_term(x[k], dtype, uns, y[k], xf)
                             : contribution<OP>(x[k], dtype, uns, r[k]));
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
                                          int dtype, int uns,
                                          const Xform& xf, unsigned same,
                                          bool write, u64* slot) {
#define CHTT_REDUCE(OPC) \
  reduce_rows<OPC, K>(x, y, r, in, dtype, uns, xf, same, write, slot)
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

// What the reductions of one kernel instance read: the specs and counts
// (in shared memory) and the states they add into.
struct Reductions {
  const int* op;
  const int* data;
  const int* mask;
  const int* uns;
  const int* dtype;
  const int* data2;          // OP_FSUMX: second column slot, power,
  const int* pow;            // its signedness and type (-1: none)
  const int* uns2;
  const int* dtype2;
  const int* cmask;
  int n_specs;
  int n_counts;
  int cap_g;
  int g0;
  u64* acc;                  // [spec][kTile]
  unsigned* cnt;             // [count][kTile]
};

// Rows S0 .. S0 + K - 1 of each lane, which share the lane's group gs:
// every count and spec.  Every lane of the warp must call it.
template <int NDATA, int S0, int K, bool XF>
__device__ __forceinline__ void reduce_lane_rows(
    const Reductions& R, int gs, const int (&r)[kSlots],
    const u64 (&raw)[NDATA > 0 ? NDATA : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks]) {
  const int lane = threadIdx.x & 31;
  const bool live = gs < R.cap_g;
  unsigned same = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int g2 = __shfl_down_sync(kFull, gs, 1 << k);
    if (lane + (1 << k) < 32 && g2 == gs) same |= 1u << k;
  }
  // every lane takes part in the shuffle (lane 0's result is unused)
  const int prev = __shfl_up_sync(kFull, gs, 1);
  const bool write = (lane == 0 || prev != gs) && live;
  const int l = gs - R.g0;
  constexpr unsigned kRowsMask = (1u << K) - 1u;
  // the rows that pass mask slot m (-1: every live row)
  auto passing = [&](int m) {
    unsigned in = live ? kRowsMask : 0u;
#pragma unroll
    for (int mm = 0; mm < kMaxMasks; ++mm)
      if (mm == m) in = (mbits[mm] >> S0) & kRowsMask;
    return in;
  };
  for (int c = 0; c < R.n_counts; ++c) {
    unsigned v = __popc(passing(R.cmask[c]));
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const unsigned v2 = __shfl_down_sync(kFull, v, 1 << k);
      if ((same >> k) & 1u) v += v2;
    }
    if (write && v) atomicAdd(&R.cnt[c * kTile + l], v);
  }
  int rr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rr[k] = r[S0 + k];
  for (int q = 0; q < R.n_specs; ++q) {
    const int qd = R.data[q], qd2 = XF ? R.data2[q] : -1;
    u64 x[K], y[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = 0;
      y[k] = 0;
#pragma unroll
      for (int d = 0; d < NDATA; ++d) {
        if (d == qd) x[k] = raw[d][S0 + k];
        if (XF && d == qd2) y[k] = raw[d][S0 + k];
      }
    }
    const Xform xf = XF ? Xform{R.dtype2[q], R.uns2[q], R.pow[q]}
                        : Xform{-1, 0, 1};
    reduce_op<K, XF>(R.op[q], x, y, rr, passing(R.mask[q]), R.dtype[q],
                     R.uns[q], xf, same, write, &R.acc[q * kTile + l]);
  }
}

// Row slots S0 .. S0 + 3 (one 128-row chunk of the warp): where every
// lane's four rows share its group, one segmented reduction for all four
// rows; else one a row slot.
template <int NDATA, int S0, bool XF>
__device__ __forceinline__ void reduce_chunk(
    const Reductions& R, const int (&g)[kSlots], const int (&r)[kSlots],
    const u64 (&raw)[NDATA > 0 ? NDATA : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks]) {
  if (__all_sync(kFull, g[S0] == g[S0 + 3])) {
    reduce_lane_rows<NDATA, S0, 4, XF>(R, g[S0], r, raw, mbits);
  } else {
    reduce_lane_rows<NDATA, S0, 1, XF>(R, g[S0], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 1, 1, XF>(R, g[S0 + 1], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 2, 1, XF>(R, g[S0 + 2], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 3, 1, XF>(R, g[S0 + 3], r, raw, mbits);
  }
}

// XF: some spec is OP_FSUMX (its second column and power are read; the
// other launches compile without them).  SORTED: the sorted-order entry
// (no permutation: row i is sorted position i).
template <int NDATA, bool XF, bool SORTED>
__global__ void __launch_bounds__(kThreads) k_segment_reduce(
    const __grid_constant__ ChttSegArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_acc = reinterpret_cast<u64*>(smem);              // [spec][kTile]
  unsigned* s_cnt =
      reinterpret_cast<unsigned*>(s_acc + a.n_specs * kTile);  // [count][kTile]
  // each spec's op, column slot, mask slot and signedness, and each
  // count's mask slot, read once from the arguments
  __shared__ int s_op[kMaxSpecs], s_data[kMaxSpecs], s_mask[kMaxSpecs],
      s_uns[kMaxSpecs], s_dtype[kMaxSpecs], s_data2[kMaxSpecs],
      s_pow[kMaxSpecs], s_uns2[kMaxSpecs], s_dtype2[kMaxSpecs],
      s_cmask[kMaxCounts];
  __shared__ int s_last;
  const long long tile_start = (long long)blockIdx.x * kTile;
  const long long tile_end =
      tile_start + kTile < a.n ? tile_start + kTile : a.n;
  const int g0 = a.gid[tile_start];
  if (g0 >= a.cap_g) return;                  // no row of a group slot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_last = g0;
  if (threadIdx.x < a.n_specs) {
    const int q = threadIdx.x;
    s_op[q] = a.spec[q].op;
    s_data[q] = a.spec[q].data;
    s_mask[q] = a.spec[q].mask;
    s_uns[q] = a.spec[q].uns;
    s_dtype[q] = a.spec[q].data < 0 ? 0 : a.dtype[a.spec[q].data];
    const bool x2 = a.spec[q].op == OP_FSUMX && a.spec[q].data2 >= 0;
    s_data2[q] = x2 ? a.spec[q].data2 : -1;
    s_dtype2[q] = x2 ? a.dtype[a.spec[q].data2] : -1;
    s_uns2[q] = a.spec[q].uns2;
    s_pow[q] = a.spec[q].pow;
  }
  if (threadIdx.x < a.n_counts) s_cmask[threadIdx.x] = a.count[threadIdx.x].mask;

  // phase 1: the warp's group ids and permutation entries; lane l holds
  // rows base + 128 c + 4 l + k in slot 4 c + k
  const long long base = tile_start + (long long)warp * kWarpRows;
  int g[kSlots], r[kSlots];
#pragma unroll
  for (int c = 0; c < kSlots / 4; ++c) {
    const long long i0 = base + 128 * c + 4 * lane;
    if (i0 + 3 < tile_end) {
      const int4 gv = *reinterpret_cast<const int4*>(a.gid + i0);
      g[4 * c] = gv.x; g[4 * c + 1] = gv.y;
      g[4 * c + 2] = gv.z; g[4 * c + 3] = gv.w;
      if constexpr (!SORTED) {
        const int4 pv = *reinterpret_cast<const int4*>(a.perm + i0);
        r[4 * c] = pv.x; r[4 * c + 1] = pv.y;
        r[4 * c + 2] = pv.z; r[4 * c + 3] = pv.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) r[4 * c + k] = (int)(i0 + k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = i0 + k;
        g[4 * c + k] = i < tile_end ? a.gid[i] : a.cap_g;
        r[4 * c + k] = i >= tile_end ? 0 : SORTED ? (int)i : a.perm[i];
      }
    }
  }
  int last = g0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (g[s] >= a.cap_g) g[s] = a.cap_g;     // no slot: one sentinel
    else last = g[s] > last ? g[s] : last;
  }
  __syncthreads();                            // s_last set
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) atomicMax(&s_last, last);

  // phase 2: every gather of the warp (each column once, each mask once)
  u64 raw[NDATA > 0 ? NDATA : 1][kSlots];
#pragma unroll
  for (int d = 0; d < NDATA; ++d) {
    const void* p = a.data[d];
    const int dt = a.dtype[d];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      raw[d][s] = g[s] < a.cap_g ? load_raw(p, dt, r[s]) : 0ull;
  }
  unsigned mbits[kMaxMasks];                  // bit s: slot s passes mask m
#pragma unroll
  for (int m = 0; m < kMaxMasks; ++m) {
    mbits[m] = 0;
    if (m < a.n_masks) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (g[s] < a.cap_g && a.mask[m][r[s]]) mbits[m] |= 1u << s;
    }
  }
  __syncthreads();                            // s_last final
  const int nloc = s_last - g0 + 1;
  for (int q = 0; q < a.n_specs; ++q) {
    const u64 id = identity(s_op[q]);
    for (int l = threadIdx.x; l < nloc; l += kThreads)
      s_acc[q * kTile + l] = id;
  }
  for (int c = 0; c < a.n_counts; ++c)
    for (int l = threadIdx.x; l < nloc; l += kThreads) s_cnt[c * kTile + l] = 0;
  __syncthreads();

  // phase 3: the reductions, a 128-row chunk of the warp at a time
  const Reductions R{s_op,    s_data,   s_mask,    s_uns,
                     s_dtype, s_data2,  s_pow,     s_uns2,
                     s_dtype2, s_cmask, a.n_specs, a.n_counts,
                     a.cap_g, g0,       s_acc,     s_cnt};
  static_assert(kSlots == 8, "two chunks of four row slots");
  reduce_chunk<NDATA, 0, XF>(R, g, r, raw, mbits);
  reduce_chunk<NDATA, 4, XF>(R, g, r, raw, mbits);
  __syncthreads();

  // the first and last groups of the tile may have rows in other tiles
  const int g_end = g0 + nloc - 1;
  const bool left_cut = tile_start > 0 && a.gid[tile_start - 1] == g0;
  const bool right_cut = tile_end < a.n && a.gid[tile_end] == g_end;
  for (int l = threadIdx.x; l < nloc; l += kThreads) {
    const int gg = g0 + l;
    const bool cut = (l == 0 && left_cut) || (l == nloc - 1 && right_cut);
    for (int q = 0; q < a.n_specs; ++q) {
      u64* out = static_cast<u64*>(a.spec[q].acc) + gg;
      const u64 v = s_acc[q * kTile + l];
      if (!cut) *out = v;
      else if (v != identity(s_op[q])) atomic_combine(s_op[q], out, v);
    }
    for (int c = 0; c < a.n_counts; ++c) {
      u64* out = static_cast<u64*>(a.count[c].out) + gg;
      const unsigned v = s_cnt[c * kTile + l];
      if (!cut) *out = v;
      else if (v) atomicAdd(reinterpret_cast<unsigned long long*>(out),
                            (unsigned long long)v);
    }
  }
}

template <int NDATA, bool XF, bool SORTED>
int launch(const ChttSegArgs& a, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * (8 * a.n_specs + 4 * a.n_counts);
  cudaError_t e = cudaFuncSetAttribute(
      k_segment_reduce<NDATA, XF, SORTED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_segment_reduce<NDATA, XF, SORTED>
      <<<(unsigned)tiles, kThreads, smem, s>>>(a);
  return chtt_last_error();
}

template <bool SORTED>
int dispatch(const ChttSegArgs& a, bool xf, cudaStream_t s) {
  switch (a.n_data) {
    case 0: return launch<0, false, SORTED>(a, s);
    case 1: return xf ? launch<1, true, SORTED>(a, s)
                      : launch<1, false, SORTED>(a, s);
    case 2: return xf ? launch<2, true, SORTED>(a, s)
                      : launch<2, false, SORTED>(a, s);
    case 3: return xf ? launch<3, true, SORTED>(a, s)
                      : launch<3, false, SORTED>(a, s);
    default: return xf ? launch<4, true, SORTED>(a, s)
                       : launch<4, false, SORTED>(a, s);
  }
}

}  // namespace

// Reduce n key-sorted rows into cap_g group slots: every spec and count of
// *args in one launch.  Each spec's acc holds its op's identity and each
// count's out zeros on entry; perm (where given) and gid start on 16-byte
// boundaries.  With perm null (the sorted-order entry) row i of the data
// and masks is sorted position i: no permutation is read, the reads are
// contiguous, and `any` keeps the smallest sorted position.
extern "C" int chtt_segment_reduce(const ChttSegArgs* args, void* stream) {
  const ChttSegArgs& a = *args;
  if (a.n < 1 || a.n >= (1ll << 31) || a.cap_g < 1 || a.n_specs < 0 ||
      a.n_specs > kMaxSpecs || a.n_data < 0 || a.n_data > kMaxData ||
      a.n_masks < 0 || a.n_masks > kMaxMasks || a.n_counts < 0 ||
      a.n_counts > kMaxCounts || a.n_specs + a.n_counts == 0 ||
      reinterpret_cast<uintptr_t>(a.perm) % 16 != 0 ||  // null passes
      reinterpret_cast<uintptr_t>(a.gid) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  bool xf = false;
  for (int q = 0; q < a.n_specs; ++q) {
    const ChttSegSpec& sp = a.spec[q];
    xf = xf || sp.op == OP_FSUMX;
    if (sp.acc == nullptr || sp.data < -1 || sp.data >= a.n_data ||
        (sp.data < 0 && sp.op != OP_ANY) ||
        sp.mask < -1 || sp.mask >= a.n_masks || sp.op < OP_SUM ||
        sp.op > OP_FSUMX || sp.op == 7 ||
        (sp.op == OP_FSUMX &&
         (sp.pow < 1 || sp.pow > 4 || sp.data2 < -1 || sp.data2 >= a.n_data)))
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a.n_counts; ++c)
    if (a.count[c].out == nullptr || a.count[c].mask < -1 ||
        a.count[c].mask >= a.n_masks)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a.perm != nullptr ? dispatch<false>(a, xf, s)
                           : dispatch<true>(a, xf, s);
}
