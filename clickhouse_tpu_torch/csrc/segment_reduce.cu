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
// where mask slot `mask` holds (-1: every row of a group).
struct ChttSegSpec {
  int op;
  int data;
  int mask;
  int uns;                   // int64 data holds UInt64 bits
  void* acc;                 // cap_g u64 states (double bits for OP_FSUM)
};

// One masked-in row count: of mask slot `mask` (-1: every row).
struct ChttSegCount {
  int mask;
  int pad;
  void* out;                 // cap_g u64 counts
};

struct ChttSegArgs {
  const int* perm;           // sorted position -> raw row
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
};

__device__ __forceinline__ u64 identity(int op) {
  return (op == OP_MIN || op == OP_ANY || op == OP_BAND) ? ~0ull : 0ull;
}

template <int OP> __device__ __forceinline__ u64 combine(u64 a, u64 b) {
  switch (OP) {
    case OP_SUM: return a + b;
    case OP_FSUM:
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
    case OP_FSUM:
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

// Reduce K rows a lane (bit k of `in`: row k is masked in) of op OP over
// the warp's runs of equal group id (bit k of `same`: the lane 2^k above
// has this lane's group; the K rows of a lane share its group) and add
// each run into its shared slot (`write`: this lane heads a run with a
// slot).
template <int OP, int K>
__device__ __forceinline__ void reduce_rows(const u64 (&x)[K],
                                            const int (&r)[K], unsigned in,
                                            int dtype, int uns, unsigned same,
                                            bool write, u64* slot) {
  u64 v = identity(OP);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((in >> k) & 1u) v = combine<OP>(v, contribution<OP>(x[k], dtype, uns,
                                                            r[k]));
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const u64 v2 = __shfl_down_sync(kFull, v, 1 << k);
    if ((same >> k) & 1u) v = combine<OP>(v, v2);
  }
  if (write && v != identity(OP)) atomic_combine(OP, slot, v);
}

template <int K>
__device__ __forceinline__ void reduce_op(int op, const u64 (&x)[K],
                                          const int (&r)[K], unsigned in,
                                          int dtype, int uns, unsigned same,
                                          bool write, u64* slot) {
  switch (op) {
    case OP_SUM:
      reduce_rows<OP_SUM, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_FSUM:
      reduce_rows<OP_FSUM, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_MIN:
      reduce_rows<OP_MIN, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_MAX:
      reduce_rows<OP_MAX, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_ANY:
      reduce_rows<OP_ANY, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_BOR:
      reduce_rows<OP_BOR, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_BAND:
      reduce_rows<OP_BAND, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    case OP_BXOR:
      reduce_rows<OP_BXOR, K>(x, r, in, dtype, uns, same, write, slot);
      break;
    default: break;
  }
}

// What the reductions of one kernel instance read: the specs and counts
// (in shared memory) and the states they add into.
struct Reductions {
  const int* op;
  const int* data;
  const int* mask;
  const int* uns;
  const int* dtype;
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
template <int NDATA, int S0, int K>
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
    const int qd = R.data[q];
    u64 x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = 0;
#pragma unroll
      for (int d = 0; d < NDATA; ++d)
        if (d == qd) x[k] = raw[d][S0 + k];
    }
    reduce_op<K>(R.op[q], x, rr, passing(R.mask[q]), R.dtype[q], R.uns[q],
                 same, write, &R.acc[q * kTile + l]);
  }
}

// Row slots S0 .. S0 + 3 (one 128-row chunk of the warp): where every
// lane's four rows share its group, one segmented reduction for all four
// rows; else one a row slot.
template <int NDATA, int S0>
__device__ __forceinline__ void reduce_chunk(
    const Reductions& R, const int (&g)[kSlots], const int (&r)[kSlots],
    const u64 (&raw)[NDATA > 0 ? NDATA : 1][kSlots],
    const unsigned (&mbits)[kMaxMasks]) {
  if (__all_sync(kFull, g[S0] == g[S0 + 3])) {
    reduce_lane_rows<NDATA, S0, 4>(R, g[S0], r, raw, mbits);
  } else {
    reduce_lane_rows<NDATA, S0, 1>(R, g[S0], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 1, 1>(R, g[S0 + 1], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 2, 1>(R, g[S0 + 2], r, raw, mbits);
    reduce_lane_rows<NDATA, S0 + 3, 1>(R, g[S0 + 3], r, raw, mbits);
  }
}

template <int NDATA>
__global__ void __launch_bounds__(kThreads) k_segment_reduce(
    const __grid_constant__ ChttSegArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* s_acc = reinterpret_cast<u64*>(smem);              // [spec][kTile]
  unsigned* s_cnt =
      reinterpret_cast<unsigned*>(s_acc + a.n_specs * kTile);  // [count][kTile]
  // each spec's op, column slot, mask slot and signedness, and each
  // count's mask slot, read once from the arguments
  __shared__ int s_op[kMaxSpecs], s_data[kMaxSpecs], s_mask[kMaxSpecs],
      s_uns[kMaxSpecs], s_dtype[kMaxSpecs], s_cmask[kMaxCounts];
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
      const int4 pv = *reinterpret_cast<const int4*>(a.perm + i0);
      g[4 * c] = gv.x; g[4 * c + 1] = gv.y;
      g[4 * c + 2] = gv.z; g[4 * c + 3] = gv.w;
      r[4 * c] = pv.x; r[4 * c + 1] = pv.y;
      r[4 * c + 2] = pv.z; r[4 * c + 3] = pv.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = i0 + k;
        g[4 * c + k] = i < tile_end ? a.gid[i] : a.cap_g;
        r[4 * c + k] = i < tile_end ? a.perm[i] : 0;
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
  const Reductions R{s_op, s_data, s_mask, s_uns, s_dtype, s_cmask,
                     a.n_specs, a.n_counts, a.cap_g, g0, s_acc, s_cnt};
  static_assert(kSlots == 8, "two chunks of four row slots");
  reduce_chunk<NDATA, 0>(R, g, r, raw, mbits);
  reduce_chunk<NDATA, 4>(R, g, r, raw, mbits);
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

template <int NDATA>
int launch(const ChttSegArgs& a, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * (8 * a.n_specs + 4 * a.n_counts);
  cudaError_t e = cudaFuncSetAttribute(
      k_segment_reduce<NDATA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_segment_reduce<NDATA><<<(unsigned)tiles, kThreads, smem, s>>>(a);
  return chtt_last_error();
}

}  // namespace

// Reduce n key-sorted rows into cap_g group slots: every spec and count of
// *args in one launch.  Each spec's acc holds its op's identity and each
// count's out zeros on entry; perm and gid start on 16-byte boundaries.
extern "C" int chtt_segment_reduce(const ChttSegArgs* args, void* stream) {
  const ChttSegArgs& a = *args;
  if (a.n < 1 || a.n >= (1ll << 31) || a.cap_g < 1 || a.n_specs < 0 ||
      a.n_specs > kMaxSpecs || a.n_data < 0 || a.n_data > kMaxData ||
      a.n_masks < 0 || a.n_masks > kMaxMasks || a.n_counts < 0 ||
      a.n_counts > kMaxCounts || a.n_specs + a.n_counts == 0 ||
      reinterpret_cast<uintptr_t>(a.perm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.gid) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < a.n_specs; ++q) {
    const ChttSegSpec& sp = a.spec[q];
    if (sp.acc == nullptr || sp.data < -1 || sp.data >= a.n_data ||
        (sp.data < 0 && sp.op != OP_ANY) ||
        sp.mask < -1 || sp.mask >= a.n_masks || sp.op < OP_SUM ||
        sp.op > OP_FSUM || sp.op == 7)
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a.n_counts; ++c)
    if (a.count[c].out == nullptr || a.count[c].mask < -1 ||
        a.count[c].mask >= a.n_masks)
      return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.n_data) {
    case 0: return launch<0>(a, s);
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    default: return launch<4>(a, s);
  }
}
