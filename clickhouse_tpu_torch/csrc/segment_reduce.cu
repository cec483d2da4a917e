// K6: per-group sum, min, max, any, bit ops and masked count over
// key-sorted rows.
//
// Replaces the reference's seg_reduce_sorted and _masked_counts
// (clickhouse_tpu/ops/scan_ops.py:147 and :286) and the Grouping.take that
// feeds them (clickhouse_tpu/ops/agg_ops.py:65).  On the TPU, sums were
// differences of prefix sums over all rows, min/max/any an extra sort of
// (group, order token) pairs, and take an inverse-permutation sort, all to
// avoid scatter.  Here the kernel walks the sorted rows, reads each row's
// value and mask through the permutation itself (data[perm[i]]: a gather
// from the column's narrow storage), and reduces each group directly.
//
// Bound on the card: bytes.  Each sorted row reads its group id and
// permutation entry (4 bytes each), its value (the storage's width) and
// its mask byte once; each group slot writes its state (8 bytes) and,
// where the op needs it, its masked-in row count (8 more: min, max, any
// and band tell a group without a masked-in row by it; a sum and bor/bxor
// need none, their identity being that group's value).  The value and
// mask reads are gathers, 32-byte sectors for 1-8 useful bytes where the
// groups' rows lie far apart in the table.
// Design:
//   * a block takes a fixed tile of 2,048 sorted rows, whatever the groups:
//     no group is given to one warp or block, so a group holding 40 % of
//     the rows spreads over every SM;
//   * each warp walks 256 consecutive rows 32 at a time (coalesced group
//     id and permutation loads); the lanes of a step reduce the runs of
//     equal group id with a segmented shuffle reduction (the ids are
//     sorted, so a run is a range of lanes), and each run's first lane adds
//     the run into the tile's shared slot of that group (group id less the
//     tile's first id: a tile holds at most 2,048 groups);
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
//     id among the masked-in rows (the rows of a group are in row order);
//   * one kernel instance an op; the value's type is a uniform switch a
//     row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 8;                     // 32-row steps a warp a tile
constexpr int kWarpRows = 32 * kSteps;
constexpr int kTile = kWarps * kWarpRows;     // 2,048 rows
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
  OP_COUNT = 7,    // masked-in rows only
  OP_FSUM = 8,     // float sum in double
};

struct SegArgs {
  const void* data;          // raw row order
  const uint8_t* mask;       // raw row order; NULL = every row
  const int* perm;           // sorted position -> raw row
  const int* gid;            // sorted order
  long long n;
  int dtype;                 // ChttDtype of data
  int uns;                   // int64 data holds UInt64 bits
  int cap_g;
  u64* acc;                  // cap_g states (double bits for OP_FSUM)
  u64* cnt;                  // cap_g masked-in row counts; NULL: not kept
};

template <int OP> __device__ __forceinline__ u64 identity() {
  if (OP == OP_MIN || OP == OP_ANY || OP == OP_BAND) return ~0ull;
  return 0ull;
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

template <int OP> __device__ __forceinline__ void shared_combine(u64* p,
                                                                 u64 v) {
  switch (OP) {
    case OP_SUM: atomicAdd((unsigned long long*)p, v); break;
    case OP_FSUM:
      atomicAdd((double*)p, __longlong_as_double((long long)v));
      break;
    case OP_MIN: case OP_ANY: atomicMin((unsigned long long*)p, v); break;
    case OP_MAX: atomicMax((unsigned long long*)p, v); break;
    case OP_BOR: atomicOr((unsigned long long*)p, v); break;
    case OP_BAND: atomicAnd((unsigned long long*)p, v); break;
    case OP_BXOR: atomicXor((unsigned long long*)p, v); break;
    default: break;
  }
}

// The row's contribution: bits for integer ops (sign- or zero-extended),
// double bits for OP_FSUM, an order key for min/max.
template <int OP>
__device__ __forceinline__ u64 contribution(const SegArgs& a, long long r) {
  u64 bits = 0;
  double f = 0.0;
  bool is_float = false, is_signed = false;
  switch (a.dtype) {
    case DT_BOOL: bits = ((const uint8_t*)a.data)[r] != 0; break;
    case DT_U8: bits = ((const uint8_t*)a.data)[r]; break;
    case DT_I8:
      bits = (u64)(long long)((const int8_t*)a.data)[r];
      is_signed = true;
      break;
    case DT_I16:
      bits = (u64)(long long)((const int16_t*)a.data)[r];
      is_signed = true;
      break;
    case DT_I32:
      bits = (u64)(long long)((const int*)a.data)[r];
      is_signed = true;
      break;
    case DT_I64:
      bits = (u64)((const long long*)a.data)[r];
      is_signed = !a.uns;
      break;
    case DT_F32: {
      const float x = ((const float*)a.data)[r];
      if (OP == OP_MIN || OP == OP_MAX) {
        // the f32 token (hash_ops.f32_token): total-order bits, high half
        const unsigned b = __float_as_uint(x);
        return (u64)((b >> 31) ? ~b : (b | 0x80000000u)) << 32;
      }
      f = (double)x;
      is_float = true;
      break;
    }
    case DT_F64:
      f = ((const double*)a.data)[r];
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

template <int OP>
__global__ void __launch_bounds__(kThreads) k_segment_reduce(SegArgs a) {
  __shared__ u64 s_acc[kTile];
  __shared__ unsigned s_cnt[kTile];
  __shared__ int s_last;
  const long long tile_start = (long long)blockIdx.x * kTile;
  const long long tile_end =
      tile_start + kTile < a.n ? tile_start + kTile : a.n;
  const int g0 = a.gid[tile_start];
  if (g0 >= a.cap_g) return;                  // no row of a group slot
  for (int l = threadIdx.x; l < kTile; l += kThreads) {
    s_acc[l] = identity<OP>();
    s_cnt[l] = 0;
  }
  if (threadIdx.x == 0) s_last = g0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = tile_start + (long long)warp * kWarpRows;
  for (int j = 0; j < kSteps; ++j) {
    const long long i = base + 32 * j + lane;
    int g = a.cap_g;
    u64 v = identity<OP>();
    unsigned c = 0;
    if (i < tile_end) {
      g = a.gid[i];
      if (g < a.cap_g) {
        const long long r = a.perm[i];
        if (a.mask == nullptr || a.mask[r]) {
          c = 1;
          if (OP == OP_ANY) v = (u64)r;
          else if (OP != OP_COUNT) v = contribution<OP>(a, r);
        }
      }
    }
    const int prev = __shfl_up_sync(kFull, g, 1);
    const bool head = lane == 0 || prev != g;
    // segmented reduction of the runs of equal g (sorted: a lane range)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int g2 = __shfl_down_sync(kFull, g, o);
      const u64 v2 = __shfl_down_sync(kFull, v, o);
      const unsigned c2 = __shfl_down_sync(kFull, c, o);
      if (lane + o < 32 && g2 == g) {
        if (OP != OP_COUNT) v = combine<OP>(v, v2);
        c += c2;
      }
    }
    if (head && g < a.cap_g) {
      const int l = g - g0;
      if (OP != OP_COUNT) shared_combine<OP>(&s_acc[l], v);
      if (a.cnt != nullptr) atomicAdd(&s_cnt[l], c);
      atomicMax(&s_last, g);
    }
  }
  __syncthreads();

  const int nloc = s_last - g0 + 1;
  // the first and last groups of the tile may have rows in other tiles
  const bool left_cut = tile_start > 0 && a.gid[tile_start - 1] == g0;
  const bool right_cut = tile_end < a.n && a.gid[tile_end] == s_last;
  for (int l = threadIdx.x; l < nloc; l += kThreads) {
    const int g = g0 + l;
    const bool cut = (l == 0 && left_cut) || (l == nloc - 1 && right_cut);
    if (!cut) {
      if (OP != OP_COUNT) a.acc[g] = s_acc[l];
      if (a.cnt != nullptr) a.cnt[g] = s_cnt[l];
    } else {
      if (OP != OP_COUNT) shared_combine<OP>(&a.acc[g], s_acc[l]);
      if (a.cnt != nullptr)
        atomicAdd((unsigned long long*)&a.cnt[g], (u64)s_cnt[l]);
    }
  }
}

template <int OP>
int launch(const SegArgs& a, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  k_segment_reduce<OP><<<(unsigned)tiles, kThreads, 0, s>>>(a);
  return chtt_last_error();
}

}  // namespace

// Reduce n key-sorted rows into cap_g group slots (op: SegOp).  acc and
// cnt must hold each op's identity (cnt 0) on entry.  acc may be NULL for
// OP_COUNT, cnt for every other op (no count is kept then).
extern "C" int chtt_segment_reduce(
    int op, const void* data, int dtype, int uns, const void* mask,
    const void* perm, const void* gid, long long n, int cap_g, void* acc,
    void* cnt, void* stream) {
  if (n < 1 || n >= (1ll << 31) || cap_g < 1 ||
      (op == OP_COUNT && cnt == nullptr) ||
      (op != OP_COUNT && (data == nullptr || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  SegArgs a;
  a.data = data;
  a.mask = (const uint8_t*)mask;
  a.perm = (const int*)perm;
  a.gid = (const int*)gid;
  a.n = n;
  a.dtype = dtype;
  a.uns = uns;
  a.cap_g = cap_g;
  a.acc = (u64*)acc;
  a.cnt = (u64*)cnt;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_SUM: return launch<OP_SUM>(a, s);
    case OP_MIN: return launch<OP_MIN>(a, s);
    case OP_MAX: return launch<OP_MAX>(a, s);
    case OP_ANY: return launch<OP_ANY>(a, s);
    case OP_BOR: return launch<OP_BOR>(a, s);
    case OP_BAND: return launch<OP_BAND>(a, s);
    case OP_BXOR: return launch<OP_BXOR>(a, s);
    case OP_COUNT: return launch<OP_COUNT>(a, s);
    case OP_FSUM: return launch<OP_FSUM>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
