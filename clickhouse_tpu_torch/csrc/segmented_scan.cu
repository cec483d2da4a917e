// K17: inclusive segmented scan (sum, min, max, first, last) with an
// optional mask, forward or reverse.
//
// Replaces the reference's _segmented_scan (clickhouse_tpu/ops/
// scan_ops.py:86) and running_reduce (:100): lax.associative_scan over
// (value, has, flag) triples, and, for the window frames' suffix scans
// (clickhouse_tpu/exec/executor.py:1156-1160), the same over [::-1] copies
// of every array.  Here a reverse scan walks the rows from the last to the
// first and reads the same boundary flags: no array is reversed.
//
// The combine of a scan-order neighbour a (earlier) and b:
//
//   value = b.flag ? b.value : op(a.value, b.value)
//   has   = b.flag ? b.has   : a.has | b.has
//   flag  = a.flag | b.flag
//
// op: a wrapping 64-bit add (integers widened), a float64 add, a min or max
// (signed, unsigned or float64; NaN propagates as jnp.minimum/maximum do),
// first (a.has ? a : b) or last (b.has ? b : a).  A masked-out row takes
// the identity (sum, min, max: the wrapper's `ident`) or has = 0 (first,
// last).  A state also carries "any" (not the empty prefix), so the scan
// needs no identity of first or last.
//
// Bound on the card: bytes (each row's data, flag and mask read once, its
// result written once).  A first version, reduce-then-scan in three
// launches: each block reduces a tile of 4,096 rows (256 threads, 16
// consecutive rows a thread, the tile read coalesced into shared memory)
// to one state whose flag says a segment starts in it; one block scans the
// tiles' states into each tile's carry; each block reads its tile again,
// scans it from its carry and stores the results coalesced from shared
// memory.  The values are read as stored (int8 ... float64) and combined
// in 64-bit registers, and float sums add in a fixed order, so a result
// repeats run to run.  A decoupled look-back (as K5's and K14's) would need
// a 64-bit value and its flags in one status word: a later redesign.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // K17_TILE_ROWS of ops/scan_ops.py
constexpr int kScanThreads = 1024;
// blocks an SM the tile passes are built for (64 registers a thread; left
// to itself the compiler took 102-117, two blocks an SM)
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_FIRST = 3, OP_LAST = 4 };
enum Acc { ACC_I64 = 0, ACC_U64 = 1, ACC_F64 = 2 };
enum Flag { F_ANY = 1, F_SEG = 2, F_HAS = 4 };

// one scan state (16 bytes in the tiles' scratch)
struct State {
  u64 v;
  int flags;
  int pad;
};

}  // namespace

// one call (ChttScanArgs; ops/_native.py K17Args)
struct ChttScanArgs {
  const void* data;             // NULL: the row index
  const unsigned char* boundary;  // NULL: one segment
  const unsigned char* mask;    // NULL: every row
  void* out;
  void* tiles;                  // a State a tile
  long long n;
  u64 ident;                    // a masked-out row's value (sum, min, max)
  int op, acc, dtype, out_dtype, reverse, pad;
};

namespace {

__device__ __forceinline__ double as_f64(u64 v) {
  return __longlong_as_double((long long)v);
}
__device__ __forceinline__ u64 f64_bits(double d) {
  return (u64)__double_as_longlong(d);
}

__device__ __forceinline__ State empty_state() {
  State s;
  s.v = 0;
  s.flags = 0;
  s.pad = 0;
  return s;
}

template <int OP, int ACC>
__device__ __forceinline__ u64 apply_op(u64 a, u64 b, int a_flags,
                                        int b_flags) {
  if (OP == OP_SUM) {
    if (ACC == ACC_F64) return f64_bits(as_f64(a) + as_f64(b));
    return a + b;
  }
  if (OP == OP_MIN || OP == OP_MAX) {
    bool pick_b;
    if (ACC == ACC_F64) {
      const double x = as_f64(a), y = as_f64(b);
      const bool better = OP == OP_MIN ? (y < x) : (y > x);
      pick_b = !(x != x) && ((y != y) || better);
    } else if (ACC == ACC_U64) {
      pick_b = OP == OP_MIN ? (b < a) : (b > a);
    } else {
      pick_b = OP == OP_MIN ? ((long long)b < (long long)a)
                            : ((long long)b > (long long)a);
    }
    return pick_b ? b : a;
  }
  if (OP == OP_FIRST) return (a_flags & F_HAS) ? a : b;
  return (b_flags & F_HAS) ? b : a;      // OP_LAST
}

template <int OP, int ACC>
__device__ __forceinline__ State combine(const State& a, const State& b) {
  if (!(a.flags & F_ANY)) return b;
  if (!(b.flags & F_ANY)) return a;
  State r;
  r.pad = 0;
  if (b.flags & F_SEG) {
    r.v = b.v;
    r.flags = F_ANY | F_SEG | (b.flags & F_HAS);
    return r;
  }
  r.v = apply_op<OP, ACC>(a.v, b.v, a.flags, b.flags);
  r.flags = F_ANY | ((a.flags | b.flags) & (F_SEG | F_HAS));
  return r;
}

__device__ __forceinline__ u64 load_value(const void* p, int dtype,
                                          long long i) {
  switch (dtype) {
    case DT_BOOL:
    case DT_U8: return (u64)((const unsigned char*)p)[i];
    case DT_I8: return (u64)(long long)((const signed char*)p)[i];
    case DT_I16: return (u64)(long long)((const short*)p)[i];
    case DT_I32: return (u64)(long long)((const int*)p)[i];
    case DT_F32: return f64_bits((double)((const float*)p)[i]);
    default: return ((const u64*)p)[i];      // DT_I64, DT_F64
  }
}

__device__ __forceinline__ void store_value(void* p, int dtype, long long i,
                                            u64 v) {
  switch (dtype) {
    case DT_BOOL: ((unsigned char*)p)[i] = v != 0; break;
    case DT_U8: ((unsigned char*)p)[i] = (unsigned char)v; break;
    case DT_I8: ((signed char*)p)[i] = (signed char)v; break;
    case DT_I16: ((short*)p)[i] = (short)v; break;
    case DT_I32: ((int*)p)[i] = (int)v; break;
    case DT_F32: ((float*)p)[i] = (float)as_f64(v); break;
    default: ((u64*)p)[i] = v; break;       // DT_I64, DT_F64
  }
}

// the row at scan position p
__device__ __forceinline__ long long row_of(const ChttScanArgs& a,
                                            long long p) {
  return a.reverse ? a.n - 1 - p : p;
}

template <int OP>
__device__ __forceinline__ State element(const ChttScanArgs& a,
                                         long long p) {
  const long long i = row_of(a, p);
  bool seg = false;
  if (a.boundary != nullptr) {
    // a reverse scan restarts where the next row starts a segment
    if (a.reverse)
      seg = i + 1 < a.n && a.boundary[i + 1];
    else
      seg = a.boundary[i] != 0;
  }
  const bool m = a.mask == nullptr || a.mask[i];
  State s;
  s.pad = 0;
  u64 v = a.data == nullptr ? (u64)i : load_value(a.data, a.dtype, i);
  if ((OP == OP_SUM || OP == OP_MIN || OP == OP_MAX) && !m) v = a.ident;
  s.v = v;
  s.flags = F_ANY | (seg ? F_SEG : 0) | (m ? F_HAS : 0);
  return s;
}

__device__ __forceinline__ State shfl_up(const State& s, int o) {
  State r;
  r.v = __shfl_up_sync(kFull, s.v, o);
  r.flags = __shfl_up_sync(kFull, s.flags, o);
  r.pad = 0;
  return r;
}

// Exclusive scan of one state a thread over a block of THREADS threads, in
// thread order; *total gets the block's combine.  warp_tot holds 32 states
// of shared memory.  Every thread of the block calls it.
template <int OP, int ACC, int THREADS>
__device__ __forceinline__ State block_exclusive(const State& x,
                                                 State* warp_tot,
                                                 State* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  State inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const State y = shfl_up(inc, o);
    if (lane >= o) inc = combine<OP, ACC>(y, inc);
  }
  State ex = shfl_up(inc, 1);
  if (lane == 0) ex = empty_state();
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    State w = lane < kWarps ? warp_tot[lane] : empty_state();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const State y = shfl_up(w, o);
      if (lane >= o) w = combine<OP, ACC>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;     // inclusive over the warps
  }
  __syncthreads();
  const State before = warp > 0 ? warp_tot[warp - 1] : empty_state();
  *total = warp_tot[kWarps - 1];
  const State out = combine<OP, ACC>(before, ex);
  __syncthreads();                             // warp_tot may be reused
  return out;
}

// A tile's element states staged in shared memory: read coalesced (a
// warp's loads cover consecutive rows), then each thread takes its 16
// consecutive rows from shared memory.  The index is padded by one slot
// every 16 so that a thread's run does not fall on one bank.
constexpr int kPadded = kTile + kTile / kItems;

__device__ __forceinline__ int pad_idx(int i) { return i + i / kItems; }

template <int OP>
__device__ __forceinline__ void stage_tile(const ChttScanArgs& a,
                                           long long tile_base, u64* sv,
                                           unsigned char* sf) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long p = tile_base + idx;
    const State e = p < a.n ? element<OP>(a, p) : empty_state();
    sv[pad_idx(idx)] = e.v;
    sf[pad_idx(idx)] = (unsigned char)e.flags;
  }
  __syncthreads();
}

__device__ __forceinline__ State staged(const u64* sv, const unsigned char* sf,
                                        int idx) {
  State s;
  s.v = sv[pad_idx(idx)];
  s.flags = sf[pad_idx(idx)];
  s.pad = 0;
  return s;
}

// pass 1: each tile's state
template <int OP, int ACC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k_scan_reduce(const ChttScanArgs a) {
  __shared__ u64 sv[kPadded];
  __shared__ unsigned char sf[kPadded];
  __shared__ State warp_tot[32];
  stage_tile<OP>(a, (long long)blockIdx.x * kTile, sv, sf);
  State acc = empty_state();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    acc = combine<OP, ACC>(acc, staged(sv, sf, threadIdx.x * kItems + k));
  State total;
  block_exclusive<OP, ACC, kThreads>(acc, warp_tot, &total);
  if (threadIdx.x == 0) ((State*)a.tiles)[blockIdx.x] = total;
}

// pass 2 (one block): each tile's state becomes the carry into the tile
template <int OP, int ACC>
__global__ void __launch_bounds__(kScanThreads)
    k_scan_tiles(const ChttScanArgs a, int n_tiles) {
  __shared__ State warp_tot[32];
  State* tiles = (State*)a.tiles;
  State carry = empty_state();
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const State x = t < n_tiles ? tiles[t] : empty_state();
    State total;
    const State ex =
        block_exclusive<OP, ACC, kScanThreads>(x, warp_tot, &total);
    if (t < n_tiles) tiles[t] = combine<OP, ACC>(carry, ex);
    carry = combine<OP, ACC>(carry, total);
  }
}

// pass 3: each tile scanned from its carry, its results staged back in
// shared memory and stored coalesced
template <int OP, int ACC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k_scan_down(const ChttScanArgs a) {
  __shared__ u64 sv[kPadded];
  __shared__ unsigned char sf[kPadded];
  __shared__ State warp_tot[32];
  const long long tile_base = (long long)blockIdx.x * kTile;
  stage_tile<OP>(a, tile_base, sv, sf);
  const int first = threadIdx.x * kItems;
  State acc = empty_state();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    acc = combine<OP, ACC>(acc, staged(sv, sf, first + k));
  State total;
  const State ex = block_exclusive<OP, ACC, kThreads>(acc, warp_tot, &total);
  State run = combine<OP, ACC>(((const State*)a.tiles)[blockIdx.x], ex);
  // a thread rewrites only its own rows' slots
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run = combine<OP, ACC>(run, staged(sv, sf, first + k));
    sv[pad_idx(first + k)] = run.v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = k * kThreads + threadIdx.x;
    const long long p = tile_base + idx;
    if (p < a.n)
      store_value(a.out, a.out_dtype, row_of(a, p), sv[pad_idx(idx)]);
  }
}

template <int OP, int ACC>
int launch(const ChttScanArgs& a, cudaStream_t st) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_scan_reduce<OP, ACC><<<(unsigned)tiles, kThreads, 0, st>>>(a);
  int rc = chtt_last_error();
  if (rc) return rc;
  k_scan_tiles<OP, ACC><<<1, kScanThreads, 0, st>>>(a, (int)tiles);
  rc = chtt_last_error();
  if (rc) return rc;
  k_scan_down<OP, ACC><<<(unsigned)tiles, kThreads, 0, st>>>(a);
  return chtt_last_error();
}

template <int OP>
int launch_acc(const ChttScanArgs& a, cudaStream_t st) {
  switch (a.acc) {
    case ACC_I64: return launch<OP, ACC_I64>(a, st);
    case ACC_U64: return launch<OP, ACC_U64>(a, st);
    case ACC_F64: return launch<OP, ACC_F64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The tiles scratch holds 16 bytes a tile of K17_TILE_ROWS rows.
extern "C" int chtt_segmented_scan(const ChttScanArgs* args, void* stream) {
  const ChttScanArgs a = *args;
  if (a.n < 0 || a.out == nullptr || a.tiles == nullptr ||
      (a.data != nullptr && (a.dtype < DT_BOOL || a.dtype > DT_F64)) ||
      a.out_dtype < DT_BOOL || a.out_dtype > DT_F64)
    return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.op) {
    case OP_SUM:
      return a.acc == ACC_F64 ? launch<OP_SUM, ACC_F64>(a, st)
                              : launch<OP_SUM, ACC_I64>(a, st);
    case OP_MIN: return launch_acc<OP_MIN>(a, st);
    case OP_MAX: return launch_acc<OP_MAX>(a, st);
    case OP_FIRST: return launch<OP_FIRST, ACC_I64>(a, st);
    case OP_LAST: return launch<OP_LAST, ACC_I64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int chtt_scan_tile_rows() { return kTile; }
