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
// last).  The first row in scan order starts a segment, so no scan needs
// an identity of first or last.  An unsigned min or max flips each value's
// sign bit as it is read and written and compares signed.
//
// Bound on the card: bytes (each row's data, flag and mask read once, its
// result written once).  The first version (a block a 4,096-row tile
// staged in shared memory, a type switch and a flag test a row, a 16-byte
// state shuffled ten times a tile, 64 registers with spills) was bound by
// issue, not bytes: 1.5707 ms at Qw5's 100M-row running sum (int32 in,
// int64 out; bound 0.3582 ms), its tiles' reduce 0.4814, their scan
// 0.0604 and the downsweep 1.0353, on an NVIDIA H100 80GB HBM3 at 700 W.
//
// This version keeps reduce-then-scan in three launches, each warp owning
// one contiguous chunk of rows (at most 24 warps an SM's worth of chunks,
// so the chunks' states number a few thousand): the reduce pass folds each
// chunk into one state; one block scans the states into each chunk's
// carry; the downsweep reads each chunk again and scans it from its carry.
// A warp walks its chunk in warp-tiles of 512 rows, a thread 16
// consecutive rows read with 16-byte loads into registers.  The stored
// width (1, 2, 4 or 8 bytes, or the row index) and the op are template
// parameters, so the per-row loop holds no type switch; boundaries, the
// mask and the direction are tested once a warp-tile.  Across a warp a
// segment start is found with __ballot_sync and one 64-bit word is
// shuffled a step (first and last: one shuffle from the lane the ballots
// name).  The reduce pass touches no shared memory; the downsweep packs
// each thread's results into a per-warp stage so that its stores are
// contiguous (a thread's own 16-byte stores, 128 bytes apart, had held it
// at 1.0 ms).  Float sums add in a fixed order (a thread's rows, the
// warp's scan, the chunks in order), so a result repeats run to run; the
// second read of the input keeps that order, which a decoupled look-back
// would not, and costs 0.149 ms of the 0.59.  Qw5's sum: reduce 0.1485,
// carry scan 0.0143, downsweep 0.4423, 0.5936 in all (share 0.60)
// against torch.cumsum's 1.1313; 3 blocks an SM (85 registers, no
// spills) beat 4 (64, spilling) by 0.03-0.1 ms a shape (PERF.md,
// chip_smoke.py --scan-search).
#include "common.cuh"

namespace {

constexpr int kItems = 16;                 // rows a thread a warp-tile
constexpr int kWarpRows = 32 * kItems;     // K17_TILE_ROWS of ops/scan_ops.py
constexpr int kThreads = 256;              // 8 warps, each its own chunk
constexpr int kBlocksPerSm = 3;            // 85 registers a thread
constexpr int kWarpsPerSm = kBlocksPerSm * kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_FIRST = 3, OP_LAST = 4 };
enum Acc { ACC_I64 = 0, ACC_U64 = 1, ACC_F64 = 2 };
// How a row's value is read: the row index itself, or its stored width,
// zero-extended (U), sign-extended (I), a float widened, or 8 bytes as
// they are.  first and last carry the bits, so they read U widths only.
enum Ld { LD_NONE, LD_U8, LD_I8, LD_U16, LD_I16, LD_U32, LD_I32, LD_F32,
          LD_B64 };
enum Flag { F_ANY = 1, F_SEG = 2, F_HAS = 4 };

// one chunk's state (16 bytes in the scratch)
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
  void* states;                 // a State a chunk (chtt_scan_chunks)
  long long n;
  u64 ident;                    // a masked-out row's value (sum, min, max)
  int op, acc, dtype, out_dtype, reverse, sms;
};

namespace {

__device__ __forceinline__ double as_f64(u64 v) {
  return __longlong_as_double((long long)v);
}
__device__ __forceinline__ u64 f64_bits(double d) {
  return (u64)__double_as_longlong(d);
}

__host__ __device__ constexpr bool kValueOp(int op) { return op <= OP_MAX; }

__host__ __device__ constexpr int width_of(int ld) {
  return ld == LD_NONE ? 0
         : ld <= LD_I8 ? 1
         : ld <= LD_I16 ? 2
         : ld <= LD_F32 ? 4 : 8;
}

// sum, min, max of two values (ACC_I64 compares signed: an unsigned scan
// has flipped its values' sign bits)
template <int OP, int ACC>
__device__ __forceinline__ u64 op2(u64 a, u64 b) {
  if (OP == OP_SUM) {
    if (ACC == ACC_F64) return f64_bits(as_f64(a) + as_f64(b));
    return a + b;
  }
  bool pick_b;
  if (ACC == ACC_F64) {
    const double x = as_f64(a), y = as_f64(b);
    const bool better = OP == OP_MIN ? (y < x) : (y > x);
    pick_b = !(x != x) && ((y != y) || better);
  } else {
    pick_b = OP == OP_MIN ? ((long long)b < (long long)a)
                          : ((long long)b > (long long)a);
  }
  return pick_b ? b : a;
}

// (v, h) = combine((v, h), (bv, bh)) within one segment
template <int OP, int ACC>
__device__ __forceinline__ void fold(u64& v, bool& h, u64 bv, bool bh) {
  if (OP == OP_FIRST) {
    v = h ? v : bv;
    h = h || bh;
  } else if (OP == OP_LAST) {
    v = bh ? bv : v;
    h = h || bh;
  } else {
    v = op2<OP, ACC>(v, bv);
  }
}

// -- the chunks' states (reduce pass and the carry scan) ---------------------

__device__ __forceinline__ State empty_state() {
  State s;
  s.v = 0;
  s.flags = 0;
  s.pad = 0;
  return s;
}

template <int OP, int ACC>
__device__ __forceinline__ State combine(const State& a, const State& b) {
  if (!(a.flags & F_ANY)) return b;
  if (!(b.flags & F_ANY)) return a;
  if (b.flags & F_SEG) return b;
  State r = a;
  bool h = (a.flags & F_HAS) != 0;
  fold<OP, ACC>(r.v, h, b.v, (b.flags & F_HAS) != 0);
  r.flags = F_ANY | (a.flags & F_SEG) | (h ? F_HAS : 0);
  return r;
}

__device__ __forceinline__ State shfl_state(const State& s, int src) {
  State r;
  r.v = __shfl_sync(kFull, s.v, src);
  r.flags = __shfl_sync(kFull, s.flags, src);
  r.pad = 0;
  return r;
}

// -- a thread's 16 rows ------------------------------------------------------

template <int NV>
__device__ __forceinline__ unsigned word_of(const uint4 (&u)[NV], int j) {
  const uint4& q = u[j >> 2];
  switch (j & 3) {
    case 0: return q.x;
    case 1: return q.y;
    case 2: return q.z;
    default: return q.w;
  }
}

// 16 bools (bytes of 0 or 1) -> 16 bits, bit k = byte k
__device__ __forceinline__ unsigned bits4(unsigned w) {
  return ((w & 0x01010101u) * 0x01020408u) >> 24;
}
__device__ __forceinline__ unsigned bits16(const unsigned char* p) {
  const uint4 u = __ldg((const uint4*)p);
  return bits4(u.x) | bits4(u.y) << 4 | bits4(u.z) << 8 | bits4(u.w) << 12;
}

template <int LD>
__device__ __forceinline__ u64 widen(unsigned w) {
  if constexpr (LD == LD_I8) return (u64)(long long)(signed char)w;
  else if constexpr (LD == LD_I16) return (u64)(long long)(short)w;
  else if constexpr (LD == LD_I32) return (u64)(long long)(int)w;
  else if constexpr (LD == LD_F32)
    return f64_bits((double)__uint_as_float(w));
  else if constexpr (LD == LD_U8) return w & 0xffu;
  else if constexpr (LD == LD_U16) return w & 0xffffu;
  else return w;                             // LD_U32
}

// rows [r0, r0 + 16) of a full warp-tile, from 16-byte loads
template <int LD>
__device__ __forceinline__ void load_full(const void* data, long long r0,
                                          u64 (&v)[kItems]) {
  if constexpr (LD == LD_NONE) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = (u64)(r0 + k);
  } else {
    constexpr int W = width_of(LD);
    constexpr int NV = kItems * W / 16;
    const uint4* p = (const uint4*)((const char*)data + r0 * W);
    uint4 u[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) u[i] = __ldg(p + i);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if constexpr (W == 8) {
        v[k] = (u64)word_of(u, 2 * k) | ((u64)word_of(u, 2 * k + 1) << 32);
      } else {
        constexpr int per = 4 / W;
        const unsigned w = word_of(u, k / per) >> (8 * W * (k % per));
        v[k] = widen<LD>(w);
      }
    }
  }
}

template <int LD>
__device__ __forceinline__ u64 load_one(const void* data, long long i) {
  constexpr int W = width_of(LD);
  if constexpr (LD == LD_NONE) return (u64)i;
  else if constexpr (W == 1) return widen<LD>(((const unsigned char*)data)[i]);
  else if constexpr (W == 2)
    return widen<LD>(((const unsigned short*)data)[i]);
  else if constexpr (W == 4) return widen<LD>(((const unsigned*)data)[i]);
  else return ((const u64*)data)[i];
}

// The output's layout: an int64 sum, the row index and 8-byte values as
// 8 bytes, a float32's min or max back to float, first and last and the
// narrow integers' min and max in their own width.
template <int OP, int ACC, int LD>
struct OutOf {
  static constexpr bool kF32 = LD == LD_F32;
  static constexpr int W =
      (OP == OP_SUM && ACC != ACC_F64) || LD == LD_NONE ? 8 : width_of(LD);
};

template <int OP, int ACC, int LD>
__device__ __forceinline__ unsigned out_word(u64 v) {
  if constexpr (OutOf<OP, ACC, LD>::kF32)
    return __float_as_uint((float)as_f64(v));
  else
    return (unsigned)v;
}

// 16-byte words a thread's 16 results take
template <int OP, int ACC, int LD>
constexpr int kOutVecs = kItems * OutOf<OP, ACC, LD>::W / 16;

// A full warp-tile's results from `base`: each thread packs its 16 rows
// into 16-byte words in the warp's stage (a word of padding a thread, so
// that eight lanes' words fall on distinct banks), then the warp stores
// the tile's words in order, 512 contiguous bytes an instruction, marked
// to leave the L2 first (nothing reads them again in this call).
template <int OP, int ACC, int LD>
__device__ __forceinline__ void store_tile(void* out, long long base,
                                           const u64 (&v)[kItems],
                                           uint4* stage) {
  constexpr int W = OutOf<OP, ACC, LD>::W;
  constexpr int NV = kOutVecs<OP, ACC, LD>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (W == 8) {
        const u64 x = v[2 * i + j / 2];
        w[j] = (j & 1) ? (unsigned)(x >> 32) : (unsigned)x;
      } else if constexpr (W == 4) {
        w[j] = out_word<OP, ACC, LD>(v[4 * i + j]);
      } else {
        constexpr int per = 4 / W;
        constexpr unsigned low = (1u << (8 * W)) - 1;
        unsigned acc = 0;
#pragma unroll
        for (int e = 0; e < per; ++e)
          acc |= (out_word<OP, ACC, LD>(v[(4 * i + j) * per + e]) & low)
                 << (8 * W * e);
        w[j] = acc;
      }
    }
    stage[lane * (NV + 1) + i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncwarp();
  uint4* p = (uint4*)((char*)out + base * W);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * 32 + lane;
    __stcs(p + c, stage[(c / NV) * (NV + 1) + c % NV]);
  }
  __syncwarp();
}

template <int OP, int ACC, int LD>
__device__ __forceinline__ void store_one(void* out, long long i, u64 v) {
  constexpr int W = OutOf<OP, ACC, LD>::W;
  if constexpr (W == 8) {
    ((u64*)out)[i] = v;
  } else {
    const unsigned x = out_word<OP, ACC, LD>(v);
    if constexpr (W == 1) ((unsigned char*)out)[i] = (unsigned char)x;
    else if constexpr (W == 2) ((unsigned short*)out)[i] = (unsigned short)x;
    else ((unsigned*)out)[i] = x;
  }
}

// A thread's 16 rows from r0 in scan order: values (masked-out rows at the
// identity for sum, min and max; an unsigned min or max's with their sign
// bits flipped), seg (bit k: item k starts a segment) and has (bit k: item
// k is masked in).  Rows past n: no segment, not masked in, the identity.
template <int OP, int ACC, int LD>
__device__ __forceinline__ void load_rows(const ChttScanArgs& a, long long r0,
                                          bool full, u64 flip, u64 ident,
                                          u64 (&v)[kItems], unsigned& seg,
                                          unsigned& has) {
  const long long n = a.n;
  if (full) {
    load_full<LD>(a.data, r0, v);
    seg = 0;
    if (a.boundary != nullptr) {
      seg = bits16(a.boundary + r0);
      // a reverse scan restarts where the next row starts a segment
      if (a.reverse)
        seg = (seg >> 1) |
              (r0 + kItems < n && a.boundary[r0 + kItems] ? 1u << 15 : 0u);
    }
    has = a.mask != nullptr ? bits16(a.mask + r0) : 0xffffu;
    if (kValueOp(OP) && a.mask != nullptr) {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (!((has >> k) & 1)) v[k] = ident;
    }
  } else {
    seg = 0;
    has = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = r0 + k;
      const bool in = i < n;
      const bool m = in && (a.mask == nullptr || a.mask[i]);
      v[k] = in ? load_one<LD>(a.data, i) : 0;
      if (kValueOp(OP) && !m) v[k] = ident;
      bool b = false;
      if (in && a.boundary != nullptr)
        b = a.reverse ? (i + 1 < n && a.boundary[i + 1]) : a.boundary[i] != 0;
      seg |= (unsigned)b << k;
      has |= (unsigned)m << k;
    }
  }
  if (kValueOp(OP) && OP != OP_SUM && flip) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] ^= flip;
  }
  // the first row in scan order starts a segment
  const long long first = a.reverse ? n - 1 : 0;
  if (first >= r0 && first < r0 + kItems) seg |= 1u << (int)(first - r0);
  if (a.reverse) {
#pragma unroll
    for (int k = 0; k < kItems / 2; ++k) {
      const u64 t = v[k];
      v[k] = v[kItems - 1 - k];
      v[kItems - 1 - k] = t;
    }
    seg = __brev(seg) >> 16;
    has = __brev(has) >> 16;
  }
}

// The thread's aggregate of its 16 rows in scan order (from its last
// segment start): value and has.
template <int OP, int ACC>
__device__ __forceinline__ void thread_fold(const u64 (&v)[kItems],
                                            unsigned seg, unsigned has,
                                            u64& t, bool& th) {
  t = v[0];
  th = has & 1;
  if (kValueOp(OP) && seg <= 1) {
#pragma unroll
    for (int k = 1; k < kItems; ++k) t = op2<OP, ACC>(t, v[k]);
    return;
  }
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    const bool hk = (has >> k) & 1;
    if ((seg >> k) & 1) {
      t = v[k];
      th = hk;
    } else {
      fold<OP, ACC>(t, th, v[k], hk);
    }
  }
}

// The warp's view of one warp-tile: each lane's inclusive state over the
// lanes before it in scan order (back to the last segment start), and
// what the lanes before it hold.
struct WarpScan {
  int sl;              // the lane's place in scan order
  unsigned starts;     // bit s: scan-lane s holds a segment start
  u64 inc;             // inclusive value
  bool inc_h;
  u64 ex;              // inclusive value of scan-lane sl - 1
  bool ex_h;
  bool ex_seg;         // a segment starts in scan-lanes [0, sl)
};

__device__ __forceinline__ int phys_lane(int s, bool rev) {
  return rev ? 31 - s : s;
}

template <int OP, int ACC>
__device__ __forceinline__ WarpScan warp_scan(u64 t, bool th, unsigned seg,
                                              bool rev) {
  WarpScan w;
  const int lane = threadIdx.x & 31;
  w.sl = rev ? 31 - lane : lane;
  unsigned S = __ballot_sync(kFull, seg != 0);
  if (rev) S = __brev(S);
  w.starts = S;
  const unsigned upto = S & (kFull >> (31 - w.sl));
  const int start = upto ? 31 - __clz(upto) : -1;
  const int lo = start > 0 ? start : 0;
  if (kValueOp(OP)) {
    u64 inc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_sync(kFull, inc, rev ? lane + o : lane - o);
      if (w.sl - o >= lo) inc = op2<OP, ACC>(y, inc);
    }
    w.inc = inc;
    w.inc_h = false;
  } else {
    unsigned H = __ballot_sync(kFull, th);
    if (rev) H = __brev(H);
    const unsigned m = H & (kFull >> (31 - w.sl)) & (kFull << lo);
    int src;
    if (OP == OP_FIRST) src = m ? __ffs(m) - 1 : w.sl;
    else src = m ? 31 - __clz(m) : lo;
    w.inc = __shfl_sync(kFull, t, phys_lane(src, rev));
    w.inc_h = m != 0;
  }
  const int prev = phys_lane(w.sl > 0 ? w.sl - 1 : 0, rev);
  w.ex = __shfl_sync(kFull, w.inc, prev);
  unsigned IH = __ballot_sync(kFull, w.inc_h);
  if (rev) IH = __brev(IH);
  w.ex_h = w.sl > 0 && ((IH >> (w.sl - 1)) & 1);
  w.ex_seg = w.sl > 0 && (S & (kFull >> (32 - w.sl))) != 0;
  return w;
}

struct Plan {
  long long tiles;   // warp-tiles
  long long per;     // warp-tiles a chunk
  long long chunks;
};

Plan plan_of(long long n, int sms) {
  Plan p;
  p.tiles = (n + kWarpRows - 1) / kWarpRows;
  const long long warps = (long long)(sms > 0 ? sms : 1) * kWarpsPerSm;
  p.per = (p.tiles + warps - 1) / warps;
  if (p.per < 1) p.per = 1;
  p.chunks = (p.tiles + p.per - 1) / p.per;
  return p;
}

// pass 1: each chunk's state
template <int OP, int ACC, int LD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k_scan_reduce(const ChttScanArgs a, long long per, long long chunks) {
  const long long c = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (c >= chunks) return;
  const bool rev = a.reverse != 0;
  const u64 flip = a.acc == ACC_U64 ? CHTT_SIGN : 0ull;
  const long long tiles = (a.n + kWarpRows - 1) / kWarpRows;
  const long long t0 = c * per;
  const long long t1 = t0 + per < tiles ? t0 + per : tiles;
  const int lane = threadIdx.x & 31;
  State chunk = empty_state();
  for (long long i = 0; i < t1 - t0; ++i) {
    const long long tile = rev ? t1 - 1 - i : t0 + i;
    const long long base = tile * kWarpRows;
    u64 v[kItems];
    unsigned seg, has;
    load_rows<OP, ACC, LD>(a, base + lane * kItems, base + kWarpRows <= a.n,
                           flip, a.ident, v, seg, has);
    u64 t;
    bool th;
    thread_fold<OP, ACC>(v, seg, has, t, th);
    const WarpScan w = warp_scan<OP, ACC>(t, th, seg, rev);
    State ts;
    const int last = phys_lane(31, rev);
    ts.v = __shfl_sync(kFull, w.inc, last);
    ts.flags = F_ANY | (w.starts ? F_SEG : 0) |
               (__shfl_sync(kFull, (int)w.inc_h, last) ? F_HAS : 0);
    ts.pad = 0;
    chunk = combine<OP, ACC>(chunk, ts);
  }
  if (lane == 0) ((State*)a.states)[c] = chunk;
}

// Exclusive scan of one state a thread over the block, in thread order;
// *total gets the block's combine.  warp_tot: 32 states of shared memory.
template <int OP, int ACC>
__device__ __forceinline__ State block_exclusive(const State& x,
                                                 State* warp_tot,
                                                 State* total) {
  constexpr int kWarps = kScanThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  State inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const State y = shfl_state(inc, lane - o);
    if (lane >= o) inc = combine<OP, ACC>(y, inc);
  }
  State ex = shfl_state(inc, lane - 1);
  if (lane == 0) ex = empty_state();
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    State w = lane < kWarps ? warp_tot[lane] : empty_state();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const State y = shfl_state(w, lane - o);
      if (lane >= o) w = combine<OP, ACC>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;     // inclusive over the warps
  }
  __syncthreads();
  const State before = warp > 0 ? warp_tot[warp - 1] : empty_state();
  *total = warp_tot[kWarps - 1];
  return combine<OP, ACC>(before, ex);
}

// pass 2 (one block): each chunk's state becomes the carry into the chunk,
// in scan order (a reverse scan's from the last chunk)
template <int OP, int ACC>
__global__ void __launch_bounds__(kScanThreads)
    k_scan_chunks(const ChttScanArgs a, long long chunks) {
  __shared__ State warp_tot[32];
  State* st = (State*)a.states;
  const bool rev = a.reverse != 0;
  const long long each = (chunks + kScanThreads - 1) / kScanThreads;
  const long long p0 = threadIdx.x * each;
  State acc = empty_state();
  for (long long i = 0; i < each; ++i) {
    const long long p = p0 + i;
    if (p < chunks) acc = combine<OP, ACC>(acc, st[rev ? chunks - 1 - p : p]);
  }
  State total;
  State run = block_exclusive<OP, ACC>(acc, warp_tot, &total);
  for (long long i = 0; i < each; ++i) {
    const long long p = p0 + i;
    if (p < chunks) {
      const long long idx = rev ? chunks - 1 - p : p;
      const State x = st[idx];
      st[idx] = run;
      run = combine<OP, ACC>(run, x);
    }
  }
}

// pass 3: each chunk scanned from its carry, a warp-tile at a time
template <int OP, int ACC, int LD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k_scan_down(const ChttScanArgs a, long long per, long long chunks) {
  const long long c = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (c >= chunks) return;
  const bool rev = a.reverse != 0;
  const u64 flip = a.acc == ACC_U64 ? CHTT_SIGN : 0ull;
  const long long tiles = (a.n + kWarpRows - 1) / kWarpRows;
  const long long t0 = c * per;
  const long long t1 = t0 + per < tiles ? t0 + per : tiles;
  constexpr int NV = kOutVecs<OP, ACC, LD>;
  __shared__ uint4 stages[kThreads / 32][32 * (NV + 1)];
  uint4* stage = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const State carry = ((const State*)a.states)[c];
  u64 cv = carry.v;
  bool ch = (carry.flags & F_HAS) != 0;
  for (long long i = 0; i < t1 - t0; ++i) {
    const long long tile = rev ? t1 - 1 - i : t0 + i;
    const long long base = tile * kWarpRows;
    const long long r0 = base + lane * kItems;
    const bool full = base + kWarpRows <= a.n;
    u64 v[kItems];
    unsigned seg, has;
    load_rows<OP, ACC, LD>(a, r0, full, flip, a.ident, v, seg, has);
    u64 t;
    bool th;
    thread_fold<OP, ACC>(v, seg, has, t, th);
    const WarpScan w = warp_scan<OP, ACC>(t, th, seg, rev);
    // the state before the thread's first row
    u64 rv = cv;
    bool rh = ch;
    if (w.ex_seg) {
      rv = w.ex;
      rh = w.ex_h;
    } else if (w.sl > 0) {
      fold<OP, ACC>(rv, rh, w.ex, w.ex_h);
    }
    if (kValueOp(OP) && seg == 0) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        rv = op2<OP, ACC>(rv, v[k]);
        v[k] = rv;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const bool hk = (has >> k) & 1;
        if ((seg >> k) & 1) {
          rv = v[k];
          rh = hk;
        } else {
          fold<OP, ACC>(rv, rh, v[k], hk);
        }
        v[k] = rv;
      }
    }
    const int last = phys_lane(31, rev);
    cv = __shfl_sync(kFull, rv, last);
    ch = __shfl_sync(kFull, (int)rh, last) != 0;
    if (kValueOp(OP) && OP != OP_SUM && flip) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) v[k] ^= flip;
    }
    if (rev) {
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k) {
        const u64 x = v[k];
        v[k] = v[kItems - 1 - k];
        v[kItems - 1 - k] = x;
      }
    }
    if (full) {
      store_tile<OP, ACC, LD>(a.out, base, v, stage);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (r0 + k < a.n) store_one<OP, ACC, LD>(a.out, r0 + k, v[k]);
    }
  }
}

// pass 0: all three; 1, 2, 3: that pass alone (chtt_segmented_scan_split)
template <int OP, int ACC, int LD>
int launch(const ChttScanArgs& a, cudaStream_t st, int pass) {
  const Plan p = plan_of(a.n, a.sms);
  const long long blocks = (p.chunks + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (pass == 0 || pass == 1) {
    k_scan_reduce<OP, ACC, LD><<<(unsigned)blocks, kThreads, 0, st>>>(
        a, p.per, p.chunks);
    rc = chtt_last_error();
    if (rc) return rc;
  }
  if (pass == 0 || pass == 2) {
    k_scan_chunks<OP, ACC><<<1, kScanThreads, 0, st>>>(a, p.chunks);
    rc = chtt_last_error();
    if (rc) return rc;
  }
  if (pass == 0 || pass == 3) {
    k_scan_down<OP, ACC, LD><<<(unsigned)blocks, kThreads, 0, st>>>(
        a, p.per, p.chunks);
    rc = chtt_last_error();
  }
  return rc;
}

// sum, min and max: integers (the row index, 1, 2, 4 or 8 bytes) or floats
template <int OP, int ACC>
int launch_value(const ChttScanArgs& a, cudaStream_t st, int pass) {
  if constexpr (ACC == ACC_F64) {
    switch (a.dtype) {
      case DT_F32: return launch<OP, ACC, LD_F32>(a, st, pass);
      case DT_F64: return launch<OP, ACC, LD_B64>(a, st, pass);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (a.data == nullptr) return launch<OP, ACC, LD_NONE>(a, st, pass);
    switch (a.dtype) {
      case DT_BOOL:
      case DT_U8: return launch<OP, ACC, LD_U8>(a, st, pass);
      case DT_I8: return launch<OP, ACC, LD_I8>(a, st, pass);
      case DT_I16: return launch<OP, ACC, LD_I16>(a, st, pass);
      case DT_I32: return launch<OP, ACC, LD_I32>(a, st, pass);
      case DT_I64: return launch<OP, ACC, LD_B64>(a, st, pass);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// first and last carry the stored bits
template <int OP>
int launch_carry(const ChttScanArgs& a, cudaStream_t st, int pass) {
  if (a.data == nullptr) return launch<OP, ACC_I64, LD_NONE>(a, st, pass);
  switch (a.dtype) {
    case DT_BOOL:
    case DT_U8:
    case DT_I8: return launch<OP, ACC_I64, LD_U8>(a, st, pass);
    case DT_I16: return launch<OP, ACC_I64, LD_U16>(a, st, pass);
    case DT_I32:
    case DT_F32: return launch<OP, ACC_I64, LD_U32>(a, st, pass);
    default: return launch<OP, ACC_I64, LD_B64>(a, st, pass);
  }
}

template <int OP>
int launch_minmax(const ChttScanArgs& a, cudaStream_t st, int pass) {
  return a.acc == ACC_F64 ? launch_value<OP, ACC_F64>(a, st, pass)
                          : launch_value<OP, ACC_I64>(a, st, pass);
}

bool is_float(int dtype) { return dtype == DT_F32 || dtype == DT_F64; }

int scan(const ChttScanArgs& a, cudaStream_t st, int pass) {
  const bool has_data = a.data != nullptr;
  if (a.n < 0 || a.out == nullptr || a.states == nullptr || pass < 0 ||
      pass > 3 || a.op < OP_SUM || a.op > OP_LAST ||
      a.acc < ACC_I64 || a.acc > ACC_F64 ||
      (has_data && (a.dtype < DT_BOOL || a.dtype > DT_F64)))
    return (int)cudaErrorInvalidValue;
  // the accumulator and the output type follow the input's
  const bool fl = has_data && is_float(a.dtype);
  if (a.op <= OP_MAX && (a.acc == ACC_F64) != fl)
    return (int)cudaErrorInvalidValue;
  const int want_out = !has_data ? DT_I64
                       : (a.op == OP_SUM && !fl) ? DT_I64 : a.dtype;
  if (a.out_dtype != want_out) return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  switch (a.op) {
    case OP_SUM:
      return fl ? launch_value<OP_SUM, ACC_F64>(a, st, pass)
                : launch_value<OP_SUM, ACC_I64>(a, st, pass);
    case OP_MIN: return launch_minmax<OP_MIN>(a, st, pass);
    case OP_MAX: return launch_minmax<OP_MAX>(a, st, pass);
    case OP_FIRST: return launch_carry<OP_FIRST>(a, st, pass);
    default: return launch_carry<OP_LAST>(a, st, pass);
  }
}

}  // namespace

// The states scratch holds 16 bytes a chunk: chtt_scan_chunks(n, sms)
// chunks, never more than one a K17_TILE_ROWS rows.
extern "C" int chtt_segmented_scan(const ChttScanArgs* args, void* stream) {
  return scan(*args, (cudaStream_t)stream, 0);
}

// A diagnostic, never on the main path: one pass of a call alone (1 the
// chunks' reduce, 2 their scan, 3 the downsweep; 0 all), so that
// chip_smoke.py can time each pass.
extern "C" int chtt_segmented_scan_split(const ChttScanArgs* args, int pass,
                                         void* stream) {
  return scan(*args, (cudaStream_t)stream, pass);
}

extern "C" long long chtt_scan_chunks(long long n, int sms) {
  return plan_of(n, sms).chunks;
}

extern "C" int chtt_scan_tile_rows() { return kWarpRows; }
