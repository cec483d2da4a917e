// K9: the 1:N join's match expansion (the IColumn::replicate analog).
//
// Replaces expand_matches (clickhouse_tpu/ops/join_ops.py:328-385), which
// merge-sorts the cumulative match counts with every output slot and hands
// each slot its probe row with a reverse cumulative minimum, because a TPU
// serialises scatter (the reference's ROADMAP, queue 2 item 8).  Here:
//
//   valid[i]   = i < n_rows, and the probe mask where one is given;
//   lens[i]    = its build matches (seg_len) if probe row i matched and is
//                valid, else 0; at most 1 for an ANY join; at least 1 for a
//                valid row of a LEFT join, 0 for an invalid one;
//   off[i]     = lens[0] + ... + lens[i-1];
//   slot j     < min(out_count, out_cap) belongs to the last row p with
//                off[p] <= j: probe row p, build position
//                seg_start[p] + (j - off[p]), flagged by matched[p] and
//                valid[p].  Slots past the rows written get 0, 0, false.
//
// Output rows are probe-major, and within a probe row follow the build
// side's key-sorted order, as the reference's.
//
// Bound on the card: bytes.  Each probe row's flags, segment start and
// length are read once (and its mask, where one is given); each output
// slot's probe row, build position and flag are written once.
// Design: one memset (the look-back words, the tile counter and the spill
// table) and two kernels:
//   * k_expand_scan, one pass over the probe rows in 4,096-row tiles taken
//     from a tile counter.  A block loads its tile coalesced (segment
//     starts and lengths in 16-byte chunks striped over the block into
//     shared memory, each thread's 16 flags with one 16-byte load), scans
//     the lengths (16 rows a thread), publishes the tile's count for the
//     decoupled look-back (warp 0 reads the status words of the 32 tiles
//     before it at once; 64-bit words: a 2-bit flag and a 62-bit count, so
//     counts past 2^32 are kept), and then writes its own output slots
//     [base, base + count) below the capacity: each thread takes four
//     consecutive slots (16-byte stores, consecutive threads on
//     consecutive slots) and finds their probe rows from the tile's
//     offsets in shared memory (a binary search, then a short walk).  No
//     offsets array and no head marks go through device memory.
//   * k_expand_spill, one block a tile of 4,096 output slots: where a
//     tile's output is larger than `heavy` slots (a heavy key, a CROSS
//     join), its scanning block writes none of it and records the tile in
//     the spill table under every output tile it covers (at most two
//     heavy tiles meet an output tile, since each spans more than one);
//     the spill block reloads and rescans such a tile (from the L2) and
//     writes its slots within its own 4,096, so a heavy row spreads over
//     as many blocks as it has output tiles.  It also zeroes the tail
//     [min(out_count, out_cap), out_cap).  Its blocks with nothing to
//     write exit after reading three words.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // rows a thread scans
constexpr int kTile = kThreads * kItems;   // 4,096 rows
constexpr int kChunks = kTile / 4;         // 16-byte chunks of a tile's ints
constexpr int kSlots = 4096;               // output slots a spill block
constexpr u64 kAggregate = 1, kInclusive = 2;
constexpr u64 kCountMask = (1ull << 62) - 1;
constexpr int kIntMax = 0x7fffffff;

}  // namespace

// Layout shared with ops/_native.py.
struct ChttExpandArgs {
  const unsigned char* matched;   // n probe rows each
  const unsigned char* valid;     // or null: every row below n_rows
  const int* seg_start;
  const int* seg_len;
  long long n;
  long long n_rows;               // rows at or past it are invalid (<= n)
  long long out_cap;              // below 2^31
  long long heavy;                // a tile's output above it: spilled
  int left;
  int any_join;
  int vec;                        // every input starts on 16 bytes
  int tiles;
  long long* out_count;
  // tiles look-back words, the tile counter, then two spill words an
  // output tile of kSlots: the heavy tile holding its first slot, and the
  // heavy tile whose first slot lies inside it (0: none; else
  // (tile + 1) << 32 | the tile's first slot)
  u64* status;
  int* p_idx;                     // out_cap slots each
  int* build_pos;
  unsigned char* mask;
};

namespace {

// A tile in shared memory.  `off` holds 16-byte chunks in a swizzled order
// (chunk q at q ^ ((q >> 3) & 7)), so that both the block's striped chunk
// stores and a thread's reads of its own four chunks are free of bank
// conflicts: first the rows' segment lengths, then their exclusive
// offsets within the tile, clamped to 2^31 - 1 (a slot below the capacity
// never reaches it).
struct Tile {
  int off[kTile];
  int start[kTile];               // segment starts, in row order
  unsigned char hit[kTile];       // matched and valid
  long long warp_tot[kWarps];
  long long total;                // the tile's slots
  long long base;                 // the slots of the tiles before it
  int tile;
};

__device__ __forceinline__ int swz(int i) {
  const int q = i >> 2;
  return ((q ^ ((q >> 3) & 7)) << 2) | (i & 3);
}

__device__ __forceinline__ void publish(u64* p, u64 flag, long long count) {
  *reinterpret_cast<volatile u64*>(p) = (flag << 62) | (u64)count;
}

__device__ __forceinline__ u64 read_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The count of the tiles before `tile` (warp 0; every lane must call it):
// the status words of up to 32 earlier tiles at once, nearest first, until
// one holds an inclusive count.
__device__ __forceinline__ long long look_back(const u64* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long t = tile - 1;; t -= 32) {
    const long long mine = t - lane;
    u64 w = kInclusive << 62;                // before tile 0: none
    if (mine >= 0) {
      do {
        w = read_status(status + mine);
      } while ((w >> 62) == 0);
    }
    const unsigned inc = __ballot_sync(kFull, (w >> 62) == kInclusive);
    const int last = inc ? __ffs(inc) - 1 : 31;  // lanes 0..last count
    before += warp_sum(lane <= last ? (long long)(w & kCountMask) : 0);
    if (inc) return before;
  }
}

__device__ __forceinline__ void scalar_chunk(const int* p, long long r,
                                             long long n, int4& v) {
  v.x = r < n ? __ldg(p + r) : 0;
  v.y = r + 1 < n ? __ldg(p + r + 1) : 0;
  v.z = r + 2 < n ? __ldg(p + r + 2) : 0;
  v.w = r + 3 < n ? __ldg(p + r + 3) : 0;
}

// Flags of rows r..r+15 (0 past n), one byte each in a uint4.
__device__ __forceinline__ uint4 load_flags(const unsigned char* p,
                                            long long r, long long n,
                                            bool vec) {
  if (vec && r + kItems <= n)
    return __ldg(reinterpret_cast<const uint4*>(p + r));
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    if (r + e < n) w[e >> 2] |= (unsigned)p[r + e] << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool flag(const uint4& f, int e) {
  const unsigned w = e < 4 ? f.x : e < 8 ? f.y : e < 12 ? f.z : f.w;
  return ((w >> (8 * (e & 3))) & 0xffu) != 0;
}

// Loads tile `tile` into t and scans its lengths: t.off then holds each
// row's exclusive offset within the tile, t.start and t.hit its segment
// start and flag, t.total the tile's slots.  Every thread must call it; it
// synchronises the block.  Returns the thread's slots (its 16 rows).
__device__ long long scan_tile(const ChttExpandArgs& a, int tile, Tile& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)tile * kTile;
  // segment lengths and starts: 16-byte chunks striped over the block
#pragma unroll
  for (int k = 0; k < kChunks / kThreads; ++k) {
    const int q = k * kThreads + tid;
    const long long r = r0 + 4 * q;
    int4 l, s;
    if (a.vec && r + 4 <= a.n) {
      l = __ldg(reinterpret_cast<const int4*>(a.seg_len + r));
      s = __ldg(reinterpret_cast<const int4*>(a.seg_start + r));
    } else {
      scalar_chunk(a.seg_len, r, a.n, l);
      scalar_chunk(a.seg_start, r, a.n, s);
    }
    reinterpret_cast<int4*>(t.off)[q ^ ((q >> 3) & 7)] = l;
    reinterpret_cast<int4*>(t.start)[q] = s;
  }
  // the thread's 16 rows' flags: one 16-byte load each
  const long long rt = r0 + kItems * tid;
  const uint4 m = load_flags(a.matched, rt, a.n, a.vec);
  const uint4 v = a.valid != nullptr ? load_flags(a.valid, rt, a.n, a.vec)
                                     : make_uint4(0, 0, 0, 0);
  __syncthreads();
  int len[kItems];
  unsigned hit[4] = {0, 0, 0, 0};
  long long mine = 0;
#pragma unroll
  for (int c = 0; c < kItems / 4; ++c) {
    const int q = (kItems / 4) * tid + c;
    const int4 l4 = reinterpret_cast<const int4*>(t.off)[q ^ ((q >> 3) & 7)];
    const int ls[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * c + u;
      const bool ok = rt + e < a.n_rows &&
                      (a.valid == nullptr || flag(v, e));
      const bool h = ok && flag(m, e);
      int l = h ? ls[u] : 0;
      if (a.any_join) l = l < 1 ? l : 1;
      if (a.left) l = ok ? (l > 1 ? l : 1) : 0;
      len[e] = l;
      hit[c] |= (unsigned)h << (8 * u);
      mine += l;
    }
  }
  reinterpret_cast<uint4*>(t.hit)[tid] =
      make_uint4(hit[0], hit[1], hit[2], hit[3]);
  // the block's exclusive scan of the threads' sums
  long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) t.warp_tot[warp] = incl;
  __syncthreads();
  long long run = incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total += t.warp_tot[w];
    if (w < warp) run += t.warp_tot[w];
  }
  // the rows' offsets, clamped, over the thread's own chunks of t.off
#pragma unroll
  for (int c = 0; c < kItems / 4; ++c) {
    int o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      o[u] = (int)(run < kIntMax ? run : kIntMax);
      run += len[4 * c + u];
    }
    const int q = (kItems / 4) * tid + c;
    reinterpret_cast<int4*>(t.off)[q ^ ((q >> 3) & 7)] =
        make_int4(o[0], o[1], o[2], o[3]);
  }
  if (tid == 0) t.total = total;
  return mine;
}

// The last row p >= lo whose offset is not above jl (the offset of row lo
// is not): steps doubling from lo until one overshoots, then halving.
__device__ __forceinline__ int row_from(const Tile& t, int lo, int jl) {
  int p = lo, step = 1;
  while (p + step < kTile && t.off[swz(p + step)] <= jl) {
    p += step;
    step <<= 1;
  }
  for (step >>= 1; step > 0; step >>= 1)
    if (p + step < kTile && t.off[swz(p + step)] <= jl) p += step;
  return p;
}

// Writes the slots [j_begin, j_end) of the scanned tile t, whose first
// slot is `base`: each thread four consecutive slots (16-byte stores of
// rows and build positions, 4 bytes of flags; consecutive threads on
// consecutive groups), the first slot's row found by a binary search of
// the tile's offsets, the next ones' by row_from.  j_end <= out_cap <
// 2^31.
__device__ __forceinline__ void write_slots(const ChttExpandArgs& a,
                                            const Tile& t, long long base,
                                            long long j_begin,
                                            long long j_end) {
  const long long r0 = (long long)t.tile * kTile;
  for (long long g = (j_begin >> 2) + threadIdx.x; 4 * g < j_end;
       g += kThreads) {
    const long long j = 4 * g;
    const int u0 = j < j_begin ? (int)(j_begin - j) : 0;
    const int u1 = j + 4 <= j_end ? 4 : (int)(j_end - j);
    const int jl0 = (int)(j + u0 - base);
    int p = 0;
#pragma unroll
    for (int step = kTile / 2; step > 0; step >>= 1)
      if (t.off[swz(p + step)] <= jl0) p += step;
    int row[4], pos[4];
    unsigned flags = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      row[u] = pos[u] = 0;
      if (u < u0 || u >= u1) continue;
      const int jl = jl0 + (u - u0);
      if (u > u0) p = row_from(t, p, jl);
      row[u] = (int)(r0 + p);
      pos[u] = t.start[p] + (jl - t.off[swz(p)]);
      flags |= (unsigned)t.hit[p] << (8 * u);
    }
    if (u0 == 0 && u1 == 4) {
      *reinterpret_cast<int4*>(a.p_idx + j) =
          make_int4(row[0], row[1], row[2], row[3]);
      *reinterpret_cast<int4*>(a.build_pos + j) =
          make_int4(pos[0], pos[1], pos[2], pos[3]);
      *reinterpret_cast<unsigned*>(a.mask + j) = flags;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < u0 || u >= u1) continue;
        a.p_idx[j + u] = row[u];
        a.build_pos[j + u] = pos[u];
        a.mask[j + u] = (unsigned char)(flags >> (8 * u));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) k_expand_scan(ChttExpandArgs a) {
  __shared__ Tile t;
  const int tid = threadIdx.x;
  if (tid == 0)
    t.tile = atomicAdd(reinterpret_cast<int*>(a.status + a.tiles), 1);
  __syncthreads();
  const int tile = t.tile;
  scan_tile(a, tile, t);
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    const long long total = t.total;
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) publish(a.status, kInclusive, total);
    } else {
      if (lane == 0) publish(a.status + tile, kAggregate, total);
      before = look_back(a.status, tile);
      if (lane == 0) publish(a.status + tile, kInclusive, before + total);
    }
    if (lane == 0) {
      t.base = before;
      if (tile == a.tiles - 1) *a.out_count = before + total;
    }
  }
  __syncthreads();
  const long long base = t.base;
  const long long end = base + t.total < a.out_cap ? base + t.total
                                                   : a.out_cap;
  if (base >= end) return;
  if (end - base <= a.heavy) {
    write_slots(a, t, base, base, end);
    return;
  }
  // a heavy tile: recorded under each output tile it covers
  u64* spill = a.status + a.tiles + 1;
  const u64 entry = ((u64)(tile + 1) << 32) | (u64)base;
  const long long k0 = base / kSlots, k1 = (end - 1) / kSlots;
  for (long long k = k0 + tid; k <= k1; k += kThreads)
    spill[2 * k + (k * kSlots >= base ? 0 : 1)] = entry;
}

__global__ void __launch_bounds__(kThreads) k_expand_spill(ChttExpandArgs a) {
  __shared__ Tile t;
  const long long j0 = (long long)blockIdx.x * kSlots;
  const long long j1 = j0 + kSlots < a.out_cap ? j0 + kSlots : a.out_cap;
  const u64* spill = a.status + a.tiles + 1 + 2 * (long long)blockIdx.x;
  const u64 entry[2] = {spill[0], spill[1]};
  const long long count = *a.out_count;
  const long long tail = count < a.out_cap ? count : a.out_cap;
  for (long long j = (j0 > tail ? j0 : tail) + threadIdx.x; j < j1;
       j += kThreads) {
    a.p_idx[j] = 0;
    a.build_pos[j] = 0;
    a.mask[j] = 0;
  }
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (entry[h] == 0) continue;          // the same for every thread
    const int tile = (int)(entry[h] >> 32) - 1;
    const long long base = (long long)(entry[h] & 0xffffffffull);
    if (threadIdx.x == 0) t.tile = tile;
    scan_tile(a, tile, t);
    __syncthreads();
    long long end = base + t.total;
    end = end < j1 ? end : j1;
    write_slots(a, t, base, base > j0 ? base : j0, end);
    __syncthreads();                      // before t is loaded again
  }
}

}  // namespace

// Rows of a scan tile and slots of a spill block (the Python wrapper sizes
// the status words from them).
extern "C" int chtt_expand_tile_rows() { return kTile; }
extern "C" int chtt_expand_spill_slots() { return kSlots; }

// status: tiles + 1 + 2 * ceil(out_cap / spill slots) words, tiles =
// ceil(n / tile rows); p_idx, build_pos and mask: out_cap slots each.
extern "C" int chtt_expand_matches(const ChttExpandArgs* args, void* stream) {
  ChttExpandArgs a = *args;
  if (a.n < 0 || a.n >= (1ll << 31) || a.n_rows < 0 || a.n_rows > a.n ||
      a.out_cap < 1 || a.out_cap >= (1ll << 31) || a.heavy < kSlots ||
      (long long)a.tiles != (a.n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (a.out_cap + kSlots - 1) / kSlots;
  cudaError_t e = cudaMemsetAsync(
      a.status, 0, sizeof(u64) * ((size_t)a.tiles + 1 + 2 * (size_t)blocks),
      st);
  if (e == cudaSuccess && a.n == 0)
    e = cudaMemsetAsync(a.out_count, 0, sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  if (a.n > 0) k_expand_scan<<<(unsigned)a.tiles, kThreads, 0, st>>>(a);
  k_expand_spill<<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return chtt_last_error();
}
