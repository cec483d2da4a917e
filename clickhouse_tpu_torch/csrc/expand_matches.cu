// K9: the 1:N join's match expansion (the IColumn::replicate analog).
//
// Replaces expand_matches (clickhouse_tpu/ops/join_ops.py:328-385), which
// merge-sorts the cumulative match counts with every output slot and hands
// each slot its probe row with a reverse cumulative minimum, because a TPU
// serialises scatter (the reference's ROADMAP, queue 2 item 8).  Here:
//
//   lens[i]    = its build matches (seg_len) if probe row i matched and is
//                valid, else 0; at most 1 for an ANY join; at least 1 for a
//                valid row of a LEFT join, 0 for an invalid one;
//   offsets[i] = lens[0] + ... + lens[i-1], clamped to the capacity;
//   slot j     < min(out_count, out_cap) belongs to the last row p with
//                offsets[p] <= j: probe row p, build position
//                seg_start[p] + (j - offsets[p]), flagged by matched[p] and
//                valid[p].  Slots past the rows written get 0, 0, false.
//
// Output rows are probe-major, and within a probe row follow the build
// side's key-sorted order, as the reference's.
//
// Bound on the card: bytes.  Each probe row's flags, segment start and
// length are read once; each output slot's probe row, build position and
// flag are written once (the offsets are an intermediate of 4 bytes a
// probe row, written and read once more).
// Design: one call, four steps on the stream:
//   * memsets of the look-back words and of the head marks (the probe-row
//     output, -1 a slot);
//   * k_expand_scan, one pass over the probe rows in 4,096-row tiles taken
//     from a tile counter: a block scan of the tile's lengths (16 rows a
//     thread), then a decoupled look-back in which warp 0 reads the status
//     words of the 32 tiles before it at once (64-bit words: a 2-bit flag,
//     a 62-bit count, so counts past 2^32 are kept); each row writes its
//     clamped offset and, if its length is not 0, marks its first slot
//     with its row id (the heads are distinct slots); the row holding the
//     last probe row writes offsets[n] and out_count;
//   * k_expand_write, one block a tile of 4,096 output slots: warp 0 finds
//     the row holding the tile's first slot by a 32-ary search of the
//     offsets, the block takes a prefix maximum of the tile's head marks
//     from it, and writes each slot's row, build position and flag with
//     coalesced stores.  A probe row with many matches (a heavy key, a
//     CROSS join) covers whole tiles, so its slots spread over as many
//     blocks; no thread loops over a row's matches.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // rows (or slots) a thread scans
constexpr int kTile = kThreads * kItems;   // 4,096
constexpr u64 kAggregate = 1, kInclusive = 2;
constexpr u64 kCountMask = (1ull << 62) - 1;

}  // namespace

// Layout shared with ops/_native.py.
struct ChttExpandArgs {
  const unsigned char* matched;   // n probe rows each
  const unsigned char* valid;
  const int* seg_start;
  const int* seg_len;
  long long n;
  long long out_cap;              // below 2^31
  int left;
  int any_join;
  int* offsets;                   // n + 1
  long long* out_count;
  u64* status;                    // a look-back word a tile, then a counter
  int* p_idx;                     // out_cap slots each
  int* build_pos;
  unsigned char* mask;
  int tiles;
  int pad;
};

namespace {

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

__device__ __forceinline__ int clamp_cap(long long v, long long cap) {
  return (int)(v < cap ? v : cap);
}

__global__ void __launch_bounds__(kThreads) k_expand_scan(ChttExpandArgs a) {
  __shared__ long long warp_tot[kWarps];
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<int*>(a.status + a.tiles), 1);
  __syncthreads();
  const int tile = s_tile;
  const long long row0 = (long long)tile * kTile + threadIdx.x * kItems;
  int len[kItems];
  long long mine = 0;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const long long r = row0 + e;
    int l = 0;
    if (r < a.n) {
      const bool v = a.valid[r] != 0;
      l = (a.matched[r] && v) ? __ldg(a.seg_len + r) : 0;
      if (a.any_join) l = l < 1 ? l : 1;
      if (a.left) l = v ? (l > 1 ? l : 1) : 0;
    }
    len[e] = l;
    mine += l;
  }
  // the block's exclusive scan of the threads' sums
  long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  long long before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total += warp_tot[w];
    if (w < warp) before_warp += warp_tot[w];
  }
  if (warp == 0) {
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) publish(a.status, kInclusive, total);
    } else {
      if (lane == 0) publish(a.status + tile, kAggregate, total);
      before = look_back(a.status, tile);
      if (lane == 0) publish(a.status + tile, kInclusive, before + total);
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  long long run = s_before + before_warp + incl - mine;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const long long r = row0 + e;
    if (r < a.n) {
      a.offsets[r] = clamp_cap(run, a.out_cap);
      if (len[e] > 0 && run < a.out_cap) a.p_idx[run] = (int)r;
      run += len[e];
      if (r == a.n - 1) {
        a.offsets[a.n] = clamp_cap(run, a.out_cap);
        *a.out_count = run;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) k_expand_write(ChttExpandArgs a) {
  __shared__ int s_src[kTile];
  __shared__ int s_warp_max[kWarps];
  __shared__ int s_p0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long j0 = (long long)blockIdx.x * kTile;
  const long long j1 = j0 + kTile < a.out_cap ? j0 + kTile : a.out_cap;
  const long long total = a.offsets[a.n];    // slots written (clamped)
  const long long jv = j1 < total ? j1 : total;
  if (j0 >= jv) {
    for (long long j = j0 + tid; j < j1; j += kThreads) {
      a.p_idx[j] = 0;
      a.build_pos[j] = 0;
      a.mask[j] = 0;
    }
    return;
  }
  // the last row p with offsets[p] <= j0 (offsets[0] = 0 <= j0): each step
  // reads 32 evenly spaced offsets and keeps the span after the last one
  // not above j0
  if (warp == 0) {
    long long lo = 0, hi = a.n;
    while (hi - lo > 1) {
      const long long step = (hi - lo + 31) / 32;
      const long long idx = lo + lane * step;
      const bool ok = idx < hi && a.offsets[idx] <= j0;
      const unsigned b = __ballot_sync(kFull, ok);
      const int last = 31 - __clz(b);
      lo += last * step;
      hi = lo + step < hi ? lo + step : hi;
    }
    if (lane == 0) s_p0 = (int)lo;
  }
  for (int jj = tid; jj < kTile; jj += kThreads)
    s_src[jj] = j0 + jj < jv ? a.p_idx[j0 + jj] : -1;
  __syncthreads();
  // prefix maximum of the head marks, from the row holding slot j0
  int v[kItems];
  int m = tid == 0 ? s_p0 : -1;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int x = s_src[tid * kItems + e];
    m = x > m ? x : m;
    v[e] = m;
  }
  int incl = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = y > incl ? y : incl;
  }
  if (lane == 31) s_warp_max[warp] = incl;
  int before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = -1;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) before = s_warp_max[w] > before ? s_warp_max[w] : before;
#pragma unroll
  for (int e = 0; e < kItems; ++e)
    s_src[tid * kItems + e] = v[e] > before ? v[e] : before;
  __syncthreads();
  for (int jj = tid; jj < j1 - j0; jj += kThreads) {
    const long long j = j0 + jj;
    if (j < jv) {
      const int p = s_src[jj];
      a.p_idx[j] = p;
      a.build_pos[j] = __ldg(a.seg_start + p) + (int)(j - a.offsets[p]);
      a.mask[j] = a.matched[p] && a.valid[p];
    } else {
      a.p_idx[j] = 0;
      a.build_pos[j] = 0;
      a.mask[j] = 0;
    }
  }
}

}  // namespace

// Rows of a scan tile (the Python wrapper sizes the look-back words from
// it).
extern "C" int chtt_expand_tile_rows() { return kTile; }

// offsets: n + 1 ints; status: tiles + 1 words, tiles = ceil(n / tile rows)
// (at least 1); p_idx, build_pos and mask: out_cap slots each.
extern "C" int chtt_expand_matches(const ChttExpandArgs* args, void* stream) {
  ChttExpandArgs a = *args;
  if (a.n < 0 || a.n >= (1ll << 31) || a.out_cap < 1 ||
      a.out_cap >= (1ll << 31) ||
      (long long)a.tiles != (a.n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a.p_idx, 0xff,
                                  sizeof(int) * (size_t)a.out_cap, st);
  if (e != cudaSuccess) return (int)e;
  if (a.n == 0) {
    e = cudaMemsetAsync(a.offsets, 0, sizeof(int), st);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(a.out_count, 0, sizeof(long long), st);
    if (e != cudaSuccess) return (int)e;
  } else {
    e = cudaMemsetAsync(a.status, 0, sizeof(u64) * ((size_t)a.tiles + 1),
                        st);
    if (e != cudaSuccess) return (int)e;
    k_expand_scan<<<(unsigned)a.tiles, kThreads, 0, st>>>(a);
  }
  const long long blocks = (a.out_cap + kTile - 1) / kTile;
  k_expand_write<<<(unsigned)blocks, kThreads, 0, st>>>(a);
  return chtt_last_error();
}
