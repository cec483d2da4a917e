// K18: segmented binary search, each query's position within its own
// segment of a sorted table.
//
// Replaces the reference's searchsorted_seg (clickhouse_tpu/ops/
// search.py:52), which finds each (segment, key) query's position in an
// array sorted by (segment, key) with two sorts of table ++ queries (its
// TPU workaround for slow random reads), and searchsorted (:77) with
// searchsorted_via_sort (:31), the same over one segment.
//
// Query j searches table[lo, hi): lo = starts[gid[j]], hi = ends[gid[j]]
// (gid clamped to the segments), or the whole table where gid is NULL.
// side left: the first position whose value is not below the query; right:
// the first whose value is above it (hi where there is none).  Values are
// int64, compared signed, or unsigned (the order tokens' u64 bits).
//
// Bound on the card: bytes (the table read once, the queries, their
// segment ids and the results).  The first version, one thread a query
// searching global memory from the top (27 dependent reads at 100M rows),
// was bound by latency: 3.7508 ms at Qw5's 100M queries against
// torch.searchsorted's 3.6568 and a bound of 0.7164, on an NVIDIA H100
// 80GB HBM3 at 700 W.
//
// The window frames' queries come sorted and the table is sorted by
// (segment, key), so neighbouring queries find their answers in one short
// stretch of the table.  A block takes a tile of 2,048 neighbouring
// queries (8 a thread, read with 16-byte loads) and first proves that
// their answers are monotone: each query's segment is the previous one's
// with a key not below it (or an empty one), or starts at or after the
// previous one's end.  Then half the block finds the tile's first answer
// and half its last with a 128-ary search each (a global read a thread a
// round, about four rounds at 100M rows); the stretch between them is
// copied into shared memory with coalesced reads, and each query searches
// the part of that window inside its own segment, from its neighbour's
// answer on (a query equal to its neighbour takes its answer).  A tile
// that is not monotone, or whose stretch passes the window (sparse
// queries), searches every query in global memory as the first version
// did, in the same kernel.  The answers leave through shared memory in
// contiguous stores.  What is left is each tile's chain of dependent
// reads (queries, segments, the search rounds, the window), hidden by 5
// blocks an SM (48 registers): 1.1026 ms at Qw5 (share 0.65), 1.1391 at
// Qw3's 1,024 partitions (0.73), every tile of both in the window
// (PERF.md, chip_smoke.py --scan-search).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                      // queries a thread
constexpr int kTileQ = kThreads * kPer;      // queries a block
constexpr int kWindow = 4096;                // table rows in shared memory
constexpr int kWays = kThreads / 2;          // probes a search a round
constexpr int kBlocksPerSm = 5;              // at most 51 registers
constexpr unsigned kFull = 0xffffffffu;

// branch counters (the diagnostic entry's `counts`)
enum { TILE_WINDOW = 0, TILE_UNORDERED = 1, TILE_WIDE = 2 };

struct Search {
  const long long* table;
  long long n_table;
  const int* gid;
  const long long* starts;
  const long long* ends;
  long long n_seg;
  u64 flip;
  bool right;
};

__device__ __forceinline__ void range_of(const Search& s, int g,
                                         long long& lo, long long& hi) {
  if (s.gid == nullptr) {
    lo = 0;
    hi = s.n_table;
    return;
  }
  const long long c = g < 0 ? 0 : (g >= s.n_seg ? s.n_seg - 1 : g);
  lo = __ldg(s.starts + c);
  hi = __ldg(s.ends + c);
}

// true where the table's value v (flipped) goes before the query's key
__device__ __forceinline__ bool before(const Search& s, long long v,
                                       long long key) {
  return s.right ? v <= key : v < key;
}

__device__ __forceinline__ long long search_global(const Search& s,
                                                   long long lo,
                                                   long long hi,
                                                   long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (before(s, (long long)((u64)__ldg(s.table + mid) ^ s.flip), key))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// answers of monotone queries j - 1, j: j's segment is j - 1's with a key
// not below it (or empty: both answers its start), or starts at or after
// j - 1's end
__device__ __forceinline__ bool monotone(long long plo, long long phi,
                                         long long pkey, long long lo,
                                         long long hi, long long key) {
  return (plo == lo && phi == hi) ? (pkey <= key || lo == hi) : phi <= lo;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    k_seg_search(const Search s, const long long* __restrict__ queries,
                 long long n_q, long long* __restrict__ out,
                 unsigned long long* counts) {
  __shared__ long long win[kWindow];
  __shared__ long long edge_key[2], edge_lo[2], edge_hi[2], bound[2];
  __shared__ long long warp_key[kThreads / 32], warp_lo[kThreads / 32],
      warp_hi[kThreads / 32];
  __shared__ int probe_true[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long q0 = (long long)blockIdx.x * kTileQ;
  const long long j0 = q0 + (long long)t * kPer;
  const bool full = q0 + kTileQ <= n_q;
  const long long nv_tile = full ? kTileQ : n_q - q0;
  const int nv = (int)(j0 >= n_q ? 0 : (n_q - j0 < kPer ? n_q - j0 : kPer));

  long long key[kPer];
  int g[kPer];
  if (full) {
    const longlong2* qp = (const longlong2*)(queries + j0);
#pragma unroll
    for (int i = 0; i < kPer / 2; ++i) {
      const longlong2 x = __ldg(qp + i);
      key[2 * i] = x.x;
      key[2 * i + 1] = x.y;
    }
    if (s.gid != nullptr) {
      const int4* gp = (const int4*)(s.gid + j0);
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const int4 x = __ldg(gp + i);
        g[4 * i] = x.x;
        g[4 * i + 1] = x.y;
        g[4 * i + 2] = x.z;
        g[4 * i + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      key[k] = k < nv ? queries[j0 + k] : 0;
      if (s.gid != nullptr) g[k] = k < nv ? s.gid[j0 + k] : 0;
    }
  }
  if (s.gid == nullptr) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) g[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) key[k] = (long long)((u64)key[k] ^ s.flip);

  // are the tile's answers monotone?
  bool ok = true;
  long long plo, phi, lo, hi;
  range_of(s, g[0], plo, phi);
#pragma unroll
  for (int k = 1; k < kPer; ++k) {
    if (k < nv) {
      if (g[k] == g[k - 1]) {
        ok = ok && (key[k - 1] <= key[k] || plo == phi);
      } else {
        range_of(s, g[k], lo, hi);
        ok = ok && monotone(plo, phi, key[k - 1], lo, hi, key[k]);
        plo = lo;
        phi = hi;
      }
    }
  }
  // the thread's last query against the next thread's first
  long long first_lo, first_hi;
  range_of(s, g[0], first_lo, first_hi);
  const long long lk = key[kPer - 1];
  const long long up_key = __shfl_up_sync(kFull, lk, 1);
  const long long up_lo = __shfl_up_sync(kFull, plo, 1);
  const long long up_hi = __shfl_up_sync(kFull, phi, 1);
  if (lane == 31) {
    warp_key[warp] = lk;
    warp_lo[warp] = plo;
    warp_hi[warp] = phi;
  }
  if (t == 0) {
    edge_key[0] = key[0];
    edge_lo[0] = first_lo;
    edge_hi[0] = first_hi;
  }
  // the tile's last query
  if ((nv_tile - 1) / kPer == t) {
    const int k = (int)((nv_tile - 1) % kPer);
    long long last_key = key[0];
#pragma unroll
    for (int i = 1; i < kPer; ++i)
      if (i == k) last_key = key[i];
    edge_key[1] = last_key;
    edge_lo[1] = plo;
    edge_hi[1] = phi;
  }
  __syncthreads();
  if (nv > 0 && t > 0) {
    if (lane > 0)
      ok = ok && monotone(up_lo, up_hi, up_key, first_lo, first_hi, key[0]);
    else
      ok = ok && monotone(warp_lo[warp - 1], warp_hi[warp - 1],
                          warp_key[warp - 1], first_lo, first_hi, key[0]);
  }
  int branch = __syncthreads_and(ok) ? TILE_WINDOW : TILE_UNORDERED;

  long long a0 = 0, a1 = 0;
  if (branch == TILE_WINDOW) {
    // the tile's first (threads 0-127) and last (128-255) answers, each
    // by a 128-ary search: probe i of a round reads L + (m * i) / 128
    const int half = t / kWays, i = t % kWays;
    long long L = edge_lo[half], H = edge_hi[half];
    const long long ek = edge_key[half];
    while (true) {
      const long long m = H - L;
      if (!__syncthreads_or(m > 0)) break;
      bool pred = false;
      if (m > 0) {
        const long long p = L + (long long)(((unsigned long long)m * i) >> 7);
        pred = before(s, (long long)((u64)__ldg(s.table + p) ^ s.flip), ek);
      }
      const unsigned b = __ballot_sync(kFull, pred);
      if (lane == 0) probe_true[warp] = __popc(b);
      __syncthreads();
      const int w0 = half * (kWays / 32);
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWays / 32; ++w) c += probe_true[w0 + w];
      if (m > 0) {
        const long long nl =
            c > 0 ? L + (long long)(((unsigned long long)m * (c - 1)) >> 7) + 1
                  : L;
        const long long nh =
            c < kWays ? L + (long long)(((unsigned long long)m * c) >> 7) : H;
        L = nl;
        H = nh;
      }
    }
    if (i == 0) bound[half] = L;
    __syncthreads();
    a0 = bound[0];
    a1 = bound[1];
    if (a1 - a0 > kWindow) {
      branch = TILE_WIDE;
    } else {
      const int span = (int)(a1 - a0);
#pragma unroll 4
      for (int x = t; x < span; x += kThreads)
        win[x] = (long long)((u64)__ldg(s.table + a0 + x) ^ s.flip);
      __syncthreads();
    }
  }

  // each answer takes its key's register (key[k] once read)
  if (branch == TILE_WINDOW) {
    // each query within the window, from its neighbour's answer on
    long long prev = a0, pk = 0, pl = -1, ph = -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < nv) {
        range_of(s, g[k], lo, hi);
        const long long kk = key[k];
        if (lo == pl && hi == ph && kk == pk) {
          key[k] = prev;
        } else {
          long long L = lo > a0 ? lo : a0;
          long long H = hi < a1 ? hi : a1;
          if (prev > L) L = prev;
          while (L < H) {
            const long long mid = L + ((H - L) >> 1);
            if (before(s, win[mid - a0], kk))
              L = mid + 1;
            else
              H = mid;
          }
          key[k] = L;
        }
        prev = key[k];
        pk = kk;
        pl = lo;
        ph = hi;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < nv) {
        range_of(s, g[k], lo, hi);
        key[k] = search_global(s, lo, hi, key[k]);
      }
    }
  }
  if (counts != nullptr && t == 0) atomicAdd(counts + branch, 1ull);
  if (full) {
    // the answers through shared memory (the window is read no more; a
    // word of padding a thread keeps eight lanes' words on distinct
    // banks), so that the block's stores are in order, 4,096 contiguous
    // bytes an instruction
    constexpr int kVecs = kPer / 2;
    longlong2* stage = (longlong2*)win;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      stage[t * (kVecs + 1) + i] = make_longlong2(key[2 * i], key[2 * i + 1]);
    __syncthreads();
    longlong2* op = (longlong2*)(out + q0);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int c = j * kThreads + t;
      op[c] = stage[(c / kVecs) * (kVecs + 1) + c % kVecs];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < nv) out[j0 + k] = key[k];
  }
}

}  // namespace

// table: n_table int64 values sorted within each segment; queries, out:
// n_q int64 (16-byte aligned); gid (int32, n_q, 16-byte aligned) with
// starts/ends (int64, n_seg), or all three NULL for one segment of the
// whole table.  counts: NULL, or 3 u64 to which each block adds one for
// its branch (the window, queries out of order, a stretch wider than the
// window): a diagnostic the main path never passes.
extern "C" int chtt_segmented_search(const void* table, long long n_table,
                                     const void* queries, long long n_q,
                                     const void* gid, const void* starts,
                                     const void* ends, long long n_seg,
                                     int right, int uns, void* out,
                                     void* counts, void* stream) {
  if (n_table < 0 || n_q < 0 ||
      (gid != nullptr && (starts == nullptr || ends == nullptr ||
                          n_seg < 1)) ||
      ((uintptr_t)queries & 15) || ((uintptr_t)out & 15) ||
      ((uintptr_t)gid & 15))
    return (int)cudaErrorInvalidValue;
  if (n_q == 0) return 0;
  const long long blocks = (n_q + kTileQ - 1) / kTileQ;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Search s;
  s.table = (const long long*)table;
  s.n_table = n_table;
  s.gid = (const int*)gid;
  s.starts = (const long long*)starts;
  s.ends = (const long long*)ends;
  s.n_seg = n_seg;
  s.flip = uns ? CHTT_SIGN : 0ull;
  s.right = right != 0;
  k_seg_search<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s, (const long long*)queries, n_q, (long long*)out,
      (unsigned long long*)counts);
  return chtt_last_error();
}
