// K5: group boundaries, dense group ids and segment bounds of key-sorted
// rows.
//
// Replaces the boundary / cumsum / num_groups lines of the reference's
// group_by_sort (clickhouse_tpu/ops/agg_ops.py:238-252) and its
// segment_starts_ends_dense (clickhouse_tpu/ops/scan_ops.py:52), which
// sorts each group's first position into its rank slot because a TPU
// serializes scatter.  Here each group's bounds are written where its
// boundary is found: starts[g] at its first row, ends[g - 1] there too, and
// ends of the last group at the valid row count.
//
// Bound on the card: bytes.  Each row's sorted key is read once and its
// group id written once; starts and ends are 16 bytes a group slot, each
// written once.
// Design: one pass, k_seg_onesweep (after K4's k_onesweep_scatter):
//   * tiles of 4,096 rows are taken from a tile counter in the order blocks
//     start, so a tile's predecessors are all running;
//   * a warp takes 512 rows in steps of one 16-byte load a lane (four
//     u32 keys or two u64), so each step's loads, and its group id
//     stores, cover one contiguous span; the key before a lane's run comes
//     from the lane below by __shfl_up_sync (from the last lane of the
//     step before at lane 0, one load before the warp's first row), and a
//     thread's 16 rows' boundaries are a 16-bit mask in a register;
//   * a warp scans its lanes' boundary counts once, all steps at a time (a
//     step's counts packed in a byte of a 64-bit word), and the warps'
//     totals give each warp its boundaries before it;
//   * decoupled look-back: the tile publishes its boundary count in a
//     64-bit (flag, count) status word, then warp 0 reads the status words
//     of the 32 tiles before it at once until one holds an inclusive count,
//     and publishes its own; one memset a call clears the words;
//   * the warp then writes its group ids a step at a time (16-byte stores
//     of u32 keys' runs, 8-byte of u64), and starts[g] / ends[g - 1] at
//     each boundary (ends of the last group at the valid row count);
//   * the blocks past the last tile (they start after every tile has)
//     wait for the last tile's inclusive count, which is num_groups, write
//     it, and fill the slots past the last group: each slot is written
//     once.
// The kernel is templated on the key layout: one u32 array (the packed
// keys of most GROUP BYs), one u64 array, and up to four arrays of either
// width read with scalar loads in runs of four rows.  A key array that
// does not start on a 16-byte boundary is read with scalar loads in its
// ragged head and tail (the tiles are shifted so that every other run is
// aligned); nothing is copied.  Rows at or past the valid row count (the
// invalid rows, which the sort put last) get group id cap_g; groups at or
// past cap_g get no slot (the caller's capacity check reports them).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kItems = 16;                  // rows a thread takes
constexpr int kTile = kThreads * kItems;    // 4,096 rows
constexpr int kWarpRows = 32 * kItems;      // 512 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 4;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

// A warp takes its 512 rows in steps: at step j, lane l holds the run of
// kRun consecutive rows starting kRun * (32 j + l) rows in, so the warp's
// loads and stores of a step cover one contiguous span.  Bit kRun j + e
// of a lane's mask is row e of its run at step j.

__device__ __forceinline__ void unpack(const uint4& q, unsigned (&k)[4]) {
  k[0] = q.x; k[1] = q.y; k[2] = q.z; k[3] = q.w;
}
__device__ __forceinline__ void unpack(const uint4& q, u64 (&k)[2]) {
  k[0] = ((u64)q.y << 32) | q.x;
  k[1] = ((u64)q.w << 32) | q.z;
}

// One sorted key array of K (unsigned or u64), one 16-byte load a run.
template <class K>
struct OneKey {
  static constexpr int kRun = 16 / sizeof(K);
  const K* key;

  // The mask of the warp's rows from row w0 on that hold another key than
  // the row before them (only bits of rows in [1, n) mean anything).  The
  // key before a run comes from the lane below, or from the last lane of
  // the step before.  Every lane of the warp must call it.
  __device__ __forceinline__ unsigned diff(long long w0, long long n) const {
    constexpr int kSteps = kItems / kRun;
    const int lane = threadIdx.x & 31;
    K k[kSteps][kRun];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      // the tiles are shifted so that a full run starts 16-byte aligned
      const long long r = w0 + (long long)kRun * (32 * j + lane);
      if (r >= 0 && r + kRun <= n) {
        unpack(__ldg(reinterpret_cast<const uint4*>(key + r)), k[j]);
      } else {
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          k[j][e] = (r + e >= 0 && r + e < n) ? key[r + e] : (K)0;
      }
    }
    K before = (lane == 0 && w0 >= 1 && w0 <= n) ? key[w0 - 1] : (K)0;
    unsigned d = 0;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const K up = __shfl_up_sync(kFull, k[j][kRun - 1], 1);
      K prev = lane ? up : before;
      before = __shfl_sync(kFull, k[j][kRun - 1], 31);
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        d |= (unsigned)(k[j][e] != prev) << (kRun * j + e);
        prev = k[j][e];
      }
    }
    return d;
  }
};

// Up to four sorted key arrays, u32 or u64 each, read with scalar loads.
struct ManyKeys {
  static constexpr int kRun = 4;
  const void* key[kMaxKeys];
  int bytes[kMaxKeys];
  int nk;

  template <class K>
  __device__ __forceinline__ static unsigned diff_of(const K* __restrict__ k,
                                                     long long w0,
                                                     long long n) {
    const int lane = threadIdx.x & 31;
    unsigned d = 0;
#pragma unroll
    for (int j = 0; j < kItems / kRun; ++j) {
      const long long r = w0 + (long long)kRun * (32 * j + lane);
      K prev = (r >= 1 && r <= n) ? k[r - 1] : (K)0;
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const K cur = r + e < n ? k[r + e] : prev;
        d |= (unsigned)(cur != prev) << (kRun * j + e);
        prev = cur;
      }
    }
    return d;
  }

  __device__ __forceinline__ unsigned diff(long long w0, long long n) const {
    unsigned d = 0;
    for (int a = 0; a < nk; ++a)
      d |= bytes[a] == 8
               ? diff_of(static_cast<const u64*>(key[a]), w0, n)
               : diff_of(static_cast<const unsigned*>(key[a]), w0, n);
    return d;
  }
};

struct SegArgs {
  const long long* nvalid;   // device: the rows before it are valid
  int* gid;
  long long* num_groups;
  long long* starts;
  long long* ends;
  u64* status;               // a look-back word a tile, then the counter
  long long n;
  int cap_g;
  int tiles;
  int shift;                 // rows before row 0 in the first tile
};

__device__ __forceinline__ void publish(u64* p, unsigned flag,
                                        unsigned count) {
  *reinterpret_cast<volatile u64*>(p) = ((u64)flag << 32) | count;
}

__device__ __forceinline__ u64 read_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// Boundaries in tiles before `tile` (warp 0): read the status words of up
// to 32 earlier tiles at once, nearest first, until one holds an
// inclusive count; every lane must call it.
__device__ __forceinline__ long long look_back(const u64* status, int tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long t = tile - 1;; t -= 32) {
    const long long mine = t - lane;
    u64 w = (u64)kInclusive << 32;            // before tile 0: none
    if (mine >= 0) {
      do {
        w = read_status(status + mine);
      } while ((unsigned)(w >> 32) == 0u);
    }
    const unsigned inc =
        __ballot_sync(kFull, (unsigned)(w >> 32) == kInclusive);
    const int last = inc ? __ffs(inc) - 1 : 31;  // lanes 0..last count
    before += __reduce_add_sync(kFull, lane <= last ? (unsigned)w : 0u);
    if (inc) return before;
  }
}

__device__ __forceinline__ long long valid_rows(const long long* nvalid,
                                                long long n) {
  const long long v = *nvalid;
  return v < 0 ? 0 : (v < n ? v : n);
}

// The blocks past the last tile: num_groups, and the slots past the last
// group (starts = ends = the valid row count).
__device__ __forceinline__ void fill_empty(const SegArgs& a, int block,
                                           long long nv,
                                           long long* s_total) {
  if (threadIdx.x == 0) {
    u64 w;
    do {
      w = read_status(a.status + a.tiles - 1);
    } while ((unsigned)(w >> 32) != kInclusive);
    *s_total = (unsigned)w;
    if (block == 0) *a.num_groups = (unsigned)w;
  }
  __syncthreads();
  const long long step = (long long)(gridDim.x - a.tiles) * kThreads;
  for (long long g = *s_total + (long long)block * kThreads + threadIdx.x;
       g < a.cap_g; g += step) {
    a.starts[g] = nv;
    a.ends[g] = nv;
  }
}

// Group ids of one run of V rows from row r (int4 / int2 stores where the
// run is whole and aligned).
template <int V>
__device__ __forceinline__ void store_run(int* gid, long long r, long long n,
                                          const int (&out)[V]) {
  if (r >= 0 && r + V <= n &&
      reinterpret_cast<uintptr_t>(gid + r) % (4 * V) == 0) {
    if constexpr (V == 4)
      *reinterpret_cast<int4*>(gid + r) =
          make_int4(out[0], out[1], out[2], out[3]);
    else
      *reinterpret_cast<int2*>(gid + r) = make_int2(out[0], out[1]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (r + e >= 0 && r + e < n) gid[r + e] = out[e];
  }
}

template <class Keys>
__global__ void __launch_bounds__(kThreads) k_seg_onesweep(Keys keys,
                                                           SegArgs a) {
  constexpr int V = Keys::kRun;
  constexpr int kSteps = kItems / V;
  __shared__ int warp_tot[kWarps];
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<int*>(a.status + a.tiles), 1);
  __syncthreads();
  const int tile = s_tile;
  const long long nv = valid_rows(a.nvalid, a.n);
  if (tile >= a.tiles) {
    fill_empty(a, tile - a.tiles, nv, &s_before);
    return;
  }
  const long long w0 =
      (long long)tile * kTile + (long long)warp * kWarpRows - a.shift;
  // the boundaries: valid rows whose key differs from the row before, and
  // row 0; each step's count packed in a byte (a warp's step has at most
  // 128 rows)
  const unsigned diff = keys.diff(w0, a.n);
  unsigned flags = 0;
  u64 packed = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long r = w0 + (long long)V * (32 * j + lane);
    unsigned f = (diff >> (V * j)) & ((1u << V) - 1u);
    if (r <= 0 && r + V > 0) f |= 1u << (int)(-r);
    const long long lo = r < 0 ? -r : 0;
    const long long hi = nv - r < V ? nv - r : V;
    f &= hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
    flags |= f << (V * j);
    packed |= (u64)__popc(f) << (8 * j);
  }
  // one warp scan of the packed counts, then the warps' totals
  u64 incl = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const u64 step_tot = __shfl_sync(kFull, incl, 31);
  const u64 excl = incl - packed;
  int warp_total = 0;
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
    warp_total += (int)((step_tot >> (8 * j)) & 0xff);
  if (lane == 0) warp_tot[warp] = warp_total;
  __syncthreads();
  int before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_tot[w];
    total += v;
    if (w < warp) before_warp += v;
  }
  if (warp == 0) {
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) publish(a.status, kInclusive, (unsigned)total);
    } else {
      if (lane == 0) publish(a.status + tile, kAggregate, (unsigned)total);
      before = look_back(a.status, tile);
      if (lane == 0)
        publish(a.status + tile, kInclusive, (unsigned)(before + total));
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();
  // group ids in row order, and each group's bounds at its boundary
  long long g_step = s_before + before_warp;  // boundaries before a step
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const long long r = w0 + (long long)V * (32 * j + lane);
    int g = (int)(g_step + ((excl >> (8 * j)) & 0xff)) - 1;
    g_step += (step_tot >> (8 * j)) & 0xff;
    int out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const long long row = r + e;
      if ((flags >> (V * j + e)) & 1u) {
        ++g;
        if (g < a.cap_g) a.starts[g] = row;
        if (g >= 1 && g - 1 < a.cap_g) a.ends[g - 1] = row;
      }
      if (row == nv - 1 && nv > 0 && g < a.cap_g) a.ends[g] = nv;
      out[e] = row < nv ? g : a.cap_g;
    }
    store_run<V>(a.gid, r, a.n, out);
  }
}

// Tiles of a call: the rows, shifted by the key array's misaligned head.
long long tile_count(long long n, int shift) {
  return (n + shift + kTile - 1) / kTile;
}

template <class Keys>
int launch(const Keys& keys, SegArgs a, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // blocks past the last tile fill the empty slots: up to 4 an SM
  long long fill = ((long long)a.cap_g + kThreads * 8 - 1) / (kThreads * 8);
  if (fill > 4ll * sms) fill = 4ll * sms;
  if (fill < 1) fill = 1;
  cudaError_t e = cudaMemsetAsync(a.status, 0,
                                  sizeof(u64) * ((size_t)a.tiles + 1), st);
  if (e != cudaSuccess) return (int)e;
  k_seg_onesweep<Keys><<<(unsigned)(a.tiles + fill), kThreads, 0, st>>>(keys,
                                                                        a);
  return chtt_last_error();
}

}  // namespace

// Rows of a tile (the Python wrapper sizes the scratch from it).
extern "C" int chtt_segment_tile_rows() { return kTile; }

// keys: nk sorted packed key arrays (u32 or u64 each, key_bytes[a]) of n
// rows; nvalid: device int64, the rows before it are valid.  Writes gid
// (int32, n), num_groups (int64), starts and ends (int64, cap_g).
// scratch holds scratch_size bytes, at least a look-back word (8 bytes) a
// tile of ceil((n + 3) / tile rows) and one for the tile counter.
extern "C" int chtt_segment_bounds(
    const void* const* keys, const int* key_bytes, int nk, long long n,
    const void* nvalid, int cap_g, void* gid, void* num_groups,
    void* starts, void* ends, void* scratch, long long scratch_size,
    void* stream) {
  if (nk < 1 || nk > kMaxKeys || n < 1 || n >= (1ll << 31) || cap_g < 1)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < nk; ++a)
    if ((key_bytes[a] != 4 && key_bytes[a] != 8) ||
        reinterpret_cast<uintptr_t>(keys[a]) % key_bytes[a] != 0)
      return (int)cudaErrorInvalidValue;
  SegArgs a;
  a.nvalid = (const long long*)nvalid;
  a.gid = (int*)gid;
  a.num_groups = (long long*)num_groups;
  a.starts = (long long*)starts;
  a.ends = (long long*)ends;
  a.status = (u64*)scratch;
  a.n = n;
  a.cap_g = cap_g;
  a.shift = nk == 1 ? (int)(reinterpret_cast<uintptr_t>(keys[0]) % 16 /
                            key_bytes[0])
                    : 0;
  const long long tiles = tile_count(n, a.shift);
  if (scratch_size < (long long)sizeof(u64) * (tiles + 1))
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  cudaStream_t st = (cudaStream_t)stream;
  if (nk == 1 && key_bytes[0] == 4)
    return launch(OneKey<unsigned>{(const unsigned*)keys[0]}, a, st);
  if (nk == 1)
    return launch(OneKey<u64>{(const u64*)keys[0]}, a, st);
  ManyKeys m;
  for (int k = 0; k < kMaxKeys; ++k) {
    m.key[k] = k < nk ? keys[k] : nullptr;
    m.bytes[k] = k < nk ? key_bytes[k] : 4;
  }
  m.nk = nk;
  return launch(m, a, st);
}
