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
// Bound on the card: bytes.  Each row's sorted key is read once (twice
// here: the count pass and the write pass) and its group id written once;
// starts and ends are 16 bytes a group slot.
// Design (three kernels, no look-back):
//   * k_seg_count: each tile of 4,096 rows counts its boundaries (a row
//     whose packed key differs from the row before it), and every block
//     fills part of starts/ends with the valid row count (the empty slots'
//     bounds, as the reference gives them);
//   * k_seg_scan: one block turns the tile counts into an exclusive prefix
//     (the group id before each tile) and writes num_groups;
//   * k_seg_write: each tile scans its boundaries in row order (16 block
//     scans of 256 rows) to give each row its dense group id, and writes
//     starts/ends at each boundary.  Groups at or above the slot capacity
//     write nothing: the caller's capacity check reports them.
// Rows at or past the valid row count (the invalid rows, which the sort put
// last) get group id cap_g.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kMaxKeys = 4;

struct SegKeys {
  const void* key[kMaxKeys];   // sorted packed keys, u32 or u64 each
  int bytes[kMaxKeys];
  int nk;
};

__device__ __forceinline__ bool is_boundary(const SegKeys& s, long long i) {
  if (i == 0) return true;
  for (int a = 0; a < s.nk; ++a) {
    if (s.bytes[a] == 8) {
      const u64* k = (const u64*)s.key[a];
      if (k[i] != k[i - 1]) return true;
    } else {
      const unsigned* k = (const unsigned*)s.key[a];
      if (k[i] != k[i - 1]) return true;
    }
  }
  return false;
}

__device__ __forceinline__ long long valid_rows(const long long* nvalid,
                                                long long n) {
  const long long v = *nvalid;
  return v < 0 ? 0 : (v < n ? v : n);
}

__global__ void __launch_bounds__(kThreads) k_seg_count(
    SegKeys s, long long n, const long long* __restrict__ nvalid,
    int* __restrict__ tile_count, int tiles, long long* __restrict__ starts,
    long long* __restrict__ ends, int cap_g) {
  __shared__ int warp_sums[32];
  const long long nv = valid_rows(nvalid, n);
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < cap_g;
       g += (long long)gridDim.x * kThreads) {
    starts[g] = nv;
    ends[g] = nv;
  }
  if ((int)blockIdx.x >= tiles) return;       // a block that only fills
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    if (i < nv && is_boundary(s, i)) ++c;
  }
  int total;
  block_exclusive_scan<kThreads>(c, warp_sums, &total);
  if (threadIdx.x == 0) tile_count[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads) k_seg_scan(
    int* __restrict__ tile_count, int tiles,
    long long* __restrict__ num_groups) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int c = 0; c < tiles; c += kScanThreads) {
    const int t = c + threadIdx.x;
    const int v = t < tiles ? tile_count[t] : 0;
    int sum;
    const int ex = block_exclusive_scan<kScanThreads>(v, warp_sums, &sum);
    if (t < tiles) tile_count[t] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) *num_groups = carry;
}

__global__ void __launch_bounds__(kThreads) k_seg_write(
    SegKeys s, long long n, const long long* __restrict__ nvalid,
    const int* __restrict__ tile_base, int* __restrict__ gid,
    long long* __restrict__ starts, long long* __restrict__ ends, int cap_g) {
  __shared__ int warp_sums[32];
  const long long nv = valid_rows(nvalid, n);
  const long long base = (long long)blockIdx.x * kTile;
  int before = tile_base[blockIdx.x];        // boundaries before this slab
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    const int flag = (i < nv && is_boundary(s, i)) ? 1 : 0;
    int slab;
    const int ex = block_exclusive_scan<kThreads>(flag, warp_sums, &slab);
    if (i < n) {
      if (i < nv) {
        const int g = before + ex + flag - 1;
        gid[i] = g;
        if (flag) {
          if (g < cap_g) starts[g] = i;
          if (g >= 1 && g - 1 < cap_g) ends[g - 1] = i;
        }
        if (i == nv - 1 && g < cap_g) ends[g] = nv;
      } else {
        gid[i] = cap_g;
      }
    }
    before += slab;
  }
}

}  // namespace

extern "C" int chtt_segment_tile_rows() { return kTile; }

// keys: nk sorted packed key arrays (u32 or u64 each, key_bytes[a]) of n
// rows; nvalid: device int64, the rows before it are valid.  Writes gid
// (int32, n), num_groups (int64), starts and ends (int64, cap_g).
// tile_count holds ceil(n / tile) ints of scratch.
extern "C" int chtt_segment_bounds(
    const void* const* keys, const int* key_bytes, int nk, long long n,
    const void* nvalid, int cap_g, void* gid, void* num_groups,
    void* starts, void* ends, void* tile_count, int fill_blocks,
    void* stream) {
  if (nk < 1 || nk > kMaxKeys || n < 1 || n >= (1ll << 31) || cap_g < 1 ||
      fill_blocks < 1)
    return (int)cudaErrorInvalidValue;
  SegKeys s;
  for (int a = 0; a < kMaxKeys; ++a) {
    s.key[a] = a < nk ? keys[a] : nullptr;
    s.bytes[a] = a < nk ? key_bytes[a] : 4;
    if (a < nk && key_bytes[a] != 4 && key_bytes[a] != 8)
      return (int)cudaErrorInvalidValue;
  }
  s.nk = nk;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)((n + kTile - 1) / kTile);
  // the fill of starts/ends needs enough blocks for cap_g slots too
  const int blocks = tiles > fill_blocks ? tiles : fill_blocks;
  k_seg_count<<<blocks, kThreads, 0, st>>>(
      s, n, (const long long*)nvalid, (int*)tile_count, tiles,
      (long long*)starts, (long long*)ends, cap_g);
  k_seg_scan<<<1, kScanThreads, 0, st>>>((int*)tile_count, tiles,
                                         (long long*)num_groups);
  k_seg_write<<<tiles, kThreads, 0, st>>>(
      s, n, (const long long*)nvalid, (const int*)tile_count, (int*)gid,
      (long long*)starts, (long long*)ends, cap_g);
  return chtt_last_error();
}
