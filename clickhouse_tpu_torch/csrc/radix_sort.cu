// K4: stable LSD radix sort of (key, row id) pairs.
//
// Replaces the stable multi-operand jax.lax.sort of the reference's sort
// grouping and full ORDER BY (clickhouse_tpu/ops/agg_ops.py:227
// group_by_sort, clickhouse_tpu/ops/sort_ops.py:71 sort_permutation).  The
// host packs the sort keys into one unsigned key of as few bits as vary
// (ops/sort_ops.py sort_rows: each key less its lower bound, the invalid
// flag on top), so a sort of 100M keys that span 21 bits takes three passes
// of 7-bit digits, not eight.  Wider keys chain calls, least significant
// first; each call carries the permutation of the one before.
//
// Bound on the card: bytes.  The function reads each key once and writes
// the sorted keys and the permutation once: 12 bytes a row for u32 keys.
// This simple version moves more: a pass reads the keys twice (histogram,
// then scatter) and the row ids once, and writes keys and row ids, 20 bytes
// a row a pass for u32 keys.
// Design (three kernels a pass, no look-back):
//   * k_radix_hist: each tile (4,096 rows of u32 keys, 2,048 of u64)
//     counts its digits in shared memory (lanes with the same digit add
//     once); the counts go to device memory
//     digit-major, counts[d * tiles + t];
//   * k_radix_scan: one block a digit turns its row of tile counts into an
//     exclusive prefix and writes the digit's total;
//   * k_radix_scatter: each block rereads its tile.  A warp owns
//     consecutive rows and walks them 32 at a time, so the rank of a row
//     among equal digits is (rows of that digit in earlier tiles) + (in
//     earlier warps of this tile) + (in earlier steps of this warp) +
//     (lower lanes of this step with the same digit, found with one
//     __ballot_sync a digit bit, + __popc): equal digits keep row order,
//     so every pass is stable and ties keep ascending row id, with no
//     atomic deciding an order.  The
//     block first places its rows in shared memory in digit order, then
//     writes them out in that order, so neighbouring threads write
//     neighbouring addresses of a digit's run (a first version wrote each
//     row from registers, scattering a warp's 32 writes over up to 32
//     runs: 13.9 ms at Q2b's inputs on an H100).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadix = 256;

// rows a thread takes a tile: the tile's keys and row ids fit in shared
// memory beside the digit counts (under the 48 KB of a static allocation)
template <class K> struct SortTile {
  static constexpr int kItems = sizeof(K) == 4 ? 16 : 8;
  static constexpr int kRows = kThreads * kItems;     // 4,096 or 2,048
  static constexpr int kWarpRows = 32 * kItems;       // rows a warp owns
};
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <class K>
__device__ __forceinline__ unsigned digit_of(K key, int shift, unsigned mask) {
  return (unsigned)(key >> shift) & mask;
}

// The lanes of the warp whose digit equals this lane's (a live lane's;
// lanes past the end are never peers): one ballot a digit bit, cheaper
// than __match_any_sync.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned digit_peers(unsigned d, bool live,
                                                int digit_bits) {
  unsigned peers = __ballot_sync(kFull, live);
  for (int b = 0; b < digit_bits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

template <class K>
__global__ void __launch_bounds__(kThreads) k_radix_hist(
    const K* __restrict__ keys, long long n, int shift, int digit_bits,
    int* __restrict__ counts, int tiles) {
  const int radix = 1 << digit_bits;
  constexpr int kItems = SortTile<K>::kItems;
  __shared__ int hist[kMaxRadix];
  for (int d = threadIdx.x; d < radix; d += kThreads) hist[d] = 0;
  __syncthreads();
  const unsigned mask = (unsigned)radix - 1;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * SortTile<K>::kRows;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + (long long)j * kThreads + threadIdx.x;
    const bool live = i < n;
    const unsigned d = live ? digit_of(keys[i], shift, mask) : 0u;
    const unsigned peers = digit_peers(d, live, digit_bits);
    if (live && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads)
    counts[(long long)d * tiles + blockIdx.x] = hist[d];
}

// Block d: counts[d * tiles + t] := sum of counts[d * tiles + t'] for t' < t;
// totals[d] := the digit's rows.
__global__ void __launch_bounds__(kScanThreads) k_radix_scan(
    int* __restrict__ counts, int tiles, int* __restrict__ totals) {
  __shared__ int warp_sums[32];
  int* row = counts + (long long)blockIdx.x * tiles;
  int carry = 0;
  for (int c = 0; c < tiles; c += kScanThreads) {
    const int t = c + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int sum;
    const int ex = block_exclusive_scan<kScanThreads>(v, warp_sums, &sum);
    if (t < tiles) row[t] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <class K>
__global__ void __launch_bounds__(kThreads) k_radix_scatter(
    const K* __restrict__ keys_in, const int* __restrict__ vals_in,
    K* __restrict__ keys_out, int* __restrict__ vals_out, long long n,
    int shift, int digit_bits, const int* __restrict__ counts,
    const int* __restrict__ totals, int tiles) {
  const int radix = 1 << digit_bits;
  constexpr int kItems = SortTile<K>::kItems;
  constexpr int kRows = SortTile<K>::kRows;
  __shared__ int warp_pos[kWarps][kMaxRadix];
  __shared__ int out_base[kMaxRadix];   // output position less local one
  __shared__ int warp_sums[32];
  __shared__ K s_key[kRows];            // the tile in digit order
  __shared__ int s_val[kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = (unsigned)radix - 1;
  const int d_own = threadIdx.x;        // the digit this thread tends
  const bool owns = d_own < radix;
  int global_start = 0;
  {
    // where this tile's rows of each digit start in the output: the rows
    // of smaller digits, plus this digit's rows in earlier tiles
    const int tot = owns ? totals[d_own] : 0;
    int all;
    const int ex = block_exclusive_scan<kThreads>(tot, warp_sums, &all);
    if (owns)
      global_start = ex + counts[(long long)d_own * tiles + blockIdx.x];
  }
  for (int i = threadIdx.x; i < kWarps * kMaxRadix; i += kThreads)
    (&warp_pos[0][0])[i] = 0;
  __syncthreads();

  // step j of warp w holds rows base + 32 j + lane
  const long long tile_start = (long long)blockIdx.x * kRows;
  const long long base = tile_start + (long long)warp * SortTile<K>::kWarpRows;
  // keys and row ids stay in registers; digits are recomputed from them
  K key[kItems];
  int val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j + lane;
    key[j] = i < n ? keys_in[i] : (K)0;
    val[j] = i >= n ? 0 : (vals_in != nullptr ? vals_in[i] : (int)i);
  }
  // this warp's rows of each digit
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = base + 32 * j + lane < n;
    const unsigned d = digit_of(key[j], shift, mask);
    const unsigned peers = digit_peers(d, live, digit_bits);
    if (live && lane == __ffs(peers) - 1) warp_pos[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the tile's rows of each digit, and where they start in the tile's
  // digit order
  int tile_count = 0;
  if (owns)
    for (int w = 0; w < kWarps; ++w) tile_count += warp_pos[w][d_own];
  int all;
  const int local_start =
      block_exclusive_scan<kThreads>(tile_count, warp_sums, &all);
  // warp_pos[w][d] := local position of warp w's first row of digit d
  if (owns) {
    int run = local_start;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_pos[w][d_own];
      warp_pos[w][d_own] = run;
      run += c;
    }
    out_base[d_own] = global_start - local_start;
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = base + 32 * j + lane < n;
    const unsigned d = digit_of(key[j], shift, mask);
    const unsigned peers = digit_peers(d, live, digit_bits);
    if (live) {
      const int pos = warp_pos[warp][d] + __popc(peers & lower);
      s_key[pos] = key[j];
      s_val[pos] = val[j];
    }
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) warp_pos[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // out in digit order: neighbouring threads, neighbouring addresses
  const int rows = (int)(n - tile_start < kRows ? n - tile_start : kRows);
  for (int p = threadIdx.x; p < rows; p += kThreads) {
    const K k = s_key[p];
    const int o = out_base[digit_of(k, shift, mask)] + p;
    keys_out[o] = k;
    vals_out[o] = s_val[p];
  }
}

template <class K>
int sort_pairs(const K* keys, const int* vals, long long n, int passes,
               int digit_bits, K* keys_a, int* vals_a, K* keys_b,
               int* vals_b, int* counts, int* totals, cudaStream_t s) {
  const int tiles =
      (int)((n + SortTile<K>::kRows - 1) / SortTile<K>::kRows);
  const int radix = 1 << digit_bits;
  const K* kin = keys;
  const int* vin = vals;
  for (int p = 0; p < passes; ++p) {
    K* kout = (p % 2 == 0) ? keys_a : keys_b;
    int* vout = (p % 2 == 0) ? vals_a : vals_b;
    const int shift = p * digit_bits;
    k_radix_hist<K><<<tiles, kThreads, 0, s>>>(kin, n, shift, digit_bits,
                                               counts, tiles);
    k_radix_scan<<<radix, kScanThreads, 0, s>>>(counts, tiles, totals);
    k_radix_scatter<K><<<tiles, kThreads, 0, s>>>(
        kin, vin, kout, vout, n, shift, digit_bits, counts, totals, tiles);
    const int rc = chtt_last_error();
    if (rc != 0) return rc;
    kin = kout;
    vin = vout;
  }
  return 0;
}

}  // namespace

// Rows a tile of the sort takes for keys of key_bytes bytes (the wrapper
// sizes the counts with it).
extern "C" int chtt_radix_tile_rows(int key_bytes) {
  return key_bytes == 8 ? SortTile<u64>::kRows : SortTile<unsigned>::kRows;
}

// Sort n (key, value) pairs by the low passes * digit_bits bits of the key
// (key_bytes 4: u32, 8: u64), stably.  vals NULL: the values are the row
// ids 0 .. n-1.  Pass p writes buffer a when p is even, b when odd; the
// result is in the buffer of the last pass.  counts holds
// (1 << digit_bits) * ceil(n / tile) ints, totals 1 << digit_bits.
extern "C" int chtt_radix_sort_pairs(
    const void* keys, int key_bytes, const void* vals, long long n,
    int passes, int digit_bits, void* keys_a, void* vals_a, void* keys_b,
    void* vals_b, void* counts, void* totals, void* stream) {
  if (n < 1 || n >= (1ll << 31) || passes < 1 || digit_bits < 1 ||
      digit_bits > 8 || (long long)passes * digit_bits > 8 * key_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 4)
    return sort_pairs<unsigned>(
        (const unsigned*)keys, (const int*)vals, n, passes, digit_bits,
        (unsigned*)keys_a, (int*)vals_a, (unsigned*)keys_b, (int*)vals_b,
        (int*)counts, (int*)totals, s);
  if (key_bytes == 8)
    return sort_pairs<u64>(
        (const u64*)keys, (const int*)vals, n, passes, digit_bits,
        (u64*)keys_a, (int*)vals_a, (u64*)keys_b, (int*)vals_b, (int*)counts,
        (int*)totals, s);
  return (int)cudaErrorInvalidValue;
}
