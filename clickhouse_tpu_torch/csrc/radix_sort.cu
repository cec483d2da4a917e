// K4: stable LSD radix sort of (key, row id) pairs, onesweep.
//
// Replaces the stable multi-operand jax.lax.sort of the reference's sort
// grouping and full ORDER BY (clickhouse_tpu/ops/agg_ops.py:227
// group_by_sort, clickhouse_tpu/ops/sort_ops.py:71 sort_permutation).  The
// host packs the sort keys into one unsigned key of as few bits as vary
// (ops/sort_ops.py sort_rows: each key less its lower bound, the invalid
// flag on top), so a sort of 100M keys that span 20 bits takes three passes
// of 7-bit digits, not eight.  Wider keys chain calls, least significant
// first; each call carries the permutation of the one before.
//
// Bound on the card: bytes.  The function reads each key once and writes
// the sorted keys and the permutation once: 12 bytes a row for u32 keys
// (0.358 ms for Q2b's 100M keys at 3.35 TB/s).  A pass of an LSD sort must
// read and write each key and row id, so the passes cost a multiple of it.
// Design (after Adinets & Merrill, "Onesweep", 2022): one histogram kernel
// for every pass, then one scatter kernel a pass, each key read once a
// pass.
//   * k_onesweep_hist reads the keys once (16-byte loads) and counts the
//     digits of every pass in shared memory; a thread adds a run of equal
//     digits with one atomic (a constant digit costs one atomic a thread,
//     not one a row); each block adds its counts to one passes x radix
//     table in device memory;
//   * k_onesweep_scatter (one launch a pass) takes tiles of 8,192 rows of
//     u32 keys (4,096 of u64) in dynamic shared memory, in the order of a
//     tile counter (a tile's predecessors have started, so the look-back
//     below never waits on a block that is not running).  A warp owns
//     consecutive rows and ranks each row among equal digits once: (rows
//     of that digit in earlier steps of this warp) + (lower lanes of this
//     step with the same digit, from one __ballot_sync a digit bit and
//     __popc).  Equal digits keep row order, so every pass is stable and
//     ties keep ascending row id, with no atomic deciding an order;
//   * decoupled look-back: the block publishes each digit's count in its
//     tile (flag "aggregate"), places its rows in shared memory in digit
//     order, then walks back over earlier tiles' status words until one
//     holds an inclusive prefix, and publishes its own ("inclusive").  A
//     status word carries the flag, the pass and the count in one 64-bit
//     word, so a reader sees all of it or none; no digits x tiles count
//     array is written or scanned;
//   * the block then writes its rows out in digit order: neighbouring
//     threads write neighbouring addresses of a digit's run, 64 rows a run
//     on average at Q2b's 7-bit digits.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W power
// limit, at Q2b's inputs (100M u32 keys of 20 bits, three 7-bit passes):
// 2.85 ms, of it 0.29 ms histogram and 0.85 ms a scatter pass (torch.sort
// 4.94 ms; the first version, three kernels a pass, 4.71 ms).  Tiles of
// 16,384 rows (1,024-thread blocks, one an SM) were slower.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHistThreads = 256;
constexpr int kThreads = 512;            // a scatter block (two fit an SM)
constexpr int kHistBlocksPerSm = 4;
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

// rows a thread ranks: the tile is kThreads * kItems rows
template <class K> struct Items {
  static constexpr int value = sizeof(K) == 4 ? 16 : 8;
};
// passes a key width allows (at least one bit a digit, at most eight)
template <class K> struct MaxPasses {
  static constexpr int value = sizeof(K) == 4 ? 4 : 8;
};

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

// One 16-byte load's keys.
__device__ __forceinline__ void unpack(const uint4& q, unsigned (&k)[4]) {
  k[0] = q.x; k[1] = q.y; k[2] = q.z; k[3] = q.w;
}
__device__ __forceinline__ void unpack(const uint4& q, u64 (&k)[2]) {
  k[0] = ((u64)q.y << 32) | q.x;
  k[1] = ((u64)q.w << 32) | q.z;
}

// Count one key's digits of every pass: runs of an equal digit (per pass)
// are added with one shared atomic when the run ends.
template <class K>
__device__ __forceinline__ void count_key(K key, int passes, int digit_bits,
                                          unsigned mask, int* s_hist,
                                          unsigned (&cur)[MaxPasses<K>::value],
                                          int (&run)[MaxPasses<K>::value]) {
#pragma unroll
  for (int p = 0; p < MaxPasses<K>::value; ++p) {
    if (p < passes) {
      const unsigned d = digit_of(key, p * digit_bits, mask);
      if (d != cur[p]) {
        if (run[p]) atomicAdd(&s_hist[(p << digit_bits) + cur[p]], run[p]);
        cur[p] = d;
        run[p] = 0;
      }
      ++run[p];
    }
  }
}

// hist[p * radix + d] += rows whose digit of pass p is d (hist zeroed).
template <class K>
__global__ void __launch_bounds__(kHistThreads) k_onesweep_hist(
    const K* __restrict__ keys, long long n, int passes, int digit_bits,
    int* __restrict__ hist) {
  constexpr int kP = MaxPasses<K>::value;
  constexpr int kPerVec = 16 / sizeof(K);
  extern __shared__ int s_hist[];                 // passes << digit_bits
  const int cells = passes << digit_bits;
  const unsigned mask = (1u << digit_bits) - 1u;
  for (int i = threadIdx.x; i < cells; i += kHistThreads) s_hist[i] = 0;
  __syncthreads();
  unsigned cur[kP];
  int run[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    cur[p] = 0;
    run[p] = 0;
  }
  const long long stride = (long long)gridDim.x * kHistThreads;
  const long long first = (long long)blockIdx.x * kHistThreads + threadIdx.x;
  const long long vecs = n / kPerVec;
  const uint4* v = reinterpret_cast<const uint4*>(keys);
  for (long long i = first; i < vecs; i += stride) {
    K k[kPerVec];
    unpack(v[i], k);
#pragma unroll
    for (int e = 0; e < kPerVec; ++e)
      count_key(k[e], passes, digit_bits, mask, s_hist, cur, run);
  }
  for (long long i = vecs * kPerVec + first; i < n; i += stride)
    count_key(keys[i], passes, digit_bits, mask, s_hist, cur, run);
#pragma unroll
  for (int p = 0; p < kP; ++p)
    if (p < passes && run[p])
      atomicAdd(&s_hist[(p << digit_bits) + cur[p]], run[p]);
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kHistThreads)
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
}

// A look-back status word: (flag | pass << 2) in the high half, the count
// in the low half.  Zero (the call's memset) is "not published".
__device__ __forceinline__ void publish(u64* p, unsigned flag, int pass,
                                        int count) {
  const u64 w = ((u64)(flag | ((unsigned)pass << 2)) << 32) | (unsigned)count;
  *reinterpret_cast<volatile u64*>(p) = w;
}

template <class K> __host__ __device__ constexpr int tile_rows() {
  return kThreads * Items<K>::value;
}

template <class K>
constexpr size_t scatter_smem(int radix) {
  return (size_t)tile_rows<K>() * (sizeof(K) + sizeof(int)) +
         sizeof(int) * ((size_t)(kThreads / 32) * radix + radix + 33);
}

// One pass: rows of keys_in / vals_in (row ids where vals_in is NULL) to
// keys_out / vals_out, stably by the digit at `shift`.  hist holds this
// pass's digit counts; status tiles * radix words and tile_counter one
// int, all zero at the first pass (status words carry the pass).
template <class K>
__global__ void __launch_bounds__(kThreads, 2) k_onesweep_scatter(
    const K* __restrict__ keys_in, const int* __restrict__ vals_in,
    K* __restrict__ keys_out, int* __restrict__ vals_out, long long n,
    int shift, int digit_bits, int pass, const int* __restrict__ hist,
    u64* status, int* tile_counter) {
  constexpr int kItems = Items<K>::value;
  constexpr int kRows = tile_rows<K>();
  constexpr int kWarpRows = 32 * kItems;
  constexpr int kW = kThreads / 32;
  const int radix = 1 << digit_bits;
  const unsigned mask = (unsigned)radix - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  K* s_key = reinterpret_cast<K*>(smem);        // the tile in digit order
  int* s_val = reinterpret_cast<int*>(s_key + kRows);
  int* warp_cnt = s_val + kRows;                // [kW][radix]
  int* s_base = warp_cnt + kW * radix;          // output position less local
  int* warp_sums = s_base + radix;              // [32]
  int* s_tile = warp_sums + 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) *s_tile = atomicAdd(tile_counter, 1);
  for (int i = threadIdx.x; i < kW * radix; i += kThreads) warp_cnt[i] = 0;
  __syncthreads();
  const long long tile = *s_tile;
  const long long tile_start = tile * kRows;
  // step j of warp w holds rows base + 32 j + lane
  const long long base = tile_start + (long long)warp * kWarpRows;
  K key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j + lane;
    key[j] = i < n ? keys_in[i] : (K)0;
  }
  // each row's rank among this warp's rows of its digit
  int rank[kItems];
  int* my_cnt = warp_cnt + warp * radix;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = base + 32 * j + lane < n;
    const unsigned d = digit_of(key[j], shift, mask);
    const unsigned peers = digit_peers(d, live, digit_bits);
    const int before = my_cnt[d];
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) my_cnt[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // the tile's rows of each digit, where they start in the tile's digit
  // order, and where each warp's start
  const int d_own = threadIdx.x;                // the digit this thread tends
  const bool owns = d_own < radix;
  int count = 0;
  if (owns)
    for (int w = 0; w < kW; ++w) count += warp_cnt[w * radix + d_own];
  int all;
  const int local_start =
      block_exclusive_scan<kThreads>(count, warp_sums, &all);
  u64* mine = status + tile * radix + d_own;
  if (owns) {
    publish(mine, tile == 0 ? kInclusive : kAggregate, pass, count);
    int run = local_start;
    for (int w = 0; w < kW; ++w) {
      const int c = warp_cnt[w * radix + d_own];
      warp_cnt[w * radix + d_own] = run;
      run += c;
    }
  }
  // where each digit starts in this pass's output
  const int digit_start =
      block_exclusive_scan<kThreads>(owns ? hist[d_own] : 0, warp_sums, &all);
  // the rows into shared memory in digit order (the scan synchronised)
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j + lane;
    if (i < n) {
      const int pos = my_cnt[digit_of(key[j], shift, mask)] + rank[j];
      s_key[pos] = key[j];
      s_val[pos] = vals_in != nullptr ? vals_in[i] : (int)i;
    }
  }
  // look back: this digit's rows in earlier tiles
  if (owns) {
    int before = 0;
    if (tile > 0) {
      long long t = tile - 1;
      for (;;) {
        const u64 w =
            *reinterpret_cast<volatile u64*>(status + t * radix + d_own);
        const unsigned hi = (unsigned)(w >> 32);
        if ((hi & 3u) == 0u || (int)(hi >> 2) != pass) continue;
        before += (int)(unsigned)w;
        if ((hi & 3u) == kInclusive) break;
        --t;
      }
      publish(mine, kInclusive, pass, before + count);
    }
    s_base[d_own] = digit_start + before - local_start;
  }
  __syncthreads();
  // out in digit order: neighbouring threads, neighbouring addresses
  const int rows = (int)(n - tile_start < kRows ? n - tile_start : kRows);
  for (int p = threadIdx.x; p < rows; p += kThreads) {
    const K k = s_key[p];
    const int o = s_base[digit_of(k, shift, mask)] + p;
    keys_out[o] = k;
    vals_out[o] = s_val[p];
  }
}

// Bytes of the scratch a call needs: the passes x radix histogram, a tile
// counter a pass (padded to 8 bytes), and tiles x radix status words.
long long scratch_bytes(long long n, int passes, int digit_bits, int rows) {
  const long long tiles = (n + rows - 1) / rows;
  const long long ints = ((long long)passes << digit_bits) + passes;
  return (ints + (ints & 1)) * 4 + tiles * (1ll << digit_bits) * 8;
}

template <class K>
int sort_pairs(const K* keys, const int* vals, long long n, int passes,
               int digit_bits, K* keys_a, int* vals_a, K* keys_b,
               int* vals_b, void* scratch, long long scratch_size,
               cudaStream_t s) {
  constexpr int kRows = tile_rows<K>();
  if (scratch_size < scratch_bytes(n, passes, digit_bits, kRows))
    return (int)cudaErrorInvalidValue;
  const int radix = 1 << digit_bits;
  const long long tiles = (n + kRows - 1) / kRows;
  int* hist = reinterpret_cast<int*>(scratch);
  int* counters = hist + passes * radix;
  const long long ints = (long long)passes * radix + passes;
  u64* status = reinterpret_cast<u64*>(hist + ints + (ints & 1));
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)scratch_bytes(n, passes, digit_bits, kRows), s);
  if (e != cudaSuccess) return (int)e;

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long vec_rows = (n + kHistThreads - 1) / kHistThreads;
  const int hist_blocks = (int)(vec_rows < (long long)sms * kHistBlocksPerSm
                                    ? (vec_rows > 0 ? vec_rows : 1)
                                    : (long long)sms * kHistBlocksPerSm);
  k_onesweep_hist<K><<<hist_blocks, kHistThreads,
                       sizeof(int) * (passes << digit_bits), s>>>(
      keys, n, passes, digit_bits, hist);
  int rc = chtt_last_error();
  if (rc != 0) return rc;

  const size_t smem = scatter_smem<K>(radix);
  e = cudaFuncSetAttribute(k_onesweep_scatter<K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const K* kin = keys;
  const int* vin = vals;
  for (int p = 0; p < passes; ++p) {
    K* kout = (p % 2 == 0) ? keys_a : keys_b;
    int* vout = (p % 2 == 0) ? vals_a : vals_b;
    k_onesweep_scatter<K><<<(unsigned)tiles, kThreads, smem, s>>>(
        kin, vin, kout, vout, n, p * digit_bits, digit_bits, p,
        hist + p * radix, status, counters + p);
    rc = chtt_last_error();
    if (rc != 0) return rc;
    kin = kout;
    vin = vout;
  }
  return 0;
}

}  // namespace

// Rows of a scatter tile for keys of key_bytes bytes (4 or 8; 0 else).
extern "C" int chtt_radix_tile_rows(int key_bytes) {
  if (key_bytes == 4) return tile_rows<unsigned>();
  if (key_bytes == 8) return tile_rows<u64>();
  return 0;
}

// Sort n (key, value) pairs by the low passes * digit_bits bits of the key
// (key_bytes 4: u32, 8: u64), stably.  keys must start on a 16-byte
// boundary.  vals NULL: the values are the row ids 0 .. n-1.  Pass p
// writes buffer a when p is even, b when odd; the result is in the buffer
// of the last pass.  scratch holds scratch_size bytes, at least the
// histogram, the tile counters and the status words (see scratch_bytes).
extern "C" int chtt_radix_sort_pairs(
    const void* keys, int key_bytes, const void* vals, long long n,
    int passes, int digit_bits, void* keys_a, void* vals_a, void* keys_b,
    void* vals_b, void* scratch, long long scratch_size, void* stream) {
  if (n < 1 || n >= (1ll << 31) || passes < 1 || digit_bits < 1 ||
      digit_bits > 8 || (key_bytes != 4 && key_bytes != 8) ||
      passes > (key_bytes == 4 ? MaxPasses<unsigned>::value
                               : MaxPasses<u64>::value) ||
      (long long)passes * digit_bits > 8 * key_bytes ||
      reinterpret_cast<uintptr_t>(keys) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 4)
    return sort_pairs<unsigned>(
        (const unsigned*)keys, (const int*)vals, n, passes, digit_bits,
        (unsigned*)keys_a, (int*)vals_a, (unsigned*)keys_b, (int*)vals_b,
        scratch, scratch_size, s);
  return sort_pairs<u64>(
      (const u64*)keys, (const int*)vals, n, passes, digit_bits,
      (u64*)keys_a, (int*)vals_a, (u64*)keys_b, (int*)vals_b, scratch,
      scratch_size, s);
}
