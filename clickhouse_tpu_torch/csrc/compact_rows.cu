// K14: stream compaction — the index of each selected row, in row order,
// and their count.
//
// Replaces the reference's gather_compaction_indices and compact_arrays
// (clickhouse_tpu/ops/filter_ops.py:26 and :42), XLA primitives (a
// cumsum of the mask and a searchsorted of each output slot in it, for a
// TPU serialises a scatter).  The streamed collect (exec/streaming.py
// CollectProgram) compacts each chunk's surviving rows on the device, so
// only they cross the link back to the host.
//
// The selection is a block's row mask in the parts K1 takes
// (ops/agg_ops.py RowMask): the rows below n where the optional bool mask
// holds and every `column CMP constant` term passes (k1_terms.cuh), so no
// bool array is built first.  Output slot j < count holds the row of the
// j-th selected row; the slots from count on are not written.
//
// Bound on the card: bytes (the mask or the terms' columns read once, 4
// bytes written a selected row, the count).  The first version (a tile of
// 4,096 rows, one 16-byte load a thread) was held by latency: 32,768
// tiles a 2^27-row chunk, each a load, a block scan, a link of the
// look-back chain and the writes in turn.  Design, one pass:
//   * tiles of kTile = 65,536 rows (2,048 a 2^27-row chunk) are taken
//     from a tile counter in the order blocks start, so a tile's
//     predecessors are all running (K5's rule, csrc/segment_bounds.cu);
//   * a tile is kRuns = 16 steps of 4,096 rows; in each a thread takes one
//     run of 16 rows (a warp 512 contiguous rows, coalesced).  A thread
//     issues its 16 copies of 16 mask bytes into shared memory at once
//     (cp.async: in flight without registers, so 3 blocks fit an SM),
//     then keeps each run's selection as 16 bits.  A partial tile, a mask
//     not 16-byte aligned or K1 terms take the general way: the runs one
//     after another, a term's columns a batch of runs at a time;
//   * counts: a warp scan of two steps' counts packed in one word gives
//     each run its rows before it in its warp and step; one warp scans
//     the tile's (step, warp) totals in row order;
//   * decoupled look-back: the tile publishes its count in a 64-bit
//     (epoch, flag, count) status word as soon as the scan gives it, warp
//     0 reads the words of the 32 tiles before it at once until one holds
//     an inclusive count, and publishes its own.  A word counts only if
//     it carries this call's epoch, so no memset clears the words between
//     calls; the block that takes the last tile resets the counter;
//   * writes: a warp's selected rows of a step go to consecutive slots:
//     up to 32 straight from the lanes, more staged in shared memory (the
//     mask's landing zone, read by then) in row order and stored 32
//     consecutive slots at a time (a dense mask at the write rate); the
//     last tile writes the count.
// One launch a call and no other device operation (the scratch is cached
// per device and stream, zeroed once: ops/filter_ops.py).  Measured on an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py --k14, k14_time), at
// Q5c's 2^27-row mask (0.1 % kept; bound 0.0402 ms): 0.0854 ms, against
// the first version's 0.3031-0.3067 and torch.nonzero's 0.353-0.361; K1's
// count of the same mask (its read alone) takes 0.0704 ms of it and a fill
// of the kept slots 0.005, so the scan, the look-back and the staging
// hold the remaining ≈0.010.  At a dense 2^27-row mask (50 % kept; bound
// 0.1202 ms): 0.191 ms (the first version 0.902).
#include "k1_terms.cuh"

struct ChttCompactArgs {
  const uint8_t* mask;      // NULL: no mask
  int* out;                 // at least n slots
  long long* count;         // one int64, written by the kernel
  u64* status;              // chtt_compact_scratch_words(): a look-back
                            // word a tile, then the tile counter (0
                            // between calls)
  long long n;              // rows to read (the row bound applied)
  int tiles, mask_vec, n_terms;
  unsigned epoch;           // this call's tag, 1 .. 2^30 - 1, new a call
  ChttK1Term terms[kMaxTerms];
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 16;                    // steps (a run each) a tile
constexpr int kStep = kThreads * kRun;       // 4,096 rows
constexpr int kTile = kStep * kRuns;         // 65,536 rows
constexpr int kMaxTiles = (int)(((1ll << 31) + kTile - 1) / kTile);
constexpr int kSlots = kRuns * kWarps;       // (step, warp) pairs a tile
constexpr unsigned kAggregate = 1u, kInclusive = 2u;
static_assert(kRuns % 2 == 0 && kSlots % 32 == 0, "tile shape");

// a look-back word: epoch (30 bits) | flag (2) | count (32)
__device__ __forceinline__ void publish(u64* p, unsigned epoch,
                                        unsigned flag, unsigned count) {
  *reinterpret_cast<volatile u64*>(p) =
      ((u64)epoch << 34) | ((u64)flag << 32) | count;
}

__device__ __forceinline__ u64 read_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// Selected rows in tiles before `tile` (warp 0): the status words of up
// to 32 earlier tiles at once, nearest first, until one holds an
// inclusive count; a word of another call's epoch is not yet published.
// Every lane must call it.
__device__ __forceinline__ long long look_back(const u64* status, int tile,
                                               unsigned epoch) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (int t = tile - 1;; t -= 32) {
    const int mine = t - lane;
    unsigned flag = kInclusive, cnt = 0u;     // before tile 0: none
    if (mine >= 0) {
      u64 w;
      do {
        w = read_status(status + mine);
      } while ((unsigned)(w >> 34) != epoch);
      flag = (unsigned)(w >> 32) & 3u;
      cnt = (unsigned)w;
    }
    const unsigned inc = __ballot_sync(kFull, flag == kInclusive);
    const int last = inc ? __ffs(inc) - 1 : 31;  // lanes 0..last count
    before += __reduce_add_sync(kFull, lane <= last ? cnt : 0u);
    if (inc) return before;
  }
}

// 16 selection bytes -> 16 bits (bit i: row i of the run)
__device__ __forceinline__ unsigned sel_bits(const Sel& s) {
  unsigned b = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)   // bytes 0..3 of 0/1 land on bits 28..31
    b |= ((s.w[j] * 0x10204080u) >> 28) << (4 * j);
  return b;
}

__device__ __forceinline__ unsigned mask_bits(uint4 u) {
  Sel s;
  s.w[0] = __vcmpne4(u.x, 0u) & 0x01010101u;
  s.w[1] = __vcmpne4(u.y, 0u) & 0x01010101u;
  s.w[2] = __vcmpne4(u.z, 0u) & 0x01010101u;
  s.w[3] = __vcmpne4(u.w, 0u) & 0x01010101u;
  return sel_bits(s);
}

__device__ __forceinline__ int rows_from(long long n, long long start) {
  const long long left = n - start;
  return left <= 0 ? 0 : left >= kRun ? kRun : (int)left;
}

// One term ANDed into a tile's runs (gb: a run's 16 bits each), a batch
// of runs' values loaded before any is tested (at most 64 registers of
// values); the loop over batches is not unrolled, to keep the code small
template <typename S>
__device__ __forceinline__ void term_runs(const ChttK1Term& t,
                                          long long base, long long n,
                                          unsigned* gb) {
  constexpr int kBatch = sizeof(S) >= 8 ? 2 : 4;
  const S* col = static_cast<const S*>(t.col);
#pragma unroll 1
  for (int r0 = 0; r0 < kRuns; r0 += kBatch) {
    S v[kBatch][kRun];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long start = base + (long long)(r0 + b) * kStep;
      const int cnt = rows_from(n, start);
      load_run<S>(col + start, cnt == kRun && t.vec, cnt, v[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long start = base + (long long)(r0 + b) * kStep;
      const int cnt = rows_from(n, start);
      unsigned m = 0u;
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        m |= (unsigned)term_pass<S>(t, v[b][i]) << i;
      if (t.valid != nullptr && cnt > 0)
        m &= sel_bits(byte_sel(t.valid + start, cnt == kRun && t.valid_vec,
                               cnt));
      gb[r0 + b] &= m;
    }
  }
}

// A tile's selection the general way (a partial tile, a mask that is not
// 16-byte aligned, K1 terms), its runs one after another
__device__ __forceinline__ void general_bits(const ChttCompactArgs& a,
                                             long long base,
                                             unsigned (&bits)[kRuns]) {
  unsigned gb[kRuns];
#pragma unroll 1
  for (int r = 0; r < kRuns; ++r) {
    const long long start = base + (long long)r * kStep;
    const int cnt = rows_from(a.n, start);
    unsigned b = (1u << cnt) - 1u;
    if (a.mask != nullptr && cnt > 0)
      b &= sel_bits(byte_sel(a.mask + start, cnt == kRun && a.mask_vec,
                             cnt));
    gb[r] = b;
  }
#pragma unroll 1
  for (int i = 0; i < a.n_terms; ++i) {
    const ChttK1Term& t = a.terms[i];
    switch (t.dtype) {
      case DT_I8: term_runs<int8_t>(t, base, a.n, gb); break;
      case DT_I16: term_runs<int16_t>(t, base, a.n, gb); break;
      case DT_I32: term_runs<int32_t>(t, base, a.n, gb); break;
      case DT_I64: term_runs<long long>(t, base, a.n, gb); break;
      case DT_F32: term_runs<float>(t, base, a.n, gb); break;
      case DT_F64: term_runs<double>(t, base, a.n, gb); break;
      default: term_runs<uint8_t>(t, base, a.n, gb); break;
    }
  }
#pragma unroll
  for (int r = 0; r < kRuns; ++r) bits[r] = gb[r];
}

// 16 bytes from global to shared memory, in flight until cp_async_wait
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 3)
    k_compact_rows(const __grid_constant__ ChttCompactArgs a) {
  // kTile bytes: the tile's mask bytes, then a warp's staged rows
  extern __shared__ uint4 s_land[];
  __shared__ int s_off[kSlots + 1];  // (step, warp) -> rows before it in
                                     // the tile; [kSlots]: the tile's
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* const land = reinterpret_cast<uint8_t*>(s_land);
  if (threadIdx.x == 0) {
    unsigned* counter = reinterpret_cast<unsigned*>(a.status + kMaxTiles);
    const int tile = (int)atomicAdd(counter, 1u);
    // the last tile is taken by the launch's last atomicAdd: ready the
    // counter for the next call
    if (tile == a.tiles - 1) atomicExch(counter, 0u);
    s_tile = tile;
  }
  __syncthreads();
  const int tile = s_tile;
  // this thread's run of step r starts at base + r * kStep
  const long long base = (long long)tile * kTile + threadIdx.x * kRun;
  unsigned bits[kRuns];
  if (a.mask != nullptr && a.mask_vec && a.n_terms == 0 &&
      (long long)(tile + 1) * kTile <= a.n) {
    // each thread reads back only the bytes it copied: no barrier
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      cp_async16(land + r * kStep + threadIdx.x * kRun,
                 a.mask + base + (long long)r * kStep);
    cp_async_wait();
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      bits[r] = mask_bits(*reinterpret_cast<const uint4*>(
          land + r * kStep + threadIdx.x * kRun));
  } else {
    general_bits(a, base, bits);
  }

  // rows before each run in its (step, warp): two steps a warp scan
  int excl[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; r += 2) {
    const int v = __popc(bits[r]) | (__popc(bits[r + 1]) << 16);
    int x = v;                         // a field holds at most 512
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    excl[r] = (x - v) & 0xFFFF;
    excl[r + 1] = (x - v) >> 16;
    if (lane == 31) {
      s_off[r * kWarps + warp] = x & 0xFFFF;
      s_off[(r + 1) * kWarps + warp] = x >> 16;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // the (step, warp) totals in row order -> exclusive offsets
    constexpr int kPer = kSlots / 32;
    int v[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = s_off[lane * kPer + j];
      sum += v[j];
    }
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int total = __shfl_sync(kFull, x, 31);
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) publish(a.status, a.epoch, kInclusive, (unsigned)total);
    } else {
      if (lane == 0)
        publish(a.status + tile, a.epoch, kAggregate, (unsigned)total);
      before = look_back(a.status, tile, a.epoch);
      if (lane == 0)
        publish(a.status + tile, a.epoch, kInclusive,
                (unsigned)(before + total));
    }
    int run = x - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s_off[lane * kPer + j] = run;
      run += v[j];
    }
    if (lane == 0) {
      s_off[kSlots] = total;
      s_before = before;
      if (tile == a.tiles - 1) *a.count = before + total;
    }
  }
  __syncthreads();

  // each warp's rows of a step to consecutive slots, in row order
  int* const buf = reinterpret_cast<int*>(s_land) + warp * (kStep / kWarps);
  int* const out = a.out + s_before;
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int slot = r * kWarps + warp;
    const int off = s_off[slot], k = s_off[slot + 1] - off;
    if (k == 0) continue;                // the warp's lanes agree
    const int row0 = (int)(base + (long long)r * kStep);
    unsigned b = bits[r];
    int p = excl[r];
    if (k <= 32) {                       // few: straight from the lanes
      while (b) {
        out[off + p++] = row0 + __ffs(b) - 1;
        b &= b - 1u;
      }
      continue;
    }
    while (b) {
      buf[p++] = row0 + __ffs(b) - 1;
      b &= b - 1u;
    }
    __syncwarp();
    for (int j = lane; j < k; j += 32) out[off + j] = buf[j];
    __syncwarp();
  }
}

}  // namespace

// Rows of a tile.
extern "C" int chtt_compact_tile_rows() { return kTile; }

// Words of the scratch a device and stream keeps: a look-back word for
// each tile of 2^31 rows, then the tile counter.  Zeroed once.
extern "C" int chtt_compact_scratch_words() { return kMaxTiles + 1; }

// args: mask (bool or NULL), out (int32, at least n slots), count (one
// int64), status (the scratch), n (0 < n < 2^31), tiles = ceil(n / tile
// rows), epoch (new a call on the scratch, 1 .. 2^30 - 1), the terms
// (ops/agg_ops.py _k1_term with head 0).  One launch, nothing else.
extern "C" int chtt_compact_rows(const ChttCompactArgs* args,
                                 void* stream) {
  const ChttCompactArgs a = *args;
  if (a.n < 1 || a.n >= (1ll << 31) || a.n_terms < 0 ||
      a.n_terms > kMaxTerms ||
      a.tiles != (int)((a.n + kTile - 1) / kTile) || a.epoch < 1u ||
      a.epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  // the mask's landing zone needs more than the default 48 KB of
  // dynamic shared memory: allowed once on each device
  static unsigned long long allowed = 0ull;   // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !((allowed >> dev) & 1ull))) {
    e = cudaFuncSetAttribute(k_compact_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTile);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k_compact_rows,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && dev < 64) allowed |= 1ull << dev;
  }
  if (e != cudaSuccess) return (int)e;
  k_compact_rows<<<(unsigned)a.tiles, kThreads, kTile,
                   (cudaStream_t)stream>>>(a);
  return chtt_last_error();
}
