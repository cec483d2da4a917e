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
// bytes written a selected row, the count).  Design, one pass:
//   * tiles of 4,096 rows are taken from a tile counter in the order
//     blocks start, so a tile's predecessors are all running (K5's rule,
//     csrc/segment_bounds.cu);
//   * a thread takes a run of 16 rows: its selection is 16 bytes of 0/1
//     in registers (the mask's bytes in one 16-byte load where aligned,
//     each term's result ANDed in), its count __popc of four words;
//   * one block scan of the threads' counts gives each run its rows
//     before it in the tile and the tile's count;
//   * decoupled look-back: the tile publishes its count in a 64-bit (flag,
//     count) status word, warp 0 reads the words of the 32 tiles before it
//     at once until one holds an inclusive count, and publishes its own;
//     one memset a call clears the words;
//   * each thread writes its selected rows' indices at its exclusive
//     prefix, so row order is kept; the last tile writes the count.
#include "k1_terms.cuh"

struct ChttCompactArgs {
  const uint8_t* mask;      // NULL: no mask
  int* out;                 // cap slots
  long long* count;         // one int64
  u64* status;              // a look-back word a tile, then the counter
  long long n;              // rows to read (the row bound applied)
  int tiles, mask_vec, n_terms, pad;
  ChttK1Term terms[kMaxTerms];
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kTile = kThreads * kRun;      // 4,096 rows
constexpr unsigned kAggregate = 1u, kInclusive = 2u;

__device__ __forceinline__ void publish(u64* p, unsigned flag,
                                        unsigned count) {
  *reinterpret_cast<volatile u64*>(p) = ((u64)flag << 32) | count;
}

__device__ __forceinline__ u64 read_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// Selected rows in tiles before `tile` (warp 0): the status words of up
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

__global__ void __launch_bounds__(kThreads)
    k_compact_rows(const __grid_constant__ ChttCompactArgs a) {
  __shared__ int warp_sums[32];
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<int*>(a.status + a.tiles), 1);
  __syncthreads();
  const int tile = s_tile;
  const long long start = (long long)tile * kTile + (long long)threadIdx.x
      * kRun;
  const long long left = a.n - start;
  const int cnt = left <= 0 ? 0 : left >= kRun ? kRun : (int)left;
  const bool body = cnt == kRun;
  Sel s = first_rows(cnt);
  if (cnt > 0) {
    if (a.mask != nullptr)
      s = sel_and(s, byte_sel(a.mask + start, body && a.mask_vec, cnt));
    for (int i = 0; i < a.n_terms; ++i)
      s = sel_and(s, term_sel_in(&a.terms[i], start, cnt, body));
  }
  const int mine = __popc(s.w[0]) + __popc(s.w[1]) + __popc(s.w[2]) +
                   __popc(s.w[3]);
  int total = 0;
  const int off = block_exclusive_scan<kThreads>(mine, warp_sums, &total);
  if (threadIdx.x < 32) {
    long long before = 0;
    if (tile == 0) {
      if (lane == 0) publish(a.status, kInclusive, (unsigned)total);
    } else {
      if (lane == 0) publish(a.status + tile, kAggregate, (unsigned)total);
      before = look_back(a.status, tile);
      if (lane == 0)
        publish(a.status + tile, kInclusive, (unsigned)(before + total));
    }
    if (lane == 0) {
      s_before = before;
      if (tile == a.tiles - 1) *a.count = before + total;
    }
  }
  __syncthreads();
  long long at = s_before + off;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (sel_byte(s, i)) a.out[at++] = (int)(start + i);
}

}  // namespace

// Rows of a tile (the Python wrapper sizes the scratch from it).
extern "C" int chtt_compact_tile_rows() { return kTile; }

// args: mask (bool or NULL), out (int32, at least n slots), count (one
// int64), status (scratch: a word a tile of ceil(n / tile rows) and one
// for the tile counter), n (0 < n < 2^31), the terms (ops/agg_ops.py
// _k1_term with head 0).  Clears the scratch, then one launch.
extern "C" int chtt_compact_rows(const ChttCompactArgs* args,
                                 void* stream) {
  const ChttCompactArgs a = *args;
  if (a.n < 1 || a.n >= (1ll << 31) || a.n_terms < 0 ||
      a.n_terms > kMaxTerms ||
      a.tiles != (int)((a.n + kTile - 1) / kTile))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a.status, 0,
                                  sizeof(u64) * ((size_t)a.tiles + 1), st);
  if (e != cudaSuccess) return (int)e;
  k_compact_rows<<<(unsigned)a.tiles, kThreads, 0, st>>>(a);
  return chtt_last_error();
}
