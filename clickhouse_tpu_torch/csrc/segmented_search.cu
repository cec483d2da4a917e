// K18: segmented binary search, each query's position within its own
// segment of a sorted table.
//
// Replaces the reference's searchsorted_seg (clickhouse_tpu/ops/
// search.py:52), which finds each (segment, key) query's position in an
// array sorted by (segment, key) with two sorts of table ++ queries (its
// TPU workaround for slow random reads), and searchsorted (:77) with
// searchsorted_via_sort (:31), the same over one segment.  The card reads
// at random well, so a query is a binary search.
//
// Query j searches table[lo, hi): lo = starts[gid[j]], hi = ends[gid[j]]
// (gid clamped to the segments), or the whole table where gid is NULL.
// side left: the first position whose value is not below the query; right:
// the first whose value is above it (hi where there is none).  Values are
// int64, compared signed, or unsigned (the order tokens' u64 bits).
//
// Bound on the card: bytes (the table read once, the queries, their
// segment ids and the results).  A first version: one thread a query, a
// block a run of 256 queries, as many blocks as runs, so the blocks in
// flight hold neighbouring queries (a grid-stride loop spread them over
// the whole array: 4.85 ms against torch.searchsorted's 3.66 at Qw5's
// 100M queries on an NVIDIA H100 80GB HBM3 at 700 W, this form 3.75;
// PERF.md, chip_smoke.py).  The window frames'
// queries come in sorted order, so neighbouring threads search
// neighbouring ranges of the table and their reads meet in the same
// sectors.  A merge-path search over a tile of monotone queries is the
// later redesign.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    k_seg_search(const long long* __restrict__ table, long long n_table,
                 const long long* __restrict__ queries, long long n_q,
                 const int* __restrict__ gid,
                 const long long* __restrict__ starts,
                 const long long* __restrict__ ends, long long n_seg,
                 int right, int uns, long long* __restrict__ out) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_q) return;
  const u64 flip = uns ? CHTT_SIGN : 0ull;
  long long lo = 0, hi = n_table;
  if (gid != nullptr) {
    long long g = gid[j];
    g = g < 0 ? 0 : (g >= n_seg ? n_seg - 1 : g);
    lo = starts[g];
    hi = ends[g];
  }
  const long long key = (long long)((u64)queries[j] ^ flip);
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const long long t = (long long)((u64)__ldg(table + mid) ^ flip);
    if (right ? (t <= key) : (t < key))
      lo = mid + 1;
    else
      hi = mid;
  }
  out[j] = lo;
}

}  // namespace

// table: n_table int64 values sorted within each segment; queries, out:
// n_q int64; gid (int32, n_q) with starts/ends (int64, n_seg), or all
// three NULL for one segment of the whole table.
extern "C" int chtt_segmented_search(const void* table, long long n_table,
                                     const void* queries, long long n_q,
                                     const void* gid, const void* starts,
                                     const void* ends, long long n_seg,
                                     int right, int uns, void* out,
                                     void* stream) {
  if (n_table < 0 || n_q < 0 ||
      (gid != nullptr && (starts == nullptr || ends == nullptr ||
                          n_seg < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_q == 0) return 0;
  const long long blocks = (n_q + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_seg_search<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n_table, (const long long*)queries, n_q,
      (const int*)gid, (const long long*)starts, (const long long*)ends,
      n_seg, right, uns, (long long*)out);
  return chtt_last_error();
}
