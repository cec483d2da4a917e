// K2: exact per-slot counts and integer sums of a dense GROUP BY.
//
// Replaces the reference's mxu_group_reduce and mxu_counts_and_sums
// (clickhouse_tpu/ops/mxu_segsum.py:51 and :172), which build one-hot
// matrices and run f32 matmuls over 8-bit limbs because a TPU serializes
// scatter.  The card has fast shared memory, so the histogram is built
// directly: no limbs, no sign bias, no matmul.  Integer adds wrap mod 2^64,
// so signed and unsigned sums share the same bits and the order the adds
// land in cannot change the result.
//
// Bound on the card: bytes read.  Every row reads its slot id (4 or 8
// bytes), its masks (1 byte each) and its summed values (1-8 bytes each)
// once; the outputs are (C + K) x S words.  At Q2's shape (int32 ids, the
// row mask, one int64 sum, S = 1,024) that is 1.3 GB at 100M rows,
// 0.388 ms at 3.35 TB/s.
// Design, against what held the first version back (one row a thread with
// scalar loads, a switch on the value type for every row, C + K 64-bit
// shared atomics a row, two blocks an SM):
//   * each thread takes runs of 4 consecutive rows (grid-stride over runs)
//     and reads each array with vector loads; the next run's ids, base
//     mask and first summed array load while this run is processed.  The
//     id type is a template parameter and each summed array's type is
//     switched on once a run, not once a row, into a loader templated on it;
//   * four blocks an SM (registers capped by __launch_bounds__, 48 KB of
//     shared memory each) where one histogram fits in 48 KB: the kernel is
//     bound by how many loads are in flight, and on the card more resident
//     warps beat larger runs;
//   * count arrays with the same mask are counted once (the wrapper passes
//     each distinct mask once and copies the result), into 32-bit shared
//     counters: a block takes at most 2^31 rows (the host adds blocks past
//     that), so no counter can wrap.  Sums are 64-bit shared atomics;
//   * each pair of warps owns a replica of the histogram (four a block)
//     where they fit in 48 KB (Q2: 1,024 slots x 12 bytes), else fewer;
//     a histogram larger than 48 KB takes one replica of up to 96 KB (two
//     blocks an SM), and above that grid.y tiles the slot range (each tile
//     rereads the rows: S = 16,384 with one count and one sum takes two);
//   * few slots (S <= 4, where a warp's lanes mostly share a slot): lanes
//     with the same slot find each other with __match_any_sync, a count is
//     __popc of the peers that pass its mask, a sum a shuffle reduction over
//     the peers, and one lane a slot does one atomic, so S = 1 costs one
//     atomic a warp, not 32 serialized ones.  From 8 slots up the match
//     costs more than the collisions it saves (measured on the card for
//     S = 1 ... 1,024), so each lane adds alone;
//   * at the end each block adds its replicas and flushes each non-zero
//     slot to device memory with one 64-bit atomic.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;                // registers capped to fit
constexpr int kRun = 4;                        // consecutive rows a thread
constexpr int kMatchMaxS = 4;                  // few slots: aggregate lanes
constexpr int kRepMax = 4;                     // histogram replicas a block
constexpr int kMaxArrays = 16;
constexpr int kRepBudget = 48 * 1024;          // replicas: four blocks an SM
constexpr int kTileBudget = 96 * 1024;         // one large replica: two
constexpr long long kMaxRowsPerBlock = 1ll << 31;
constexpr unsigned kFull = 0xffffffffu;

struct DenseArgs {
  const void* ids;
  const uint8_t* base;                 // NULL = all rows
  long long n;
  int S;
  int C;                               // distinct count masks
  int K;
  int tile;                            // slots a replica holds
  int rep;                             // histogram replicas a block
  int rep_words;                       // u64 words a replica takes
  const uint8_t* cmask[kMaxArrays];    // NULL = base only
  const void* svals[kMaxArrays];
  int sdtype[kMaxArrays];
  const uint8_t* smask[kMaxArrays];    // NULL = base only
  u64* counts;                         // C x S
  u64* sums;                           // K x S
};

// ---- loads of one run of kRun rows --------------------------------------------

template <class T> __device__ __forceinline__ u64 widen(T x) {
  return (u64)(long long)x;            // signed: sign-extend
}
template <> __device__ __forceinline__ u64 widen<uint8_t>(uint8_t x) {
  return (u64)x;                       // bool and UInt8: zero-extend
}

// kRun elements of T at t (a run, aligned to its size) in as few loads as
// fit
template <class T>
__device__ __forceinline__ void load_vec(const T* t, T (&x)[kRun]) {
  constexpr int kBytes = kRun * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    union { uint4 q[kBytes / 16]; T x[kRun]; } u;
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j) u.q[j] = __ldcs((const uint4*)t + j);
#pragma unroll
    for (int r = 0; r < kRun; ++r) x[r] = u.x[r];
  } else if constexpr (kBytes == 8) {
    union { uint2 q; T x[kRun]; } u;
    u.q = __ldcs((const uint2*)t);
#pragma unroll
    for (int r = 0; r < kRun; ++r) x[r] = u.x[r];
  } else if constexpr (kBytes == 4) {
    union { unsigned q; T x[kRun]; } u;
    u.q = __ldcs((const unsigned*)t);
#pragma unroll
    for (int r = 0; r < kRun; ++r) x[r] = u.x[r];
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r) x[r] = t[r];
  }
}

// v[r] = p[i + r] widened to 64 bits (0 past n)
template <class T>
__device__ __forceinline__ void load_run(const void* p, long long i,
                                         long long n, u64 v[kRun]) {
  const T* t = (const T*)p + i;
  if (i + kRun <= n) {
    T x[kRun];
    load_vec<T>(t, x);
#pragma unroll
    for (int r = 0; r < kRun; ++r) v[r] = widen<T>(x[r]);
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r) v[r] = i + r < n ? widen<T>(t[r]) : 0ull;
  }
}

__device__ __forceinline__ void load_values(const void* p, int dtype,
                                            long long i, long long n,
                                            u64 v[kRun]) {
  switch (dtype) {                     // once a run, uniform across the warp
    case DT_BOOL:
    case DT_U8: load_run<uint8_t>(p, i, n, v); break;
    case DT_I8: load_run<int8_t>(p, i, n, v); break;
    case DT_I16: load_run<int16_t>(p, i, n, v); break;
    case DT_I32: load_run<int32_t>(p, i, n, v); break;
    default: load_run<long long>(p, i, n, v); break;
  }
}

// bit r set where mask[i + r] != 0 (all rows where mask is NULL)
__device__ __forceinline__ unsigned load_mask(const uint8_t* m, long long i,
                                              long long n) {
  if (m == nullptr) return (1u << kRun) - 1u;
  unsigned bits = 0u;
  if (i + kRun <= n) {
    uint8_t x[kRun];
    load_vec<uint8_t>(m + i, x);
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (x[r] != 0) bits |= 1u << r;
  } else {
    for (int r = 0; r < kRun; ++r)
      if (i + r < n && m[i + r] != 0) bits |= 1u << r;
  }
  return bits;
}

// ---- warp aggregation ---------------------------------------------------------

// sum of x over the lanes of `peers` (every lane calls; the lowest lane of
// each group ends with its group's sum): a shuffle reduction whose rounds
// follow the largest group, none where every lane is alone
__device__ __forceinline__ u64 reduce_peers(unsigned peers, u64 x) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  peers &= ~((2u << lane) - 1u);                // peers above this lane
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);
    const u64 t = __shfl_sync(kFull, x, next > 0 ? next - 1 : lane);
    if (next > 0) x += t;
    peers &= ~__ballot_sync(kFull, rel & 1);
    rel >>= 1;
  }
  return x;
}

// sum of x over all 32 lanes (every lane ends with it): what reduce_peers
// gives a full group, in five shuffles and no votes
__device__ __forceinline__ u64 warp_sum(u64 x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// ---- the kernel -----------------------------------------------------------------

// The loads of one run: ids, base mask and the first summed array.
template <class Id>
struct RunLoads {
  Id id[kRun];
  unsigned base;
  u64 v0[kRun];
};

template <class Id>
__device__ __forceinline__ void load_run_head(const DenseArgs& a, long long i,
                                              RunLoads<Id>& L) {
  const Id* t = (const Id*)a.ids + i;
  if (i + kRun <= a.n) {
    load_vec<Id>(t, L.id);
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r) L.id[r] = i + r < a.n ? t[r] : Id(-1);
  }
  L.base = load_mask(a.base, i, a.n);
  if (a.K > 0) load_values(a.svals[0], a.sdtype[0], i, a.n, L.v0);
}

// shared layout of a replica: K x tile u64 sums, then C x tile u32 counts.
// kMatch: group a warp's lanes by slot with __match_any_sync (few slots)
// and let one lane a group add the group's total (a warp whose lanes all
// share one slot sums by butterfly); else each lane adds its own rows
// alone.
template <class Id, bool kMatch>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
k_dense_group_reduce(DenseArgs a) {
  extern __shared__ u64 hist[];
  const int tile_lo = blockIdx.y * a.tile;
  const int width = min(a.tile, a.S - tile_lo);
  for (int j = threadIdx.x; j < a.rep * a.rep_words; j += blockDim.x)
    hist[j] = 0ull;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* my_sums = hist + (long long)(warp % a.rep) * a.rep_words;
  unsigned* my_counts = (unsigned*)(my_sums + (long long)a.K * a.tile);

  const long long runs = (a.n + kRun - 1) / kRun;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp loops the same number of times (warp intrinsics);
  // the next run's ids, base mask and first values load during this one
  const long long first = (long long)blockIdx.x * blockDim.x + warp * 32;
  RunLoads<Id> cur = {}, nxt = {};
  if (first + lane < runs) load_run_head<Id>(a, (first + lane) * kRun, cur);
  for (long long wr = first; wr < runs; wr += stride) {
    const long long run = wr + lane;
    const long long i = run * kRun;
    const bool live = run < runs;
    if (run + stride < runs) load_run_head<Id>(a, i + stride * kRun, nxt);
    int slot[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const long long id = (long long)cur.id[r];
      const long long v = id - tile_lo;
      const bool in = live && ((cur.base >> r) & 1u) && i + r < a.n
                      && id >= 0 && id < a.S && v >= 0 && v < width;
      slot[r] = in ? (int)v : -1;
    }
    unsigned peers[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      peers[r] = kMatch ? __match_any_sync(kFull, slot[r]) : 1u << lane;
    }

    for (int c = 0; c < a.C; ++c) {
      const unsigned m = live ? load_mask(a.cmask[c], i, a.n) : 0u;
      unsigned* h = my_counts + (long long)c * a.tile;
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const bool p = slot[r] >= 0 && ((m >> r) & 1u);
        const unsigned g = peers[r] & __ballot_sync(kFull, p);
        if (p && lane == __ffs(g) - 1) atomicAdd(h + slot[r], (unsigned)__popc(g));
      }
    }
    for (int k = 0; k < a.K; ++k) {
      u64 v[kRun] = {};
      if (k == 0) {
#pragma unroll
        for (int r = 0; r < kRun; ++r) v[r] = cur.v0[r];
      } else if (live) {
        load_values(a.svals[k], a.sdtype[k], i, a.n, v);
      }
      const unsigned m = live ? load_mask(a.smask[k], i, a.n) : 0u;
      u64* h = my_sums + (long long)k * a.tile;
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const bool p = slot[r] >= 0 && ((m >> r) & 1u);
        const unsigned g = peers[r] & __ballot_sync(kFull, p);
        const u64 x = p ? v[r] : 0ull;
        const u64 s = !kMatch ? x
                      : peers[r] == kFull ? warp_sum(x)
                                          : reduce_peers(peers[r], x);
        if (g != 0u && lane == __ffs(peers[r]) - 1) atomicAdd(h + slot[r], s);
      }
    }
    cur = nxt;
  }
  __syncthreads();

  const int arrays = a.K + a.C;
  for (int j = threadIdx.x; j < arrays * width; j += blockDim.x) {
    const int arr = j / width, s = j - arr * width;
    u64 v = 0ull;
    for (int r = 0; r < a.rep; ++r) {
      const u64* rs = hist + (long long)r * a.rep_words;
      if (arr < a.K) v += rs[(long long)arr * a.tile + s];
      else v += ((const unsigned*)(rs + (long long)a.K * a.tile))
                    [(long long)(arr - a.K) * a.tile + s];
    }
    if (v == 0ull) continue;
    const long long slot = tile_lo + s;
    if (arr >= a.K) atomicAdd(&a.counts[(long long)(arr - a.K) * a.S + slot], v);
    else atomicAdd(&a.sums[(long long)arr * a.S + slot], v);
  }
}

template <class Id, bool kMatch>
static int launch(const DenseArgs& a, int nb, int tiles, size_t smem,
                  cudaStream_t st) {
  auto kern = k_dense_group_reduce<Id, kMatch>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(nb, tiles), kThreads, smem, st>>>(a);
  return chtt_last_error();
}

// ids: n int32/int64 slot ids (rows outside [0, S) are skipped); base: n
// bytes or NULL; cmasks (C counted masks, distinct) and svals/sdtypes/
// smasks (K sums) are HOST arrays; every device array 16-byte aligned;
// counts (C x S) and sums (K x S) are zeroed int64 outputs.
extern "C" int chtt_dense_group_reduce(
    const void* ids, int ids_is64, const void* base, long long n, int S,
    int C, const void* const* cmasks, int K, const void* const* svals,
    const int* sdtypes, const void* const* smasks, void* counts, void* sums,
    int nb, void* stream) {
  if (C + K < 1 || C > kMaxArrays || K > kMaxArrays || S < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  DenseArgs a;
  a.ids = ids;
  a.base = (const uint8_t*)base;
  a.n = n;
  a.S = S;
  a.C = C;
  a.K = K;
  for (int c = 0; c < kMaxArrays; ++c)
    a.cmask[c] = c < C ? (const uint8_t*)cmasks[c] : nullptr;
  for (int k = 0; k < kMaxArrays; ++k) {
    a.svals[k] = k < K ? svals[k] : nullptr;
    a.sdtype[k] = k < K ? sdtypes[k] : 0;
    a.smask[k] = k < K ? (const uint8_t*)smasks[k] : nullptr;
  }
  a.counts = (u64*)counts;
  a.sums = (u64*)sums;
  // replicas: one a pair of warps where they fit in kRepBudget, else
  // fewer; a histogram above it takes one replica of up to kTileBudget,
  // and above that grid.y tiles of `tile` slots
  const int per_slot = 8 * K + 4 * C;
  int tile = S, rep = kRepMax;
  while (rep > 1 && (long long)rep * per_slot * S > kRepBudget) rep >>= 1;
  if ((long long)per_slot * S > kTileBudget) tile = kTileBudget / per_slot;
  a.tile = tile;
  a.rep = rep;
  a.rep_words = (int)(((long long)per_slot * tile + 7) / 8);
  const int tiles = (S + tile - 1) / tile;
  const size_t smem = (size_t)rep * a.rep_words * 8;
  const long long min_nb = (n + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock;
  if (nb < min_nb) nb = (int)min_nb;
  if (n == 0) return chtt_last_error();
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= kMatchMaxS)
    return ids_is64 ? launch<long long, true>(a, nb, tiles, smem, st)
                    : launch<int, true>(a, nb, tiles, smem, st);
  return ids_is64 ? launch<long long, false>(a, nb, tiles, smem, st)
                  : launch<int, false>(a, nb, tiles, smem, st);
}
