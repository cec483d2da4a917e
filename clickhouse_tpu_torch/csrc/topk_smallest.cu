// K3: indices of the k smallest rows, ties to the lower row id, k <= 4,096.
//
// Replaces the reference's topk_permutation32 and topk_permutation
// (clickhouse_tpu/ops/sort_ops.py:110 and :140), which the executor's
// ORDER BY ... LIMIT k path calls (clickhouse_tpu/exec/executor.py:975).
// Two entries share one kernel body, templated on the row source:
//   * 32-bit: a u32 key (int32 bits) and a validity byte per row.  As in
//     the reference, valid keys clamp to 2^32 - 2 and invalid rows take
//     2^32 - 1, so valid keys 2^32 - 2 and 2^32 - 1 tie; the clamp and the
//     sentinel are applied in registers.  A row's order key packs into one
//     u64: (key << 32) | row id.
//   * 64-bit: a u64 token and a validity byte per row, ordered by
//     (invalid, token, row id).  Validity stays a key of its own: the order
//     key is the pair (invalid ? ~0 : token, invalid << 32 | row id).
//
// Bound on the card: bytes read, each row's key (4 or 8 bytes) and validity
// byte once: 500 MB (32-bit) or 900 MB (64-bit) at 100M rows, 0.149 or
// 0.269 ms at 3.35 TB/s.  Everything else is on-chip work on the few rows
// that can still enter the top k.  Design:
//   * level 1 (k_topk_stream, 3 blocks an SM, registers capped to fit;
//     on the card 2 and 4 were slower): each block walks a
//     contiguous chunk.  A thread keeps 4 16-byte loads of keys (16 u32 or
//     8 u64 rows) and their validity bytes in flight for the next step
//     while it scans this one, comparing each row with a threshold held in
//     a register: the block's current k-th best, and the smallest k-th best
//     any block has published (a u64 in device memory, lowered with
//     atomicMin and reread once a step; for the 64-bit entry its token
//     half).  Rows that pass are appended to a shared buffer with one
//     shared atomic per warp (__ballot_sync, __popc).  After each step one
//     barrier (__syncthreads_or) asks whether more than 128 rows wait; only
//     then does the block merge them into its sorted best k.  A few hundred
//     rows with 8-byte keys are merged by counting each entry's rank, with
//     no sort and two barriers; more, or 16-byte keys, are sorted first (an
//     ascending bitonic network over their count, not over a fixed tile)
//     and merged by binary-search rank.  The first step goes in growing
//     parts (256, 256, 512, ... rows), merged at once, so the threshold is
//     tight before whole steps are scanned against it;
//   * bound (k_topk_bound): the k-th best of one block is a weak bound on
//     the global one when every block sees the same distribution, so each
//     block also writes its j-th best for j = k, k/4, k/16, k/64; the m-th
//     smallest of the blocks' j-th bests, m = ceil(k / j), has >= k rows
//     at or below it.  One small block per (block, j) ranks them;
//   * merge (k_topk_final, one block of 1,024 threads): the entries at or
//     below the least bound are a prefix of each block's sorted list; it
//     streams those (about k of them on Q3's data, not nb x k) through the
//     same admission and merge and writes k row ids (clamped to n - 1).
// The chunk is a multiple of a step, so the vector loads stay aligned; the
// wrapper hands 16-byte-aligned keys and validity.  Shared memory per
// block: (2k + one step + 1,024) order keys, 8 or 16 bytes each.
// Tried on the card and dropped, each slower at Q3's shape: merging after
// every step that admitted a row, 8 loads a thread, a one-block merge over
// all nb x k candidates, a coarse per-row test with one vote a step (its
// registers cost a block an SM).  A cp.async or TMA double buffer was not
// tried: the register prefetch already keeps a step's loads in flight.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;     // the last merge: one block
constexpr int kLoads = 4;              // 16-byte loads in flight a thread
constexpr int kBlocksPerSm = 3;         // level 1; registers capped to fit
constexpr unsigned kFull = 0xffffffffu;

// ---- order keys -------------------------------------------------------------

struct Pair {                          // 64-bit entry: (a, b)
  u64 a;                               // invalid ? ~0 : token
  u64 b;                               // invalid << 32 | row id
};

__device__ __forceinline__ bool key_less(u64 x, u64 y) { return x < y; }
__device__ __forceinline__ bool key_less(const Pair& x, const Pair& y) {
  return x.a < y.a || (x.a == y.a && x.b < y.b);
}
template <class Key> __device__ __forceinline__ Key key_sentinel();
template <> __device__ __forceinline__ u64 key_sentinel<u64>() { return ~0ull; }
template <> __device__ __forceinline__ Pair key_sentinel<Pair>() {
  return Pair{~0ull, ~0ull};
}
__device__ __forceinline__ unsigned key_rid(u64 x) { return (unsigned)x; }
__device__ __forceinline__ unsigned key_rid(const Pair& x) {
  return (unsigned)x.b;
}
// the part of a key that is published across blocks (a u64 whose order is
// a coarsening of the key order)
__device__ __forceinline__ u64 key_global(u64 x) { return x; }
__device__ __forceinline__ u64 key_global(const Pair& x) { return x.a; }
__device__ __forceinline__ bool key_is_sentinel(u64 x) { return x == ~0ull; }
__device__ __forceinline__ bool key_is_sentinel(const Pair& x) {
  return x.a == ~0ull && x.b == ~0ull;
}

__device__ __forceinline__ u64 key32_of(uint32_t key, uint32_t valid_byte,
                                        long long row) {
  const uint32_t k = valid_byte ? min(key, 0xfffffffeu) : 0xffffffffu;
  return ((u64)k << 32) | (u64)(uint32_t)row;
}

__device__ __forceinline__ Pair key64_of(u64 tok, uint32_t valid_byte,
                                         long long row) {
  const u64 inv = valid_byte ? 0ull : 1ull;
  return Pair{inv ? ~0ull : tok, (inv << 32) | (u64)(uint32_t)row};
}

// ---- row sources: VEC rows per 16-byte load --------------------------------

struct Rows32 {
  using Key = u64;
  static constexpr int VEC = 4;
  const uint32_t* key;
  const uint8_t* valid;                // NULL = all valid
  __device__ __forceinline__ void load(long long i, uint4& q,
                                       uint32_t& v) const {
    q = __ldcs((const uint4*)(key + i));
    v = valid != nullptr ? __ldcs((const unsigned int*)(valid + i))
                         : 0x01010101u;
  }
  __device__ __forceinline__ Key at(const uint4& q, uint32_t v, int e,
                                    long long i) const {
    const uint32_t w = e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
    return key32_of(w, (v >> (8 * e)) & 0xffu, i + e);
  }
  __device__ __forceinline__ Key one(long long i) const {
    return key32_of(key[i], valid != nullptr ? valid[i] : 1u, i);
  }
};

struct Rows64 {
  using Key = Pair;
  static constexpr int VEC = 2;
  const u64* key;
  const uint8_t* valid;
  __device__ __forceinline__ void load(long long i, uint4& q,
                                       uint32_t& v) const {
    q = __ldcs((const uint4*)(key + i));
    v = valid != nullptr ? (uint32_t)__ldcs((const unsigned short*)(valid + i))
                         : 0x0101u;
  }
  __device__ __forceinline__ Key at(const uint4& q, uint32_t v, int e,
                                    long long i) const {
    const u64 t = e == 0 ? ((u64)q.y << 32 | q.x) : ((u64)q.w << 32 | q.z);
    return key64_of(t, (v >> (8 * e)) & 0xffu, i + e);
  }
  __device__ __forceinline__ Key one(long long i) const {
    return key64_of(key[i], valid != nullptr ? valid[i] : 1u, i);
  }
};

// rows a full step reads (and the most one scan admits): 4,096 u32 keys or
// 2,048 u64 tokens, 16 bytes x kLoads a thread (an order key is twice a
// row key's width).  The buffer holds a step and kMergeSlack more, so a
// block merges only once more than kMergeAt rows wait (or at once, while
// it warms up).
constexpr int kMergeSlack = 1024;
template <class Key>
constexpr int kStepKeys = kThreads * kLoads * 32 / (int)sizeof(Key);
template <class Key>
constexpr int kBuf = kStepKeys<Key> + kMergeSlack;
constexpr int kMergeAt = 128;

// ---- block-wide pieces ------------------------------------------------------

// ascending sort of s[0, c) by the whole block: the all-ascending bitonic
// network over the next power of two, with the virtual entries at c and
// above taken as +inf (so every compare that reaches them is a no-op and is
// skipped).  Starts and ends synced.
template <class Key>
__device__ void sort_count(Key* s, int c) {
  int P = 1;
  while (P < c) P <<= 1;
  for (int size = 2; size <= P; size <<= 1) {
    const int half = size >> 1;
    for (int i = threadIdx.x; i < P / 2; i += blockDim.x) {
      const int blk = i / half, off = i - blk * half;
      const int j = blk * size + off, p = blk * size + size - 1 - off;
      if (p < c && key_less(s[p], s[j])) {
        const Key t = s[j]; s[j] = s[p]; s[p] = t;
      }
    }
    __syncthreads();
    for (int stride = size >> 2; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += blockDim.x) {
        const int j = (i / stride) * 2 * stride + (i % stride);
        const int p = j + stride;
        if (p < c && key_less(s[p], s[j])) {
          const Key t = s[j]; s[j] = s[p]; s[p] = t;
        }
      }
      __syncthreads();
    }
  }
}

// number of entries of the sorted a[0, m) below x
template <class Key>
__device__ __forceinline__ int rank_below(const Key* a, int m, const Key& x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(a[mid], x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// number of entries of a[0, m) (any order) below x
template <class Key>
__device__ __forceinline__ int count_below(const Key* a, int m, const Key& x) {
  int r = 0;
  for (int j = 0; j < m; ++j) r += key_less(a[j], x);
  return r;
}

// A merge ranks by counting while the compares a thread makes stay under
// this (a few hundred waiting rows); above it, it sorts the buffer first.
// On the card counting paid off for the packed 8-byte keys only.
template <class Key>
constexpr int kCountMergeWork = sizeof(Key) == 8 ? 2048 : 0;

// The running state of one block: its best k (sorted, two halves of
// shared memory used in turn) and the buffer of admitted rows.
template <class Key>
struct Block {
  Key* best;                           // k entries, sorted
  Key* spare;                          // k entries, the next best
  Key* buf;                            // kBuf<Key> entries at most
  int* count;                          // shared
  int k;
  Key thr;                             // the block's k-th best so far
  u64 g;                               // the published k-th best (global)
  int hi;                              // this warp's last buffer end

  __device__ __forceinline__ bool admit(const Key& x) const {
    return key_less(x, thr) && key_global(x) <= g;
  }

  // append x where pred, one shared atomic per warp; every lane calls
  __device__ __forceinline__ void append(bool pred, const Key& x) {
    const unsigned m = __ballot_sync(kFull, pred);
    if (m == 0u) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int pos = 0;
    if (lane == leader) pos = atomicAdd(count, __popc(m));
    pos = __shfl_sync(kFull, pos, leader);
    if (pred) buf[pos + __popc(m & ((1u << lane) - 1u))] = x;
    hi = pos + __popc(m);
  }

  // after a scan: merge the admitted rows into the best k if more than
  // merge_at wait (one barrier otherwise); then reread the global word
  __device__ void settle(u64* gthr, int merge_at) {
    if (__syncthreads_or(hi > merge_at)) {
      const int c = *count;
      if ((long long)c * (k + c)
          <= kCountMergeWork<Key> * (long long)blockDim.x) {
        // few rows: each entry's rank in best + buf by counting, with no
        // sort of the buffer (its keys are distinct and below any sentinel)
        for (int i = threadIdx.x; i < k; i += blockDim.x) {
          const Key x = best[i];
          const int r = i + count_below(buf, c, x);
          if (r < k) spare[r] = x;
        }
        for (int j = threadIdx.x; j < c; j += blockDim.x) {
          const Key y = buf[j];
          const int r = count_below(buf, c, y) + rank_below(best, k, y);
          if (r < k) spare[r] = y;
        }
      } else {
        sort_count(buf, c);            // syncs at its start and end
        for (int i = threadIdx.x; i < k; i += blockDim.x) {
          const Key x = best[i];
          const int r = i + rank_below(buf, c, x);
          if (r < k) spare[r] = x;
        }
        for (int j = threadIdx.x; j < c; j += blockDim.x) {
          const Key y = buf[j];
          const int r = j + rank_below(best, k, y);
          if (r < k) spare[r] = y;
        }
      }
      __syncthreads();
      Key* t = best; best = spare; spare = t;
      thr = best[k - 1];
      if (threadIdx.x == 0) {
        *count = 0;
        if (gthr != nullptr && !key_is_sentinel(thr))
          atomicMin(gthr, key_global(thr));
      }
      hi = 0;
      __syncthreads();
    }
    if (gthr != nullptr) g = min(g, __ldcg(gthr));
  }

  // rows [b, e) with scalar loads (e - b <= kStepKeys<Key>)
  template <class Src>
  __device__ void scan_scalar(const Src& src, long long b, long long e) {
    for (long long base = b; base < e; base += blockDim.x) {
      const long long i = base + threadIdx.x;
      Key x = key_sentinel<Key>();
      if (i < e) x = src.one(i);
      append(i < e && admit(x), x);
    }
  }

  // the rows of one full step from base, already loaded: of each thread's
  // kLoads * VEC rows, those with flat index l * VEC + e in [f0, f1)
  template <class Src>
  __device__ void scan_loaded(const Src& src, long long base,
                              const uint4 (&q)[kLoads],
                              const uint32_t (&v)[kLoads], int f0, int f1) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const long long i =
          base + ((long long)l * kThreads + threadIdx.x) * Src::VEC;
#pragma unroll
      for (int e = 0; e < Src::VEC; ++e) {
        const int f = l * Src::VEC + e;
        if (f >= f0 && f < f1) {
          const Key x = src.at(q[l], v[l], e, i);
          append(admit(x), x);
        }
      }
    }
  }
};

template <class Src>
__device__ __forceinline__ void load_step(const Src& src, long long base,
                                          uint4 (&q)[kLoads],
                                          uint32_t (&v)[kLoads]) {
#pragma unroll
  for (int l = 0; l < kLoads; ++l)
    src.load(base + ((long long)l * kThreads + threadIdx.x) * Src::VEC, q[l],
             v[l]);
}

template <class Key>
__device__ Block<Key> block_init(Key* s, int* count, int k, u64 g0) {
  Block<Key> B;
  B.best = s;
  B.spare = s + k;
  B.buf = s + 2 * k;
  B.count = count;
  B.k = k;
  B.thr = key_sentinel<Key>();
  B.g = g0;
  B.hi = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) s[j] = key_sentinel<Key>();
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  return B;
}

template <class Key>
__device__ void write_ids(const Block<Key>& B, long long n,
                          long long* __restrict__ out) {
  for (int j = threadIdx.x; j < B.k; j += blockDim.x) {
    const long long r = (long long)key_rid(B.best[j]);
    out[j] = r < n ? r : n - 1;
  }
}

// Scratch: the threshold level 1 publishes, then for each level-1 block
// its sorted best k and its kQuant quantiles (its j_t-th best for
// j_t = ceil(k / 4^t)), which bound the global k-th best in the merge.
constexpr int kQuant = 4;

__device__ __forceinline__ int quant_rank(int k, int t) {
  int d = 1;
  for (int i = 0; i < t; ++i) d *= 4;
  return (k + d - 1) / d;                // j_t, >= 1
}

// level 1: rows [blockIdx.x * chunk, +chunk) -> the block's best k.  With
// one block it writes k row ids to out; else its best k to cand[b*k, +k)
// and its quantiles to quant[b*kQuant, +kQuant).
template <class Src>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
k_topk_stream(Src src, long long n, long long chunk, int k, u64* gthr,
              typename Src::Key* __restrict__ cand,
              typename Src::Key* __restrict__ quant,
              long long* __restrict__ out) {
  using Key = typename Src::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;
  if (out != nullptr) gthr = nullptr;
  Block<Key> B = block_init((Key*)smem, &count, k, ~0ull);
  constexpr int kPer = kLoads * Src::VEC;        // rows a thread a step
  constexpr long long kStep = (long long)kThreads * kPer;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  long long pos = lo;
  // full steps, the next step's loads in flight while this one is scanned;
  // the first step goes in growing parts (256, 256, 512, ... rows) so the
  // threshold tightens before whole steps are admitted against it
  if (pos + kStep <= hi) {
    uint4 q[kLoads];
    uint32_t v[kLoads];
    load_step(src, pos, q, v);
    for (bool first = true; pos + kStep <= hi; pos += kStep, first = false) {
      uint4 qn[kLoads];
      uint32_t vn[kLoads];
      const bool more = pos + 2 * kStep <= hi;
      if (more) load_step(src, pos + kStep, qn, vn);
      for (int f0 = 0, f1 = first ? 1 : kPer; f0 < kPer;
           f0 = f1, f1 = min(2 * f1, kPer)) {
        B.scan_loaded(src, pos, q, v, f0, f1);
        B.settle(gthr, first ? 0 : kMergeAt);
      }
      if (more) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          q[l] = qn[l];
          v[l] = vn[l];
        }
      }
    }
  }
  // the rest (or a chunk under one step): growing ranges, scalar loads
  for (long long w = kThreads; pos < hi; w = min(2 * w, kStep)) {
    const long long e = pos + w < hi ? pos + w : hi;
    B.scan_scalar(src, pos, e);
    B.settle(gthr, 0);
    pos = e;
  }
  B.settle(gthr, 0);
  if (out != nullptr) {
    write_ids(B, n, out);
    return;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    cand[(long long)blockIdx.x * k + j] = B.best[j];
  if (threadIdx.x < kQuant)
    quant[blockIdx.x * kQuant + threadIdx.x] =
        B.best[quant_rank(k, threadIdx.x) - 1];
}

// The bound T on the global k-th best: for each t, the m_t-th smallest
// (m_t = ceil(k / j_t)) of the blocks' j_t-th bests has at least
// m_t x j_t >= k entries at or below it.  Block (i, t) ranks block i's
// j_t-th best among all nb (ties by block) and, if it is the m_t-th,
// writes it to bound[t]; T is the least of the kQuant bounds.
template <class Key>
__global__ void __launch_bounds__(128)
k_topk_bound(const Key* __restrict__ quant, int nb, int k,
             Key* __restrict__ bound) {
  __shared__ int rank;
  const int i = blockIdx.x, t = blockIdx.y;
  const int m = (k + quant_rank(k, t) - 1) / quant_rank(k, t);
  if (m > nb) return;
  if (threadIdx.x == 0) rank = 0;
  __syncthreads();
  const Key x = quant[i * kQuant + t];
  int r = 0;
  for (int l = threadIdx.x; l < nb; l += blockDim.x) {
    const Key y = quant[l * kQuant + t];
    r += key_less(y, x) || (!key_less(x, y) && l < i);
  }
  r = __reduce_add_sync(kFull, r);
  if ((threadIdx.x & 31) == 0) atomicAdd(&rank, r);
  __syncthreads();
  if (threadIdx.x == 0 && rank == m - 1) bound[t] = x;
}

// merge, one block: the entries at or below T are a prefix of each
// block's sorted list; the block streams those prefixes (found by binary
// search, laid end to end by a prefix sum) through the same admission and
// merge, and writes k row ids.
template <class Key>
__global__ void __launch_bounds__(kFinalThreads)
k_topk_final(const Key* __restrict__ cand, const Key* __restrict__ bound,
             int nb, int k, long long n, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count;
  __shared__ int offs[kFinalThreads + 1];        // prefix sums of lengths
  __shared__ int warp_tot[kFinalThreads / 32];
  Block<Key> B = block_init((Key*)smem, &count, k, ~0ull);
  Key T = bound[0];
  for (int t = 1; t < kQuant; ++t)
    if (key_less(bound[t], T)) T = bound[t];
  // prefix length of each list at or below T, then their prefix sums
  const int b = threadIdx.x;
  int len = 0;
  if (b < nb) {
    const Key* L = cand + (long long)b * k;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!key_less(T, L[mid]) && !key_is_sentinel(L[mid])) lo = mid + 1;
      else hi = mid;
    }
    len = lo;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = len;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kFinalThreads / 32 ? warp_tot[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kFinalThreads / 32) warp_tot[lane] = w;   // inclusive
  }
  __syncthreads();
  offs[threadIdx.x + 1] = incl + (warp > 0 ? warp_tot[warp - 1] : 0);
  if (threadIdx.x == 0) offs[0] = 0;
  __syncthreads();
  const int M = offs[nb];
  for (int pos = 0; pos < M; pos += kStepKeys<Key>) {
    const int e = pos + kStepKeys<Key> < M ? pos + kStepKeys<Key> : M;
    for (int base = pos; base < e; base += blockDim.x) {
      const int f = base + threadIdx.x;
      Key x = key_sentinel<Key>();
      if (f < e) {
        int lo = 0, hi = nb;                       // offs[lo] <= f < offs[lo+1]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (offs[mid] <= f) lo = mid;
          else hi = mid;
        }
        x = cand[(long long)lo * k + (f - offs[lo])];
      }
      B.append(f < e && B.admit(x), x);
    }
    B.settle(nullptr, 0);
  }
  write_ids(B, n, out);
}

// ---- host side ----------------------------------------------------------------

template <class Key>
static size_t smem_bytes(int k) {
  return ((size_t)2 * k + (size_t)kBuf<Key>) * sizeof(Key);
}

template <class Kernel>
static int smem_ready(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <class Src>
static int blocks_for(long long n, int k) {
  using Key = typename Src::Key;
  const size_t smem = smem_bytes<Key>(k);
  int e = smem_ready(k_topk_stream<Src>, smem);
  if (e != 0) return -e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_topk_stream<Src>, kThreads, smem);
  if (e != 0) return -e;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  if (per_sm < 1) per_sm = 1;
  if ((long long)sms * per_sm > kFinalThreads) per_sm = kFinalThreads / sms;
  const long long step = (long long)kThreads * kLoads * Src::VEC;
  // at least 16 steps of rows a block
  long long nb = (n + 16 * step - 1) / (16 * step);
  if (nb > (long long)sms * per_sm) nb = (long long)sms * per_sm;
  return nb < 1 ? 1 : (int)nb;
}

template <class Src>
static int run_topk(Src src, long long n, int k, int nb, void* out,
                    void* scratch, cudaStream_t st) {
  using Key = typename Src::Key;
  const size_t smem = smem_bytes<Key>(k);
  int e = smem_ready(k_topk_stream<Src>, smem);
  if (e == 0) e = smem_ready(k_topk_final<Key>, smem);
  if (e != 0) return e;
  u64* gthr = (u64*)scratch;
  Key* cand = (Key*)((char*)scratch + 16);
  Key* quant = cand + (long long)nb * k;
  Key* bound = quant + (long long)nb * kQuant;
  long long* o = (long long*)out;
  constexpr long long kStep = (long long)kThreads * kLoads * Src::VEC;
  long long chunk = (n + nb - 1) / nb;
  chunk = (chunk + kStep - 1) / kStep * kStep;
  e = (int)cudaMemsetAsync(gthr, 0xff, sizeof(u64), st);
  if (e != 0) return e;
  k_topk_stream<Src><<<nb, kThreads, smem, st>>>(
      src, n, chunk, k, gthr, cand, quant, nb > 1 ? nullptr : o);
  e = chtt_last_error();
  if (e != 0) return e;
  if (nb > 1) {
    e = (int)cudaMemsetAsync(bound, 0xff, kQuant * sizeof(Key), st);
    if (e != 0) return e;
    k_topk_bound<Key><<<dim3(nb, kQuant), 128, 0, st>>>(quant, nb, k, bound);
    e = chtt_last_error();
    if (e != 0) return e;
    k_topk_final<Key><<<1, kFinalThreads, smem, st>>>(cand, bound, nb, k, n,
                                                      o);
  }
  return chtt_last_error();
}

// Scratch bytes for nb level-1 blocks: the published threshold (16), each
// block's best k and its quantiles, and the merge's bounds.
extern "C" long long chtt_topk_scratch_bytes(int key_bytes, int nb, int k) {
  return 16 + ((long long)nb * (k + kQuant) + kQuant) * 2 * key_bytes;
}

// Level-1 blocks for n rows and k (key_bytes 4 or 8); a negative value is
// a CUDA error.
extern "C" int chtt_topk_blocks(int key_bytes, long long n, int k) {
  if (key_bytes == 4) return blocks_for<Rows32>(n, k);
  return blocks_for<Rows64>(n, k);
}

// key: n u32 (key_bytes 4) or u64 (key_bytes 8), 16-byte aligned; valid: n
// bytes (aligned alike) or NULL; out: k int64; scratch: the bytes
// chtt_topk_scratch_bytes gives for nb blocks.
extern "C" int chtt_topk_smallest(const void* key, int key_bytes,
                                  const void* valid, long long n, int k,
                                  int nb, void* out, void* scratch,
                                  void* stream) {
  if (k < 1 || k > 4096 || n < 1 || nb < 1
      || (key_bytes != 4 && key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* val = (const uint8_t*)valid;
  if (key_bytes == 4)
    return run_topk(Rows32{(const uint32_t*)key, val}, n, k, nb, out,
                    scratch, st);
  return run_topk(Rows64{(const u64*)key, val}, n, k, nb, out, scratch, st);
}
