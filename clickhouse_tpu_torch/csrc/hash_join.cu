// K8: the hash join's table build and probe.
//
// Replaces propagate_join (clickhouse_tpu/ops/join_ops.py:131-250, without
// ASOF) and the probe of probe_join_table (:265-325).  On a TPU those sort
// concat(build, probe) and carry each build row's words down its key run
// with cumulative maxima, because random gathers are slow there; the card
// gathers well from L2, so this is the hash join the reference engine
// (ClickHouse's HashJoin) runs: build an open-addressing table of the
// build keys, probe it once a probe row.  The observable result is the
// same: a probe row's match is the SMALLEST build row id among the build
// rows with its key (the reference's "first inserted" ANY choice), or none.
//
// Bound on the card: bytes.  Each build row's keys are read once, each
// probe row's keys once, its match flag and words written once.  What
// holds a probe back is its chain of dependent random reads from the L2:
// a first version read the bucket's row id, then the occupant's key at
// that id, then one read a word, each a 32-byte sector, one row a thread.
// Design:
//   * a bucket is 16 bytes, two to a sector: a 64-bit key word, the row id
//     and one 32-bit word.  With one key of 4 or 8 bytes (Q4, Q4h, Q4x)
//     the key word is the key itself, so a hop decides hit or miss on its
//     own bucket without reading the build side; with 2-8 key words it is
//     the 64-bit hash, and a hit is confirmed word by word against the
//     build rows (equality is always on the key words, never the hash);
//   * a matched row's words in one load: after the build, a finalise pass
//     writes each occupied bucket's winning row's words into the bucket
//     itself where they fit (one word beside the row id; a second in the
//     key word's high half for one 4-byte key: Q4h's `label`, Q4x's
//     seg_start and seg_len), else into a row-major payload array of 2 or
//     4 words a build row, read by the bucket's row id with one 8- or
//     16-byte load; more than 4 words take another finalise and probe a
//     chunk of 4.  Words ride in the bucket where they fit because a hit
//     then reads nothing else, and the payload goes by row rather than
//     bucket because it is half the size: the L2 keeps only part of a
//     table that every SM reads (random gathers slow from about 16 MB);
//   * the ANY rule: a build thread claims an empty bucket with atomicCAS on
//     its row id, then writes the key word; on an occupied bucket it
//     compares its keys with the occupant row's build keys (the key word
//     may not be written yet) and, where they are equal, keeps the smaller
//     row id with atomicMin.  A bucket's key never changes once claimed,
//     so rows of one key meet at one bucket and the smallest row id stays,
//     whatever order the threads run in.  The probe, a later launch, reads
//     only finished buckets;
//   * one probe row a thread, in a grid-stride loop at 32 registers (64
//     warps an SM keep the rows' chains in flight): its hops load one
//     bucket each, a hit its payload with one more load.  Designs that
//     kept several rows a thread in flight were slower on an H100: a warp
//     walking R rows a lane in lock step waits each round for the longest
//     of its 32 * R chains, and its registers cut the warps an SM holds
//     (R = 4 and R = 2 both lost to R = 1), and lanes refilling slots as
//     rows resolve spend more instructions than the chains they hide.
//     Evict-first
//     loads and stores (__ldcs/__stcs) for the probe stream and its
//     outputs leave the L2 to the table.
// The hash is splitmix64's finaliser folded over the key words (not
// observable); `hash_mask` (all ones but in tests) is ANDed into it, so a
// test can force every hash equal and exercise the word-by-word check.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 8;
constexpr int kMaxWords = 4;
constexpr int kEmpty = -1;

}  // namespace

// Layout shared with ops/_native.py.
struct ChttHashArgs {
  const void* build[kMaxKeys];        // key arrays of the build side
  const void* probe[kMaxKeys];        // the same keys of the probe side
  int bytes[kMaxKeys];                // 4 or 8 a key
  int nk;
  int n_words;
  const unsigned char* build_valid;   // null: every build row is valid
  const unsigned char* probe_valid;   // null: every probe row may match
  long long n_build;
  long long n_probe;
  void* table;                        // cap buckets of 16 bytes
  long long cap;                      // a power of two
  int* payload;                       // stride words a bucket, or null
  int stride;                         // 0 (in the bucket), 1, 2 or 4
  int pad;
  unsigned long long hash_mask;
  unsigned char* matched;             // one flag a probe row, or null
  const int* src[kMaxWords];          // build-side words
  int* out[kMaxWords];                // one word a probe row each
};

namespace {

__device__ __forceinline__ u64 mix64(u64 z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ u64 word_at(const void* p, int bytes,
                                       long long i) {
  return bytes == 8 ? (u64)__ldg(static_cast<const long long*>(p) + i)
                    : (u64)(unsigned)__ldg(static_cast<const int*>(p) + i);
}

// A probe key word, loaded evict-first (the probe stream).
__device__ __forceinline__ u64 word_cs(const void* p, int bytes,
                                       long long i) {
  return bytes == 8 ? (u64)__ldcs(static_cast<const long long*>(p) + i)
                    : (u64)(unsigned)__ldcs(static_cast<const int*>(p) + i);
}

// The bucket's parts: the key word at byte 0, the row id at 8, the word at
// 12.
__device__ __forceinline__ u64* bucket_key(void* t, u64 s) {
  return reinterpret_cast<u64*>(static_cast<char*>(t) + 16 * s);
}
__device__ __forceinline__ int* bucket_id(void* t, u64 s) {
  return reinterpret_cast<int*>(static_cast<char*>(t) + 16 * s + 8);
}

// Row i's hash (masked) and its bucket key word: the key itself for one
// key, else the hash.  The key arrays are indexed only by unrolled loops,
// so their pointers are read from the kernel's parameters, never from a
// local copy.
template <bool kProbe>
__device__ __forceinline__ u64 hash_row(const ChttHashArgs& a, long long i,
                                        u64* kw) {
  u64 h = 0;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k) {
    if (k < a.nk) {
      const u64 w = kProbe ? word_cs(a.probe[k], a.bytes[k], i)
                           : word_at(a.build[k], a.bytes[k], i);
      if (k == 0) *kw = w;
      h = mix64(h ^ w);
    }
  }
  h &= a.hash_mask;
  if (a.nk > 1) *kw = h;
  return h;
}

// Whether build row b holds the key of row i (of the probe side if kProbe).
template <bool kProbe>
__device__ __forceinline__ bool same_key(const ChttHashArgs& a, int b,
                                         long long i) {
  bool eq = true;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k)
    if (k < a.nk)
      eq = eq && word_at(a.build[k], a.bytes[k], b) ==
                     word_at(kProbe ? a.probe[k] : a.build[k], a.bytes[k], i);
  return eq;
}

__global__ void __launch_bounds__(kThreads) k_hash_build(const ChttHashArgs a) {
  const u64 mask = (u64)a.cap - 1;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_build; i += step) {
    if (a.build_valid != nullptr && !a.build_valid[i]) continue;
    u64 kw;
    u64 s = hash_row<false>(a, i, &kw) & mask;
    for (;;) {
      int* idp = bucket_id(a.table, s);
      int cur = *reinterpret_cast<volatile int*>(idp);
      if (cur == kEmpty) {
        cur = atomicCAS(idp, kEmpty, (int)i);
        if (cur == kEmpty) {
          *bucket_key(a.table, s) = kw;
          break;
        }
      }
      if (same_key<false>(a, cur, i)) {
        atomicMin(idp, (int)i);
        break;
      }
      s = (s + 1) & mask;
    }
  }
}

// This probe's words: each occupied bucket's winning row's in the bucket
// (one word, two for one 4-byte key), or every build row's in the row-major
// payload array (stride words a row), which a hit reads by the bucket's
// row id.
__global__ void __launch_bounds__(kThreads)
    k_hash_finalize(const ChttHashArgs a) {
  const long long step = (long long)gridDim.x * kThreads;
  const long long n = a.stride == 0 ? a.cap : a.n_build;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    if (a.stride == 0) {
      const int id = *bucket_id(a.table, (u64)i);
      if (id == kEmpty) continue;
      bucket_id(a.table, (u64)i)[1] = __ldg(a.src[0] + id);
      if (a.n_words > 1)
        reinterpret_cast<int*>(bucket_key(a.table, (u64)i))[1] =
            __ldg(a.src[1] + id);
      continue;
    }
    int v[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      v[w] = w < a.n_words ? __ldg(a.src[w] + i) : 0;
    if (a.stride == 1)
      a.payload[i] = v[0];
    else if (a.stride == 2)
      reinterpret_cast<int2*>(a.payload)[i] = make_int2(v[0], v[1]);
    else
      reinterpret_cast<int4*>(a.payload)[i] = make_int4(v[0], v[1], v[2],
                                                        v[3]);
  }
}

// One probe row a thread, in a grid-stride loop (32 registers, so 64
// warps an SM hide the latency): its key, then its hops, each one bucket
// (one 16-byte load), then a matched row's payload with one load.
__global__ void __launch_bounds__(kThreads) k_hash_probe(const ChttHashArgs a) {
  const u64 mask = (u64)a.cap - 1;
  const uint4* __restrict__ tab = static_cast<const uint4*>(a.table);
  const bool key4 = a.nk == 1 && a.bytes[0] == 4;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < a.n_probe; row += step) {
    bool hit = false;
    uint4 b = make_uint4(0, 0, 0, 0);
    if (a.probe_valid == nullptr || __ldcs(a.probe_valid + row)) {
      u64 kw;
      u64 s = hash_row<true>(a, row, &kw) & mask;
      for (;;) {
        const uint4 q = __ldg(tab + s);
        if ((int)q.z == kEmpty) break;
        const u64 key = key4 ? (u64)q.x : ((u64)q.x | ((u64)q.y << 32));
        if (key == kw && (a.nk == 1 || same_key<true>(a, (int)q.z, row))) {
          hit = true;
          b = q;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    int v[kMaxWords] = {(int)b.w, (int)b.y, 0, 0};
    if (hit && a.stride == 1) {
      v[0] = __ldg(a.payload + b.z);
    } else if (hit && a.stride == 2) {
      const int2 p = __ldg(reinterpret_cast<const int2*>(a.payload) + b.z);
      v[0] = p.x;
      v[1] = p.y;
    } else if (hit && a.stride == 4) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(a.payload) + b.z);
      v[0] = p.x;
      v[1] = p.y;
      v[2] = p.z;
      v[3] = p.w;
    }
    if (a.matched != nullptr) __stcs(a.matched + row, (unsigned char)hit);
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      if (w < a.n_words) __stcs(a.out[w] + row, hit ? v[w] : 0);
  }
}

int blocks_for(long long n, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

bool keys_ok(const ChttHashArgs& a) {
  if (a.nk < 1 || a.nk > kMaxKeys || a.cap < 2 || (a.cap & (a.cap - 1)) ||
      a.cap > (1ll << 31) || reinterpret_cast<uintptr_t>(a.table) % 16)
    return false;
  for (int k = 0; k < a.nk; ++k)
    if (a.bytes[k] != 4 && a.bytes[k] != 8) return false;
  return true;
}

}  // namespace

// Clear the table and insert the valid build rows (n_build < 2^31, at most
// cap / 2 of them).
extern "C" int chtt_hash_build(const ChttHashArgs* args, void* stream) {
  const ChttHashArgs& a = *args;
  if (!keys_ok(a) || a.n_build < 0 || a.n_build >= (1ll << 31) ||
      2 * a.n_build > a.cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a.table, 0xff, 16 * (size_t)a.cap, st);
  if (e != cudaSuccess) return (int)e;
  if (a.n_build > 0)
    k_hash_build<<<blocks_for(a.n_build, 8), kThreads, 0, st>>>(a);
  return chtt_last_error();
}

// Write the words of this probe into the table built by chtt_hash_build
// from the same build keys (n_words > 0), and probe it.
extern "C" int chtt_hash_probe(const ChttHashArgs* args, void* stream) {
  const ChttHashArgs& a = *args;
  const int in_bucket = a.nk == 1 && a.bytes[0] == 4 ? 2 : 1;
  if (!keys_ok(a) || a.n_probe < 0 || a.n_words < 0 ||
      a.n_words > kMaxWords ||
      (a.stride == 0 && a.n_words > in_bucket) ||
      (a.stride != 0 && (a.payload == nullptr || a.n_words > a.stride ||
                         (a.stride != 1 && a.stride != 2 && a.stride != 4) ||
                         reinterpret_cast<uintptr_t>(a.payload) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n_words > 0)
    k_hash_finalize<<<blocks_for(a.stride == 0 ? a.cap : a.n_build, 8),
                      kThreads, 0, st>>>(a);
  if (a.n_probe > 0)
    k_hash_probe<<<blocks_for(a.n_probe, 16), kThreads, 0, st>>>(a);
  return chtt_last_error();
}
