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
// Bound on the card: bytes.  Each build row's keys are read once (and its
// occupant's keys on a clash), each probe row's keys once, and each
// matched row's words are gathered once; the table holds one int32 a
// bucket at a load of at most 1/2 (Q4h's: 2,097,152 buckets, 8 MB, in the
// H100's 50 MB L2, as are its build keys and words).
// Design:
//   * keys: up to eight key arrays a side, each 4 or 8 bytes a row (ints,
//     float bit patterns, dictionary codes); keys compare exactly, word by
//     word, never by hash.  The hash is splitmix64's finaliser folded over
//     the words (it is not observable);
//   * build (k_hash_build, after a memset of the table to -1): a thread a
//     build row walks from its hash; at an empty bucket it claims it with
//     atomicCAS; at a bucket whose occupant has its key it takes
//     atomicMin of the row ids, so equal keys keep their smallest row id
//     whatever order the threads run in; any other occupant sends it on to
//     the next bucket.  A bucket's key never changes once claimed, so rows
//     with one key meet at one bucket;
//   * probe (k_hash_probe): a thread a probe row walks from its hash until
//     an empty bucket or a bucket holding its key; it writes its match flag
//     and, for each of up to eight build-side words, the matched row's word
//     (0 without a match) in the same launch.  The N:1 join's words are
//     the payload columns' 32-bit words; the 1:N join's table holds group
//     indices and its words are the groups' segment starts and lengths.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 8;
constexpr int kMaxWords = 8;
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
  int* table;                         // cap buckets
  long long cap;                      // a power of two
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

// The key arrays are indexed only by unrolled loops, so their pointers are
// read from the kernel's parameters, never from a local copy.
template <bool kProbe>
__device__ __forceinline__ u64 hash_row(const ChttHashArgs& a, long long i) {
  u64 h = 0;
#pragma unroll
  for (int k = 0; k < kMaxKeys; ++k)
    if (k < a.nk)
      h = mix64(h ^ word_at(kProbe ? a.probe[k] : a.build[k], a.bytes[k], i));
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

__global__ void __launch_bounds__(kThreads) k_hash_build(ChttHashArgs a) {
  const unsigned long long mask = (unsigned long long)a.cap - 1;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_build; i += step) {
    if (a.build_valid != nullptr && !a.build_valid[i]) continue;
    unsigned long long s = hash_row<false>(a, i) & mask;
    for (;;) {
      int cur = *reinterpret_cast<volatile int*>(a.table + s);
      if (cur == kEmpty) {
        cur = atomicCAS(a.table + s, kEmpty, (int)i);
        if (cur == kEmpty) break;
      }
      if (same_key<false>(a, cur, i)) {
        atomicMin(a.table + s, (int)i);
        break;
      }
      s = (s + 1) & mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads) k_hash_probe(ChttHashArgs a) {
  const unsigned long long mask = (unsigned long long)a.cap - 1;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_probe; i += step) {
    int id = kEmpty;
    if (a.probe_valid == nullptr || a.probe_valid[i]) {
      unsigned long long s = hash_row<true>(a, i) & mask;
      for (;;) {
        const int cur = __ldg(a.table + s);
        if (cur == kEmpty) break;
        if (same_key<true>(a, cur, i)) {
          id = cur;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    if (a.matched != nullptr) a.matched[i] = id != kEmpty;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      if (w < a.n_words) a.out[w][i] = id != kEmpty ? __ldg(a.src[w] + id) : 0;
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
      a.cap > (1ll << 31))
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
  cudaError_t e =
      cudaMemsetAsync(a.table, 0xff, sizeof(int) * (size_t)a.cap, st);
  if (e != cudaSuccess) return (int)e;
  if (a.n_build > 0)
    k_hash_build<<<blocks_for(a.n_build, 8), kThreads, 0, st>>>(a);
  return chtt_last_error();
}

// Probe the table built by chtt_hash_build from the same build keys.
extern "C" int chtt_hash_probe(const ChttHashArgs* args, void* stream) {
  const ChttHashArgs& a = *args;
  if (!keys_ok(a) || a.n_probe < 0 || a.n_words < 0 ||
      a.n_words > kMaxWords)
    return (int)cudaErrorInvalidValue;
  if (a.n_probe > 0)
    k_hash_probe<<<blocks_for(a.n_probe, 16), kThreads, 0,
                   (cudaStream_t)stream>>>(a);
  return chtt_last_error();
}
