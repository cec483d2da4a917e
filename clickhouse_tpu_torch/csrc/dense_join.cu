// K7: the direct-address join (an N:1 join against unique build keys whose
// proven range [lo, hi] is small enough for a table of R = hi - lo + 1
// slots).
//
// Replaces dense_gather_join (clickhouse_tpu/ops/join_ops.py:65-128), which
// scatters each build word into a sentinel-filled table with XLA's scatter
// and gathers it back per probe row.
//
// Bound on the card: bytes.  Each build row's key and words are read once
// and scattered once into tables of 4 bytes a slot (Q4's: 1,000,000 slots,
// 4 MB, which sits in the H100's 50 MB L2); each probe row's key is read
// once, in its narrow storage, its matched flag and output words written
// once.  The gathers hit the L2-resident table.
// Design: three launches a call.  k_dense_init writes the sentinel into
// every table slot; k_dense_build scatters, one thread a build row (the
// keys are unique, so each slot is written by at most one row and the
// scatter is deterministic; without words a presence table takes 1s, which
// all writers agree on); k_dense_probe walks the probe rows, one thread a
// row in a grid-stride loop, templated on the probe key's storage type.  A
// probe row matches when it is valid, its key lies in [lo, hi] and the
// first table's slot does not hold that table's sentinel.  "key" and
// "keyvalid" output words are the probe key (as int32) and the match flag:
// nothing is gathered for them.  Key offsets are taken in wrapping 64-bit
// arithmetic, so UInt64 keys (int64 bits) and keys near the int64 limits
// land in [0, R) exactly when they lie in [lo, hi].
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxEntries = 8;

enum EntryKind { E_WORD = 0, E_KEY = 1, E_KEYVALID = 2, E_PRESENCE = 3 };

}  // namespace

// One output word of the join (layout shared with ops/_native.py).
struct ChttDenseEntry {
  const int* word;   // E_WORD: the build word (n_build rows)
  int* table;        // E_WORD / E_PRESENCE: R slots
  int* out;          // E_WORD / E_KEY / E_KEYVALID: one word a probe row
  int kind;
  int sentinel;      // E_WORD: a value no build word takes; E_PRESENCE: 0
};

struct ChttDenseArgs {
  const void* build_key;
  const unsigned char* build_valid;   // null: every build row is valid
  long long n_build;
  const void* probe_key;
  const unsigned char* probe_valid;   // null: every probe row may match
  long long n_probe;
  long long lo;                       // as int64 bits
  long long R;
  unsigned char* matched;             // one flag a probe row
  int build_dtype;                    // ChttDtype of build_key
  int probe_dtype;                    // ChttDtype of probe_key
  int n_entries;
  int first;                          // the table entry that decides matched
  ChttDenseEntry e[kMaxEntries];
};

namespace {

__device__ __forceinline__ long long load_key(const void* p, int dtype,
                                              long long i) {
  switch (dtype) {
    case DT_BOOL:
    case DT_U8:
      return static_cast<const unsigned char*>(p)[i];
    case DT_I8:
      return static_cast<const signed char*>(p)[i];
    case DT_I16:
      return static_cast<const short*>(p)[i];
    case DT_I32:
      return static_cast<const int*>(p)[i];
    default:
      return static_cast<const long long*>(p)[i];
  }
}

// The key's slot, or -1 outside [lo, hi] (wrapping 64-bit difference).
__device__ __forceinline__ long long slot_of(long long key, long long lo,
                                             long long R) {
  const u64 off = (u64)key - (u64)lo;
  return off < (u64)R ? (long long)off : -1;
}

__global__ void __launch_bounds__(kThreads) k_dense_init(ChttDenseArgs a) {
  const long long step = (long long)gridDim.x * kThreads;
#pragma unroll
  for (int t = 0; t < kMaxEntries; ++t) {
    if (t >= a.n_entries) break;
    const ChttDenseEntry& e = a.e[t];
    if (e.kind != E_WORD && e.kind != E_PRESENCE) continue;
    for (long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
         s < a.R; s += step)
      e.table[s] = e.sentinel;
  }
}

__global__ void __launch_bounds__(kThreads) k_dense_build(ChttDenseArgs a) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_build; i += step) {
    if (a.build_valid != nullptr && !a.build_valid[i]) continue;
    const long long s = slot_of(load_key(a.build_key, a.build_dtype, i),
                                a.lo, a.R);
    if (s < 0) continue;
#pragma unroll
    for (int t = 0; t < kMaxEntries; ++t) {
      if (t >= a.n_entries) break;
      const ChttDenseEntry& e = a.e[t];
      if (e.kind == E_WORD)
        e.table[s] = e.word[i];
      else if (e.kind == E_PRESENCE)
        e.table[s] = 1;
    }
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads) k_dense_probe(ChttDenseArgs a) {
  const K* __restrict__ key = static_cast<const K*>(a.probe_key);
  // the deciding table, picked by an unrolled loop (the entries are read
  // from the kernel's parameters, never from a local copy)
  const int* ftable = nullptr;
  int fsent = 0;
#pragma unroll
  for (int t = 0; t < kMaxEntries; ++t)
    if (t == a.first) {
      ftable = a.e[t].table;
      fsent = a.e[t].sentinel;
    }
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_probe; i += step) {
    const long long k = (long long)__ldg(key + i);
    long long s = slot_of(k, a.lo, a.R);
    if (a.probe_valid != nullptr && !a.probe_valid[i]) s = -1;
    const int g = s >= 0 ? __ldg(ftable + s) : fsent;
    const bool m = g != fsent;
    a.matched[i] = m;
#pragma unroll
    for (int t = 0; t < kMaxEntries; ++t) {
      if (t >= a.n_entries) break;
      const ChttDenseEntry& e = a.e[t];
      if (e.kind == E_WORD)
        e.out[i] = !m ? 0 : (t == a.first ? g : __ldg(e.table + s));
      else if (e.kind == E_KEY)
        e.out[i] = m ? (int)k : 0;
      else if (e.kind == E_KEYVALID)
        e.out[i] = m ? 1 : 0;
    }
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

}  // namespace

// The entries past n_entries are ignored; e[first] must be an E_WORD or
// E_PRESENCE entry.  Key types: bool, int8, uint8, int16, int32, int64.
extern "C" int chtt_dense_join(const ChttDenseArgs* args, void* stream) {
  const ChttDenseArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) || a.n_entries < 1 ||
      a.n_entries > kMaxEntries || a.first < 0 || a.first >= a.n_entries ||
      (a.e[a.first].kind != E_WORD && a.e[a.first].kind != E_PRESENCE) ||
      a.n_build < 0 || a.n_probe < 0 || a.build_dtype < DT_BOOL ||
      a.build_dtype > DT_I64 || a.probe_dtype < DT_BOOL ||
      a.probe_dtype > DT_I64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  k_dense_init<<<blocks_for(a.R, 8), kThreads, 0, st>>>(a);
  if (a.n_build > 0)
    k_dense_build<<<blocks_for(a.n_build, 8), kThreads, 0, st>>>(a);
  if (a.n_probe > 0) {
    const int nb = blocks_for(a.n_probe, 16);
    switch (a.probe_dtype) {
      case DT_BOOL:
      case DT_U8:
        k_dense_probe<unsigned char><<<nb, kThreads, 0, st>>>(a);
        break;
      case DT_I8:
        k_dense_probe<signed char><<<nb, kThreads, 0, st>>>(a);
        break;
      case DT_I16:
        k_dense_probe<short><<<nb, kThreads, 0, st>>>(a);
        break;
      case DT_I32:
        k_dense_probe<int><<<nb, kThreads, 0, st>>>(a);
        break;
      default:
        k_dense_probe<long long><<<nb, kThreads, 0, st>>>(a);
        break;
    }
  }
  return chtt_last_error();
}
