// K7: the direct-address join (an N:1 join against unique build keys whose
// proven range [lo, hi] is small enough for a table of R = hi - lo + 1
// slots).
//
// Replaces dense_gather_join (clickhouse_tpu/ops/join_ops.py:65-128), which
// scatters each build word into a sentinel-filled table with XLA's scatter
// and gathers it back per probe row.
//
// Bound on the card: bytes.  Each build row's key and words are read once
// and written once into the table; each probe row's key is read once, in
// its narrow storage, and its match flag and output words written once.
// What holds a plain version back is not those bytes but the gathers: one
// random read a probe row and a word, from a table in the L2, each moving a
// whole 32-byte sector, each behind its probe key's load.  One random
// gather a row is the floor: on an H100, 100M of them take about as long
// from a 1 MB table as from a 16 MB one (chip_smoke.py --gathers), more
// than Q4's bytes take.
// Design:
//   * a narrow, packed table: a slot holds every gathered word, each in
//     the fewest bytes (1, 2 or 4) that its proven range and its sentinel
//     need, less its lower bound, side by side (the widest first, each on
//     a multiple of its width); a slot is 1, 2, 4, 8, 16 or 32 bytes (Q4's
//     `label` in [0, 96] with sentinel -1: one byte, a 1 MB table of which
//     each SM keeps a part in its L1).  One gather a row, whatever the
//     number of words; a 32-byte slot is two 16-byte loads of one sector;
//   * several rows a thread: a thread takes 4 rows (2 for int64 keys) with
//     one 16-byte load (narrower keys: 4 or 8 bytes), threads striped so
//     that a warp's access is one contiguous span; it issues all of its
//     gathers before any store, then stores its 4 match flags as one 4-byte
//     store and each output word's 4 values as one 16-byte store;
//   * evict-first loads and stores (__ldcs/__stcs) for the probe stream, so
//     the 100M-row stream does not push the table out of the L2; the
//     table's gathers go through the read-only path into the L1, which
//     gets the SM's whole carveout (the probe uses no shared memory);
//   * edges: a probe key view off its vector alignment is read with one
//     load a row (the same rows a thread; nothing is copied or shifted),
//     likewise a misaligned probe mask; the outputs are fresh allocations,
//     so their vector stores stay aligned; the last n % 4 rows are the
//     grid's first thread's;
//   * three launches a call: k_dense_init writes the empty slot (every
//     word's sentinel) into every slot; k_dense_build writes each valid
//     build row's slot with one store (the keys are unique, so each slot
//     is written by at most one row; a presence table, with no words,
//     holds a 1, which all writers agree on); k_dense_probe as above.
//     The ranges are the caller's proof, not the kernel's: a valid build
//     row whose key lies outside [lo, hi], or whose word lies outside its
//     stated range, sets the out_of_range flag (cleared by k_dense_init),
//     which the caller tests before it trusts the words.
//     "key" and "keyvalid" outputs are the probe key (as int32) and the
//     match flag: nothing is gathered for them.  A probe row matches when
//     it is valid, its key lies in [lo, hi] and the first word's field is
//     not its sentinel.  Key offsets are taken in wrapping 64-bit
//     arithmetic, so UInt64 keys (int64 bits) and keys near the int64
//     limits land in [0, R) exactly when they lie in [lo, hi].
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxOuts = 8;
constexpr int kSlotU32 = 8;          // the widest slot: 32 bytes

enum OutKind { O_WORD = 0, O_KEY = 1, O_KEYVALID = 2 };

}  // namespace

// One word of a slot (layout shared with ops/_native.py).
struct ChttDenseWord {
  const int* src;      // the build word (n_build rows); null: the constant 1
  unsigned base;       // the slot holds (word - base) in `bytes` bytes
  int bytes;           // 1, 2 or 4
  int offset;          // byte offset in the slot, a multiple of bytes
  unsigned empty;      // the field where no build row lies
  unsigned lo;         // the word's stated range: (word - lo) <= span
  unsigned span;
};

// One output word a probe row.
struct ChttDenseOut {
  int* out;
  int kind;            // O_WORD: the slot's word at (offset, bytes) + base
  unsigned base;
  int bytes;
  int offset;
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
  unsigned char* table;               // R slots, 16-byte aligned, padded
  unsigned char* matched;             // one flag a probe row
  int* out_of_range;                  // set to 1 where a valid build row's
                                      // key or word leaves its range
  int build_dtype;                    // ChttDtype of build_key
  int probe_dtype;                    // ChttDtype of probe_key
  int slot_bytes;                     // 1, 2, 4, 8, 16 or 32
  int n_words;                        // w[0] decides the match
  int n_outs;
  int pad;
  ChttDenseWord w[kMaxWords];
  ChttDenseOut o[kMaxOuts];
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

__device__ __forceinline__ unsigned field_mask(int bytes) {
  return bytes >= 4 ? 0xffffffffu : (1u << (8 * bytes)) - 1u;
}

// The slot's registers are indexed only by unrolled loops with a compare,
// so they stay in registers.
template <int NU>
__device__ __forceinline__ void put_field(unsigned (&u)[NU], int offset,
                                          int bytes, unsigned v) {
  const int q = offset >> 2, sh = (offset & 3) * 8;
#pragma unroll
  for (int j = 0; j < NU; ++j)
    if (j == q) u[j] |= (v & field_mask(bytes)) << sh;
}

template <int NU>
__device__ __forceinline__ unsigned get_field(const unsigned (&u)[NU],
                                              int offset, int bytes) {
  const int q = offset >> 2, sh = (offset & 3) * 8;
  unsigned x = 0;
#pragma unroll
  for (int j = 0; j < NU; ++j)
    if (j == q) x = u[j];
  return (x >> sh) & field_mask(bytes);
}

// The slot where no build row lies: every word's sentinel field.
__device__ __forceinline__ void empty_slot(const ChttDenseArgs& a,
                                           unsigned (&u)[kSlotU32]) {
#pragma unroll
  for (int j = 0; j < kSlotU32; ++j) u[j] = 0;
#pragma unroll
  for (int t = 0; t < kMaxWords; ++t)
    if (t < a.n_words) put_field(u, a.w[t].offset, a.w[t].bytes, a.w[t].empty);
}

__global__ void __launch_bounds__(kThreads)
    k_dense_init(const ChttDenseArgs a, long long n_u32) {
  unsigned u[kSlotU32];
  empty_slot(a, u);
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.out_of_range = 0;
  const int sb = a.slot_bytes;
  unsigned* __restrict__ t = reinterpret_cast<unsigned*>(a.table);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_u32; i += step) {
    unsigned v;
    if (sb == 1) {
      v = (u[0] & 0xffu) * 0x01010101u;
    } else if (sb == 2) {
      v = (u[0] & 0xffffu) * 0x00010001u;
    } else {
      const int q = (int)(i & (sb / 4 - 1));
      v = u[0];
#pragma unroll
      for (int j = 1; j < kSlotU32; ++j)
        if (j == q) v = u[j];
    }
    t[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads) k_dense_build(const ChttDenseArgs a) {
  const int sb = a.slot_bytes;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < a.n_build; i += step) {
    if (a.build_valid != nullptr && !a.build_valid[i]) continue;
    const long long s = slot_of(load_key(a.build_key, a.build_dtype, i),
                                a.lo, a.R);
    if (s < 0) {
      *a.out_of_range = 1;
      continue;
    }
    unsigned u[kSlotU32];
#pragma unroll
    for (int j = 0; j < kSlotU32; ++j) u[j] = 0;
    bool fits = true;
#pragma unroll
    for (int t = 0; t < kMaxWords; ++t) {
      if (t >= a.n_words) break;
      const ChttDenseWord& w = a.w[t];
      const unsigned v = w.src != nullptr ? (unsigned)__ldg(w.src + i) : 1u;
      fits = fits && v - w.lo <= w.span;
      put_field(u, w.offset, w.bytes, v - w.base);
    }
    if (!fits) *a.out_of_range = 1;
    unsigned char* p = a.table + s * sb;
    if (sb == 1) {
      *p = (unsigned char)u[0];
    } else if (sb == 2) {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)u[0];
    } else if (sb == 4) {
      *reinterpret_cast<unsigned*>(p) = u[0];
    } else if (sb == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
      reinterpret_cast<uint4*>(p)[0] = make_uint4(u[0], u[1], u[2], u[3]);
      if (sb == 32)
        reinterpret_cast<uint4*>(p)[1] = make_uint4(u[4], u[5], u[6], u[7]);
    }
  }
}

// One slot, gathered through the read-only path.
template <int SB, int NU>
__device__ __forceinline__ void load_slot(const unsigned char* __restrict__ t,
                                          long long s, unsigned (&u)[NU]) {
  if constexpr (SB == 1) {
    u[0] = __ldg(t + s);
  } else if constexpr (SB == 2) {
    u[0] = __ldg(reinterpret_cast<const unsigned short*>(t) + s);
  } else if constexpr (SB == 4) {
    u[0] = __ldg(reinterpret_cast<const unsigned*>(t) + s);
  } else if constexpr (SB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(t) + s);
    u[0] = v.x;
    u[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < SB / 16; ++h) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(t) + s * (SB / 16)
                            + h);
      u[4 * h] = v.x;
      u[4 * h + 1] = v.y;
      u[4 * h + 2] = v.z;
      u[4 * h + 3] = v.w;
    }
  }
}

// RPT probe keys from row0: one vector load where the view is aligned to
// it, else one load a row.
template <class K, int RPT>
__device__ __forceinline__ void load_keys(const K* __restrict__ p,
                                          long long row0, bool vec,
                                          long long (&k)[RPT]) {
  if (RPT > 1 && vec) {
    if constexpr (RPT > 1 && sizeof(K) == 8) {
      const longlong2 x = __ldcs(reinterpret_cast<const longlong2*>(p + row0));
      k[0] = x.x;
      k[1] = x.y;
    } else if constexpr (RPT > 1 && sizeof(K) == 4) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(p + row0));
      k[0] = x.x;
      k[1] = x.y;
      k[2] = x.z;
      k[3] = x.w;
    } else if constexpr (RPT > 1 && sizeof(K) == 2) {
      const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p + row0));
      k[0] = (short)(unsigned short)(x.x & 0xffffu);
      k[1] = (short)(unsigned short)(x.x >> 16);
      k[2] = (short)(unsigned short)(x.y & 0xffffu);
      k[3] = (short)(unsigned short)(x.y >> 16);
    } else if constexpr (RPT > 1) {
      const unsigned x = __ldcs(reinterpret_cast<const unsigned*>(p + row0));
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const unsigned b = (x >> (8 * r)) & 0xffu;
        k[r] = K(-1) < K(0) ? (long long)(signed char)b : (long long)b;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    if constexpr (sizeof(K) == 1) {
      const unsigned b = __ldcs(reinterpret_cast<const unsigned char*>(
          p + row0 + r));
      k[r] = K(-1) < K(0) ? (long long)(signed char)b : (long long)b;
    } else {
      k[r] = (long long)__ldcs(p + row0 + r);
    }
  }
}

template <int RPT>
__device__ __forceinline__ void load_valid(const unsigned char* __restrict__ p,
                                           long long row0, bool vec,
                                           bool (&ok)[RPT]) {
  if (p == nullptr) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) ok[r] = true;
  } else if (RPT == 4 && vec) {
    const unsigned x = __ldcs(reinterpret_cast<const unsigned*>(p + row0));
#pragma unroll
    for (int r = 0; r < RPT; ++r) ok[r] = (x >> (8 * r)) & 0xffu;
  } else if (RPT == 2 && vec) {
    const unsigned x = __ldcs(reinterpret_cast<const unsigned short*>(
        p + row0));
#pragma unroll
    for (int r = 0; r < RPT; ++r) ok[r] = (x >> (8 * r)) & 0xffu;
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) ok[r] = __ldcs(p + row0 + r) != 0;
  }
}

template <int RPT>
__device__ __forceinline__ void store_flags(unsigned char* __restrict__ p,
                                            long long row0,
                                            const bool (&m)[RPT]) {
  if constexpr (RPT == 4) {
    __stcs(reinterpret_cast<unsigned*>(p + row0),
           (unsigned)m[0] | (unsigned)m[1] << 8 | (unsigned)m[2] << 16 |
               (unsigned)m[3] << 24);
  } else if constexpr (RPT == 2) {
    __stcs(reinterpret_cast<unsigned short*>(p + row0),
           (unsigned short)((unsigned)m[0] | (unsigned)m[1] << 8));
  } else {
    __stcs(p + row0, (unsigned char)m[0]);
  }
}

template <int RPT>
__device__ __forceinline__ void store_words(int* __restrict__ p,
                                            long long row0,
                                            const int (&v)[RPT]) {
  if constexpr (RPT == 4) {
    __stcs(reinterpret_cast<int4*>(p + row0), make_int4(v[0], v[1], v[2],
                                                        v[3]));
  } else if constexpr (RPT == 2) {
    __stcs(reinterpret_cast<int2*>(p + row0), make_int2(v[0], v[1]));
  } else {
    __stcs(p + row0, v[0]);
  }
}

// RPT consecutive probe rows from row0: keys and flags, every gather, then
// every store.
template <class K, int SB, int RPT>
__device__ __forceinline__ void probe_rows(const ChttDenseArgs& a,
                                           long long row0, bool key_vec,
                                           bool valid_vec) {
  constexpr int NU = SB <= 4 ? 1 : SB / 4;
  long long k[RPT];
  bool ok[RPT];
  load_keys<K, RPT>(static_cast<const K*>(a.probe_key), row0, key_vec, k);
  load_valid<RPT>(a.probe_valid, row0, valid_vec, ok);
  unsigned u[RPT][NU];
  bool in[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long s = slot_of(k[r], a.lo, a.R);
    in[r] = ok[r] && s >= 0;
#pragma unroll
    for (int j = 0; j < NU; ++j) u[r][j] = 0;
    if (in[r]) load_slot<SB, NU>(a.table, s, u[r]);
  }
  bool m[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    m[r] = in[r] && get_field<NU>(u[r], a.w[0].offset, a.w[0].bytes) !=
                        a.w[0].empty;
  store_flags<RPT>(a.matched, row0, m);
#pragma unroll
  for (int t = 0; t < kMaxOuts; ++t) {
    if (t >= a.n_outs) break;
    const ChttDenseOut& o = a.o[t];
    int v[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      int x;
      if (o.kind == O_WORD)
        x = (int)(o.base + get_field<NU>(u[r], o.offset, o.bytes));
      else if (o.kind == O_KEY)
        x = (int)k[r];
      else
        x = 1;
      v[r] = m[r] ? x : 0;
    }
    store_words<RPT>(o.out, row0, v);
  }
}

template <class K, int SB>
__global__ void __launch_bounds__(kThreads)
    k_dense_probe(const ChttDenseArgs a, int key_vec, int valid_vec) {
  constexpr int RPT = sizeof(K) == 8 ? 2 : 4;
  const long long nvec = a.n_probe / RPT;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long v = first; v < nvec; v += step)
    probe_rows<K, SB, RPT>(a, v * RPT, key_vec != 0, valid_vec != 0);
  if (first == 0)
    for (long long i = nvec * RPT; i < a.n_probe; ++i)
      probe_rows<K, SB, 1>(a, i, false, false);
}

int blocks_for(long long n, int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm;
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

template <class K, int SB>
void launch_probe_sb(const ChttDenseArgs& a, cudaStream_t st) {
  constexpr int RPT = sizeof(K) == 8 ? 2 : 4;
  static bool carved = false;
  if (!carved) {
    // no shared memory: the whole carveout to the L1 that the gathers use
    cudaFuncSetAttribute(k_dense_probe<K, SB>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carved = true;
  }
  const int key_vec =
      (reinterpret_cast<uintptr_t>(a.probe_key) % (RPT * sizeof(K))) == 0;
  const int valid_vec = a.probe_valid != nullptr &&
      (reinterpret_cast<uintptr_t>(a.probe_valid) % RPT) == 0;
  k_dense_probe<K, SB><<<blocks_for(a.n_probe / RPT + 1, 16), kThreads, 0,
                         st>>>(a, key_vec, valid_vec);
}

template <class K>
void launch_probe(const ChttDenseArgs& a, cudaStream_t st) {
  switch (a.slot_bytes) {
    case 1: launch_probe_sb<K, 1>(a, st); break;
    case 2: launch_probe_sb<K, 2>(a, st); break;
    case 4: launch_probe_sb<K, 4>(a, st); break;
    case 8: launch_probe_sb<K, 8>(a, st); break;
    case 16: launch_probe_sb<K, 16>(a, st); break;
    default: launch_probe_sb<K, 32>(a, st); break;
  }
}

bool layout_ok(const ChttDenseArgs& a) {
  const int sb = a.slot_bytes;
  if (sb != 1 && sb != 2 && sb != 4 && sb != 8 && sb != 16 && sb != 32)
    return false;
  if (a.n_words < 1 || a.n_words > kMaxWords || a.n_outs < 0 ||
      a.n_outs > kMaxOuts ||
      reinterpret_cast<uintptr_t>(a.table) % 16 != 0)
    return false;
  for (int t = 0; t < a.n_words; ++t) {
    const ChttDenseWord& w = a.w[t];
    if ((w.bytes != 1 && w.bytes != 2 && w.bytes != 4) || w.offset < 0 ||
        w.offset % w.bytes != 0 || w.offset + w.bytes > sb)
      return false;
  }
  for (int t = 0; t < a.n_outs; ++t) {
    const ChttDenseOut& o = a.o[t];
    if (o.out == nullptr || o.kind < O_WORD || o.kind > O_KEYVALID)
      return false;
    if (o.kind == O_WORD &&
        ((o.bytes != 1 && o.bytes != 2 && o.bytes != 4) || o.offset < 0 ||
         o.offset % o.bytes != 0 || o.offset + o.bytes > sb))
      return false;
  }
  return true;
}

}  // namespace

// Key types: bool, int8, uint8, int16, int32, int64.  The table holds
// R * slot_bytes bytes, rounded up to a multiple of 16.
extern "C" int chtt_dense_join(const ChttDenseArgs* args, void* stream) {
  const ChttDenseArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) || !layout_ok(a) || a.n_build < 0 ||
      a.out_of_range == nullptr ||
      a.n_probe < 0 || a.build_dtype < DT_BOOL || a.build_dtype > DT_I64 ||
      a.probe_dtype < DT_BOOL || a.probe_dtype > DT_I64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_u32 = (a.R * a.slot_bytes + 15) / 16 * 4;
  k_dense_init<<<blocks_for(n_u32, 8), kThreads, 0, st>>>(a, n_u32);
  if (a.n_build > 0)
    k_dense_build<<<blocks_for(a.n_build, 8), kThreads, 0, st>>>(a);
  if (a.n_probe > 0) {
    switch (a.probe_dtype) {
      case DT_BOOL:
      case DT_U8: launch_probe<unsigned char>(a, st); break;
      case DT_I8: launch_probe<signed char>(a, st); break;
      case DT_I16: launch_probe<short>(a, st); break;
      case DT_I32: launch_probe<int>(a, st); break;
      default: launch_probe<long long>(a, st); break;
    }
  }
  return chtt_last_error();
}
