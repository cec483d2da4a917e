// K16: HyperLogLog registers (ops/sketch_ops.py): the update (with the
// copy of its keyed cells, an entry of its own), the merge and the
// finalize of HLLUniqAgg (uniq, uniqCombined, uniqCombined64, uniqHLL12,
// uniqTheta).
//
// Replaces HLLUniqAgg.update (clickhouse_tpu/exprs/agg_sketch.py:301),
// .merge (:346) and .finalize (:355).  The TPU has no scatter, so the
// reference hashes every row, sorts the rows by (keys, register, -rho),
// takes each run's head and assembles 8 one-byte registers a u64 limb with
// a segmented cumsum; its merge is a segmented per-byte max over sorted
// states.  The state here is the same bytes: (groups, m) uint8, register r
// of a group in byte r of its row (the reference's limb l holds register
// 8l + k in byte k, little-endian).
//
// (a) update: a row's register is h & (m - 1) and its rho 1 + the count of
// trailing zeros of (h >> log2 m) | 2^(64 - log2 m), h the row hash
// (hash64.cuh) of the argument columns as stored, formed in registers: no
// hash is written.  The registers depend only on the set of (group, hash)
// pairs, so the rows may come in any order.  Two ways in:
//   - in row order (k_hll_update_rows): GROUP BY () (one slot), or the
//     sort grouping where every key has a small proven range.  A row's
//     slot is its keys' digits (value - lo) in mixed radix, first key
//     fastest, formed in registers from the keys (int32): no perm and no
//     group id is read, every load is coalesced and marked streamed.
//     GROUP BY (): each block keeps the m registers in shared memory, a
//     u32 each (shared atomicMax, read first and skipped where the
//     register holds rho), and byte-maxes them into the state once at its
//     end.  Measured on an H100 (PERF.md): the hashes alone take 0.41 of
//     its 0.49 ms at Qu1 (K15's hash of the same column, 0.47, is alike);
//     that end flush costs 0.01, and each block's registers written as a
//     partial row and folded by a second kernel took as long.
//     Keyed: a u32 cell a (slot, register) in device memory (the live
//     registers: at most HLL_ROWS_MAX_CELLS), read through L1 (a stale
//     value is a lower one: it costs an atomic, never an answer) and
//     raised by atomicMax where rho is above it; k_hll_cells (its own
//     entry) copies them as bytes into each slot's group (a slot -> group
//     table from the grouping's unique keys).  Measured on an H100
//     (PERF.md): a byte a register in shared memory with a CAS on its
//     word, a block's partial rows and a fold, took 2.3-3.5 ms at Qu2's
//     65,536 registers against the cells' 0.68 (a block saw ~4 rows a
//     register, so half the rows took a CAS), a global byte CAS on the
//     state 15-21 ms.
//   - through perm (k_hll_update_sorted): the other sort groupings (wide,
//     float or unbounded keys).  A warp's tile of sorted positions at a
//     time: the group id and the row id (perm) are coalesced reads, the
//     value is read through perm (one random access a row) and the
//     (group, register) byte takes a global byte max (a CAS on its 32-bit
//     word, read first: CUDA has no byte atomicMax).
// A thread's rows' loads are all issued before the first hash, and each
// kernel is built for each storage type of the first column.  Measured on
// an H100 (PERF.md): the perm entry is set by its gather through perm (the
// same gather alone, as index_select, takes as long), which the row-order
// entry does not make.  Bound: bytes (the columns' and keys' storage, the
// mask, perm and gid where read, once; the state written once; the cells'
// copy: the cells and the table read, the state written).
// (b) merge: a thread a (group, 4-register word): the per-byte max
// (__vmaxu4) over the rows of the group's partial states, read through
// perm from K5's starts and ends (K6's sorted entry's layout), a mask
// optional.  Bound: bytes (the partial states read, the merged written).
// (c) finalize: 4 to 32 lanes a group (16 bytes a lane a load) sum
// 2^-register in float32 and count the zero registers, reduced by
// shuffles; the estimate is the reference's formula (float32, alpha, the
// linear-counting branch, round half to even).  Bound: bytes (the state
// read once, 8 bytes a group written).  The float32 sum is taken in
// another order than the reference's, so an estimate may differ from it
// by 1 where the sum's last bit differs.
#include "hash64.cuh"

constexpr int kMaxSlotKeys = 4;

// One GROUP BY key of the row-order update (ops/_native.K16SlotKey): its
// int32 values (stride 0: one value for every row; the wrapper hands a key
// of another type as its digits), the least value of its proven range,
// the range's span and the slot's multiplier (the product of the earlier
// keys' spans).
struct ChttSlotKey {
  const int* data;
  long long lo;
  long long span;
  long long mult;
  int stride;
  int pad;
};

// What a row-order GROUP BY () launch does: the update, or (chtt_hll_split,
// a measurement) a part of it.
enum HllProbe {
  HP_UPDATE = 0,     // the update, its registers into the state
  HP_HASH = 1,       // the rows' hashes alone, no register
  HP_NO_FLUSH = 2,   // the registers, nothing flushed into the state
};

// One update (ops/_native.K16Args).
struct ChttHllArgs {
  ChttHashCol cols[kMaxHashCols];
  int n_cols;
  int log2m;
  long long n;            // rows (row order) or sorted positions (perm)
  long long cap_g;        // group rows of the state
  const int* perm;        // sorted position -> row (NULL: row order)
  const int* gid;         // group of each sorted position (with perm)
  const unsigned char* mask;  // raw-order row mask (NULL: every row)
  unsigned char* state;   // (cap_g, m) registers, zeroed by the caller
                          // (the keyed row-order update writes none)
  // the row-order entry (perm NULL)
  ChttSlotKey keys[kMaxSlotKeys];
  int n_keys;             // 0: GROUP BY (), one slot
  int pad;
  long long slots;        // S, the product of the keys' spans
  unsigned* cells;        // keyed: S * m u32 registers, zeroed
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// The byte at p becomes max(byte, v): a CAS on its aligned 32-bit word,
// skipped where the byte already holds v or more.
__device__ __forceinline__ void byte_max(unsigned char* p, unsigned v) {
  unsigned* w = (unsigned*)((size_t)p & ~(size_t)3);
  const int sh = (int)((size_t)p & 3) * 8;
  unsigned old = *(volatile unsigned*)w;
  while (((old >> sh) & 0xFFu) < v) {
    const unsigned want = (old & ~(0xFFu << sh)) | (v << sh);
    const unsigned got = atomicCAS(w, old, want);
    if (got == old) break;
    old = got;
  }
}

// A row's register h & (m - 1) and its rho, 1 + the trailing zeros of
// (h >> log2m) | 2^(64 - log2m): the place of h's lowest set bit at or
// above bit log2m, counted from log2m, or 65 - log2m where there is none
// (no variable 64-bit shift).
__device__ __forceinline__ void reg_rho(u64 h, int log2m, unsigned* reg,
                                        unsigned* rho) {
  *reg = (unsigned)h & ((1u << log2m) - 1u);
  const u64 hi = h & ~((1ull << log2m) - 1ull);
  *rho = hi != 0 ? (unsigned)(__ffsll((long long)hi) - log2m)
                 : (unsigned)(65 - log2m);
}


// The row-order update.  NK: the keys the instance reads (a launch's
// n_keys is at most NK; 0: GROUP BY (), the registers in shared memory).
// ONE: the hash is of one integer column, with no term (uniq(x)): hash64
// of its value, no column or term dispatch a row.  PROBE: HllProbe.  A
// thread's kUnroll rows' values, key values and mask bytes are loaded
// before any is hashed.  The instances of GROUP BY () and of one key are
// held to 64 registers: 4 blocks an SM.
template <int DT0, int NK, bool ONE, int PROBE>
__global__ void __launch_bounds__(kThreads, NK <= 1 ? 4 : 1)
    k_hll_update_rows(const ChttHllArgs a) {
  extern __shared__ unsigned sreg[];
  const int log2m = a.log2m;
  if (NK == 0) {
    for (int i = threadIdx.x; i < (1 << log2m); i += kThreads) sreg[i] = 0;
    __syncthreads();
  }
  u64 hx = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x;
       base < a.n; base += stride * kUnroll) {
    u64 raw[kUnroll][kMaxHashCols];
    int kv[kUnroll][NK > 0 ? NK : 1];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * stride;
      ok[u] = r < a.n;
      if (ok[u]) {
        if (ONE)
          raw[u][0] = load_raw<DT0, true>(a.cols[0], r);
        else
          load_row<DT0, true>(a.cols, a.n_cols, r, raw[u]);
#pragma unroll
        for (int k = 0; k < NK; ++k)
          kv[u][k] = k < a.n_keys
                         ? ld_ro<true>(a.keys[k].data + r * a.keys[k].stride)
                         : 0;
        if (a.mask != nullptr) ok[u] = ld_ro<true>(a.mask + r) != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      long long slot = 0;
      bool in = true;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        if (k < a.n_keys) {
          const long long d = (long long)kv[u][k] - a.keys[k].lo;
          in = in && (unsigned long long)d < (unsigned long long)a.keys[k].span;
          slot += d * a.keys[k].mult;
        }
      }
      if (!in) continue;                 // outside the proven range
      const u64 h =
          ONE ? chtt_hash64(DT0 == DT_BOOL ? (u64)(raw[u][0] != 0) : raw[u][0])
              : row_hash_of<DT0>(a.cols, a.n_cols, raw[u]);
      if (PROBE == HP_HASH) {
        hx ^= h;
        continue;
      }
      unsigned reg, rho;
      reg_rho(h, log2m, &reg, &rho);
      if (NK == 0) {
        if (rho > sreg[reg]) atomicMax(&sreg[reg], rho);
      } else {
        unsigned* cell = a.cells + (slot << log2m) + reg;
        if (rho > __ldca(cell)) atomicMax(cell, rho);
      }
    }
  }
  if (PROBE == HP_HASH) {
    if (hx == 0x5DEECE66Dull) a.state[0] = 1;  // keeps the hashes computed
    return;
  }
  if (NK > 0 || PROBE == HP_NO_FLUSH) return;
  __syncthreads();
  for (int i = threadIdx.x; i < (1 << log2m); i += kThreads)
    if (sreg[i]) byte_max(a.state + i, sreg[i]);
}

// The keyed update's u32 cells into the state: chunk q (16 registers) of
// slot q / C (C = m / 16) as 16 bytes, written to the slot's group
// slot_group[slot] (none where it is -1 or cap_g and above).
__global__ void __launch_bounds__(kThreads)
    k_hll_cells(const uint4* __restrict__ cells, long long chunks, int log2c,
                const int* __restrict__ slot_group, long long cap_g,
                uint4* __restrict__ state) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= chunks) return;
  const long long g = __ldg(slot_group + (q >> log2c));
  if (g < 0 || g >= cap_g) return;
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = __ldg(cells + 4 * q + j);
    w[j] = v.x | (v.y << 8) | (v.z << 16) | (v.w << 24);
  }
  state[(g << log2c) + (q & ((1ll << log2c) - 1))] =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// The sort grouping through perm: a warp takes kTile consecutive sorted
// positions at a time (the group ids and row ids coalesced), the values
// through perm.
constexpr int kTile = 32 * kUnroll;

template <int DT0>
__global__ void __launch_bounds__(kThreads)
    k_hll_update_sorted(const ChttHllArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base =
           (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kTile +
           lane;
       base < a.n; base += warps * kTile) {
    int g[kUnroll], row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u;
      g[u] = i < a.n ? __ldg(a.gid + i) : (int)a.cap_g;
      row[u] = i < a.n ? __ldg(a.perm + i) : 0;
    }
    u64 raw[kUnroll][kMaxHashCols];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = g[u] >= 0 && g[u] < a.cap_g;
      if (ok[u]) {
        load_row<DT0>(a.cols, a.n_cols, row[u], raw[u]);
        if (a.mask != nullptr) ok[u] = __ldg(a.mask + row[u]) != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      unsigned reg, rho;
      reg_rho(row_hash_of<DT0>(a.cols, a.n_cols, raw[u]), a.log2m, &reg,
              &rho);
      byte_max(a.state + ((long long)g[u] << a.log2m) + reg, rho);
    }
  }
}

typedef void (*HllKernel)(const ChttHllArgs);

// The row-order instance of a launch: GROUP BY () (no key), at most 1
// key or up to 4; those of at most one key also for one integer column
// with no term (`one`; never a float column).
struct PickRows {
  int n_keys;
  bool one;
  template <int DT>
  HllKernel operator()() const {
    constexpr bool kInt = DT != DT_F32 && DT != DT_F64;
    if (n_keys == 0)
      return one ? k_hll_update_rows<DT, 0, kInt, HP_UPDATE>
                 : k_hll_update_rows<DT, 0, false, HP_UPDATE>;
    if (n_keys > 1)
      return k_hll_update_rows<DT, kMaxSlotKeys, false, HP_UPDATE>;
    return one ? k_hll_update_rows<DT, 1, kInt, HP_UPDATE>
               : k_hll_update_rows<DT, 1, false, HP_UPDATE>;
  }
};

// GROUP BY ()'s parts over one integer column (chtt_hll_split).
struct PickSplit {
  int probe;
  template <int DT>
  HllKernel operator()() const {
    if constexpr (DT == DT_F32 || DT == DT_F64)
      return nullptr;
    else
      return probe == HP_HASH ? k_hll_update_rows<DT, 0, true, HP_HASH>
                              : k_hll_update_rows<DT, 0, true, HP_NO_FLUSH>;
  }
};

template <typename F>
HllKernel pick_by_dtype(int dt, F f) {
  switch (dt) {
    case DT_BOOL: return f.template operator()<DT_BOOL>();
    case DT_I8: return f.template operator()<DT_I8>();
    case DT_U8: return f.template operator()<DT_U8>();
    case DT_I16: return f.template operator()<DT_I16>();
    case DT_I32: return f.template operator()<DT_I32>();
    case DT_I64: return f.template operator()<DT_I64>();
    case DT_F32: return f.template operator()<DT_F32>();
    default: return f.template operator()<DT_F64>();
  }
}

struct PickSorted {
  template <int DT>
  HllKernel operator()() const {
    return k_hll_update_sorted<DT>;
  }
};

// Dynamic shared bytes of a row-order launch: GROUP BY ()'s registers
// (16 KB at most).
int rows_smem(const ChttHllArgs& a) {
  return a.n_keys == 0 ? 4 << a.log2m : 0;
}

// (b): out word q of group q / W = the byte max over the group's rows.
__global__ void __launch_bounds__(kThreads)
    k_hll_merge(const unsigned* __restrict__ in,
                const long long* __restrict__ starts,
                const long long* __restrict__ ends,
                const int* __restrict__ perm,
                const unsigned char* __restrict__ mask, long long n_in,
                long long n_groups, int log2w, unsigned* __restrict__ out) {
  const long long total = n_groups << log2w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long wmask = (1ll << log2w) - 1;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += stride) {
    const long long g = q >> log2w, w = q & wmask;
    long long s, e;
    if (starts != nullptr) {
      s = __ldg(starts + g);
      e = __ldg(ends + g);
    } else {
      s = 0;
      e = g == 0 ? n_in : 0;
    }
    unsigned acc = 0;
    for (long long p = s; p < e; ++p) {
      const long long r = perm != nullptr ? (long long)__ldg(perm + p) : p;
      if (mask != nullptr && !__ldg(mask + r)) continue;
      acc = __vmaxu4(acc, __ldg(in + (r << log2w) + w));
    }
    out[q] = acc;
  }
}

// 2^-b for a register b (0..64) as an exact float32.
__device__ __forceinline__ float exp2_neg(unsigned b) {
  return __int_as_float((int)(127u - b) << 23);
}

// (c): lanes lanes (4..32, a power of two) a group, 16 bytes a lane a load.
__global__ void __launch_bounds__(kThreads)
    k_hll_finalize(const uint4* __restrict__ state, long long n_groups,
                   int log2m, int lanes, long long* __restrict__ out) {
  const int m = 1 << log2m;
  const int loads = m / 16;                       // uint4 a row
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane % lanes;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const double alpha = 0.7213 / (1.0 + 1.079 / m);
  const float am2 = (float)(alpha * m * m);
  for (long long r0 = warp * per_warp; r0 < n_groups;
       r0 += warps * per_warp) {
    const long long row = r0 + lane / lanes;
    float z = 0.f;
    int v = 0;
    if (row < n_groups) {
      const uint4* p = state + row * loads;
      for (int j = sub; j < loads; j += lanes) {
        const uint4 q = __ldg(p + j);
        const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const unsigned x = (words[k] >> (8 * b)) & 0xFFu;
            z += exp2_neg(x);
            v += x == 0;
          }
        }
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {
      z += __shfl_xor_sync(0xffffffffu, z, o);
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (row < n_groups && sub == 0) {
      float e = am2 / fmaxf(z, 1e-9f);
      const float lc = (float)m * logf((float)m / (float)max(v, 1));
      if (e <= 2.5f * (float)m && v > 0) e = lc;
      out[row] = (long long)rintf(e);
    }
  }
}

bool log2m_ok(int log2m) { return log2m >= 6 && log2m <= 12; }

// A row-order launch's arguments: its keys and slots, the state where
// GROUP BY () writes it, the cells where keyed.
bool rows_ok(const ChttHllArgs& a) {
  if (a.n_keys < 0 || a.n_keys > kMaxSlotKeys || a.slots < 1 ||
      a.slots > (1ll << 30) || (a.n_keys == 0 && a.state == nullptr) ||
      (a.n_keys > 0 && a.cells == nullptr))
    return false;
  long long mult = 1;
  for (int k = 0; k < a.n_keys; ++k) {
    const ChttSlotKey& key = a.keys[k];
    if (key.data == nullptr || (key.stride != 0 && key.stride != 1) ||
        key.span < 1 || key.mult != mult)
      return false;
    mult *= key.span;
    if (mult > a.slots) return false;
  }
  return mult == a.slots;
}

bool update_ok(const ChttHllArgs* a) {
  if (a == nullptr || a->n_cols < 1 || a->n_cols > kMaxHashCols ||
      !log2m_ok(a->log2m) || a->n < 0 || a->cap_g < 1 ||
      (a->perm == nullptr) != (a->gid == nullptr))
    return false;
  for (int k = 0; k < a->n_cols; ++k)
    if (!hash_col_ok(a->cols[k]) || (k > 0 && a->cols[k].kind == HK_HASH))
      return false;
  return a->perm != nullptr ? a->state != nullptr : rows_ok(*a);
}

// One integer column with no term: the `one` instances.
bool one_int(const ChttHllArgs& a) {
  const ChttHashCol& c = a.cols[0];
  return a.n_cols == 1 && c.kind == HK_INT && c.term == HT_NONE;
}

HllKernel rows_kernel(const ChttHllArgs& a) {
  return pick_by_dtype(a.cols[0].dtype, PickRows{a.n_keys, one_int(a)});
}

}  // namespace

// Blocks an SM of a row-order update (a->perm NULL): its instance's
// occupancy (the keyed instances ask for all of the SM's L1 for the
// cells); 0 where the arguments are refused.
extern "C" int chtt_hll_rows_per_sm(const ChttHllArgs* a) {
  if (!update_ok(a) || a->perm != nullptr) return 0;
  const HllKernel k = rows_kernel(*a);
  if (a->n_keys > 0 &&
      cudaFuncSetAttribute((const void*)k,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           0) != cudaSuccess)
    return 0;
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, (const void*)k, kThreads, rows_smem(*a)) != cudaSuccess)
    return 0;
  return occ;
}

// One update (ChttHllArgs) in `blocks` blocks.  perm and gid: the sort
// grouping through perm.  Else in row order: GROUP BY () into the state,
// keyed into a->cells (chtt_hll_cells copies them into the state).
extern "C" int chtt_hll_update(const ChttHllArgs* a, int blocks,
                               void* stream) {
  if (!update_ok(a) || blocks < 1) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->perm != nullptr)
    pick_by_dtype(a->cols[0].dtype, PickSorted{})<<<blocks, kThreads, 0,
                                                    st>>>(*a);
  else
    rows_kernel(*a)<<<blocks, kThreads, rows_smem(*a), st>>>(*a);
  return chtt_last_error();
}

// A part of GROUP BY ()'s update over one integer column with no term, for
// its measurement: probe HP_HASH (the hashes alone) or HP_NO_FLUSH (the
// registers, nothing flushed), in `blocks` blocks.
extern "C" int chtt_hll_split(const ChttHllArgs* a, int probe, int blocks,
                              void* stream) {
  if (!update_ok(a) || a->perm != nullptr || a->n_keys != 0 ||
      !one_int(*a) || blocks < 1 || (probe != HP_HASH && probe != HP_NO_FLUSH))
    return (int)cudaErrorInvalidValue;
  const HllKernel k = pick_by_dtype(a->cols[0].dtype, PickSplit{probe});
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  k<<<blocks, kThreads, rows_smem(*a), (cudaStream_t)stream>>>(*a);
  return chtt_last_error();
}

// The keyed row-order update's cells (slots * m u32, 16-byte aligned) into
// state (cap_g, m), zeroed: slot s's registers as bytes in row
// slot_group[s] (int32; none where -1 or cap_g and above).
extern "C" int chtt_hll_cells(const void* cells, long long slots, int log2m,
                              const void* slot_group, long long cap_g,
                              void* state, void* stream) {
  if (cells == nullptr || slot_group == nullptr || state == nullptr ||
      !log2m_ok(log2m) || slots < 0 || cap_g < 1 || ((size_t)cells & 15) ||
      ((size_t)state & 15))
    return (int)cudaErrorInvalidValue;
  const long long chunks = slots << (log2m - 4);
  if (chunks == 0) return 0;
  k_hll_cells<<<(unsigned)((chunks + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>((const uint4*)cells, chunks,
                                        log2m - 4, (const int*)slot_group,
                                        cap_g, (uint4*)state);
  return chtt_last_error();
}

// in: n_in partial states of m registers; out: n_groups merged states.
// starts/ends (int64) and perm (int32) from K5 and the sort; starts NULL:
// group 0 is every partial row, the others none.  mask: partial rows that
// take part (bool, NULL: all).
extern "C" int chtt_hll_merge(const void* in, const void* starts,
                              const void* ends, const void* perm,
                              const void* mask, long long n_in,
                              long long n_groups, int log2m, void* out,
                              int blocks, void* stream) {
  if (in == nullptr || out == nullptr || !log2m_ok(log2m) || n_in < 0 ||
      n_groups < 0 || blocks < 1 || (starts == nullptr) != (ends == nullptr)
      || (perm != nullptr && starts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  k_hll_merge<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)in, (const long long*)starts, (const long long*)ends,
      (const int*)perm, (const unsigned char*)mask, n_in, n_groups,
      log2m - 2, (unsigned*)out);
  return chtt_last_error();
}

// state: n_groups rows of m registers (16-byte aligned); out: n_groups
// int64 estimates.
extern "C" int chtt_hll_finalize(const void* state, long long n_groups,
                                 int log2m, void* out, int blocks,
                                 void* stream) {
  if (state == nullptr || out == nullptr || !log2m_ok(log2m) ||
      n_groups < 0 || blocks < 1 || ((size_t)state & 15))
    return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  const int lanes = (1 << log2m) / 16 < 32 ? (1 << log2m) / 16 : 32;
  k_hll_finalize<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)state, n_groups, log2m, lanes, (long long*)out);
  return chtt_last_error();
}
