// K16: HyperLogLog registers (ops/sketch_ops.py), three entries: the
// update, the merge and the finalize of HLLUniqAgg (uniq, uniqCombined,
// uniqCombined64, uniqHLL12, uniqTheta).
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
// hash is written.  Under GROUP BY () (no perm, no gid) each block keeps
// the m registers in shared memory as u32 words (shared atomicMax), then
// takes one global byte max each (a CAS on the byte's 32-bit word; CUDA
// has no byte atomicMax).  Under the sort grouping the rows are taken in
// sorted order, a warp's tile of them at a time: the group id and the row
// id (perm) are coalesced reads, the value is read through perm (one
// random access a row) and the (group, register) byte takes a global byte
// max.  Both read the state byte first and skip the CAS where it already
// holds rho or more, which after the first rows is nearly always; a
// thread's rows' loads are all issued before the first hash, and each
// kernel is built for each storage type of the first column.  Measured
// on an H100 (PERF.md): the sorted update is set by the gather through
// perm (the same gather alone, as index_select, takes as long).  Bound: bytes (the columns'
// storage, perm and gid read once, the state written once).
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
//
// A first version, right before fast.
#include "hash64.cuh"

// One update (ops/_native.K16Args).
struct ChttHllArgs {
  ChttHashCol cols[kMaxHashCols];
  int n_cols;
  int log2m;
  long long n;            // rows (trivial) or sorted positions (perm/gid)
  long long cap_g;        // group rows of the state
  const int* perm;        // sorted position -> row (NULL: GROUP BY ())
  const int* gid;         // group of each sorted position (with perm)
  const unsigned char* mask;  // raw-order row mask (NULL: every row)
  unsigned char* state;   // (cap_g, m) registers
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

__device__ __forceinline__ void reg_rho(u64 h, int log2m, unsigned* reg,
                                        unsigned* rho) {
  *reg = (unsigned)(h & ((1ull << log2m) - 1ull));
  const u64 wg = (h >> log2m) | (1ull << (64 - log2m));
  *rho = (unsigned)__ffsll((long long)wg);   // 1 + trailing zeros
}

// GROUP BY (): registers in shared memory, one global byte max each.  A
// thread's kUnroll rows' values (and mask bytes) are loaded before any is
// hashed.
template <int DT0>
__global__ void __launch_bounds__(kThreads)
    k_hll_update_shared(const ChttHllArgs a) {
  extern __shared__ unsigned sreg[];
  const int m = 1 << a.log2m;
  for (int r = threadIdx.x; r < m; r += blockDim.x) sreg[r] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < a.n; base += stride * kUnroll) {
    u64 raw[kUnroll][kMaxHashCols];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * stride;
      ok[u] = r < a.n;
      if (ok[u]) {
        load_row<DT0>(a.cols, a.n_cols, r, raw[u]);
        if (a.mask != nullptr) ok[u] = __ldg(a.mask + r) != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      unsigned reg, rho;
      reg_rho(row_hash_of<DT0>(a.cols, a.n_cols, raw[u]), a.log2m, &reg,
              &rho);
      if (rho > sreg[reg]) atomicMax(&sreg[reg], rho);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += blockDim.x)
    if (sreg[r]) byte_max(a.state + r, sreg[r]);
}

// The sort grouping: a warp takes kTile consecutive sorted positions at a
// time (the group ids and row ids coalesced), the values through perm.
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

struct LaunchUpdate {
  const ChttHllArgs& a;
  int blocks;
  cudaStream_t st;
  template <int DT>
  int operator()() const {
    if (a.perm == nullptr)
      k_hll_update_shared<DT><<<blocks, kThreads,
                                sizeof(unsigned) << a.log2m, st>>>(a);
    else
      k_hll_update_sorted<DT><<<blocks, kThreads, 0, st>>>(a);
    return chtt_last_error();
  }
};

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

}  // namespace

// One update (ChttHllArgs): perm and gid both NULL for GROUP BY ().
extern "C" int chtt_hll_update(const ChttHllArgs* a, int blocks,
                               void* stream) {
  if (a == nullptr || a->n_cols < 1 || a->n_cols > kMaxHashCols ||
      !log2m_ok(a->log2m) || a->n < 0 || a->cap_g < 1 ||
      a->state == nullptr || blocks < 1 ||
      (a->perm == nullptr) != (a->gid == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a->n_cols; ++k)
    if (!hash_col_ok(a->cols[k]) || (k > 0 && a->cols[k].kind == HK_HASH))
      return (int)cudaErrorInvalidValue;
  if (a->n == 0) return 0;
  return by_dtype(a->cols[0].dtype,
                  LaunchUpdate{*a, blocks, (cudaStream_t)stream});
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
