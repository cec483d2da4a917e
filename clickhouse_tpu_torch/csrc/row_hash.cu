// K15: the row hash, hash_columns over 1-4 columns in one pass (ops/
// hash_ops.row_hash).
//
// Replaces the reference's hash_columns (clickhouse_tpu/ops/hash_ops.py:
// 179), which XLA runs as one elementwise pass a splitmix step over the
// columns widened to u64.  Here each column is read as it is stored
// (int8/16/32/64, uint8, Bool, a dictionary code, a float whose token is
// formed in registers, an intDiv/modulo term of a narrow column) and the
// splitmix steps (hash64.cuh) run in registers: one int64 (u64 bits) is
// written a row.
//
// Bound on the card: bytes (each column's storage read once, 8 bytes a row
// written; 64-bit multiplies are a few instructions a byte).  A first
// version: a grid-stride loop, four rows a thread a step (kUnroll), a
// column at a time over them, so a thread keeps four loads of a column in
// flight; a warp's loads and stores are coalesced; one instance for each
// storage type of the first column, whose loads then take no switch.
// (Loading every column's four values before the first hash doubled the
// registers and halved the blocks an SM holds: 0.77 ms at Qu3's inputs
// against 0.61 on an H100; PERF.md.)
#include "hash64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

struct ChttRowHashArgs {
  ChttHashCol cols[kMaxHashCols];
  int n_cols;
};

template <int DT0>
__global__ void __launch_bounds__(kThreads)
    k_row_hash(const ChttRowHashArgs a, long long n,
               long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < n; base += stride * kUnroll) {
    u64 h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * stride;
      h[u] = r < n ? hash_start(a.cols[0], hash_of<DT0>(
                                    a.cols[0], load_raw<DT0>(a.cols[0], r)))
                   : 0;
    }
    for (int k = 1; k < a.n_cols; ++k) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + u * stride;
        if (r < n)
          h[u] = chtt_hash_combine(h[u], hash_of(a.cols[k],
                                                 load_raw(a.cols[k], r)));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + u * stride;
      if (r < n) out[r] = (long long)h[u];
    }
  }
}

struct Launch {
  const ChttRowHashArgs& a;
  long long n;
  long long* out;
  int blocks;
  cudaStream_t st;
  template <int DT>
  int operator()() const {
    k_row_hash<DT><<<blocks, kThreads, 0, st>>>(a, n, out);
    return chtt_last_error();
  }
};

}  // namespace

// cols: n_cols (1-4) ChttHashCol; out: n int64.
extern "C" int chtt_row_hash(const ChttHashCol* cols, int n_cols, long long n,
                             void* out, int blocks, void* stream) {
  if (n_cols < 1 || n_cols > kMaxHashCols || n < 0 || blocks < 1 ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  ChttRowHashArgs a = {};
  for (int k = 0; k < n_cols; ++k) {
    if (!hash_col_ok(cols[k]) || (k > 0 && cols[k].kind == HK_HASH))
      return (int)cudaErrorInvalidValue;
    a.cols[k] = cols[k];
  }
  a.n_cols = n_cols;
  if (n == 0) return 0;
  return by_dtype(cols[0].dtype, Launch{a, n, (long long*)out, blocks,
                                        (cudaStream_t)stream});
}
