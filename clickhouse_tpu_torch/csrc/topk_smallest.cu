// K3: indices of the k smallest rows by (invalid, token as u64, row id).
//
// Replaces the reference's topk_permutation and topk_permutation32
// (clickhouse_tpu/ops/sort_ops.py:140 and :110), which the executor's
// ORDER BY ... LIMIT k path calls (clickhouse_tpu/exec/executor.py:959).
// Validity is a key of its own, never folded into the token, and ties go
// to the lower row id, as in the reference.
//
// Bound on the card: bytes read.  The first level reads every row's token
// (8 bytes) and validity byte once; the rest is on-chip work on a few
// thousand candidates per block.  Design:
//   * level 1 (k_topk_stream): each block walks a contiguous chunk of rows
//     and keeps its best k so far, sorted, in shared memory.  A row is
//     admitted into a buffer beside them only if it beats the current k-th
//     best; the buffer and the best k are sorted together (bitonic network)
//     only when the buffer may overflow, so on typical data a block sorts a
//     handful of times while it streams its rows at memory speed;
//   * levels 2..: k_topk_tile sorts tiles of candidates and keeps the k
//     smallest of each (tile >= 2k, so each level at least halves them);
//   * the last launch sorts the survivors in one block and writes k row ids.
// A tile takes tile x 16 bytes of shared memory: 32 KB for k <= 1,024, up
// to 128 KB for k = 4,096 (dynamic shared memory above 48 KB).
#include "common.cuh"

struct Cand {
  u64 tok;
  unsigned int rid;
  unsigned int inv;            // 0 valid, 1 invalid, 2 padding
};

constexpr int kStreamThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRound = kStreamThreads * kRowsPerThread;   // rows per round

__device__ __forceinline__ bool cand_less(const Cand& a, const Cand& b) {
  if (a.inv != b.inv) return a.inv < b.inv;
  if (a.tok != b.tok) return a.tok < b.tok;
  return a.rid < b.rid;
}

__device__ __forceinline__ Cand sentinel() {
  Cand c;
  c.tok = ~0ull;
  c.rid = 0xffffffffu;
  c.inv = 2u;
  return c;
}

__device__ __forceinline__ Cand row_cand(const u64* token,
                                         const uint8_t* valid, long long i) {
  Cand c;
  c.tok = token[i];
  c.rid = (unsigned int)i;
  c.inv = (valid != nullptr && valid[i] == 0) ? 1u : 0u;
  return c;
}

// ascending bitonic sort of s[0, tile) by the whole block; ends synced
__device__ void bitonic_sort(Cand* s, int tile) {
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = threadIdx.x; j < tile; j += blockDim.x) {
        const int p = j ^ stride;
        if (p > j) {
          const bool up = (j & size) == 0;
          if (cand_less(s[p], s[j]) == up) {
            Cand t = s[j];
            s[j] = s[p];
            s[p] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// level 1: chunk rows per block -> k candidates per block
__global__ void __launch_bounds__(kStreamThreads)
k_topk_stream(const u64* __restrict__ token, const uint8_t* __restrict__ valid,
              long long n, long long chunk, int tile, int k,
              Cand* __restrict__ cand_out) {
  extern __shared__ Cand s[];      // [0, k) best so far, [k, tile) buffer
  __shared__ int count;
  __shared__ Cand thr;             // the k-th best so far
  for (int j = threadIdx.x; j < tile; j += blockDim.x) s[j] = sentinel();
  if (threadIdx.x == 0) {
    count = 0;
    thr = sentinel();
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  for (long long base = lo; base < hi + kRound; base += kRound) {
    const int used = count;
    __syncthreads();               // every thread has read count
    if (used > 0 && (base >= hi || used + kRound > tile - k)) {
      for (int j = k + used + threadIdx.x; j < tile; j += blockDim.x)
        s[j] = sentinel();
      __syncthreads();
      bitonic_sort(s, tile);
      if (threadIdx.x == 0) {
        count = 0;
        thr = s[k - 1];
      }
      __syncthreads();
    }
    if (base >= hi) break;
    const Cand t = thr;
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long i = base + (long long)r * blockDim.x + threadIdx.x;
      if (i < hi) {
        const Cand c = row_cand(token, valid, i);
        if (cand_less(c, t)) s[k + atomicAdd(&count, 1)] = c;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    cand_out[(long long)blockIdx.x * k + j] = s[j];
}

// levels 2..: sort tiles of candidates (or, when n <= tile, the rows
// themselves) and keep k per tile; final_out: write k row ids (clamped to
// n_rows - 1) instead of candidates
__global__ void k_topk_tile(const u64* __restrict__ token,
                            const uint8_t* __restrict__ valid,
                            const Cand* __restrict__ cand_in, long long m,
                            int tile, int keep, Cand* __restrict__ cand_out,
                            long long* __restrict__ final_out,
                            long long n_rows) {
  extern __shared__ Cand s[];
  const long long base = (long long)blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const long long i = base + j;
    if (i >= m) s[j] = sentinel();
    else if (cand_in != nullptr) s[j] = cand_in[i];
    else s[j] = row_cand(token, valid, i);
  }
  __syncthreads();
  bitonic_sort(s, tile);
  for (int j = threadIdx.x; j < keep; j += blockDim.x) {
    if (final_out != nullptr) {
      const long long r = (long long)s[j].rid;
      final_out[j] = r < n_rows ? r : n_rows - 1;
    } else {
      cand_out[(long long)blockIdx.x * keep + j] = s[j];
    }
  }
}

static int smem_ready(const void* kernel, int tile) {
  const size_t smem = (size_t)tile * sizeof(Cand);
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// token: n u64 (as int64 bits); valid: n bytes or NULL; out: k int64.
// tile: a power of two >= max(2k, k + 1024); nb: level-1 blocks; scratch:
// two candidate buffers of nb * k Cand each (16 bytes a candidate).
extern "C" int chtt_topk_smallest(const void* token, const void* valid,
                                  long long n, int k, int tile, int nb,
                                  void* out, void* scratch_a,
                                  void* scratch_b, void* stream) {
  if (k < 1 || n < 1 || nb < 1 || tile < 2 * k || tile < k + kRound
      || (tile & (tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = smem_ready((const void*)k_topk_tile, tile);
  if (e == 0) e = smem_ready((const void*)k_topk_stream, tile);
  if (e != 0) return e;
  const int threads = tile >= 1024 ? 1024 : tile;
  const size_t smem = (size_t)tile * sizeof(Cand);
  const u64* tok = (const u64*)token;
  const uint8_t* val = (const uint8_t*)valid;
  long long* o = (long long*)out;
  if (n <= tile) {
    k_topk_tile<<<1, threads, smem, st>>>(tok, val, nullptr, n, tile, k,
                                          nullptr, o, n);
    return chtt_last_error();
  }
  Cand* bufs[2] = {(Cand*)scratch_a, (Cand*)scratch_b};
  const long long chunk = (n + nb - 1) / nb;
  k_topk_stream<<<nb, kStreamThreads, smem, st>>>(tok, val, n, chunk, tile,
                                                  k, bufs[0]);
  long long m = (long long)nb * k;
  int cur = 0;
  while (m > tile) {
    const long long blocks = (m + tile - 1) / tile;
    k_topk_tile<<<(unsigned)blocks, threads, smem, st>>>(
        nullptr, nullptr, bufs[cur], m, tile, k, bufs[1 - cur], nullptr, n);
    m = blocks * k;
    cur = 1 - cur;
  }
  k_topk_tile<<<1, threads, smem, st>>>(nullptr, nullptr, bufs[cur], m, tile,
                                        k, nullptr, o, n);
  return chtt_last_error();
}
