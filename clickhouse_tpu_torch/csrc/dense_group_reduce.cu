// K2: exact per-slot counts and integer sums of a dense GROUP BY.
//
// Replaces the reference's mxu_group_reduce and mxu_counts_and_sums
// (clickhouse_tpu/ops/mxu_segsum.py:51 and :172), which build one-hot
// matrices and run f32 matmuls over 8-bit limbs because a TPU serializes
// scatter.  The card has fast shared-memory atomics, so the histogram is
// built directly: no limbs, no sign bias, no matmul.
//
// Bound on the card: bytes read.  Every row reads its slot id (4 or 8
// bytes), its masks (1 byte each) and its summed values (1-8 bytes each)
// once; the outputs are (C + K) x S words.  The design keeps the per-row
// traffic at that: each block walks a grid-stride range of rows and adds
// into a private histogram in shared memory with 64-bit atomics (integer
// adds wrap mod 2^64, so signed and unsigned sums share the same bits and
// the order the atomics land in cannot change the result), then flushes
// each non-zero slot to device memory with one atomic per slot per block.
//
// Shared-memory bound: the histogram of one block is (C + K) arrays of
// `tile` u64 slots, with (C + K) * tile * 8 <= kSmemBudget (96 KB, so two
// blocks fit on an SM).  When S slots do not fit, the slot range is cut
// into tiles of `tile` slots and grid.y walks the tiles: each tile rereads
// the rows, which costs bytes only where S x (C + K) exceeds 12,288 words
// (S = 16,384 with one count and one sum takes three tiles).
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxArrays = 16;
constexpr int kSmemBudget = 96 * 1024;

struct DenseArgs {
  const void* ids;
  int ids_is64;
  const uint8_t* base;                 // NULL = all rows
  long long n;
  int S;
  int C;
  int K;
  int tile;
  const uint8_t* cmask[kMaxArrays];    // NULL = base only
  const void* svals[kMaxArrays];
  int sdtype[kMaxArrays];
  const uint8_t* smask[kMaxArrays];    // NULL = base only
  u64* counts;                         // C x S
  u64* sums;                           // K x S
};

__global__ void __launch_bounds__(kThreads)
k_dense_group_reduce(DenseArgs a) {
  extern __shared__ u64 hist[];        // (C + K) x tile
  const int tile_lo = blockIdx.y * a.tile;
  const int width = min(a.tile, a.S - tile_lo);
  const int arrays = a.C + a.K;
  for (int j = threadIdx.x; j < arrays * a.tile; j += blockDim.x) hist[j] = 0ull;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    if (a.base != nullptr && a.base[i] == 0) continue;
    const long long id = a.ids_is64 ? ((const long long*)a.ids)[i]
                                    : (long long)((const int*)a.ids)[i];
    const long long s = id - tile_lo;
    if (id < 0 || id >= a.S || s < 0 || s >= width) continue;
    for (int c = 0; c < a.C; ++c) {
      if (a.cmask[c] == nullptr || a.cmask[c][i] != 0)
        atomicAdd(&hist[c * a.tile + s], 1ull);
    }
    for (int k = 0; k < a.K; ++k) {
      if (a.smask[k] == nullptr || a.smask[k][i] != 0)
        atomicAdd(&hist[(a.C + k) * a.tile + s],
                  load_int_u64(a.svals[k], a.sdtype[k], i));
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < arrays * a.tile; j += blockDim.x) {
    const int arr = j / a.tile, s = j - arr * a.tile;
    const u64 v = hist[j];
    if (v == 0ull || s >= width) continue;
    if (arr < a.C) atomicAdd(&a.counts[(long long)arr * a.S + tile_lo + s], v);
    else atomicAdd(&a.sums[(long long)(arr - a.C) * a.S + tile_lo + s], v);
  }
}

// ids: n int32/int64 slot ids (rows outside [0, S) are skipped); base: n
// bytes or NULL; cmasks/svals/smasks/sdtypes: HOST arrays of C and K
// entries; counts (C x S) and sums (K x S) are zeroed int64 outputs.
extern "C" int chtt_dense_group_reduce(
    const void* ids, int ids_is64, const void* base, long long n, int S,
    int C, const void* const* cmasks, int K, const void* const* svals,
    const int* sdtypes, const void* const* smasks, void* counts, void* sums,
    int nb, void* stream) {
  if (C + K < 1 || C > kMaxArrays || K > kMaxArrays || S < 1)
    return (int)cudaErrorInvalidValue;
  DenseArgs a;
  a.ids = ids;
  a.ids_is64 = ids_is64;
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
  const int per_slot = 8 * (C + K);
  int tile = kSmemBudget / per_slot;
  if (tile > S) tile = S;
  a.tile = tile;
  const int tiles = (S + tile - 1) / tile;
  const size_t smem = (size_t)per_slot * tile;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k_dense_group_reduce, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    dim3 grid(nb, tiles);
    k_dense_group_reduce<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return chtt_last_error();
}
