// K13: the bit-packed chunk transport's unpack, one streamed chunk of a
// bounded integer column from its "half" layout to its narrow storage.
//
// Replaces _chunk_block's unpack (clickhouse_tpu/exec/streaming.py:
// 930-968), which XLA lowers to bpp strided u8 lane slices, shifts, ors
// and a concatenate inside the per-chunk program.
//
// The layout (storage/table.py ChunkSource.encode_column): a chunk of cap
// values (cap even, half = cap / 2) is half pairs of bpp bytes each,
// little-endian; pair j holds value j in its low w4 bits and value
// j + half in the next w4 (w4 a multiple of 4, 4..28, so a pair is at
// most 7 bytes), each less the column's lower bound off:
//
//   out[j]        = (pair_j        & mask) + off
//   out[j + half] = (pair_j >> w4  & mask) + off,   mask = 2^w4 - 1
//
// written in the column's storage type (int8/uint8/int16/int32/int64).
// Bound on the card: bytes (half * bpp read once, cap * itemsize written
// once).  A first version: one thread a pair in a grid-stride loop; a
// warp's pairs are 32 * bpp consecutive bytes, so its byte loads fall in
// a few sectors; the two stores of a warp are each coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_unpack_pairs(const unsigned char* __restrict__ data, long long half,
                   int bpp, int w4, long long off, T* __restrict__ out) {
  const u64 mask = (1ull << w4) - 1ull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < half; j += stride) {
    const unsigned char* p = data + j * bpp;
    u64 pair = 0;
    for (int k = 0; k < bpp; ++k) pair |= (u64)__ldg(p + k) << (8 * k);
    out[j] = (T)((long long)(pair & mask) + off);
    out[j + half] = (T)((long long)((pair >> w4) & mask) + off);
  }
}

template <typename T>
int launch(const void* data, long long half, int bpp, int w4, long long off,
           void* out, int blocks, cudaStream_t st) {
  k_unpack_pairs<T><<<blocks, kThreads, 0, st>>>(
      (const unsigned char*)data, half, bpp, w4, off, (T*)out);
  return chtt_last_error();
}

}  // namespace

// data: half * bpp bytes; out: 2 * half values of ChttDtype out_dtype
// (DT_I8, DT_U8, DT_I16, DT_I32 or DT_I64).
extern "C" int chtt_unpack_pairs(const void* data, long long half, int bpp,
                                 int w4, long long off, int out_dtype,
                                 void* out, int blocks, void* stream) {
  if (half < 0 || w4 < 4 || w4 > 28 || (w4 & 3) || bpp != w4 / 4 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (half == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (out_dtype) {
    case DT_I8: return launch<signed char>(data, half, bpp, w4, off, out,
                                           blocks, st);
    case DT_U8: return launch<unsigned char>(data, half, bpp, w4, off, out,
                                             blocks, st);
    case DT_I16: return launch<short>(data, half, bpp, w4, off, out, blocks,
                                      st);
    case DT_I32: return launch<int>(data, half, bpp, w4, off, out, blocks,
                                    st);
    case DT_I64: return launch<long long>(data, half, bpp, w4, off, out,
                                          blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
