// K19: aggregate-state rows.  pack: N state columns -> one (rows, B) byte
// matrix, each column at its byte offset of the row, little-endian (an
// AggregateFunction column's value); unpack: the matrix -> the N columns.
//
// Replaces pack_state_columns / unpack_state_columns
// (clickhouse_tpu/exprs/aggregates.py:1004-1035), which XLA lowers to a
// bitcast and a concatenate (pack) and a slice and a bitcast per column
// (unpack).
//
// A state column c is a contiguous (rows, w_c) tensor of elements of 1, 2,
// 4 or 8 bytes: its row r is the cb_c = w_c * itemsize bytes at r * cb_c,
// and the row's bytes go to off_c .. off_c + cb_c - 1 of the packed row.
// Since both sides are little-endian byte strings, the kernel moves bytes
// and knows no element type.
//
// B need not be a multiple of 8 or 16 (4 for groupBitOr(UInt32), 12 for
// argMax(UInt32, Int64), 9 for maxState of a UInt8 with its presence
// count), so a packed row may start on any byte.  A block takes a tile of
// T rows (T * B <= kTileBytes of shared memory) and moves every region it
// reads or writes contiguously in global memory: the tile's T * cb_c
// bytes of each column and the tile's T * B bytes of the matrix, with
// aligned 16-byte accesses and a byte head and tail; the reshuffle
// between the column layout and the row layout happens in shared memory.
// With dst_rows (pack) input row g goes to packed row dst_rows[g]; with
// src_rows (unpack) output row i comes from packed row src_rows[i]: those
// rows are moved a byte a thread, a row's bytes by consecutive threads.
// Bound on the card: bytes (every column read or written once, the
// matrix written or read once, and the row index).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;
constexpr int kTileBytes = 32768;

struct Cols {
  unsigned char* ptr[kMaxCols];
  int cb[kMaxCols];    // bytes of a row of the column
  int off[kMaxCols];   // its offset in the packed row
  int n;
};

// For i in [0, len): put(i, g[i]), reading g with aligned 16-byte loads
// between a byte head and tail.
template <typename Put>
__device__ __forceinline__ void load_region(const unsigned char* g,
                                            int len, Put put) {
  const int head = min(len, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int vecs = (len - head) >> 4;
  const int tail0 = head + (vecs << 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x) put(i, g[i]);
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint4 x = __ldg(gv + v);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&x);
    const int at = head + (v << 4);
#pragma unroll
    for (int k = 0; k < 16; ++k) put(at + k, b[k]);
  }
  for (int i = tail0 + threadIdx.x; i < len; i += blockDim.x) put(i, g[i]);
}

// For i in [0, len): g[i] = get(i), with aligned 16-byte stores between a
// byte head and tail.
template <typename Get>
__device__ __forceinline__ void store_region(unsigned char* g, int len,
                                             Get get) {
  const int head = min(len, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int vecs = (len - head) >> 4;
  const int tail0 = head + (vecs << 4);
  for (int i = threadIdx.x; i < head; i += blockDim.x) g[i] = get(i);
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    uint4 x;
    unsigned char* b = reinterpret_cast<unsigned char*>(&x);
    const int at = head + (v << 4);
#pragma unroll
    for (int k = 0; k < 16; ++k) b[k] = get(at + k);
    gv[v] = x;
  }
  for (int i = tail0 + threadIdx.x; i < len; i += blockDim.x) g[i] = get(i);
}

__global__ void __launch_bounds__(kThreads)
    k_state_pack(Cols cols, long long n, int B, int T,
                 const long long* __restrict__ dst_rows,
                 unsigned char* __restrict__ out) {
  extern __shared__ unsigned char tile[];
  const long long tiles = (n + T - 1) / T;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * T;
    const int nr = (int)min((long long)T, n - r0);
    for (int c = 0; c < cols.n; ++c) {
      const int cb = cols.cb[c], off = cols.off[c];
      load_region(cols.ptr[c] + r0 * cb, nr * cb,
                  [&](int i, unsigned char b) {
                    const int r = i / cb;
                    tile[r * B + off + (i - r * cb)] = b;
                  });
    }
    __syncthreads();
    if (dst_rows == nullptr) {
      store_region(out + r0 * B, nr * B, [&](int i) { return tile[i]; });
    } else {
      for (int i = threadIdx.x; i < nr * B; i += blockDim.x) {
        const int r = i / B;
        out[__ldg(dst_rows + r0 + r) * B + (i - r * B)] = tile[i];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    k_state_unpack(const unsigned char* __restrict__ in, long long n, int B,
                   int T, const long long* __restrict__ src_rows,
                   Cols cols) {
  extern __shared__ unsigned char tile[];
  const long long tiles = (n + T - 1) / T;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * T;
    const int nr = (int)min((long long)T, n - r0);
    if (src_rows == nullptr) {
      load_region(in + r0 * B, nr * B,
                  [&](int i, unsigned char b) { tile[i] = b; });
    } else {
      for (int i = threadIdx.x; i < nr * B; i += blockDim.x) {
        const int r = i / B;
        tile[i] = __ldg(in + __ldg(src_rows + r0 + r) * B + (i - r * B));
      }
    }
    __syncthreads();
    for (int c = 0; c < cols.n; ++c) {
      const int cb = cols.cb[c], off = cols.off[c];
      store_region(cols.ptr[c] + r0 * cb, nr * cb, [&](int i) {
        const int r = i / cb;
        return tile[r * B + off + (i - r * cb)];
      });
    }
    __syncthreads();
  }
}

int fill_cols(Cols* c, void* const* ptrs, const int* cb, int ncols, int B) {
  if (ncols < 1 || ncols > kMaxCols) return -1;
  int off = 0;
  for (int i = 0; i < ncols; ++i) {
    if (cb[i] < 1) return -1;
    c->ptr[i] = (unsigned char*)ptrs[i];
    c->cb[i] = cb[i];
    c->off[i] = off;
    off += cb[i];
  }
  c->n = ncols;
  return off == B ? 0 : -1;
}

}  // namespace

// Rows a tile of a B-byte row (what one block moves through shared memory
// at a time).
extern "C" int chtt_state_tile_rows(int B) {
  if (B < 1 || B > kTileBytes) return 0;
  return min(1024, kTileBytes / B);
}

// pack: cols[i] holds n rows of cb[i] bytes; out is (rows, B) bytes, B the
// sum of cb; row g goes to out row g, or to dst_rows[g] (int64) if given.
extern "C" int chtt_state_pack(void* const* cols, const int* cb, int ncols,
                               long long n, int B, const void* dst_rows,
                               void* out, int blocks, void* stream) {
  Cols c;
  if (n < 0 || blocks < 1 || fill_cols(&c, cols, cb, ncols, B) != 0 ||
      chtt_state_tile_rows(B) < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int T = chtt_state_tile_rows(B);
  k_state_pack<<<blocks, kThreads, T * B, (cudaStream_t)stream>>>(
      c, n, B, T, (const long long*)dst_rows, (unsigned char*)out);
  return chtt_last_error();
}

// unpack: in is (rows, B) bytes; cols[i] gets n rows of cb[i] bytes, row i
// from in row i, or from src_rows[i] (int64) if given.
extern "C" int chtt_state_unpack(const void* in, long long n, int B,
                                 const void* src_rows, void* const* cols,
                                 const int* cb, int ncols, int blocks,
                                 void* stream) {
  Cols c;
  if (n < 0 || blocks < 1 || fill_cols(&c, cols, cb, ncols, B) != 0 ||
      chtt_state_tile_rows(B) < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int T = chtt_state_tile_rows(B);
  k_state_unpack<<<blocks, kThreads, T * B, (cudaStream_t)stream>>>(
      (const unsigned char*)in, n, B, T, (const long long*)src_rows, c);
  return chtt_last_error();
}
