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
// Bound on the card: bytes (every column read or written once, the matrix
// written or read once, and the row index).  The first version moved a
// byte a thread through shared memory with an integer division a byte (a
// CALL in the SASS): 2.5011 ms to unpack Qm3's 100M 16-byte rows, bound
// 0.9552, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// Two paths, both with no division in a loop of theirs.
//
// Tiles (every launch without an index).  A block takes a tile of T rows
// (T * B <= kTileBytes) through shared memory, where the tile's packed
// bytes lie at the same address mod 16 as in global memory: the packed
// side moves aligned 16-byte vectors straight between the two.  A thread
// moves a column element (the largest of 8, 4, 2, 1 bytes that divides
// cb_c and the column's address, and no wider than the rows keep aligned
// in the tile where that is 4 bytes or more), consecutive threads
// consecutive elements of the column's T * cb_c contiguous bytes, so both
// global sides move whole 32-byte sectors; the element's row comes from a
// division by cb_c / esize fixed for the launch (a multiply-high and a
// shift).  An element at an address of its own alignment in the tile
// moves as one access, else a byte at a time (B = 9: the int64 at byte 1
// of the row).  A launch of fewer full tiles than the card holds cuts T.
//
// Word path (dst_rows, src_rows: FINAL's pack at the kept rows, an
// unpack of chosen rows).  The wrapper picks the word width W: the
// largest of 16, 8, 4, 2 and 1 that divides B, every cb_c and the address
// of every base pointer (ops/state_ops.py k19_plan).  A row is then K = B
// / W words, and column c's row is cw_c = cb_c / W of them.  The grid's
// active threads are a multiple of K, so each thread keeps one word
// position j of the row (its column c and word j - first_c in the
// column's row, found once) for its whole loop: the row index, a W-byte
// load and a W-byte store a row, stepping a fixed number of rows, with no
// shared memory.  The grid is sized to the work, so a few kept rows are
// one short launch.
//
// Why tiles without an index: at 3.2 GB of every layout the tiles took
// 1.11-1.43 ms (shares 0.67-0.86) and the word path 1.13-1.61 to pack
// and 1.13-5.17 to unpack: where a warp's 32 words split a column's
// sectors (K = 3, 5, 9: B = 12, 20, 24, 36, 40) its unpack stores partial
// sectors, at 0.18-0.38 of the bound; where they do not (B = 4, 16,
// 4,096) the tiles were still 2-7 % faster (PERF.md, chip_smoke.py
// --states, which times both paths at each layout).
#include "common.cuh"

// The tile path's tile (dynamic shared memory), addressed by 32-bit
// offsets.
extern __shared__ __align__(16) unsigned char k19_tile[];

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;
constexpr int kTileBytes = 32768;
constexpr int kUnroll = 4;      // rows a thread has in flight (word path)

template <int W> struct WordOf;
template <> struct WordOf<1> { typedef unsigned char T; };
template <> struct WordOf<2> { typedef unsigned short T; };
template <> struct WordOf<4> { typedef unsigned int T; };
template <> struct WordOf<8> { typedef unsigned long long T; };
template <> struct WordOf<16> { typedef uint4 T; };

// One launch of the word path.
struct WordArgs {
  unsigned char* col[kMaxCols];
  int cw[kMaxCols];        // words a row of column c
  int first[kMaxCols];     // its first word in the packed row
  int K;                   // words a packed row
  unsigned char* packed;
  const long long* rows;   // dst_rows (pack) or src_rows (unpack), or null
  long long n;             // column rows
  int active;              // threads that move words: a multiple of K
  unsigned k_mul;          // t / K = (umulhi(t, k_mul) + t) >> k_shr
  int k_shr;
  long long step;          // rows a step of the grid: active / K
};

// Division by d fixed for the launch, exact for i < 2^31 (the form of
// CUTLASS's FastDivmod).
void fast_div(unsigned d, unsigned* mul, int* shr) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  *mul = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  *shr = l;
}

__device__ __forceinline__ int div_by(int i, unsigned mul, int shr) {
  return (int)((__umulhi((unsigned)i, mul) + (unsigned)i) >> shr);
}

template <int W, bool kPack>
__global__ void __launch_bounds__(kThreads) k_state_words(WordArgs a) {
  typedef typename WordOf<W>::T Word;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.active) return;
  const int r0 = div_by(t, a.k_mul, a.k_shr);
  const int j = t - r0 * a.K;            // once a thread: its word position
  const long long step = a.step;
  int c = 0;
  while (j >= a.first[c] + a.cw[c]) ++c;
  Word* col = reinterpret_cast<Word*>(a.col[c]) + (j - a.first[c]);
  Word* packed = reinterpret_cast<Word*>(a.packed) + j;
  const long long cw = a.cw[c], K = a.K;
  const long long* __restrict__ rows = a.rows;
  for (long long r = r0; r < a.n; r += kUnroll * step) {
    Word v[kUnroll];
    long long pr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      if (ru < a.n) {
        pr[u] = rows != nullptr ? __ldg(rows + ru) : ru;
        v[u] = kPack ? col[ru * cw] : packed[pr[u] * K];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      if (ru < a.n) {
        if (kPack)
          packed[pr[u] * K] = v[u];
        else
          col[ru * cw] = v[u];
      }
    }
  }
}

// The tile path's columns.
struct Cols {
  unsigned char* ptr[kMaxCols];
  int cb[kMaxCols];        // bytes of a row of the column
  int off[kMaxCols];       // its offset in the packed row
  int esize[kMaxCols];     // bytes of the elements it moves in
  int per_row[kMaxCols];   // elements a row: cb / esize
  unsigned mul[kMaxCols];  // i / per_row = (umulhi(i, mul) + i) >> shr
  int shr[kMaxCols];
  int n;
};

// An element of E at tile offset a, which may be off E's alignment.
template <typename E>
__device__ __forceinline__ void put(int a, E v) {
  if (sizeof(E) == 1 || (a & (sizeof(E) - 1)) == 0) {
    *reinterpret_cast<E*>(k19_tile + a) = v;
  } else {
#pragma unroll
    for (int b = 0; b < (int)sizeof(E); ++b)
      k19_tile[a + b] = (unsigned char)(v >> (8 * b));
  }
}

template <typename E>
__device__ __forceinline__ E get(int a) {
  if (sizeof(E) == 1 || (a & (sizeof(E) - 1)) == 0)
    return *reinterpret_cast<const E*>(k19_tile + a);
  E v = 0;
#pragma unroll
  for (int b = 0; b < (int)sizeof(E); ++b) v |= (E)k19_tile[a + b] << (8 * b);
  return v;
}

// g[0, len) <-> tile[s, s + len), g and s equal mod 16: aligned 16-byte
// accesses between a byte head and tail.
template <bool kToShared>
__device__ __forceinline__ void move_packed(unsigned char* g, int s,
                                            int len) {
  const int head = min(len, (int)((16 - ((uintptr_t)g & 15)) & 15));
  const int vecs = (len - head) >> 4;
  const int tail0 = head + (vecs << 4);
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  uint4* sv = reinterpret_cast<uint4*>(k19_tile + s + head);
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    if (kToShared) sv[v] = gv[v]; else gv[v] = sv[v];
  }
  // the bytes before the first and after the last vector
  for (int m = threadIdx.x; m < head + len - tail0; m += kThreads) {
    const int i = m < head ? m : tail0 + (m - head);
    if (kToShared) k19_tile[s + i] = g[i]; else g[i] = k19_tile[s + i];
  }
}

// Column c's part of a tile: its ne elements of E at g (rows of per_row
// elements) <-> element k of row r at tile offset s + r * B + k * E.
// Consecutive threads take consecutive elements, so the global side
// coalesces; each element's row comes from a division fixed for the
// launch.
template <typename E, bool kToShared>
__device__ __forceinline__ void move_column(unsigned char* g, int s, int ne,
                                            int per_row, unsigned mul,
                                            int shr, int B) {
  E* ge = reinterpret_cast<E*>(g);
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    const int r = div_by(i, mul, shr), k = i - r * per_row;
    const int a = s + r * B + k * (int)sizeof(E);
    if (kToShared) put<E>(a, ge[i]); else ge[i] = get<E>(a);
  }
}

// Column c's part of a tile at its element size es (8, 4, 2 or 1).
template <bool kToShared>
__device__ __forceinline__ void move_column_of(unsigned char* g, int s,
                                               int ne, int per_row,
                                               unsigned mul, int shr, int B,
                                               int es) {
  switch (es) {
    case 8:
      move_column<unsigned long long, kToShared>(g, s, ne, per_row, mul,
                                                 shr, B);
      break;
    case 4:
      move_column<unsigned, kToShared>(g, s, ne, per_row, mul, shr, B);
      break;
    case 2:
      move_column<unsigned short, kToShared>(g, s, ne, per_row, mul, shr, B);
      break;
    default:
      move_column<unsigned char, kToShared>(g, s, ne, per_row, mul, shr, B);
  }
}

template <bool kPack>
__global__ void __launch_bounds__(kThreads)
    k_state_tile(Cols cols, unsigned char* packed, long long n,
                 long long tiles, int B, int T) {
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * T;
    const int nr = (int)min((long long)T, n - r0);
    unsigned char* g = packed + r0 * B;
    const int s = (int)((uintptr_t)g & 15);
    if (!kPack) {
      move_packed<true>(g, s, nr * B);
      __syncthreads();
    }
    // the columns read from the kernel's parameters directly (a reference
    // to them would copy them to local memory)
    for (int c = 0; c < cols.n; ++c)
      move_column_of<kPack>(cols.ptr[c] + r0 * cols.cb[c], s + cols.off[c],
                            nr * cols.per_row[c], cols.per_row[c],
                            cols.mul[c], cols.shr[c], B, cols.esize[c]);
    if (kPack) {
      __syncthreads();
      move_packed<false>(g, s, nr * B);
    }
    __syncthreads();
  }
}

bool aligned(const void* p, int w) { return ((uintptr_t)p & (w - 1)) == 0; }

// Blocks of a launch: `want`, at most as many as the card holds at once.
int grid(const void* kernel, int smem, long long want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(want < 1 ? 1 : want < most ? want : most);
  return 0;
}

template <int W, bool kPack>
int launch_words(WordArgs& a, cudaStream_t s) {
  auto* kernel = k_state_words<W, kPack>;
  // a thread a (row, word) up to the card's resident threads, and at
  // least K threads
  const long long need = (a.n * a.K + kThreads - 1) / kThreads;
  const long long least = (a.K + kThreads - 1) / kThreads;
  int blocks = 0;
  const int e = grid((const void*)kernel, 0, need > least ? need : least,
                     &blocks);
  if (e) return e;
  a.active = blocks * kThreads / a.K * a.K;
  a.step = a.active / a.K;
  fast_div((unsigned)a.K, &a.k_mul, &a.k_shr);
  kernel<<<blocks, kThreads, 0, s>>>(a);
  return chtt_last_error();
}

template <bool kPack>
int launch_word_width(WordArgs& a, int w, cudaStream_t s) {
  switch (w) {
    case 16: return launch_words<16, kPack>(a, s);
    case 8: return launch_words<8, kPack>(a, s);
    case 4: return launch_words<4, kPack>(a, s);
    case 2: return launch_words<2, kPack>(a, s);
    default: return launch_words<1, kPack>(a, s);
  }
}

template <bool kPack>
int launch_tile(Cols& c, unsigned char* packed, long long n, int B,
                cudaStream_t s) {
  auto* kernel = k_state_tile<kPack>;
  const int full = kTileBytes / B;
  int most = 0;
  const int e = grid((const void*)kernel, full * B + 16, 1LL << 40, &most);
  if (e) return e;
  // a tile of T rows a block; a launch of fewer full tiles than the card
  // holds at once cuts T so that its tiles fill the card
  const long long fill = (n + most - 1) / most;
  const int T = (int)(fill < full ? fill : full);
  const long long tiles = (n + T - 1) / T;
  const int blocks = (int)(tiles < most ? tiles : most);
  kernel<<<blocks, kThreads, T * B + 16, s>>>(c, packed, n, tiles, B, T);
  return chtt_last_error();
}

// Checks a launch's layout against w and fills both paths' arguments.
int plan(void* const* ptrs, const int* cb, int ncols, long long n, int B,
         int w, const void* packed, WordArgs* a, Cols* c) {
  if (n < 0 || ncols < 1 || ncols > kMaxCols || B < 1 || B > kTileBytes ||
      (w != 1 && w != 2 && w != 4 && w != 8 && w != 16) || B % w ||
      !aligned(packed, w))
    return -1;
  int off = 0;
  for (int i = 0; i < ncols; ++i) {
    if (cb[i] < 1 || cb[i] % w || !aligned(ptrs[i], w)) return -1;
    a->col[i] = (unsigned char*)ptrs[i];
    a->cw[i] = cb[i] / w;
    a->first[i] = off / w;
    // the column's element (its width, as its address allows); where
    // the tile's rows keep a word of 4 or more aligned, no wider than it
    int es = 8, sa = 8;
    while (cb[i] % es || !aligned(ptrs[i], es)) es >>= 1;
    while (B % sa || off % sa || !aligned(packed, sa)) sa >>= 1;
    if (sa >= 4 && sa < es) es = sa;
    c->ptr[i] = (unsigned char*)ptrs[i];
    c->cb[i] = cb[i];
    c->off[i] = off;
    c->esize[i] = es;
    c->per_row[i] = cb[i] / es;
    fast_div((unsigned)(cb[i] / es), &c->mul[i], &c->shr[i]);
    off += cb[i];
  }
  if (off != B) return -1;
  c->n = ncols;
  a->K = B / w;
  a->packed = (unsigned char*)packed;
  a->n = n;
  return 0;
}

}  // namespace

// Rows of a tile of B-byte rows (what one block of the tile path moves
// through shared memory at a time).
extern "C" int chtt_state_tile_rows(int B) {
  return B < 1 || B > kTileBytes ? 0 : kTileBytes / B;
}

// pack: cols[i] holds n rows of cb[i] bytes; out is (rows, B) bytes, B the
// sum of cb; row g goes to out row g, or to dst_rows[g] (int64) if given.
// w: the word width (it divides B, every cb and every pointer's address);
// tile: through shared-memory tiles, else the word path (an index always
// takes the word path).
extern "C" int chtt_state_pack(void* const* cols, const int* cb, int ncols,
                               long long n, int B, int w, int tile,
                               const void* dst_rows, void* out,
                               void* stream) {
  WordArgs a;
  Cols c;
  if (plan(cols, cb, ncols, n, B, w, out, &a, &c) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  a.rows = (const long long*)dst_rows;
  if (dst_rows != nullptr || !tile)
    return launch_word_width<true>(a, w, (cudaStream_t)stream);
  return launch_tile<true>(c, (unsigned char*)out, n, B,
                           (cudaStream_t)stream);
}

// unpack: in is (rows, B) bytes; cols[i] gets n rows of cb[i] bytes, row i
// from in row i, or from src_rows[i] (int64) if given; w, tile as for pack.
extern "C" int chtt_state_unpack(const void* in, long long n, int B, int w,
                                 int tile, const void* src_rows,
                                 void* const* cols,
                                 const int* cb, int ncols, void* stream) {
  WordArgs a;
  Cols c;
  if (plan(cols, cb, ncols, n, B, w, in, &a, &c) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  a.rows = (const long long*)src_rows;
  if (src_rows != nullptr || !tile)
    return launch_word_width<false>(a, w, (cudaStream_t)stream);
  return launch_tile<false>(c, (unsigned char*)in, n, B,
                            (cudaStream_t)stream);
}
