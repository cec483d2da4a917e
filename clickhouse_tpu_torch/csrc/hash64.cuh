// The row hash of the engine (ops/hash_ops.py): the reference's splitmix64
// finalizer over a value's u64 bits, folded over up to kMaxHashCols columns
// by the boost-style combiner, each column read as it is stored.  Shared by
// K15 (row_hash.cu) and K16 (hll.cu).
#pragma once

#include "common.cuh"

constexpr int kMaxHashCols = 4;
#define CHTT_GOLDEN 0x9E3779B97F4A7C15ull

// hash_ops.hash64
__device__ __forceinline__ u64 chtt_hash64(u64 z) {
  z += CHTT_GOLDEN;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// hash_ops.hash_combine
__device__ __forceinline__ u64 chtt_hash_combine(u64 h, u64 x) {
  x = chtt_hash64(x);
  return chtt_hash64(h ^ (x + CHTT_GOLDEN + (h << 6) + (h >> 2)));
}

// How a column's stored values become u64 bits (hash_ops._KINDS).
enum HashKind {
  HK_INT = 0,   // the integer (Bool, code) sign- or zero-extended
  HK_F32 = 1,   // the f32 token of a Float32
  HK_F64 = 2,   // the f64 token of a Float64 (float32 storage widened)
  HK_HASH = 3,  // a hash of earlier columns (int64), first column only:
                // the fold goes on from it
};

// An intDiv/modulo term of an int8/16/32 column (scan_ops.Term).
enum HashTerm {
  HT_NONE = 0,
  HT_DIV = 1,
  HT_MOD = 2,
};

// One column of a row hash (ops/_native.HashCol).  magic, shift1 and
// shift2 divide by |c| (calendar_ops.magic(|c|, 32): m, then min(l, 1) and
// max(l - 1, 0)).  stride 0: one value for every row.
struct ChttHashCol {
  const void* data;
  int dtype;
  int kind;
  int term;
  int c;
  unsigned magic;
  int shift1;
  int shift2;
  int stride;
};

// intDiv or modulo of v by c, truncating; the remainder takes v's sign
// (the same arithmetic as K6's apply_term).  c is neither 0 nor -1.
__device__ __forceinline__ int hash_term(int v, const ChttHashCol& f) {
  const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
  const unsigned d = f.c < 0 ? 0u - (unsigned)f.c : (unsigned)f.c;
  const unsigned t = __umulhi(f.magic, a);
  const unsigned q = (t + ((a - t) >> f.shift1)) >> f.shift2;
  if (f.term == HT_DIV) return (int)(((v < 0) != (f.c < 0)) ? 0u - q : q);
  const unsigned r = a - q * d;
  return (int)(v < 0 ? 0u - r : r);
}

__device__ __forceinline__ u64 f32_token_bits(float f) {
  const unsigned b = __float_as_uint(f);
  return (u64)((b >> 31) ? ~b : (b | 0x80000000u)) << 32;
}

__device__ __forceinline__ long long int_term(int v, const ChttHashCol& c) {
  return (long long)(c.term != HT_NONE ? hash_term(v, c) : v);
}

// A read-only load: through the non-coherent cache, or (CS) marked as
// streamed (evict first), which leaves L1 to data read again.
template <bool CS, typename T>
__device__ __forceinline__ T ld_ro(const T* p) {
  return CS ? __ldcs(p) : __ldg(p);
}

// Column c's stored value at row `row`, as loaded: an integer sign- or
// zero-extended (Bool, uint8 zero), a float's bits.  DT is the column's
// storage type where the kernel is built for it (its switch folds away),
// else -1 (read c.dtype).  The loads of several rows are issued before
// any is used (hash_of).
template <int DT = -1, bool CS = false>
__device__ __forceinline__ u64 load_raw(const ChttHashCol& c, long long row) {
  const long long i = row * c.stride;
  switch (DT < 0 ? c.dtype : DT) {
    case DT_BOOL:
    case DT_U8:
      return (u64)ld_ro<CS>((const unsigned char*)c.data + i);
    case DT_I8:
      return (u64)(long long)ld_ro<CS>((const signed char*)c.data + i);
    case DT_I16:
      return (u64)(long long)ld_ro<CS>((const short*)c.data + i);
    case DT_I32:
      return (u64)(long long)ld_ro<CS>((const int*)c.data + i);
    case DT_F32:
      return (u64)__float_as_uint(ld_ro<CS>((const float*)c.data + i));
    default:  // DT_I64, DT_F64: the 8 bytes as they are
      return (u64)ld_ro<CS>((const long long*)c.data + i);
  }
}

// The value the hash takes of a loaded raw value (hash_ops._to_u64 of the
// logical value): a Bool 0/1, a term of the narrow integer, a float's
// token (a Float64 stored as float32 widened first).
template <int DT = -1>
__device__ __forceinline__ u64 hash_of(const ChttHashCol& c, u64 raw) {
  switch (DT < 0 ? c.dtype : DT) {
    case DT_BOOL:
      return (u64)(raw != 0);
    case DT_I8:
    case DT_I16:
    case DT_I32:
      return (u64)int_term((int)(long long)raw, c);
    case DT_F32: {
      const float f = __uint_as_float((unsigned)raw);
      return c.kind == HK_F64 ? f64_order_key((double)f) : f32_token_bits(f);
    }
    case DT_F64:
      return f64_order_key(__longlong_as_double((long long)raw));
    default:
      return raw;
  }
}

// The fold's start: hash64 of the first column's value, or the hash it
// holds.
__device__ __forceinline__ u64 hash_start(const ChttHashCol& c, u64 v) {
  return c.kind == HK_HASH ? v : chtt_hash64(v);
}

// hash_ops.hash_columns of the n_cols columns' raw values raw[k] of one
// row (load_row); DT0 the first column's storage type, or -1.
template <int DT0>
__device__ __forceinline__ u64 row_hash_of(const ChttHashCol* cols,
                                           int n_cols,
                                           const u64 (&raw)[kMaxHashCols]) {
  u64 h = hash_start(cols[0], hash_of<DT0>(cols[0], raw[0]));
#pragma unroll
  for (int k = 1; k < kMaxHashCols; ++k)
    if (k < n_cols) h = chtt_hash_combine(h, hash_of(cols[k], raw[k]));
  return h;
}

// The raw values of the n_cols columns at row `row` (CS: streamed loads).
template <int DT0, bool CS = false>
__device__ __forceinline__ void load_row(const ChttHashCol* cols, int n_cols,
                                         long long row,
                                         u64 (&raw)[kMaxHashCols]) {
  raw[0] = load_raw<DT0, CS>(cols[0], row);
#pragma unroll
  for (int k = 1; k < kMaxHashCols; ++k)
    raw[k] = k < n_cols ? load_raw<-1, CS>(cols[k], row) : 0;
}

// Calls f.template operator()<DT>() with the constant DT of storage type
// dt (the kernels are built for each type of their first column).
template <typename F>
inline int by_dtype(int dt, F f) {
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

// Host check of a column descriptor: a known storage type, a term over
// int8/16/32 storage only, a float kind over float storage only, a hash
// over int64 only.  (A hash as any but the first column is the caller's
// to refuse.)
inline bool hash_col_ok(const ChttHashCol& c) {
  if (c.data == nullptr || c.dtype < DT_BOOL || c.dtype > DT_F64 ||
      c.kind < HK_INT || c.kind > HK_HASH || c.term < HT_NONE ||
      c.term > HT_MOD || (c.stride != 0 && c.stride != 1))
    return false;
  if (c.term != HT_NONE &&
      (c.dtype < DT_I8 || c.dtype > DT_I32 || c.dtype == DT_U8 || c.c == 0 ||
       c.c == -1 || c.shift1 < 0 || c.shift2 < 0))
    return false;
  if (c.kind == HK_HASH) return c.dtype == DT_I64 && c.term == HT_NONE;
  const bool flt = c.dtype == DT_F32 || c.dtype == DT_F64;
  if (flt != (c.kind != HK_INT)) return false;
  return !(c.kind == HK_F32 && c.dtype != DT_F32);
}
