// K1's filter terms: `column CMP constant` over a run of 16 rows,
// evaluated in registers as 16 selection bytes (csrc/masked_reduce.cu
// reduces the rows they select; csrc/compact_rows.cu writes their
// indices).  ops/agg_ops.py _k1_term builds a term on the host.
#pragma once

#include <type_traits>

#include "common.cuh"

// how a term turns a value into the key its range is tested on
enum { TM_I32 = 0,    // narrow integer storage, signed 32-bit range test
       TM_K64 = 1,    // 64-bit integer key: bits ^ xorv
       TM_F32 = 2,    // float order key of the value rounded to float32
       TM_F64 = 3 };  // float order key of the value as float64

constexpr int kRun = 16;       // rows a thread takes at a time
constexpr int kMaxTerms = 4;

// One `column CMP constant` term (ops/agg_ops.py builds it).  A row passes
// when its key k (see the modes) satisfies ((k - lo) <= span) != neg, a
// NaN value when nan_pass, and its validity byte (if any) is non-zero.
struct ChttK1Term {
  const void* col;
  const uint8_t* valid;
  u64 lo, span, xorv;
  int dtype, mode, neg, nan_pass;
  int u64src;          // TM_F64 of UInt64 bits: convert as unsigned
  int vec, valid_vec;  // 16-byte loads allowed in the body
  int pad;
};

struct Sel {           // byte i of w[i / 4]: row i of the run selected (0/1)
  unsigned w[4];
};

__device__ __forceinline__ Sel sel_and(Sel a, const Sel& b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) a.w[j] &= b.w[j];
  return a;
}

__device__ __forceinline__ Sel first_rows(int cnt) {
  Sel s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = cnt - 4 * j;   // rows of word j inside the run
    s.w[j] = k >= 4 ? 0x01010101u
                    : k <= 0 ? 0u : (0x01010101u >> (8 * (4 - k)));
  }
  return s;
}

__device__ __forceinline__ bool sel_byte(const Sel& s, int i) {
  return (s.w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// 16 rows of a column (zero past cnt); vec: one 16-byte aligned full run
template <typename S>
__device__ __forceinline__ void load_run(const S* __restrict__ p, bool vec,
                                         int cnt, S (&v)[kRun]) {
  if (vec) {
    union {
      uint4 u[sizeof(S)];
      S s[kRun];
    } r;
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < (int)sizeof(S); ++j) r.u[j] = __ldg(q + j);
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = r.s[i];
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = i < cnt ? p[i] : (S)0;
  }
}

// bytes -> 0/1 selection bytes (non-zero selects)
__device__ __forceinline__ Sel byte_sel(const uint8_t* __restrict__ p,
                                        bool vec, int cnt) {
  Sel s;
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    s.w[0] = __vcmpne4(u.x, 0u) & 0x01010101u;
    s.w[1] = __vcmpne4(u.y, 0u) & 0x01010101u;
    s.w[2] = __vcmpne4(u.z, 0u) & 0x01010101u;
    s.w[3] = __vcmpne4(u.w, 0u) & 0x01010101u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s.w[j] = 0u;
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < cnt && p[i] != 0) s.w[i >> 2] |= 1u << (8 * (i & 3));
  }
  return s;
}

__device__ __forceinline__ bool in_range(const ChttK1Term& t, u64 key) {
  return ((key - t.lo) <= t.span) != (t.neg != 0);
}

// float order key with -0.0 read as +0.0 (they compare equal)
__device__ __forceinline__ u64 cmp_key(double d) {
  return f64_order_key(d == 0.0 ? 0.0 : d);
}

template <typename S>
__device__ __forceinline__ bool term_pass(const ChttK1Term& t, S v) {
  if constexpr (std::is_floating_point<S>::value) {
    const double d = t.mode == TM_F32 ? (double)(float)v : (double)v;
    if (d != d) return t.nan_pass != 0;
    return in_range(t, cmp_key(d));
  } else {
    const long long x = (long long)v;     // sign- or zero-extends
    if (t.mode == TM_I32) {
      const unsigned k = (unsigned)(int)x - (unsigned)t.lo;
      return (k <= (unsigned)t.span) != (t.neg != 0);
    }
    if (t.mode == TM_K64) return in_range(t, (u64)x ^ t.xorv);
    if (t.mode == TM_F32) return in_range(t, cmp_key((double)(float)x));
    // UInt64 bits convert as unsigned, rounded once
    const double d = t.u64src ? __ull2double_rn((u64)x) : (double)x;
    return in_range(t, cmp_key(d));
  }
}

template <typename S>
__device__ __forceinline__ Sel term_run(const ChttK1Term& t, long long start,
                                        int cnt, bool body) {
  S v[kRun];
  load_run<S>(static_cast<const S*>(t.col) + start, body && t.vec, cnt, v);
  Sel s;
#pragma unroll
  for (int j = 0; j < 4; ++j) s.w[j] = 0u;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    s.w[i >> 2] |= (unsigned)term_pass<S>(t, v[i]) << (8 * (i & 3));
  return s;
}

__device__ __forceinline__ Sel term_sel_in(const ChttK1Term* t,
                                           long long start, int cnt,
                                           bool body) {
  Sel s;
  switch (t->dtype) {
    case DT_I8: s = term_run<int8_t>(*t, start, cnt, body); break;
    case DT_I16: s = term_run<int16_t>(*t, start, cnt, body); break;
    case DT_I32: s = term_run<int32_t>(*t, start, cnt, body); break;
    case DT_I64: s = term_run<long long>(*t, start, cnt, body); break;
    case DT_F32: s = term_run<float>(*t, start, cnt, body); break;
    case DT_F64: s = term_run<double>(*t, start, cnt, body); break;
    default: s = term_run<uint8_t>(*t, start, cnt, body); break;
  }
  if (t->valid != nullptr)
    s = sel_and(s, byte_sel(t->valid + start, body && t->valid_vec, cnt));
  return s;
}
