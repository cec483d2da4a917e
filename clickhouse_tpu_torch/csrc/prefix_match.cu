// K10: a prefix or suffix match over a string dictionary's bytes, one
// answer a dictionary value.
//
// Replaces _device_prefix_lut (clickhouse_tpu/exprs/functions.py:611-632),
// which compares the first p columns of a (U, 64) byte matrix (each value
// truncated to 64 bytes, reversed for a suffix) with the needle in XLA.
// Here the values are kept as ClickHouse's ColumnString keeps them: one
// chars buffer of the UTF-8 bytes back to back and U + 1 offsets, nothing
// truncated; a suffix is compared where it lies, at the value's end.
//
//   out[u] = (len(u) >= p and bytes(u)[0:p] == needle) XOR negate
//   (with suffix, the last p bytes; p = 0 matches every value)
//
// Bound on the card: bytes.  Each value's two offsets are read once, the
// bytes it compares (the first or last p, fewer where a byte differs) and
// one output byte a value written once; for a short value the compared
// bytes of neighbouring values share 32-byte sectors, so a prefix of 21
// bytes over values of about 28 (Q7b) reads every sector of the chars.
// Design (a first version, right before fast):
//   * one thread a value, a grid-stride loop; a warp's values lie side by
//     side in the chars, so its byte loads fall into a few lines that the
//     L1 keeps while the warp walks its p bytes (read-only path);
//   * the needle is staged in shared memory (up to kStage bytes; a longer
//     needle's rest is read through the read-only path) and may be longer
//     than any value: a value shorter than p is 0 without a byte read;
//   * a value's compare stops at its first differing byte;
//   * offsets int32 while the chars fit in 2^31 bytes, else int64 (a
//     template parameter); no launch for U = 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 16384;         // needle bytes kept in shared memory

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    k_prefix_match(const unsigned char* __restrict__ chars,
                   const Off* __restrict__ offsets, long long n_values,
                   const unsigned char* __restrict__ needle, int p,
                   int suffix, int negate, unsigned char* __restrict__ out) {
  extern __shared__ unsigned char s_needle[];
  const int staged = p < kStage ? p : kStage;
  for (int j = threadIdx.x; j < staged; j += blockDim.x)
    s_needle[j] = needle[j];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < n_values; u += stride) {
    const long long a = (long long)__ldg(offsets + u);
    const long long b = (long long)__ldg(offsets + u + 1);
    bool hit = b - a >= p;
    if (hit && p > 0) {
      const unsigned char* s = chars + (suffix ? b - p : a);
      int j = 0;
      for (; j < staged; ++j)
        if (__ldg(s + j) != s_needle[j]) break;
      hit = j == staged;
      for (; hit && j < p; ++j)
        hit = __ldg(s + j) == __ldg(needle + j);
    }
    out[u] = (unsigned char)(hit != (negate != 0));
  }
}

}  // namespace

// chars: the values' bytes; offsets: U + 1 int32 (offsets64 = 0) or int64;
// needle: p bytes on the device (may be null for p = 0); out: U bytes.
extern "C" int chtt_prefix_match(const void* chars, const void* offsets,
                                 int offsets64, long long n_values,
                                 const void* needle, int p, int suffix,
                                 int negate, void* out, int blocks,
                                 void* stream) {
  if (n_values < 0 || p < 0 || blocks < 1 || (p > 0 && needle == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_values == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(p < kStage ? p : kStage);
  const unsigned char* c = (const unsigned char*)chars;
  const unsigned char* nd = (const unsigned char*)needle;
  unsigned char* o = (unsigned char*)out;
  if (offsets64)
    k_prefix_match<long long><<<blocks, kThreads, smem, st>>>(
        c, (const long long*)offsets, n_values, nd, p, suffix, negate, o);
  else
    k_prefix_match<int><<<blocks, kThreads, smem, st>>>(
        c, (const int*)offsets, n_values, nd, p, suffix, negate, o);
  return chtt_last_error();
}
