// K11: brute-force vector distances, one float32 distance a row of an
// Array(Float32) column to one query vector.
//
// Replaces _mxu_dist_parts (clickhouse_tpu/exprs/functions_ext.py:2204)
// and the `mxu` forms of its distances (:2269-2287), which XLA runs as
// three float32 products over the padded (cap, W) matrix: a @ q,
// (a * a) @ 1 (the matrix read twice, and an a * a temporary unless XLA
// fuses it) and the length-masked |q|^2, then the distance.  Here the
// three parts and the distance are one pass:
//
//   dot_i = sum_j A_ij q_j,  a2_i = sum_j A_ij^2,  b2_i = sum_{j<len_i} q_j^2
//   cosine     1 - dot / max(sqrt(a2) sqrt(b2), FLT_MIN)
//   L2         sqrt(max(a2 - 2 dot + b2, 0))
//   L2Squared  max(a2 - 2 dot + b2, 0)
//   dot        dot
//
// (A is zero past each row's length, so dot and a2 need no mask.)  Rows
// at and past n get the value of a zero row of length 0 (1 for cosine, 0
// otherwise) without a read.
//
// Bound on the card: bytes.  Each byte of A is read once (n * W * 4), the
// lengths (n * 4) and the output (cap * 4) once; at W = 128 a row is 512
// bytes.  Design:
//   * a warp takes kRows = 4 consecutive rows a step of a grid-stride
//     loop; a lane loads one float4 of each row (W = 128: one step, the
//     warp's loads four 512-byte runs back to back) and lane r the length
//     of row r, all before any sum, so five loads a lane are in flight
//     (a first version took a row a step and read its length after the
//     sums: two waits a row, one after the other); loads are marked
//     streaming (__ldcs: read once);
//   * q and the prefix sums of q^2 (sequential float32 adds, as a
//     cumulative sum) sit in shared memory, built by each block;
//   * dot and a2 are summed by warp shuffles; lane 0 reads the row's
//     length, applies the formula (no contraction into FMA, as the
//     reference's separate float32 operations) and writes the result.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;              // rows a warp takes a step
constexpr int kMaxWidth = 4096;       // q and its prefix: 32 KB of shared
                                      // (K11_MAX_WIDTH of ops/_native.py)

enum ChttDistanceOp { OP_COSINE = 0, OP_L2 = 1, OP_L2SQ = 2, OP_DOT = 3 };

__device__ __forceinline__ float finish(int op, float dot, float a2,
                                        float b2) {
  if (op == OP_DOT) return dot;
  if (op == OP_COSINE) {
    float den = __fmul_rn(__fsqrt_rn(a2), __fsqrt_rn(b2));
    den = den < FLT_MIN ? FLT_MIN : den;        // a NaN stays NaN
    return __fsub_rn(1.0f, __fdiv_rn(dot, den));
  }
  float v = __fadd_rn(__fsub_rn(a2, __fmul_rn(2.0f, dot)), b2);
  v = v < 0.0f ? 0.0f : v;
  return op == OP_L2 ? __fsqrt_rn(v) : v;
}

// A warp takes kRows consecutive rows a step: each lane starts the load of
// its float4 of every row, and lane r of row r's length, before any sum,
// so a lane has kRows + 1 loads in flight.
__global__ void __launch_bounds__(kThreads)
    k_vector_distance(const float4* __restrict__ A,
                      const int* __restrict__ lengths,
                      const float* __restrict__ q, long long n,
                      long long cap, int w, int op,
                      float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);   // w floats
  float* s_prefix = s_q + w;                      // w + 1: sum_{i<j} q_i^2
  for (int j = threadIdx.x; j < w; j += blockDim.x) s_q[j] = q[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    s_prefix[0] = 0.0f;
    for (int j = 0; j < w; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(s_q[j], s_q[j]));
      s_prefix[j + 1] = acc;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int w4 = w >> 2;
  const float zero_row = op == OP_COSINE ? 1.0f : 0.0f;
  // row0 is the same for every lane of a warp, so every lane reaches the
  // shuffles
  for (long long row0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x)
                         >> 5) * kRows;
       row0 < cap; row0 += warps * kRows) {
    const long long mine = row0 + lane;           // lane r < kRows: row0 + r
    if (row0 >= n) {
      if (lane < kRows && mine < cap) out[mine] = zero_row;
      continue;
    }
    int len = 0;
    if (lane < kRows && mine < n) len = __ldcs(lengths + mine);
    const float4* a = A + row0 * w4;
    float dot[kRows], a2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dot[r] = a2[r] = 0.0f;
    for (int j = lane; j < w4; j += 32) {
      float4 x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        x[r] = row0 + r < n ? __ldcs(a + (long long)r * w4 + j)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 y = smem4[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        dot[r] = fmaf(x[r].x, y.x, dot[r]);
        dot[r] = fmaf(x[r].y, y.y, dot[r]);
        dot[r] = fmaf(x[r].z, y.z, dot[r]);
        dot[r] = fmaf(x[r].w, y.w, dot[r]);
        a2[r] = fmaf(x[r].x, x[r].x, a2[r]);
        a2[r] = fmaf(x[r].y, x[r].y, a2[r]);
        a2[r] = fmaf(x[r].z, x[r].z, a2[r]);
        a2[r] = fmaf(x[r].w, x[r].w, a2[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
        a2[r] += __shfl_xor_sync(0xffffffffu, a2[r], o);
      }
    }
    if (lane < kRows && mine < cap) {
      float d = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r == lane) {
          d = dot[r];
          s2 = a2[r];
        }
      len = len < 0 ? 0 : (len > w ? w : len);
      out[mine] = mine < n ? finish(op, d, s2, s_prefix[len]) : zero_row;
    }
  }
}

}  // namespace

// A: cap x w float32 rows (w a multiple of 8, 16-byte aligned); lengths:
// cap int32; q: w float32; out: cap float32.  Rows >= n are not read.
extern "C" int chtt_vector_distance(const void* A, const void* lengths,
                                    const void* q, long long n,
                                    long long cap, int w, int op, void* out,
                                    int blocks, void* stream) {
  if (n < 0 || cap < n || w < 8 || (w & 7) || w > kMaxWidth || op < 0 ||
      op > OP_DOT || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  const size_t smem = (size_t)(2 * w + 4) * sizeof(float);
  k_vector_distance<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)A, (const int*)lengths, (const float*)q, n, cap, w, op,
      (float*)out);
  return chtt_last_error();
}
