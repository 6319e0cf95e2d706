// The butterfly's tree (B7), one definition for every kernel that combines
// a clause group's partials: bfly_kernel (butterfly.cu, the standalone
// call) and the prologues of B6 (stream_chunk.cu) and B9 (stoch_chunk.cu),
// which read the S ranks' slots themselves.
//
// The tree: the S partials of a word in rank order, paired level by level,
// (a0 + a1) at S = 2, (a0 + a1) + (a2 + a3) at S = 4, an absent partner
// skipped at an S that is not a power of two ((a0 + a1) + a2 at S = 3), the
// lower block the left operand. IEEE addition is commutative, so this is
// the order in which the TPU kernel's log2(S) rounds of partner exchanges
// (odesat_tpu/ops/butterfly.py) add, and every rank gets the same bits. A
// max zone combines by max instead: NaN if either is NaN (the canonical
// quiet NaN), else the larger, the lower rank's of two equal values.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace bfly {

constexpr int kMaxRanks = 64;

// The S partial buffers of one call, rank order: this rank's own slot and
// its peers' (IPC-mapped on a clause mesh; S = 1: the launch's own partial).
struct Parts {
  const float* p[kMaxRanks];
  int s;
};

__device__ __forceinline__ float combine(float a, float b, bool mx) {
  if (!mx) return a + b;
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? b : a;
}

// The float64 form (the standalone call only; the fused readers below take
// float32): the same rules, the canonical quiet NaN 0x7ff8000000000000.
__device__ __forceinline__ double combine(double a, double b, bool mx) {
  if (!mx) return a + b;
  if (a != a || b != b) return __longlong_as_double(0x7ff8000000000000LL);
  return a < b ? b : a;
}

// The tree over the S values of one word, in place in v (float or double).
// S > 0: the group size at compile time; S = 0: `s` at run time.
template <int S, typename T>
__device__ __forceinline__ T tree(T* v, int s, bool mx) {
  constexpr int kSlots = S > 0 ? S : kMaxRanks;
  const int n = S > 0 ? S : s;
#pragma unroll
  for (int w = 1; w < kSlots; w <<= 1) {
    if (w >= n) break;
#pragma unroll
    for (int i = 0; i + w < kSlots; i += 2 * w) {
      if (i + w >= n) break;
      v[i] = combine(v[i], v[i + w], mx);
    }
  }
  return v[0];
}

// Word k of the S partials, combined (plain loads: at S = 1 a launch may
// clear the word after reading it).
template <int S>
__device__ __forceinline__ float at(const Parts& P, size_t k, bool mx = false) {
  constexpr int kSlots = S > 0 ? S : kMaxRanks;
  float v[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (r < (S > 0 ? S : P.s)) v[r] = P.p[r][k];
  return tree<S>(v, P.s, mx);
}

// Words k .. k+3 of the S partials, summed (k a multiple of 4, every
// buffer 16-byte aligned, none written by the launch).
template <int S>
__device__ __forceinline__ float4 at4(const Parts& P, size_t k) {
  constexpr int kSlots = S > 0 ? S : kMaxRanks;
  float4 in[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (r < (S > 0 ? S : P.s)) in[r] = __ldg(reinterpret_cast<const float4*>(P.p[r] + k));
  float x[kSlots], y[kSlots], z[kSlots], w[kSlots];
#pragma unroll
  for (int r = 0; r < kSlots; ++r)
    if (r < (S > 0 ? S : P.s)) {
      x[r] = in[r].x;
      y[r] = in[r].y;
      z[r] = in[r].z;
      w[r] = in[r].w;
    }
  return make_float4(tree<S>(x, P.s, false), tree<S>(y, P.s, false), tree<S>(z, P.s, false),
                     tree<S>(w, P.s, false));
}

// Word k combined at the group size the launch was given: one word a
// trajectory (a flag, an error), where a switch costs nothing.
__device__ __forceinline__ float word(const Parts& P, size_t k, bool mx = false) {
  switch (P.s) {
    case 1: return P.p[0][k];
    case 2: return at<2>(P, k, mx);
    case 4: return at<4>(P, k, mx);
    default: return at<0>(P, k, mx);
  }
}

}  // namespace bfly
