// The interleaved tile layout of the clause-mesh chunk kernels B6
// (stream_chunk.cu) and B9 (stoch_chunk.cu), and the lane mask of the lane
// tiles of B1/B2 (ode_lanes.cuh), B3/B4 (stoch_chunk.cu) and B10
// (stream_chunk.cu).
//
// A chunk's per-trajectory buffers are laid out (G, X, R): tile g holds
// trajectories g*R .. g*R+R-1, and element x of trajectory g*R+r lies at
// (g*X + x)*R + r. A CTA of kThreads threads works on one tile (grid x)
// and a span of its clauses or variables (grid y). Its threads form
// kThreads/R groups of R lanes; lane r of a group takes trajectory r, so a
// group reads one table word for R trajectories and every gather of a
// per-trajectory array moves R neighbouring words. The kernels are built
// for R = kR: 32 f32 words fill a 128-byte line. On the H100, at config 7
// of the clause mesh, R = 32 ran both kernels faster than R = 8, and CTAs
// of 128 threads faster than of 256, 512 or 1024 (PERF.md).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace tile {

constexpr int kR = 32;  // trajectories a tile
constexpr int kThreads = 128;
constexpr int kItems = 4;  // items a lane group takes, on average, from its span
constexpr unsigned kFull = 0xffffffffu;

// The grid over G tiles and the spans of an axis of n items: spans of
// about kThreads/R*kItems items.
inline dim3 grid(int G, int R, int n) {
  const int per = kThreads / R * kItems;
  const int spans = std::max(1, std::min((n + per - 1) / per, 65535));
  return dim3(static_cast<unsigned>(G), static_cast<unsigned>(spans));
}

// The lane's trajectory within its tile.
template <int R>
__device__ __forceinline__ int lane() {
  return static_cast<int>(threadIdx.x) % R;
}

// body(item) for each item of [0, n) this thread's lane group takes: the
// CTA's span is blockIdx.y's share of [0, n), walked in order, with
// neighbouring lane groups on neighbouring items.
template <int R, typename F>
__device__ __forceinline__ void for_items(int n, F&& body) {
  constexpr int groups = kThreads / R;
  const int per = (n + static_cast<int>(gridDim.y) - 1) / static_cast<int>(gridDim.y);
  const int lo = static_cast<int>(blockIdx.y) * per;
  const int hi = min(n, lo + per);
  for (int item = lo + static_cast<int>(threadIdx.x) / R; item < hi; item += groups) body(item);
}

// The R-bit mask of a warp's lanes for which `bit` holds on some lane
// group of the warp (R a power of two, at most 32; every thread of the
// warp calls it).
__device__ __forceinline__ unsigned lane_mask(bool bit, int R) {
  unsigned m = __ballot_sync(kFull, bit);
  for (int s = R; s < 32; s <<= 1) m |= m >> s;
  return R == 32 ? m : m & ((1u << R) - 1u);
}

}  // namespace tile
