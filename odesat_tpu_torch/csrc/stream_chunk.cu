// Large-formula ODE chunk (B2), single-step RHS (B10), one clause shard's
// RHS (B5) and the clause-sharded chunk's launches (B6) for Hopper (sm_90a).
//
// B2 (stream_chunk_launch) replaces odesat_tpu/ops/stream_pallas.py::
// make_stream_chunk; B10 (rhs_launch) replaces odesat_tpu/ops/rhs_pallas.py::
// make_pallas_rhs; B5 (shard_stream_launch) replaces odesat_tpu/ops/
// shard_stream.py::_make_shard_call; B6 (shard_chunk_launch) replaces
// odesat_tpu/ops/shard_chunk.py::make_shard_chunk_call. B10 runs a tile of
// R trajectories a CTA on the lanes of its thread groups, with the tile's
// state in shared memory (namespace rhs, below); B5 and B6 run one pass
// device code over the tile layout of tile.cuh, R trajectories a tile on
// the lanes of a thread group.
//
// B2 computes exactly what B1 (csrc/fused_chunk.cu) computes, for formulas
// whose tables and state do not fit one CTA's shared memory: it is B1's
// device code (ode_lanes.cuh) with the clause state streamed. One CTA owns
// one tile of R trajectories for the whole chunk, one a lane of each thread
// group; the tile's v window (and the adaptive half step hv) sits in shared
// memory, interleaved [i][r]; xs, xl and the per-occurrence contributions
// (and the adaptive scratch) live in a device scratch buffer, tiled [x][r],
// so every access of a group is R neighbouring words, one 128-byte line at
// R = 32. The contributions are stored in CSR order: the clause phase
// writes each slot's line at its occurrence's position, and the variable
// phase reads its list as a stream. The first step reads xs, xl from the
// row-major input and the last writes the row-major output, so the chunk
// needs no tiling pass. The tables (literal codes, the CSR position of
// each slot, the CSR pointers) are read from global memory, where every
// CTA reads the same bytes and they stay in the 50 MB L2; each word serves
// the tile's R trajectories.
//
// What bounds B2 on the card: device-memory bytes. A fixed step moves xs
// and xl (read and written) and the contributions (written and read), 4*Mp
// + 2*nnz words a trajectory; the v gathers hit shared memory. R is the
// largest power of two up to 32 whose v (and hv) window fits the CTA
// (ops/stream_chunk.py::stream_lanes): 32 at the preprocessed n=1k
// instance, 8 (4 adaptive) at the locally structured n=4096.
//
// B10 is one RHS pass, (v, xs, xl) -> (dv, dxs, dxl, allsat), in float or
// double: a tile of R trajectories a CTA, whose rows it reads and writes
// coalesced, transposing them through shared memory into the [x][r]
// layout; the clause phase and the variable phase in B1's arithmetic and
// order, the contributions in CSR order in shared memory (resident) or, for
// tiles that do not fit, in a device scratch (streamed). What bounds it:
// device-memory bytes, each a row read or a row write. R is the largest
// power of two up to 32 whose footprint fits (ops/rhs_kernel.py::rhs_plan):
// 32 at hard.cnf in float, 8 at uf250.
//
// Unit clauses (infinite gradients), float64 chunks and a batch-shared
// adaptive dt are rejected by the Python wrappers before launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// contraction into FMA, so the kernels round where their plain torch
// versions do), bound through the plain C entry points at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "bfly_tree.cuh"
#include "bulk.cuh"
#include "ode_lanes.cuh"
#include "tile.cuh"

namespace {

template <typename T>
struct K_ {
  static constexpr T alpha = T(5.0);
  static constexpr T beta = T(20.0);
  static constexpr T gamma = T(0.25);
  static constexpr T delta = T(0.05);
  static constexpr T eps = T(1e-3);
  static constexpr T xs_hi = T(0.999);  // 1 - EPSILON, rounded once as Python does
};
constexpr float kDtMin = 0.0078125f;  // 2^-7
constexpr float kDtMax = 1000.0f;

struct Tables {
  const int* lit_code;  // (K, Mp): 2*var + (negated ? 1 : 0), -1 at padding
  const int* occ_ptr;   // (Np + 1) CSR row pointers over occ_code
  const int* occ_code;  // (nnz): 2*m + negated, clause column and sign of each occurrence
  int Np, Mp, K;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // fmaxf/fminf ignore NaN like jnp.fmax/fmin and Rust's f64::max/min
  return fminf(fmaxf(x, lo), hi);
}

// fmin/fmax in the state's precision (NaN-ignoring, like B1's fminf/fmaxf)
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, bool BF16>
__device__ __forceinline__ T lit_value(T vi, int negated) {
  if constexpr (BF16) vi = round_bf16(vi);
  const T qv = negated ? -vi : vi;  // q * v, exact
  return T(1) - qv;
}

// One occurrence's signed contribution to dv: B1's clause-phase arithmetic,
// operation for operation, from the clause's m1, m2, xs, xl.
template <typename T, bool PAPER, bool BF16>
__device__ __forceinline__ T contribution(T val, T m1, T m2, T xs, T xl, T zeta, int negated) {
  const T c = T(0.5) * m1;
  const T a = T(-0.5) * (xl * xs);
  const T b = T(-0.5) * ((T(1) + zeta * xl) * (T(1) - xs));
  const T A1 = a * m1;
  const T A2 = a * m2;
  const bool is_min = val <= m1;
  T cp;
  if constexpr (PAPER) {
    cp = is_min ? (A2 + b * val) : A1;
  } else {
    const T gate = (val == c) ? T(1) : T(0);
    cp = (is_min ? A2 : A1) + b * (val * gate);
  }
  if constexpr (BF16) cp = round_bf16(cp);
  return negated ? cp : -cp;  // times -q
}

struct Scalars {
  float zeta, dt_fixed, tol, xl_cap;
};

// B5 (shard_stream_launch) replaces odesat_tpu/ops/shard_stream.py::
// _make_shard_call (:574): one clause shard's RHS, one pass a launch, for the
// `--shard-chunk off` path, whose caller all-reduces the shard's partial dv
// over the clause group between launches and runs the v update, the dt
// control and the done latch in torch. Modes (ops/shard_stream.py):
//   kRhs    out = (dv partial | 1 - sat), dxs1, dxl1 (the adaptive first
//           evaluation);
//   kFixed  out = (dv partial | 1 - sat), and the clamped Euler update of
//           xs, xl into xs2, xl2 (dt is 0 for done rows);
//   kSecond at v = hv: the half-step clause state recomputed per
//           occurrence from the first launch's dxs1, dxl1, out = the dv
//           partial there, xs2, xl2 = adv ? two half steps : unchanged,
//           and err = the shard's step-doubling error over xs and xl.
// Design: a B5 launch is B6's pass (chunk_pass_kernel, chunk_pad_kernel,
// below) over the same tile layout, R trajectories a tile on the lanes of a
// group, without B6's apply prologue and head: the step and the advance
// flag are given (pass_dt's GIVEN) instead of derived from done, the fixed
// step and the reduced sat flag; a head kernel first clears the words the
// pass publishes into (the sat flag, or the error). So each table word
// serves R trajectories, each gather moves R useful words, no clause word
// of a trajectory crosses memory (m1, m2 are recomputed per occurrence) and
// nothing of a trajectory lives in shared memory. The new clause memories
// go to the second copy xs2, xl2, since a grid over spans has no barrier
// between the variable and the clause side; the runner swaps the copies.
// What bounds it: device-memory bytes (v, xs and xl cross memory every
// step) and the L2 traffic of the occurrence gathers, as for B6.
enum ShardMode { kRhs = 0, kFixed = 1, kSecond = 2 };

// B6 (shard_chunk_launch) replaces odesat_tpu/ops/shard_chunk.py::
// make_shard_chunk_call (:158): the clause-sharded ODE chunk whose dv
// all-reduce the TPU kernel ran inside itself, over ICI remote DMA (B7,
// odesat_tpu/ops/butterfly.py), combining each partner's payload straight
// into its accumulator. On Hopper the chunk is a sequence of launches and
// the all-reduce is fused into them the same way: every kernel that reads a
// sum reads the S ranks' partials of the launch it consumes (a table of
// pointers, bfly::Parts: this rank's slot and the peers' IPC-mapped slots,
// which a stream wait on the peers' flags has made final; at S = 1 the
// rank's own partial) and adds them in the butterfly's tree as it reads
// them (bfly_tree.cuh, one definition with B7's standalone kernel), row Np
// of the second pass's partials by max. Everything else the TPU kernel did
// in VMEM runs in these launches: each applies the result of the launches
// before it (the v update, the done latch, and for the adaptive integrator
// the commit, the step-doubling error and the dt control), then runs the
// shard's next pass, writing its partials into this launch's slot (acc,
// acc2), never a slot a peer may still read (ops/butterfly.py's schedule).
// A fixed step is one launch, an adaptive step two, and a chunk of n steps
// ends with one apply-only launch.
// Phases (ops/shard_chunk.py):
//   kStep    fixed: [apply the previous step] v, done; dt_c = done ? 0 : dt;
//            the fixed pass -> acc[:Np] = dv partial, acc[Np] = 1 - sat,
//            the new xs, xl into xs2, xl2;
//   kApply   fixed: apply only;
//   kFirst   adaptive: [commit the previous step] v, dt, done; pass 1 ->
//            acc[:Np] = dv1 partial, acc[Np] = 1 - sat, dxs1, dxl1;
//   kHalf    adaptive: hv = clamp(v + (dt_c/2) dv1) from the summed dv1;
//            the second pass at hv -> acc2[:Np] = dv2 partial, acc2[Np] =
//            the shard's error (whose readers max-combine that row), xs, xl
//            committed into xs2, xl2 under the advance flag;
//   kCommit  adaptive: commit only: tv = clamp(hv + (dt_c/2) dv2), err =
//            max(err2, |clamp(v + dt_c dv1) - tv|), dt <- clip(dt *
//            sqrt(tol / max(err, 1e-30)), 2^-7, 1e3), v, dt under the advance
//            flag, done |= allsat.
// (dv1, dv2, err2 and the sat count are the sums of the S partials; err2
// their max.) `done` in device memory between launches is the done the last
// pass ran with; the next launch latches the summed sat flag.
//
// Design: the chunk's buffers are in the tile layout of tile.cuh, (G, X,
// R) with R trajectories a tile, so a lane group reads each table word
// (literal codes, CSR pointers, occurrence codes) once for R trajectories
// and each gather of v, xs, xl, dxs1 or dxl1 moves R useful words. Nothing
// of a trajectory lives in shared memory, so many CTAs share an SM. A phase
// is a short sequence of kernels on the stream, each over (tile, span):
//   apply   v from the summed dv (and dv2), over variables, four
//           trajectories a thread (16-byte reads of each partial, a warp on
//           whole 128-byte rows); adaptive: the commit's error, a max per
//           trajectory, into `errbits`;
//   head    one thread a trajectory: the done latch, the dt control, and
//           the sat flag cleared for the pass that follows;
//   hv      kHalf: the half step into a scratch tile (16-byte reads, as
//           apply);
//   pass    over variables: dv over each variable's CSR list, with each
//           occurrence's m1, m2 recomputed from v (no clause words cross
//           memory) and its xs, xl gathered (kSecond: the half-step xs, xl
//           recomputed from xs, dxs1, xl, dxl1); the clause side of the
//           pass (the sat flag; dxs1, dxl1; the clause-memory update; the
//           step-doubling error) runs at each clause's first occurrence in
//           its slot-0 variable's list and writes the new memories to a
//           second copy, xs2 and xl2, which the caller swaps with xs, xl;
//   pad     the clause side for the shard's padded clauses, which have no
//           occurrence.
// Every value is computed with the plain version's operations in its order
// (--fmad=false) and dv sums run in CSR order, so B6 equals its plain
// version and B5's path bit for bit. The only reductions across threads are
// the sat flag (stores of one value) and maxima of non-negative floats
// (integer atomicMax on their bits), both independent of order: repeats
// are bit-identical. What bounds it: device-memory bytes (v, xs and xl
// cross memory every step, and the S partials the prologue reads) and the
// L2 traffic of the occurrence gathers.
enum ChunkPhase { kStep = 0, kApply = 1, kFirst = 2, kHalf = 3, kCommit = 4 };

// The running top-2 min of clause m for lane r of a tile (B1's loop, the
// reference's scan semantics): v is the tile's (Np, R) block.
template <int R, bool BF16>
__device__ __forceinline__ bool tile_min2(const Tables& f, const float* __restrict__ v, int r,
                                          int m, float* m1o, float* m2o) {
  const int c0 = __ldg(f.lit_code + m);
  if (c0 < 0) {
    *m1o = 0.0f;
    *m2o = 0.0f;
    return false;
  }
  float m1 = lit_value<float, BF16>(__ldg(v + static_cast<size_t>(c0 >> 1) * R + r), c0 & 1);
  float m2 = __int_as_float(0x7f800000);  // +inf
  for (int k = 1; k < f.K; ++k) {
    const int ck = __ldg(f.lit_code + static_cast<size_t>(k) * f.Mp + m);
    if (ck < 0) continue;  // padding slot: +inf never changes m1, m2
    const float val = lit_value<float, BF16>(__ldg(v + static_cast<size_t>(ck >> 1) * R + r),
                                             ck & 1);
    m2 = vmin(m2, vmax(m1, val));
    m1 = vmin(m1, val);
  }
  *m1o = m1;
  *m2o = m2;
  return true;
}

// The word of trajectory r of tile g at row x of a (G, rows, R) buffer.
template <int R>
__device__ __forceinline__ size_t at(int g, int rows, int x, int r) {
  return (static_cast<size_t>(g) * rows + x) * R + r;
}

// Publish a per-trajectory max of non-negative floats: the CTA's maxima
// meet in shared memory, then one global atomicMax a trajectory.
template <int R>
__device__ __forceinline__ void publish_max(int* s_max, float e, int* out) {
  if (e != 0.0f) atomicMax(s_max + tile::lane<R>(), __float_as_int(e));
  __syncthreads();
  if (threadIdx.x < R && s_max[threadIdx.x] != 0) atomicMax(out + threadIdx.x, s_max[threadIdx.x]);
}

// The span of tile rows [lo, hi) of an axis of n rows that CTA (blockIdx.x,
// blockIdx.y) takes, walked by the 16-byte kernels below: a thread takes
// four neighbouring lanes of a row (R/4 threads a row, one 128-byte line at
// R = 32), so a warp reads whole rows of each buffer.
template <int R>
struct Quads {
  static constexpr int kPerRow = R / 4;
  static constexpr int kRows = tile::kThreads / kPerRow;  // rows a CTA takes at once
  int lo, hi, r0;
  __device__ __forceinline__ Quads(int n) {
    const int per = (n + static_cast<int>(gridDim.y) - 1) / static_cast<int>(gridDim.y);
    lo = static_cast<int>(blockIdx.y) * per;
    hi = min(n, lo + per);
    r0 = 4 * (static_cast<int>(threadIdx.x) % kPerRow);
  }
  __device__ __forceinline__ int first() const {
    return lo + static_cast<int>(threadIdx.x) / kPerRow;
  }
};

__device__ __forceinline__ float4 clamp4(float4 x) {
  return make_float4(clampf(x.x, -1.0f, 1.0f), clampf(x.y, -1.0f, 1.0f),
                     clampf(x.z, -1.0f, 1.0f), clampf(x.w, -1.0f, 1.0f));
}

// The step of each of a thread's four trajectories (lanes r0 .. r0+3 of
// tile g): 0 when done, else the fixed step or the row's dt.
template <int R, bool FIXED>
__device__ __forceinline__ float4 lane_steps(const unsigned char* __restrict__ done,
                                             const float* __restrict__ dt, float dt_fixed,
                                             int g, int r0, uchar4* d) {
  const size_t t = static_cast<size_t>(g) * R + r0;
  *d = *reinterpret_cast<const uchar4*>(done + t);
  const float4 s = FIXED ? make_float4(dt_fixed, dt_fixed, dt_fixed, dt_fixed)
                         : *reinterpret_cast<const float4*>(dt + t);
  return make_float4(d->x ? 0.0f : s.x, d->y ? 0.0f : s.y, d->z ? 0.0f : s.z,
                     d->w ? 0.0f : s.w);
}

// The apply prologue over variables, from the S ranks' partials of the
// previous launches (red: the dv sums and the sat count; red2, adaptive: the
// second pass's dv2), added in the butterfly's tree as they are read. S: 1,
// 2, 4 at compile time, 0 at run time (red.s).
template <int R, bool FIXED, int S>
__global__ void __launch_bounds__(tile::kThreads)
    chunk_apply_kernel(float* __restrict__ v, const bfly::Parts red, const bfly::Parts red2,
                       const float* __restrict__ dt, const unsigned char* __restrict__ done,
                       int* __restrict__ errbits, float dt_fixed, int Np) {
  __shared__ int s_max[R];
  const int g = blockIdx.x;
  const Quads<R> span(Np);
  const int r0 = span.r0;
  if (!FIXED && threadIdx.x < R) s_max[threadIdx.x] = 0;
  uchar4 d;
  const float4 dtc = lane_steps<R, FIXED>(done, dt, dt_fixed, g, r0, &d);
  float* vt = v + at<R>(g, Np, 0, r0);
  const size_t a1 = at<R>(g, Np + 1, 0, r0);
  if constexpr (FIXED) {
    for (int i = span.first(); i < span.hi; i += Quads<R>::kRows) {
      const size_t k = static_cast<size_t>(i) * R;
      const float4 x = *reinterpret_cast<const float4*>(vt + k);
      const float4 dv = bfly::at4<S>(red, a1 + k);
      *reinterpret_cast<float4*>(vt + k) =
          clamp4(make_float4(x.x + dtc.x * dv.x, x.y + dtc.y * dv.y, x.z + dtc.z * dv.z,
                             x.w + dtc.w * dv.w));
    }
  } else {
    const size_t flag = a1 + static_cast<size_t>(Np) * R;
    bool adv[4];  // !done and !allsat
    const unsigned char dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) adv[c] = !dd[c] && bfly::word(red, flag + c) != 0.0f;
    const float dc[4] = {dtc.x, dtc.y, dtc.z, dtc.w};
    float half[4], e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 4; ++c) half[c] = 0.5f * dc[c];
    __syncthreads();  // s_max cleared
    for (int i = span.first(); i < span.hi; i += Quads<R>::kRows) {
      const size_t k = static_cast<size_t>(i) * R;
      float4 x4 = *reinterpret_cast<const float4*>(vt + k);
      const float4 p4 = bfly::at4<S>(red, a1 + k), q4 = bfly::at4<S>(red2, a1 + k);
      float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float p[4] = {p4.x, p4.y, p4.z, p4.w}, q[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float fv = clampf(x[c] + dc[c] * p[c], -1.0f, 1.0f);
        const float hv = clampf(x[c] + half[c] * p[c], -1.0f, 1.0f);
        const float tv = clampf(hv + half[c] * q[c], -1.0f, 1.0f);
        e[c] = fmaxf(e[c], fabsf(fv - tv));
        if (adv[c]) x[c] = tv;
      }
      if (adv[0] || adv[1] || adv[2] || adv[3])
        *reinterpret_cast<float4*>(vt + k) = make_float4(x[0], x[1], x[2], x[3]);
    }
    // the per-trajectory maxima meet in shared memory, then one global
    // atomicMax a trajectory (non-negative floats order as their bits)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e[c] != 0.0f) atomicMax(s_max + r0 + c, __float_as_int(e[c]));
    __syncthreads();
    if (threadIdx.x < R && s_max[threadIdx.x] != 0)
      atomicMax(errbits + g * R + threadIdx.x, s_max[threadIdx.x]);
  }
}

// One thread a trajectory, after apply (`applied`: the done latch from the
// summed sat flag, row Np of the red partials, and for the adaptive
// integrator the dt control from the error, row Np of the red2 partials,
// which combine by max) or alone; `clear_flag` clears row Np of `acc` for the pass
// that follows. At S = 1 red's one partial may be `acc` (a group of one:
// the partial is the sum); the word is read before it is cleared.
template <bool FIXED>
__global__ void chunk_head_kernel(const bfly::Parts red, float* acc, float* __restrict__ dt,
                                  unsigned char* __restrict__ done, const bfly::Parts red2,
                                  int* __restrict__ errbits, float tol, int Np, int R, int n,
                                  int applied, int clear_flag) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t flag = (static_cast<size_t>(t / R) * (Np + 1) + Np) * R + t % R;
  if (applied) {
    const bool d = done[t] != 0;
    const bool allsat = bfly::word(red, flag) == 0.0f;
    if (!FIXED) {
      const float e = fmaxf(bfly::word(red2, flag, true), __int_as_float(errbits[t]));
      errbits[t] = 0;
      const float ratio = tol / fmaxf(e, 1e-30f);
      if (!d && !allsat) dt[t] = clampf(dt[t] * sqrtf(ratio), kDtMin, kDtMax);
    }
    done[t] = (d || allsat) ? 1 : 0;
  }
  if (clear_flag) acc[flag] = 0.0f;
}

// kHalf's half step hv = clamp(v + (dt_c/2) dv1) into a scratch tile, dv1
// from the S partials of the first pass; clears the pass's error words.
template <int R, int S>
__global__ void __launch_bounds__(tile::kThreads)
    chunk_hv_kernel(const float* __restrict__ v, const bfly::Parts red,
                    const float* __restrict__ dt, const unsigned char* __restrict__ done,
                    float* __restrict__ hv, float* __restrict__ err, size_t err_stride, int Np) {
  const int g = blockIdx.x;
  const Quads<R> span(Np);
  const int r0 = span.r0;
  uchar4 d;
  const float4 dtc = lane_steps<R, false>(done, dt, 0.0f, g, r0, &d);
  const float4 half = make_float4(0.5f * dtc.x, 0.5f * dtc.y, 0.5f * dtc.z, 0.5f * dtc.w);
  const float* vt = v + at<R>(g, Np, 0, r0);
  const size_t a1 = at<R>(g, Np + 1, 0, r0);
  float* ht = hv + at<R>(g, Np, 0, r0);
  for (int i = span.first(); i < span.hi; i += Quads<R>::kRows) {
    const size_t k = static_cast<size_t>(i) * R;
    const float4 x = *reinterpret_cast<const float4*>(vt + k);
    const float4 dv = bfly::at4<S>(red, a1 + k);
    *reinterpret_cast<float4*>(ht + k) =
        clamp4(make_float4(x.x + half.x * dv.x, x.y + half.y * dv.y, x.z + half.z * dv.z,
                           x.w + half.w * dv.w));
  }
  // the pass's error maxima start at 0
  if (blockIdx.y == 0 && threadIdx.x < R) err[g * err_stride + threadIdx.x] = 0.0f;
}

// The clause side of a pass in MODE (ShardMode) for the clause word k of
// one trajectory, from its running min m1 (`real`: the clause has a
// literal), its memories x0, l0 and, for kSecond, the first pass's d1s,
// d1l and the half-step memories hxs, hxl: kFixed writes the Euler update
// to xs_out, xl_out; kRhs writes dxs1, dxl1; kSecond writes the two half
// steps (the memories unchanged unless `adv`) to xs_out, xl_out and takes
// the step-doubling error into e. Returns whether the clause is
// unsatisfied. The plain version's arithmetic (ops/shard_stream.py), operation
// for operation.
template <int MODE>
__device__ __forceinline__ bool clause_side(bool real, float m1, float x0, float l0, float d1s,
                                            float d1l, float hxs, float hxl, size_t k, float dtc,
                                            bool adv, float* xs_out, float* xl_out, float* dxs1,
                                            float* dxl1, const Scalars& s, float& e) {
  using C = K_<float>;
  const float c = 0.5f * m1;
  float dxs = 0.0f, dxl = 0.0f;
  if (real) {
    dxs = C::beta * ((MODE == kSecond ? hxs : x0) + C::eps) * (c - C::gamma);
    dxl = C::alpha * (c - C::delta);
  }
  if constexpr (MODE == kFixed) {
    xs_out[k] = clampf(x0 + dtc * dxs, C::eps, C::xs_hi);
    xl_out[k] = clampf(l0 + dtc * dxl, 1.0f, s.xl_cap);
  } else if constexpr (MODE == kRhs) {
    dxs1[k] = dxs;
    dxl1[k] = dxl;
  } else {
    const float half = 0.5f * dtc;
    const float txs = clampf(hxs + half * dxs, C::eps, C::xs_hi);
    const float txl = clampf(hxl + half * dxl, 1.0f, s.xl_cap);
    const float fxs = clampf(x0 + dtc * d1s, C::eps, C::xs_hi);
    const float fxl = clampf(l0 + dtc * d1l, 1.0f, s.xl_cap);
    e = fmaxf(e, fmaxf(fabsf(fxs - txs), fabsf(fxl - txl)));
    xs_out[k] = adv ? txs : x0;
    xl_out[k] = adv ? txl : l0;
  }
  return real && !(c < C::gamma);
}

// The step trajectory t = g*R + r of a pass takes and, for kSecond, its
// advance flag. B6 derives both: the step is 0 when done, else the fixed
// step or dt; the flag is "not done and not all satisfied after the first
// pass" (the summed flag, row Np of the red partials). B5 (GIVEN) is
// handed both: dt, already 0 for a done row, and, in the `done` pointer,
// the advance flag.
template <int R, int MODE, bool GIVEN>
__device__ __forceinline__ float pass_dt(const unsigned char* done, const float* dt,
                                         const bfly::Parts& red, const Scalars& s, int g, int r,
                                         int Np, bool* adv) {
  const int t = g * R + r;
  if constexpr (GIVEN) {
    *adv = MODE == kSecond && done[t] != 0;
    return MODE == kRhs ? 0.0f : dt[t];
  } else {
    const bool d = done[t] != 0;
    *adv = MODE == kSecond && !d && bfly::word(red, at<R>(g, Np + 1, Np, r)) != 0.0f;
    return d ? 0.0f : (MODE == kFixed ? s.dt_fixed : (MODE == kSecond ? dt[t] : 0.0f));
  }
}

// Publish the CTA's sat flags (kFixed, kRhs: acc[Np] = 1 where a clause
// was unsatisfied) or its error maxima (kSecond) per trajectory, into the
// error words of tile g at err + g * err_stride.
template <int R, int MODE>
__device__ __forceinline__ void publish(int* s_red, int unsat, float e, float* acc, float* err,
                                        size_t err_stride, int g, int Np) {
  if constexpr (MODE == kSecond) {
    publish_max<R>(s_red, e, reinterpret_cast<int*>(err + g * err_stride));
  } else {
    if (unsat) s_red[tile::lane<R>()] = 1;
    __syncthreads();
    if (threadIdx.x < R && s_red[threadIdx.x]) acc[at<R>(g, Np + 1, Np, threadIdx.x)] = 1.0f;
  }
}

// A pass in MODE over the span's variables: dv of each variable over its
// CSR list into `out` (rows: Np + 1 for acc and B6's acc2, Np for B5's
// second-pass output; the red partials hold the sat flags kSecond reads; v is hv for
// kSecond, whose clause memories are the half step's, recomputed per
// occurrence from xs, dxs1, xl, dxl1). The clause side runs once for each
// real clause, at the first occurrence in its slot-0 variable's list (the
// lists run in clause, then slot order); kFixed and kSecond write the new
// memories to xs_out, xl_out, the chunk's second copy, since other
// occurrences still read the old ones.
template <int R, int MODE, bool PAPER, bool BF16, bool GIVEN>
__global__ void __launch_bounds__(tile::kThreads)
    chunk_pass_kernel(const float* __restrict__ v, const float* __restrict__ xs,
                      const float* __restrict__ xl, float* __restrict__ xs_out,
                      float* __restrict__ xl_out, float* dxs1, float* dxl1,
                      const float* __restrict__ dt, const unsigned char* __restrict__ done,
                      float* out, int rows, const bfly::Parts red, float* acc,
                      float* __restrict__ err, size_t err_stride, Tables f, Scalars s) {
  using C = K_<float>;
  __shared__ int s_red[R];
  const int g = blockIdx.x, r = tile::lane<R>();
  const int Np = f.Np;
  if (threadIdx.x < R) s_red[threadIdx.x] = 0;
  __syncthreads();
  bool adv;
  const float dtc = pass_dt<R, MODE, GIVEN>(done, dt, red, s, g, r, Np, &adv);
  const float half = 0.5f * dtc;
  const float* vt = v + at<R>(g, Np, 0, 0);
  const size_t c0 = at<R>(g, f.Mp, 0, 0);
  float* ot = out + at<R>(g, rows, 0, 0);
  int unsat = 0;
  float e = 0.0f;
  tile::for_items<R>(Np, [&](int i) {
    const float vi = vt[static_cast<size_t>(i) * R + r];
    float dv = 0.0f;
    int prev = -1;
    const int end = __ldg(f.occ_ptr + i + 1);
    for (int j = __ldg(f.occ_ptr + i); j < end; ++j) {
      const int oc = __ldg(f.occ_code + j);
      const int m = oc >> 1;
      float m1, m2;
      tile_min2<R, BF16>(f, vt, r, m, &m1, &m2);
      const size_t k = c0 + static_cast<size_t>(m) * R + r;
      const float x0 = __ldg(xs + k), l0 = __ldg(xl + k);
      float cxs = x0, cxl = l0, d1s = 0.0f, d1l = 0.0f;
      if constexpr (MODE == kSecond) {
        d1s = __ldg(dxs1 + k);
        d1l = __ldg(dxl1 + k);
        cxs = clampf(x0 + half * d1s, C::eps, C::xs_hi);
        cxl = clampf(l0 + half * d1l, 1.0f, s.xl_cap);
      }
      const float val = lit_value<float, BF16>(vi, oc & 1);
      dv += contribution<float, PAPER, BF16>(val, m1, m2, cxs, cxl, s.zeta, oc & 1);
      if (m != prev && (__ldg(f.lit_code + m) >> 1) == i &&
          clause_side<MODE>(true, m1, x0, l0, d1s, d1l, cxs, cxl, k, dtc, adv, xs_out, xl_out,
                            dxs1, dxl1, s, e))
        unsat = 1;
      prev = m;
    }
    ot[static_cast<size_t>(i) * R + r] = dv;
  });
  publish<R, MODE>(s_red, unsat, e, acc, err, err_stride, g, Np);
}

// The clause side of a pass for the shard's padded clauses (`pads`, n of
// them), which have no occurrence.
template <int R, int MODE, bool GIVEN>
__global__ void __launch_bounds__(tile::kThreads)
    chunk_pad_kernel(const float* __restrict__ xs, const float* __restrict__ xl,
                     float* __restrict__ xs_out, float* __restrict__ xl_out, float* dxs1,
                     float* dxl1, const float* __restrict__ dt,
                     const unsigned char* __restrict__ done, const bfly::Parts red, float* acc,
                     float* __restrict__ err, size_t err_stride, const int* __restrict__ pads,
                     int n, int Np, int Mp, Scalars s) {
  using C = K_<float>;
  __shared__ int s_red[R];
  const int g = blockIdx.x, r = tile::lane<R>();
  if (threadIdx.x < R) s_red[threadIdx.x] = 0;
  __syncthreads();
  bool adv;
  const float dtc = pass_dt<R, MODE, GIVEN>(done, dt, red, s, g, r, Np, &adv);
  const float half = 0.5f * dtc;
  const size_t c0 = at<R>(g, Mp, 0, 0);
  float e = 0.0f;
  tile::for_items<R>(n, [&](int p) {
    const size_t k = c0 + static_cast<size_t>(__ldg(pads + p)) * R + r;
    const float x0 = xs[k], l0 = xl[k];
    float hxs = 0.0f, hxl = 0.0f, d1s = 0.0f, d1l = 0.0f;
    if constexpr (MODE == kSecond) {
      d1s = dxs1[k];
      d1l = dxl1[k];
      hxs = clampf(x0 + half * d1s, C::eps, C::xs_hi);
      hxl = clampf(l0 + half * d1l, 1.0f, s.xl_cap);
    }
    clause_side<MODE>(false, 0.0f, x0, l0, d1s, d1l, hxs, hxl, k, dtc, adv, xs_out, xl_out, dxs1,
                      dxl1, s, e);
  });
  publish<R, MODE>(s_red, 0, e, acc, err, err_stride, g, Np);
}

// The pointers and sizes of one B5 or B6 launch (null where a phase reads
// none; B5 passes its advance flags as `done`, see pass_dt). `red`, `red2`:
// the S ranks' partials of the launches whose sums B6 reads (at S = 1 they
// may be `acc`, `acc2` themselves: a group of one; none for B5); `acc`,
// `acc2`: the partials a pass writes; the second pass's error words of tile
// g at err + g * err_stride (B6: row Np of acc2; B5: a (G, R) array).
struct ChunkArgs {
  float *v, *xs, *xl, *xs2, *xl2, *dt;
  unsigned char* done;
  bfly::Parts red, red2;
  float *acc, *acc2, *err, *dxs1, *dxl1, *hv;
  size_t err_stride;
  int* errbits;
  const int* pads;
  int n_pads;
  Tables f;
  Scalars s;
  int G;
  bool paper, bf16;
};

// A pass in MODE: chunk_pass_kernel over the variables, then
// chunk_pad_kernel over the padded clauses; GIVEN as in pass_dt.
template <int R, int MODE, bool GIVEN>
void launch_pass(const ChunkArgs& a, const float* v, float* out, int rows, cudaStream_t st) {
  const dim3 grid = tile::grid(a.G, R, a.f.Np);
#define ODESAT_PASS(P, H)                                                                  \
  chunk_pass_kernel<R, MODE, P, H, GIVEN><<<grid, tile::kThreads, 0, st>>>(                       \
      v, a.xs, a.xl, a.xs2, a.xl2, a.dxs1, a.dxl1, a.dt, a.done, out, rows, a.red, a.acc, a.err, \
      a.err_stride, a.f, a.s)
  if (a.paper) {
    if (a.bf16) ODESAT_PASS(true, true); else ODESAT_PASS(true, false);
  } else {
    if (a.bf16) ODESAT_PASS(false, true); else ODESAT_PASS(false, false);
  }
#undef ODESAT_PASS
  if (a.n_pads > 0)
    chunk_pad_kernel<R, MODE, GIVEN><<<tile::grid(a.G, R, a.n_pads), tile::kThreads, 0, st>>>(
        a.xs, a.xl, a.xs2, a.xl2, a.dxs1, a.dxl1, a.dt, a.done, a.red, a.acc, a.err,
        a.err_stride, a.pads, a.n_pads, a.f.Np, a.f.Mp, a.s);
}

// The prologue kernels that read S partials in bulk, instantiated for S =
// 1, 2 and 4 (S = 0 reads red.s at run time).
template <int R, int S>
void launch_prologue(int phase, bool applied, const ChunkArgs& a, cudaStream_t st) {
  const int Np = a.f.Np;
  const dim3 vgrid = tile::grid(a.G, R, Np);
  const bool fixed = phase == kStep || phase == kApply;
  if (applied) {
    if (fixed)
      chunk_apply_kernel<R, true, S><<<vgrid, tile::kThreads, 0, st>>>(
          a.v, a.red, a.red2, nullptr, a.done, nullptr, a.s.dt_fixed, Np);
    else
      chunk_apply_kernel<R, false, S><<<vgrid, tile::kThreads, 0, st>>>(
          a.v, a.red, a.red2, a.dt, a.done, a.errbits, 0.0f, Np);
  }
  if (phase == kHalf)
    chunk_hv_kernel<R, S><<<vgrid, tile::kThreads, 0, st>>>(a.v, a.red, a.dt, a.done, a.hv,
                                                            a.err, a.err_stride, Np);
}

// One B6 launch in `phase`: the kernel sequence above on stream `st`.
template <int R>
int shard_chunk_phase(int phase, bool apply, const ChunkArgs& a, cudaStream_t st) {
  const int Np = a.f.Np;
  const bool fixed = phase == kStep || phase == kApply;
  const bool tail = phase == kApply || phase == kCommit;
  const bool applied = tail || ((phase == kStep || phase == kFirst) && apply);
  const bool bulk = applied || phase == kHalf;
  if (bulk && a.red.s == 1) launch_prologue<R, 1>(phase, applied, a, st);
  else if (bulk && a.red.s == 2) launch_prologue<R, 2>(phase, applied, a, st);
  else if (bulk && a.red.s == 4) launch_prologue<R, 4>(phase, applied, a, st);
  else if (bulk) launch_prologue<R, 0>(phase, applied, a, st);
  if (phase != kHalf) {
    const int n = a.G * R;
    const int blocks = (n + tile::kThreads - 1) / tile::kThreads;
    if (fixed)
      chunk_head_kernel<true><<<blocks, tile::kThreads, 0, st>>>(
          a.red, a.acc, nullptr, a.done, a.red2, nullptr, 0.0f, Np, R, n, applied, !tail);
    else
      chunk_head_kernel<false><<<blocks, tile::kThreads, 0, st>>>(
          a.red, a.acc, a.dt, a.done, a.red2, a.errbits, a.s.tol, Np, R, n, applied, !tail);
  }
  if (tail) return static_cast<int>(cudaGetLastError());
  if (phase == kHalf) {
    launch_pass<R, kSecond, false>(a, a.hv, a.acc2, Np + 1, st);
  } else if (phase == kStep) {
    launch_pass<R, kFixed, false>(a, a.v, a.acc, Np + 1, st);
  } else {
    launch_pass<R, kRhs, false>(a, a.v, a.acc, Np + 1, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// One B5 launch in `mode` (ShardMode) on stream `st`: the words the pass
// publishes into are cleared by B6's head kernel (the sat flag, row Np of
// `out`; the error, a (G, 1, R) buffer to the head kernel), then B6's pass
// runs with the step and the advance flag given. `out` is (G, Np+1, R) for
// kRhs and kFixed, (G, Np, R) for kSecond.
template <int R>
int shard_stream_pass(int mode, const ChunkArgs& a, float* out, cudaStream_t st) {
  const int Np = a.f.Np, n = a.G * R;
  const int blocks = (n + tile::kThreads - 1) / tile::kThreads;
  if (mode == kSecond) {
    chunk_head_kernel<true><<<blocks, tile::kThreads, 0, st>>>(
        a.red, a.err, nullptr, nullptr, a.red2, nullptr, 0.0f, 0, R, n, 0, 1);
    launch_pass<R, kSecond, true>(a, a.v, out, Np, st);
  } else {
    chunk_head_kernel<true><<<blocks, tile::kThreads, 0, st>>>(
        a.red, out, nullptr, nullptr, a.red2, nullptr, 0.0f, Np, R, n, 0, 1);
    if (mode == kFixed)
      launch_pass<R, kFixed, true>(a, a.v, out, Np + 1, st);
    else
      launch_pass<R, kRhs, true>(a, a.v, out, Np + 1, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether `p` (null counts as aligned) is a multiple of `bytes`.
bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// B10 (rhs_launch) replaces odesat_tpu/ops/rhs_pallas.py::make_pallas_rhs
// (:62): one RHS pass (v, xs, xl) -> (dv, dxs, dxl, allsat), float or
// double. A tile of R trajectories (R a power of two up to kMaxLanes) is
// worked on by one CTA, one trajectory a lane of each group of R threads,
// as B1 runs them, so every table word and every clause's slots serve R
// trajectories. The tile's state lives in shared memory a row a
// trajectory, each row whole 16-byte units and, where R > 1, a row stride
// of 16 bytes past a multiple of 128, so that a lane group's R words of one
// item fall on distinct banks (R <= 8). Rows arrive and leave as 1D bulk
// copies (bulk.cuh): one thread issues a copy a row and the others wait on
// an mbarrier, so no thread spends an instruction or a register on a word
// of the copy. Each tile runs
//   clause phase    (groups over clauses, by width segment): the running
//                   top-2 min over the slots in slot order and each slot's
//                   signed contribution, factored as B1's clause_terms
//                   factors it, written at its occurrence's CSR position;
//                   dxs = beta (xs + eps)(c - gamma) and dxl = alpha (c -
//                   delta) overwrite the clause's xs and xl; the lane's
//                   "some clause unsatisfied" folds by ballot;
//   variable phase  (groups over variables): dv over the CSR list in four
//                   partial sums (csr_sum), over v in place.
// Resident form (rhs_resident_kernel): the contributions sit in shared
// memory, a row a trajectory, and a persistent CTA walks tiles
// blockIdx.x, + gridDim.x, ... with two buffers for the rows: the bulk
// loads of the next tile run while the threads compute this one, and the
// stores drain behind them. Streamed form (rhs_streamed_kernel), for tiles
// whose footprint does not fit: a CTA a tile, only v and a window of C
// clauses' xs and xl in shared memory, the clause axis in windows of C, and
// the contributions in a device scratch of the wrapper's, (nnz, R) a tile,
// R neighbouring words an occurrence; rows that are not whole 16-byte
// units are copied by the threads. No float atomics; built with
// --fmad=false, so B10 equals its plain version (ops/fused_chunk.py::
// _rhs_plain over B10's tables, partial_sums=4) bit for bit. What bounds
// it: device-memory bytes, every one a row read or a row write.
namespace rhs {

constexpr int kHeadBytes = 32;  // two mbarriers and two unsat masks
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;  // two CTAs of kMaxThreads an SM: 64 registers a thread
constexpr int kMaxLanes = 8;
constexpr int kUnroll = 4;  // row elements a thread has in flight in a copy by the threads

// Elements a row of n takes in the tile: whole 16-byte units and, where
// R > 1, 16 bytes past a multiple of 128 (a lane group's words of one item
// on distinct banks).
__host__ __device__ inline int row_stride(int n, int itemsize, int R) {
  int bytes = (n * itemsize + 15) / 16 * 16;
  if (R > 1) bytes += ((16 - bytes % 128) % 128 + 128) % 128;
  return bytes / itemsize;
}

// Shared memory of one CTA. Resident: two buffers of v, xs and xl rows and
// one of contributions (C = Mp); streamed: v and a window of C clauses.
inline size_t smem_bytes(int itemsize, bool resident, int Np, int C, int nnz, int R) {
  const size_t state = static_cast<size_t>(row_stride(Np, itemsize, R)) +
                       2 * static_cast<size_t>(row_stride(C, itemsize, R));
  const size_t row =
      resident ? 2 * state + static_cast<size_t>(row_stride(nnz, itemsize, R)) : state;
  return kHeadBytes + static_cast<size_t>(itemsize) * R * row;
}

// Walk the elements (r, x) of an nr-by-w block in row order, consecutive
// threads on consecutive elements, kUnroll of them a thread at once:
// body(u, ok, r, x) for each, u the unroll slot.
template <typename F>
__device__ __forceinline__ void walk_rows(int nr, int w, F&& body) {
  const int nt = static_cast<int>(blockDim.x), total = nr * w;
  const int dr = nt / w, dx = nt - dr * w;
  int r = static_cast<int>(threadIdx.x) / w, x = static_cast<int>(threadIdx.x) - r * w;
  for (int j = static_cast<int>(threadIdx.x); j < total; j += kUnroll * nt) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      body(u, j + u * nt < total, r, x);
      x += dx;
      r += dr;
      if (x >= w) {
        x -= w;
        ++r;
      }
    }
  }
}

// Columns [c0, c0 + w) of nr rows: in device memory, rows of n elements
// from `rows`; in shared memory, rows of P elements from `tile`.
template <typename T>
struct Block {
  T* rows;
  size_t n;
  int c0, w;
  T* tile;
  int P;

  // The rows move as bulk copies: 16-byte units at 16-byte addresses.
  __device__ __forceinline__ bool bulk() const {
    return (n * sizeof(T)) % 16 == 0 && (c0 * sizeof(T)) % 16 == 0 &&
           (w * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(rows) % 16 == 0;
  }
  __device__ __forceinline__ unsigned row_bytes() const { return static_cast<unsigned>(w * sizeof(T)); }
  // Thread 0: the bulk copies of nr rows into the tile, completing on bar.
  __device__ __forceinline__ void load(int nr, uint64_t* bar) const {
    for (int r = 0; r < nr; ++r) bulk::load(tile + r * P, rows + r * n + c0, row_bytes(), bar);
  }
  // Thread 0: the bulk copies of nr rows out of the tile.
  __device__ __forceinline__ void store(int nr) const {
    for (int r = 0; r < nr; ++r) bulk::store(rows + r * n + c0, tile + r * P, row_bytes());
  }
};

// Read N blocks of nr rows into shared memory; every thread returns once
// they have landed. Bulk blocks come in on the mbarrier (its phase parity
// flips), the others through the threads.
template <typename T, int N>
__device__ __forceinline__ void stage_in(const Block<T> (&b)[N], int nr, uint64_t* bar,
                                         unsigned& parity) {
  unsigned bytes = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (b[i].bulk()) {
      bytes += nr * b[i].row_bytes();
    } else {
      T val[kUnroll];
      int at[kUnroll];
      walk_rows(nr, b[i].w, [&](int u, bool ok, int r, int x) {
        at[u] = ok ? r * b[i].P + x : -1;
        if (ok) val[u] = __ldcs(b[i].rows + r * b[i].n + b[i].c0 + x);
        if (u == kUnroll - 1) {
#pragma unroll
          for (int q = 0; q < kUnroll; ++q)
            if (at[q] >= 0) b[i].tile[at[q]] = val[q];
        }
      });
    }
  }
  if (bytes && threadIdx.x == 0) {
    bulk::fence_async();
    bulk::expect(bar, bytes);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (b[i].bulk()) b[i].load(nr, bar);
  }
  __syncthreads();  // the threads' copies landed
  if (bytes) {
    bulk::wait(bar, parity);
    parity ^= 1u;
  }
}

// Write N blocks of nr rows from shared memory: bulk blocks as copies that
// thread 0 issues in one group (it waits on them before their shared memory
// is written again and before it exits), the others through the threads.
template <typename T, int N>
__device__ __forceinline__ void stage_out(const Block<T> (&b)[N], int nr) {
  bulk::fence_async();
  __syncthreads();  // every thread's writes visible to the copies
  bool any = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (b[i].bulk()) {
      any = true;
      if (threadIdx.x == 0) b[i].store(nr);
    } else {
      walk_rows(nr, b[i].w, [&](int, bool ok, int r, int x) {
        if (ok) __stcs(b[i].rows + r * b[i].n + b[i].c0 + x, b[i].tile[r * b[i].P + x]);
      });
    }
  }
  if (any && threadIdx.x == 0) bulk::commit();
}

// Slot k's signed contribution (times -q) from its literal value and the
// clause's coefficients: B1's clause_terms, operation for operation.
template <typename T, bool PAPER>
__device__ __forceinline__ T slot_term(T val, T m1, T c, T b, T A1, T A2, int negated) {
  const bool is_min = val <= m1;
  T cp;
  if constexpr (PAPER) {
    cp = is_min ? (A2 + b * val) : A1;
  } else {
    const T gate = (val == c) ? T(1) : T(0);
    cp = (is_min ? A2 : A1) + b * (val * gate);
  }
  return negated ? cp : -cp;
}

// Clause m for one lane (v: its row; contrib: its first contribution, cs
// apart), the slots below w (KMAX > 0: at most KMAX of them, read at once
// into registers; KMAX = 0: any number, read as the loops need them).
// Writes the slots' contributions at their CSR positions, replaces x (xs)
// and l (xl) by dxs and dxl (0 for a padded clause) and returns whether
// the clause is unsatisfied.
template <typename T, int KMAX, bool PAPER>
__device__ __forceinline__ bool rhs_clause(const int* __restrict__ code,
                                           const int* __restrict__ pos, int m, int Mp, int w,
                                           const T* v, T& x, T& l, T* contrib, int cs, T zeta) {
  using Kc = K_<T>;
  constexpr int N = KMAX > 0 ? KMAX : 1;
  int cd[N], at[N];
  T val[N];
  T m1, m2 = T(__int_as_float(0x7f800000));  // +inf
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      cd[k] = k < w ? __ldg(code + k * Mp + m) : -1;
      at[k] = k < w ? __ldg(pos + k * Mp + m) : 0;
    }
    if (cd[0] < 0) {
      x = l = T(0);
      return false;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)  // read at padding, unused
      val[k] = lit_value<T, false>(v[max(cd[k], 0) >> 1], cd[k] & 1);
    m1 = val[0];
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
      if (cd[k] < 0) continue;  // padding slot: +inf never changes m1, m2
      m2 = vmin(m2, vmax(m1, val[k]));
      m1 = vmin(m1, val[k]);
    }
  } else {
    const int c0 = __ldg(code + m);
    if (c0 < 0) {
      x = l = T(0);
      return false;
    }
    m1 = lit_value<T, false>(v[c0 >> 1], c0 & 1);
    for (int k = 1; k < w; ++k) {
      const int ck = __ldg(code + k * Mp + m);
      if (ck < 0) continue;
      const T vk = lit_value<T, false>(v[ck >> 1], ck & 1);
      m2 = vmin(m2, vmax(m1, vk));
      m1 = vmin(m1, vk);
    }
  }
  const T c = T(0.5) * m1;
  const T a = T(-0.5) * (l * x);
  const T b = T(-0.5) * ((T(1) + zeta * l) * (T(1) - x));
  const T A1 = a * m1;
  const T A2 = a * m2;
  if constexpr (KMAX > 0) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (cd[k] >= 0)
        contrib[at[k] * cs] = slot_term<T, PAPER>(val[k], m1, c, b, A1, A2, cd[k] & 1);
  } else {
    for (int k = 0; k < w; ++k) {
      const int ck = __ldg(code + k * Mp + m);
      if (ck < 0) continue;
      const T vk = lit_value<T, false>(v[ck >> 1], ck & 1);
      contrib[__ldg(pos + k * Mp + m) * cs] = slot_term<T, PAPER>(vk, m1, c, b, A1, A2, ck & 1);
    }
  }
  x = Kc::beta * (x + Kc::eps) * (c - Kc::gamma);
  l = Kc::alpha * (c - Kc::delta);
  return !(c < Kc::gamma);
}

// The clauses [lo, hi) of a segment of width w that group grp of G takes,
// for one lane; xs and xl are the lane's rows of the window whose first
// clause is c0.
template <typename T, int KMAX, bool PAPER>
__device__ __forceinline__ bool rhs_clauses(const int* __restrict__ code,
                                            const int* __restrict__ pos, int lo, int hi, int c0,
                                            int Mp, int w, int grp, int G, const T* v, T* xs,
                                            T* xl, T* contrib, int cs, T zeta) {
  bool bad = false;
  for (int m = lo + grp; m < hi; m += G) {
    T x = xs[m - c0], l = xl[m - c0];
    bad |= rhs_clause<T, KMAX, PAPER>(code, pos, m, Mp, w, v, x, l, contrib, cs, zeta);
    xs[m - c0] = x;
    xl[m - c0] = l;
  }
  return bad;
}

// dv of variable i for one lane: its contributions (c: the lane's first,
// cs apart) over the CSR list in four partial sums, list positions 0, 1, 2
// and 3 mod 4, each in list order, added as (s0 + s1) + (s2 + s3): four
// independent chains of adds, and each about a quarter of the list's
// rounding (the plain version sums so too).
template <typename T>
__device__ __forceinline__ T csr_sum(const int* __restrict__ ptr, const T* c, int cs, int i) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int j = __ldg(ptr + i);
  const int end = __ldg(ptr + i + 1);
  for (; j + 4 <= end; j += 4) {
    s0 += c[j * cs];
    s1 += c[(j + 1) * cs];
    s2 += c[(j + 2) * cs];
    s3 += c[(j + 3) * cs];
  }
  if (j < end) s0 += c[j * cs];
  if (j + 1 < end) s1 += c[(j + 1) * cs];
  if (j + 2 < end) s2 += c[(j + 2) * cs];
  return (s0 + s1) + (s2 + s3);
}

template <typename T>
struct Io {
  const T* v;
  const T* xs;
  const T* xl;
  T* dv;
  T* dxs;
  T* dxl;
  unsigned char* allsat;
  T* scratch;  // streamed: the contributions, (nnz, R) a tile
};

struct Pass {
  const int* lit_code;  // (K, Mp): 2*var + negated, -1 at padding
  const int* occ_ptr;   // (Np + 1) CSR pointers
  const int* slot_pos;  // (K*Mp): the CSR position of each slot
  const int* segs;      // (nseg, 4): clause_segments
  int nseg, Np, Mp, nnz;
  int B, R, lg_r, C;  // C: the clauses a window holds (Mp when resident)
};

// The clause phase of one lane over the window [c0, c0 + w) (v, xs, xl:
// the lane's rows; contrib: its first contribution, cs apart); returns
// whether one of its clauses is unsatisfied.
template <typename T, bool PAPER>
__device__ __forceinline__ bool clause_window(const Pass& f, int c0, int w, int grp, int G,
                                              const T* v, T* xs, T* xl, T* contrib, int cs,
                                              T zeta) {
  bool bad = false;
  for (int q = 0; q < f.nseg; ++q) {
    const int lo = max(__ldg(f.segs + 4 * q), c0);
    const int hi = min(__ldg(f.segs + 4 * q + 1), c0 + w);
    const int width = __ldg(f.segs + 4 * q + 2);
    if (lo >= hi) continue;
    if (width == 3)
      bad |= rhs_clauses<T, 3, PAPER>(f.lit_code, f.slot_pos, lo, hi, c0, f.Mp, 3, grp, G, v, xs,
                                      xl, contrib, cs, zeta);
    else if (width <= 4)
      bad |= rhs_clauses<T, 4, PAPER>(f.lit_code, f.slot_pos, lo, hi, c0, f.Mp, width, grp, G, v,
                                      xs, xl, contrib, cs, zeta);
    else
      bad |= rhs_clauses<T, 0, PAPER>(f.lit_code, f.slot_pos, lo, hi, c0, f.Mp, width, grp, G, v,
                                      xs, xl, contrib, cs, zeta);
  }
  return bad;
}

// The resident form: a persistent CTA walks its tiles with two row
// buffers; thread 0 issues the next tile's loads (once the stores that read
// that buffer have read it) before the threads compute this tile.
template <typename T, bool PAPER>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) rhs_resident_kernel(Io<T> io, Pass f, T zeta) {
  constexpr int isz = static_cast<int>(sizeof(T));
  const int tid = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
  const int R = f.R, r = tid & (R - 1), grp = tid >> f.lg_r, G = nt >> f.lg_r;
  const int Np = f.Np, Mp = f.Mp;
  const int Pv = row_stride(Np, isz, R), Pm = row_stride(Mp, isz, R);
  const size_t state = static_cast<size_t>(R) * (Pv + 2 * Pm);
  const int tiles = (f.B + R - 1) / R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // [2]
  unsigned* unsat = reinterpret_cast<unsigned*>(smem_raw + 16);  // [2]
  T* buf = reinterpret_cast<T*>(smem_raw + kHeadBytes);  // [2] x (v, xs, xl rows)
  T* contrib = buf + 2 * state + static_cast<size_t>(r) * row_stride(f.nnz, isz, R);
  // Block i of tile g in buffer b: 0 v, 1 xs, 2 xl (to its rows with `out`)
  auto block = [&](int i, int g, int b, bool out) {
    const size_t t0 = static_cast<size_t>(g) * R;
    T* tile = buf + b * state + (i == 0 ? 0 : R * (Pv + (i - 1) * Pm));
    if (i == 0) return Block<T>{(out ? io.dv : const_cast<T*>(io.v)) + t0 * Np, static_cast<size_t>(Np), 0, Np, tile, Pv};
    T* rows = i == 1 ? (out ? io.dxs : const_cast<T*>(io.xs)) : (out ? io.dxl : const_cast<T*>(io.xl));
    return Block<T>{rows + t0 * Mp, static_cast<size_t>(Mp), 0, Mp, tile, Pm};
  };
  auto rows_of = [&](int g) { return min(R, f.B - g * R); };
  auto issue = [&](int g, int b) {  // thread 0: tile g's rows into buffer b
    const int nr = rows_of(g);
    bulk::fence_async();
    bulk::expect(bar + b, static_cast<unsigned>(nr * (Np + 2 * Mp) * isz));
    for (int i = 0; i < 3; ++i) block(i, g, b, false).load(nr, bar + b);
  };
  if (tid == 0) {
    unsat[0] = unsat[1] = 0;
    bulk::init(bar);
    bulk::init(bar + 1);
    issue(blockIdx.x, 0);
  }
  __syncthreads();  // the barriers initialised
  for (int i = 0, g = blockIdx.x; g < tiles; ++i, g += gridDim.x) {
    const int b = i & 1, nr = rows_of(g);
    if (tid == 0 && g + static_cast<int>(gridDim.x) < tiles) {
      bulk::wait_read();  // the last tile's stores have read the other buffer
      issue(g + gridDim.x, 1 - b);
    }
    bulk::wait(bar + b, (i >> 1) & 1);
    T* v = buf + b * state + static_cast<size_t>(r) * Pv;
    T* xs = buf + b * state + static_cast<size_t>(R) * Pv + static_cast<size_t>(r) * Pm;
    T* xl = xs + static_cast<size_t>(R) * Pm;
    const bool bad = clause_window<T, PAPER>(f, 0, Mp, grp, G, v, xs, xl, contrib, 1, zeta);
    const unsigned m_bad = tile::lane_mask(bad, R);
    if ((tid & 31) == 0 && m_bad) atomicOr(unsat + b, m_bad);
    bulk::fence_async();
    __syncthreads();  // dxs, dxl, the contributions and the flags published
    if (tid == 0) {
      block(1, g, b, true).store(nr);
      block(2, g, b, true).store(nr);
      bulk::commit();
      unsat[1 - b] = 0;  // the next tile's flags: every read of them is behind this barrier
    }
    for (int i2 = grp; i2 < Np; i2 += G) v[i2] = csr_sum(f.occ_ptr, contrib, 1, i2);
    bulk::fence_async();
    __syncthreads();  // dv published
    if (tid == 0) {
      block(0, g, b, true).store(nr);
      bulk::commit();
    }
    if (tid < nr) io.allsat[static_cast<size_t>(g) * R + tid] = ((unsat[b] >> tid) & 1u) ? 0 : 1;
  }
  if (tid == 0) bulk::wait_all();
}

// The streamed form: a CTA a tile, the clause axis in windows of C, the
// contributions in the device scratch.
template <typename T, bool PAPER>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) rhs_streamed_kernel(Io<T> io, Pass f, T zeta) {
  constexpr int isz = static_cast<int>(sizeof(T));
  const int tid = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
  const int R = f.R, r = tid & (R - 1), grp = tid >> f.lg_r, G = nt >> f.lg_r;
  const int Np = f.Np, Mp = f.Mp, C = f.C;
  const int Pv = row_stride(Np, isz, R), Pw = row_stride(C, isz, R);
  const size_t t0 = static_cast<size_t>(blockIdx.x) * R;
  const int nr = min(R, static_cast<int>(f.B - t0));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned* unsat = reinterpret_cast<unsigned*>(smem_raw + 16);
  T* v = reinterpret_cast<T*>(smem_raw + kHeadBytes);
  T* xs = v + static_cast<size_t>(R) * Pv;
  T* xl = xs + static_cast<size_t>(R) * Pw;
  T* contrib = io.scratch + static_cast<size_t>(blockIdx.x) * f.nnz * R + r;
  if (tid == 0) {
    *unsat = 0;
    bulk::init(bar);
  }
  __syncthreads();  // the barrier initialised
  unsigned parity = 0;
  T* const v_row = v + static_cast<size_t>(r) * Pv;
  bool bad = false;
  for (int c0 = 0; c0 < Mp; c0 += C) {
    const int w = min(C, Mp - c0);
    const Block<T> in_w[2] = {
        {const_cast<T*>(io.xs) + t0 * Mp, static_cast<size_t>(Mp), c0, w, xs, Pw},
        {const_cast<T*>(io.xl) + t0 * Mp, static_cast<size_t>(Mp), c0, w, xl, Pw}};
    if (c0 == 0) {
      const Block<T> in[3] = {
          {const_cast<T*>(io.v) + t0 * Np, static_cast<size_t>(Np), 0, Np, v, Pv}, in_w[0],
          in_w[1]};
      stage_in(in, nr, bar, parity);
    } else {
      stage_in(in_w, nr, bar, parity);
    }
    bad |= clause_window<T, PAPER>(f, c0, w, grp, G, v_row, xs + static_cast<size_t>(r) * Pw,
                                   xl + static_cast<size_t>(r) * Pw, contrib, R, zeta);
    const Block<T> out_w[2] = {{io.dxs + t0 * Mp, static_cast<size_t>(Mp), c0, w, xs, Pw},
                               {io.dxl + t0 * Mp, static_cast<size_t>(Mp), c0, w, xl, Pw}};
    stage_out(out_w, nr);  // also publishes the window's contributions
    if (c0 + w < Mp) {  // the window is staged again once the stores have read it
      if (tid == 0) bulk::wait_read();
      __syncthreads();
    }
  }
  const unsigned m_bad = tile::lane_mask(bad, R);
  if ((tid & 31) == 0 && m_bad) atomicOr(unsat, m_bad);
  for (int i = grp; i < Np; i += G) v_row[i] = csr_sum(f.occ_ptr, contrib, R, i);
  const Block<T> out_v[1] = {{io.dv + t0 * Np, static_cast<size_t>(Np), 0, Np, v, Pv}};
  stage_out(out_v, nr);  // dv and the flags published
  if (tid < nr) io.allsat[t0 + tid] = ((*unsat >> tid) & 1u) ? 0 : 1;
  if (tid == 0) bulk::wait_all();
}

template <typename T>
int launch_tile(const Io<T>& io, const Pass& f, bool paper, bool resident, int threads,
                size_t smem, T zeta, cudaStream_t st) {
  const int tiles = (f.B + f.R - 1) / f.R;
#define ODESAT_RHS(KERNEL, P)                                                                   \
  {                                                                                             \
    auto kernel = KERNEL<T, P>;                                                                 \
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                           static_cast<int>(smem));                             \
    if (err != cudaSuccess) return static_cast<int>(err);                                       \
    int grid = tiles;                                                                           \
    if (resident) {                                                                             \
      int dev = 0, sms = 0, per_sm = 0;                                                         \
      if ((err = cudaGetDevice(&dev)) != cudaSuccess ||                                         \
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=          \
              cudaSuccess ||                                                                    \
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,        \
                                                               smem)) != cudaSuccess)           \
        return static_cast<int>(err);                                                           \
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);                   \
      grid = min(tiles, per_sm * sms);                                                          \
    }                                                                                           \
    kernel<<<grid, threads, smem, st>>>(io, f, zeta);                                           \
    return static_cast<int>(cudaGetLastError());                                                \
  }
  if (resident) {
    if (paper) ODESAT_RHS(rhs_resident_kernel, true) else ODESAT_RHS(rhs_resident_kernel, false)
  }
  if (paper) ODESAT_RHS(rhs_streamed_kernel, true) else ODESAT_RHS(rhs_streamed_kernel, false)
#undef ODESAT_RHS
}

}  // namespace rhs

}  // namespace

extern "C" {

// The most dynamic shared memory a CTA may use on the current device.
int stream_chunk_smem_limit(void) { return smem_optin(); }

// B2's shared-memory bytes and device scratch floats a tile needs at R lanes;
// the Python gate and wrapper use the same formulas.
size_t stream_chunk_smem_bytes(int Np, int fixed, int R) {
  return lanes::smem_bytes(false, fixed != 0, Np, 0, 0, 0, R);
}
size_t stream_chunk_scratch_floats(int Np, int Mp, int nnz, int fixed, int R) {
  return lanes::scratch_floats(fixed != 0, Np, Mp, nnz, R);
}

// B2. `scratch` holds stream_chunk_scratch_floats(...) floats for each of
// the ceil(B / R) tiles; `segs` as for B1 (fused_chunk_launch). Returns a cudaError_t code (0 = launched).
int stream_chunk_launch(const float* v_in, const float* xs_in, const float* xl_in,
                        const float* dt_in, const unsigned char* done_in, float* v_out,
                        float* xs_out, float* xl_out, float* dt_out, unsigned char* done_out,
                        const int* lit_code, const int* occ_ptr, const int* slot_pos,
                        const int* segs, int nseg, float* scratch, int B, int Np, int Mp, int K,
                        int nnz, int chunk_steps, int fixed, int paper, int bf16, int R,
                        int threads, float zeta, float dt_fixed, float tol, float xl_cap,
                        void* stream) {
  const size_t smem = lanes::smem_bytes(false, fixed != 0, Np, Mp, K, nnz, R);
  if (smem > static_cast<size_t>(smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  const lanes::State st{v_in,  xs_in,  xl_in,  dt_in,  done_in, v_out,
                        xs_out, xl_out, dt_out, done_out, scratch};
  const lanes::Formula f{lit_code, occ_ptr, nullptr, slot_pos, segs, Np, Mp, K, nnz, nseg};
  const lanes::Scalars s{zeta, dt_fixed, tol, xl_cap};
  return lanes::launch<false>(st, f, s, B, R, threads, chunk_steps, fixed != 0, paper != 0,
                              bf16 != 0, smem, static_cast<cudaStream_t>(stream));
}

// Whether a resident B10 launch takes these shapes and buffers: one
// window, rows of whole 16-byte units at 16-byte addresses (its rows move
// only as bulk copies).
static bool rhs_resident_ok(int is_double, int Np, int Mp, int C,
                            std::initializer_list<const void*> rows) {
  const int unit = is_double ? 2 : 4;
  for (const void* p : rows)
    if (reinterpret_cast<size_t>(p) % 16 != 0) return false;
  return C == Mp && Np % unit == 0 && Mp % unit == 0;
}

// B10 in float (is_double = 0) or double: tiles of R trajectories, CTAs
// of `threads` threads, resident (the contributions in shared memory, C =
// Mp) or streamed (windows of C clauses; `scratch` holds nnz*R elements
// for each of the ceil(B / R) tiles); `segs` as for B1. Returns a
// cudaError_t code (0 = launched).
int rhs_launch(int is_double, const void* v_in, const void* xs_in, const void* xl_in, void* dv_out,
               void* dxs_out, void* dxl_out, unsigned char* allsat_out, void* scratch,
               const int* lit_code, const int* occ_ptr, const int* slot_pos, const int* segs,
               int nseg, int B, int Np, int Mp, int nnz, int R, int C, int resident, int threads,
               int paper, double zeta, void* stream) {
  int lg = 0;
  while (lg < 6 && (1 << lg) < R) ++lg;
  if (R < 1 || R > rhs::kMaxLanes || (1 << lg) != R || threads < 32 || threads > rhs::kMaxThreads ||
      threads % 32 != 0 || B < 1 || nseg < 1 || C < 1 || C > Mp ||
      (!resident && scratch == nullptr) || (resident &&
       !rhs_resident_ok(is_double, Np, Mp, C, {v_in, xs_in, xl_in, dv_out, dxs_out, dxl_out})))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rhs::smem_bytes(is_double ? 8 : 4, resident != 0, Np, C, nnz, R);
  const int optin = smem_optin();
  if (optin < 0 || smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const rhs::Pass f{lit_code, occ_ptr, slot_pos, segs, nseg, Np, Mp, nnz, B, R, lg, C};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return rhs::launch_tile(
        rhs::Io<double>{static_cast<const double*>(v_in), static_cast<const double*>(xs_in),
                        static_cast<const double*>(xl_in), static_cast<double*>(dv_out),
                        static_cast<double*>(dxs_out), static_cast<double*>(dxl_out), allsat_out,
                        static_cast<double*>(scratch)},
        f, paper != 0, resident != 0, threads, smem, zeta, st);
  return rhs::launch_tile(
      rhs::Io<float>{static_cast<const float*>(v_in), static_cast<const float*>(xs_in),
                     static_cast<const float*>(xl_in), static_cast<float*>(dv_out),
                     static_cast<float*>(dxs_out), static_cast<float*>(dxl_out), allsat_out,
                     static_cast<float*>(scratch)},
      f, paper != 0, resident != 0, threads, smem, static_cast<float>(zeta), st);
}

// B10's shared-memory bytes a CTA; the Python footprint uses the same formula.
size_t rhs_smem_bytes(int is_double, int resident, int Np, int C, int nnz, int R) {
  return rhs::smem_bytes(is_double ? 8 : 4, resident != 0, Np, C, nnz, R);
}

// B5 in mode 0 (rhs), 1 (fixed) or 2 (second); see ShardMode. The buffers
// are in the tile layout of tile.cuh with R = tile::kR trajectories a tile:
// v (G, Np, R) (hv in mode 2); xs, xl, xs2, xl2, dxs1, dxl1 (G, Mp, R); dt,
// adv, err (G, R); out (G, Np+1, R) = (dv partial | 1 - sat) in modes 0 and
// 1, (G, Np, R) = dv partial in mode 2. rhs writes dxs1, dxl1; fixed and
// second write the new clause memories to xs2, xl2 (the caller swaps the
// two copies); second reads dxs1, dxl1 and adv, and writes err. `pads`
// lists the shard's n_pads padded clauses. Pointers a mode does not use may
// be null. Returns a cudaError_t code (0 = launched).
int shard_stream_launch(int mode, float* v, float* dt, unsigned char* adv, float* xs, float* xl,
                        float* xs2, float* xl2, float* dxs1, float* dxl1, float* out, float* err,
                        const int* pads, int n_pads, const int* lit_code, const int* occ_ptr,
                        const int* occ_code, int G, int R, int Np, int Mp, int K, int paper,
                        int bf16, float zeta, float xl_cap, void* stream) {
  if (mode < kRhs || mode > kSecond || G < 1 || R != tile::kR || n_pads < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool second = mode == kSecond;
  const ChunkArgs a{v,       xs,      xl,
                    xs2,     xl2,     dt,
                    adv,     bfly::Parts{}, bfly::Parts{},
                    second ? nullptr : out, nullptr,
                    err,     dxs1,    dxl1,
                    nullptr, static_cast<size_t>(R), nullptr,
                    pads,    n_pads,  Tables{lit_code, occ_ptr, occ_code, Np, Mp, K},
                    Scalars{zeta, 0.0f, 0.0f, xl_cap},
                    G,       paper != 0, bf16 != 0};
  return shard_stream_pass<tile::kR>(mode, a, out, static_cast<cudaStream_t>(stream));
}

// B6 in phase 0 (step), 1 (apply), 2 (first), 3 (half) or 4 (commit); see
// ChunkPhase. The buffers are in the tile layout of tile.cuh with R =
// tile::kR trajectories a tile: v, hv (G, Np, R); xs, xl, xs2, xl2, dxs1,
// dxl1 (G, Mp, R); acc, acc2 and every partial of red and red2 (G, Np+1,
// R); dt, done, errbits (G, R). acc = (dv | 1 - sat) and acc2 = (dv2 | the
// step-doubling error) are the partials the passes write (this rank's slots
// on a clause mesh). red[0..s) and red2[0..s) are the S ranks' partials
// (rank order) of the launches whose sums this one reads: apply, head, hv
// and the second pass add them in the butterfly's tree as they read them,
// and red2's row Np combines by max (at S = 1, acc and acc2 themselves).
// `apply` (phases 0 and 2) applies the previous launch's result first.
// step and half write the new clause memories to xs2, xl2 (the caller swaps
// the two copies); `pads` lists the shard's n_pads padded clauses. `hv`
// and `errbits` are the adaptive chunk's scratch (errbits zero between
// launches). Pointers a phase does not use may be null (red2 for the fixed
// integrator). Every buffer is 16-byte aligned (done and errbits 4-byte).
// Returns a cudaError_t code (0 = launched).
int shard_chunk_launch(int phase, int apply, float* v, float* xs, float* xl, float* dt,
                       unsigned char* done, const float* const* red, const float* const* red2,
                       int s, float* acc, float* acc2, float* dxs1, float* dxl1, float* xs2,
                       float* xl2, float* hv, int* errbits, const int* pads, int n_pads,
                       const int* lit_code, const int* occ_ptr, const int* occ_code, int G, int R,
                       int Np, int Mp, int K, int paper, int bf16, float zeta, float dt_fixed,
                       float tol, float xl_cap, void* stream) {
  if (phase < kStep || phase > kCommit || G < 1 || R != tile::kR || n_pads < 0 || s < 1 ||
      s > bfly::kMaxRanks || red == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bfly::Parts p1{}, p2{};
  p1.s = p2.s = s;
  bool ok = aligned(v, 16) && aligned(dt, 16) && aligned(hv, 16) && aligned(done, 4);
  for (int k = 0; k < s; ++k) {
    p1.p[k] = red[k];
    p2.p[k] = red2 != nullptr ? red2[k] : nullptr;
    ok = ok && aligned(p1.p[k], 16) && aligned(p2.p[k], 16);
  }
  if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  float* err = acc2 != nullptr ? acc2 + static_cast<size_t>(Np) * R : nullptr;
  const ChunkArgs a{v,       xs,     xl,
                    xs2,     xl2,    dt,
                    done,    p1,     p2,
                    acc,     acc2,
                    err,     dxs1,   dxl1,
                    hv,      static_cast<size_t>(Np + 1) * R, errbits,
                    pads,    n_pads, Tables{lit_code, occ_ptr, occ_code, Np, Mp, K},
                    Scalars{zeta, dt_fixed, tol, xl_cap},
                    G,       paper != 0, bf16 != 0};
  return shard_chunk_phase<tile::kR>(phase, apply != 0, a, static_cast<cudaStream_t>(stream));
}

const char* stream_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
