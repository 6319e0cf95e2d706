// The single-device ODE chunk on a warp's lanes: the device code of B1
// (fused_chunk.cu, RESIDENT) and B2 (stream_chunk.cu, streamed).
//
// One CTA runs one tile of R trajectories (R a power of two, at most
// tile::kR = 32) for a whole chunk. Its T threads form T/R groups of R
// lanes; lane r of every group takes trajectory tile*R + r, and group g
// owns clauses g, g + T/R, ... and variables g, g + T/R, ... for the whole
// chunk. Every per-trajectory array is interleaved [x][r] as in tile.cuh,
// so a group's access to item x is R neighbouring words (one conflict-free
// shared-memory wavefront, or one 128-byte line at R = 32), and every table
// word a group reads serves R trajectories.
//
// Each lane does its own trajectory's arithmetic in the order of the plain
// version (ops/fused_chunk.py::fused_chunk_plain): the top-2 min over the
// slots in slot order, the contributions factored as there, dv summed over
// the variable's CSR list in order, no float atomics; built with
// --fmad=false. So B1 and B2 equal the plain version, and each other, bit
// for bit.
//
// Per step (fixed: two barriers; adaptive: four, or one when no lane of
// the tile advances):
//   clause phase    (groups over clauses): v gathered from the tile's
//                   window, running top-2 min, coefficients, the K signed
//                   contributions into `contrib`, the clause's own memories;
//   lane flags      a ballot per warp folds each lane's "some clause
//                   unsatisfied" onto R bits, one shared atomicOr a warp;
//   variable phase  (groups over variables): dv over the CSR list.
// All-satisfied, done, dt and the step-doubling error are facts of a lane:
// every thread holds the tile's R-bit done mask (the same on every
// thread), its lane's dt, and updates only where its lane advances. The
// error is a max per lane: a shuffle max over a warp's groups, then an
// integer atomicMax on the bits of the non-negative float in shared memory
// (order-free). The flag and error words are kept three deep, indexed by
// step mod 3, so each step clears the buffer two steps old without a
// barrier of its own.
//
// The clause axis is walked by segment, the formula's width buckets
// (ops/fused_chunk.py::clause_segments): a clause of a segment of width w
// has w slots read, all at once into registers for w <= 6 (forms 3, 4, 6),
// in loops past that; a formula no wider than 4 gets a kernel without the
// wide forms (WIDE), whose registers slow the narrow ones. In the fixed
// integrator a padded clause is a fixed point once clamped, so after a
// chunk's first step each segment's trailing padded clauses are left out.
//
// Semantics of the TPU kernel kept: fixed mode updates on the step that
// detects all-satisfied (dt = 0 for done lanes: clamps only), then
// freezes; adaptive mode never advances a satisfied or done lane (its
// state stays bit-identical) and clips dt into [2^-7, 1e3]; padding slots
// never win the min; bf16 rounds v before the literal values and each
// contribution before the f32 dv sum.
//
// RESIDENT (B1): the tables and the whole tile state (v, xs, xl, the
// contributions in slot order; adaptive: the half step hv, the full-step
// trial fv, the first pass's dxs1, dxl1) live in shared memory for the
// chunk, read from the row-major (B, .) state at entry and written back at
// exit. Streamed (B2): only v (and hv) live in shared memory; xs, xl, the
// contributions (in CSR order, so the variable phase reads them as a
// stream) and the adaptive scratch live in device memory, tiled [x][r] in
// a scratch buffer of the wrapper's; the first step reads xs, xl from the
// row-major input and the last writes the row-major output. The tables
// are read from global memory (L2) by every CTA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace lanes {

constexpr float kAlpha = 5.0f;
constexpr float kBeta = 20.0f;
constexpr float kGamma = 0.25f;
constexpr float kDelta = 0.05f;
constexpr float kEps = 1e-3f;
constexpr float kXsHi = 0.999f;  // 1 - EPSILON, rounded once as Python does
constexpr float kDtMin = 0.0078125f;  // 2^-7
constexpr float kDtMax = 1000.0f;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared words of the lane flags and errors at the start of shared memory:
// three unsat masks, then three rows of R error words.
__host__ __device__ constexpr int red_words(int R) { return 3 + 3 * R; }

struct Formula {
  const int* lit_code;  // (K, Mp): 2*var + (negated ? 1 : 0), -1 at padding
  const int* occ_ptr;   // (Np + 1) CSR row pointers
  const int* occ_slot;  // (nnz) RESIDENT: the slot k*Mp + m of each occurrence, CSR order
  const int* slot_pos;  // (K*Mp) streamed: the CSR position of each slot (-1 at padding)
  const int* segs;      // (nseg, 4): clause ranges [m0, m1) whose slots lie below width w,
                        // padded clauses only from m_pad on
  int Np, Mp, K, nnz, nseg;
};

struct Scalars {
  float zeta, dt_fixed, tol, xl_cap;
};

// The row-major state in and out, and (streamed) the tiled device scratch:
// per tile xs, xl (Mp, R), contrib (nnz, R); adaptive d1s, d1l (Mp, R) and
// fv (Np, R). In and out may be the same buffers (the device loop runs the
// chunk in place): a CTA reads its own rows before its first barrier and
// writes them after its last, and no other CTA touches them.
//
// `stop`, when not null, is the device loop's stop word
// (csrc/device_loop.cu): a lane that leaves the chunk done stores 1 there,
// or with `stop_all` a lane that leaves it not done ("keep going"). Padded
// lanes never store. A store of a constant, so the CTAs' order does not
// matter.
//
// `at`, when not null, is the device loop's pointer block
// (ops/device_loop.py): the state's five buffers, v, xs, xl, dt and done,
// as device addresses, which the kernel reads (at_or) in place of the
// in and out pointers and runs the chunk in place on. A graph captured
// once then runs on whatever buffers a dispatch names there.
struct State {
  const float* v_in;
  const float* xs_in;
  const float* xl_in;
  const float* dt_in;
  const unsigned char* done_in;
  float* v_out;
  float* xs_out;
  float* xl_out;
  float* dt_out;
  unsigned char* done_out;
  float* scratch;
  int* stop = nullptr;
  int stop_all = 0;
  void* const* at = nullptr;
};

// Field i of the state: its own pointer `own`, or, where the launch has the
// pointer block `at`, the address the block holds. A volatile load where
// the field is used, at the chunk's entry or exit, so the compiler keeps no
// address from the block live across the chunk's steps, which then compile
// as they do without one (B1 within 0.2% of its time before the block,
// PERF.md).
template <typename T>
__device__ __forceinline__ T* at_or(void* const* at, int i, T* own) {
  if (at == nullptr) return own;
  return static_cast<T*>(*reinterpret_cast<void* const volatile*>(at + i));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // fmaxf/fminf ignore NaN like jnp.fmax/fmin and Rust's f64::max/min
  return fminf(fmaxf(x, lo), hi);
}

// A table word: __ldg from global memory, a plain load from shared memory.
template <bool GLOBAL>
__device__ __forceinline__ int word(const int* p) {
  if constexpr (GLOBAL) return __ldg(p);
  else return *p;
}

template <bool BF16>
__device__ __forceinline__ float lit_value(const float* v, int code, int R, int r) {
  float vi = v[(code >> 1) * R + r];
  if constexpr (BF16) vi = __bfloat162float(__float2bfloat16_rn(vi));
  const float qv = (code & 1) ? -vi : vi;  // q * v, exact
  return 1.0f - qv;
}

// The slots of clause m, for lanes of K <= KMAX: each slot's literal code
// (-1 at padding and past K) and the element its contribution goes to
// (slot order k*Mp + m, or its CSR position through slot_pos). All loads are
// issued together.
template <int KMAX, bool GLOBAL>
__device__ __forceinline__ void load_slots(const int* code, const int* pos, int m, int Mp, int K,
                                           int (&cd)[KMAX], int (&at)[KMAX]) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    cd[k] = k < K ? word<GLOBAL>(code + k * Mp + m) : -1;
    at[k] = GLOBAL ? (k < K ? word<true>(pos + k * Mp + m) : 0) : k * Mp + m;
  }
}

// Clause phase of clause m for lane r, from its slots: writes the K signed
// contributions and returns c (0 for a padded clause, which has no
// occurrences). B1's arithmetic, operation for operation: the running top-2
// min in slot order, then each slot's contribution.
template <int KMAX, bool PAPER, bool BF16>
__device__ __forceinline__ float clause_terms(const int (&cd)[KMAX], const int (&at)[KMAX],
                                              const float* v, float xs, float xl, int R, int r,
                                              float zeta, float* contrib, bool* real) {
  *real = cd[0] >= 0;
  if (cd[0] < 0) return 0.0f;
  float val[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) val[k] = lit_value<BF16>(v, max(cd[k], 0), R, r);  // read at padding, unused
  float m1 = val[0];
  float m2 = __int_as_float(0x7f800000);  // +inf
#pragma unroll
  for (int k = 1; k < KMAX; ++k) {
    if (cd[k] < 0) continue;  // padding slot: +inf never changes m1, m2
    m2 = fminf(m2, fmaxf(m1, val[k]));
    m1 = fminf(m1, val[k]);
  }
  const float c = 0.5f * m1;
  const float a = -0.5f * (xl * xs);
  const float b = -0.5f * ((1.0f + zeta * xl) * (1.0f - xs));
  const float A1 = a * m1;
  const float A2 = a * m2;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (cd[k] < 0) continue;
    const bool is_min = val[k] <= m1;
    float cp;
    if constexpr (PAPER) {
      cp = is_min ? (A2 + b * val[k]) : A1;
    } else {
      const float gate = (val[k] == c) ? 1.0f : 0.0f;
      cp = (is_min ? A2 : A1) + b * (val[k] * gate);
    }
    if constexpr (BF16) cp = __bfloat162float(__float2bfloat16_rn(cp));
    contrib[at[k] * R + r] = (cd[k] & 1) ? cp : -cp;  // times -q
  }
  return c;
}

// The same for any K (KMAX = 0): the slots are read as the loops need them.
template <bool GLOBAL, bool PAPER, bool BF16>
__device__ __forceinline__ float clause_terms_any(const int* code, const int* pos,
                                                  const float* v, float xs, float xl, int m,
                                                  int Mp, int K, int R, int r, float zeta,
                                                  float* contrib, bool* real) {
  const int c0 = word<GLOBAL>(code + m);
  *real = c0 >= 0;
  if (c0 < 0) return 0.0f;
  float m1 = lit_value<BF16>(v, c0, R, r);
  float m2 = __int_as_float(0x7f800000);  // +inf
  for (int k = 1; k < K; ++k) {
    const int ck = word<GLOBAL>(code + k * Mp + m);
    if (ck < 0) continue;  // padding slot: +inf never changes m1, m2
    const float val = lit_value<BF16>(v, ck, R, r);
    m2 = fminf(m2, fmaxf(m1, val));
    m1 = fminf(m1, val);
  }
  const float c = 0.5f * m1;
  const float a = -0.5f * (xl * xs);
  const float b = -0.5f * ((1.0f + zeta * xl) * (1.0f - xs));
  const float A1 = a * m1;
  const float A2 = a * m2;
  for (int k = 0; k < K; ++k) {
    const int ck = word<GLOBAL>(code + k * Mp + m);
    if (ck < 0) continue;
    const float val = lit_value<BF16>(v, ck, R, r);
    const bool is_min = val <= m1;
    float cp;
    if constexpr (PAPER) {
      cp = is_min ? (A2 + b * val) : A1;
    } else {
      const float gate = (val == c) ? 1.0f : 0.0f;
      cp = (is_min ? A2 : A1) + b * (val * gate);
    }
    if constexpr (BF16) cp = __bfloat162float(__float2bfloat16_rn(cp));
    const int at = GLOBAL ? word<true>(pos + k * Mp + m) : k * Mp + m;
    contrib[at * R + r] = (ck & 1) ? cp : -cp;  // times -q
  }
  return c;
}

// dv of variable i for lane r: its contributions in CSR order, a batch of
// loads (eight from device memory, four from shared) issued before their
// adds, which stay in list order.
template <bool GLOBAL>
__device__ __forceinline__ float var_sum(const int* ptr, const int* slot, const float* contrib,
                                         int i, int R, int r) {
  float dv = 0.0f;
  int j = word<GLOBAL>(ptr + i);
  const int end = word<GLOBAL>(ptr + i + 1);
  const float* c = contrib + r;
  if constexpr (GLOBAL) {
    for (; j < end; j += 8) {  // the last batch masked: one round of loads per eight
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = j + u < end ? c[(j + u) * R] : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j + u < end) dv += t[u];
    }
  } else {
    for (; j + 4 <= end; j += 4) {
      const int s0 = slot[j], s1 = slot[j + 1], s2 = slot[j + 2], s3 = slot[j + 3];
      const float c0 = c[s0 * R], c1 = c[s1 * R], c2 = c[s2 * R], c3 = c[s3 * R];
      dv += c0;
      dv += c1;
      dv += c2;
      dv += c3;
    }
    for (; j < end; ++j) dv += c[slot[j] * R];
  }
  return dv;
}

using tile::lane_mask;  // the R-bit mask of a warp's lanes for which `bit` holds on some group

// The lane's max of e over the warp's groups, published to errw[lane].
__device__ __forceinline__ void publish_err(float e, int R, int* errw) {
  for (int s = R; s < 32; s <<= 1) e = fmaxf(e, __shfl_down_sync(kFull, e, s));
  const int w = static_cast<int>(threadIdx.x & 31);
  if (w < R && e > 0.0f) atomicMax(errw + w, __float_as_int(e));
}

// Streamed: device scratch floats a tile needs.
__host__ __device__ inline size_t scratch_floats(bool fixed, int Np, int Mp, int nnz, int R) {
  return static_cast<size_t>(R) *
         (2 * static_cast<size_t>(Mp) + nnz + (fixed ? 0 : 2 * static_cast<size_t>(Mp) + Np));
}

// The clause memories of a tile: in shared memory (RESIDENT), or in the
// tile's device scratch except at the first step (read from the row-major
// input) and the last (written to the row-major output).
struct ClauseIO {
  float* xs;  // the tile's (Mp, R) block
  float* xl;
  const float* xs_row;  // streamed: the lane's row of the input, null when padded
  const float* xl_row;
  float* xs_orow;  // streamed: the lane's row of the output, null when padded
  float* xl_orow;
};

// What a thread's clause pass reads and writes in one step.
struct Lane {
  const int* code;
  const int* pos;
  int Mp, R, r, G, grp;
  const float* xs_src;  // the lane's clause memories: source and stride
  const float* xl_src;
  int ss;
  float* xs_dst;  // destination and stride
  float* xl_dst;
  int ds;
  float* contrib;
  float* d1s;  // adaptive: the first pass's dxs, dxl (the tile's (Mp, R) blocks)
  float* d1l;
  float zeta, xl_cap;
  float dt;       // fixed: the lane's step (0 when done); adaptive: the lane's dt
  bool adv;       // adaptive, second pass: the lane advances
  bool moved;     // source and destination differ: a lane that does not advance copies
  bool skip_pad;  // fixed: padded clauses are fixed points (clamped by an earlier step)
};

enum Pass { kFixedPass = 0, kFirstPass = 1, kSecondPass = 2 };

// Clause m of a pass, from the lane's memories x0, l0: the clause phase in
// the register form for slots below w <= FORM (FORM 0: the loops), then the
// clause side of PASS.
template <int FORM, int PASS, bool GLOBAL, bool PAPER, bool BF16>
__device__ __forceinline__ void clause_one(const Lane& L, const float* __restrict__ v,
                                           float* __restrict__ contrib, int m, int w,
                                           const int (&cd)[FORM > 0 ? FORM : 1],
                                           const int (&at)[FORM > 0 ? FORM : 1], float x0,
                                           float l0, bool& bad, float& err) {
  const int R = L.R, r = L.r;
  const float half = 0.5f * L.dt;
  if (PASS == kSecondPass && !L.adv) {
    if (L.moved) {
      L.xs_dst[m * L.ds] = x0;
      L.xl_dst[m * L.ds] = l0;
    }
    return;
  }
  float cx = x0, cl = l0, e1s = 0.0f, e1l = 0.0f;
  if constexpr (PASS == kSecondPass) {  // the half step's memories
    e1s = L.d1s[m * R + r];
    e1l = L.d1l[m * R + r];
    cx = clampf(x0 + half * e1s, kEps, kXsHi);
    cl = clampf(l0 + half * e1l, 1.0f, L.xl_cap);
  }
  bool real;
  float c;
  if constexpr (FORM > 0) {
    c = clause_terms<FORM, PAPER, BF16>(cd, at, v, cx, cl, R, r, L.zeta, contrib, &real);
  } else {
    c = clause_terms_any<GLOBAL, PAPER, BF16>(L.code, L.pos, v, cx, cl, m, L.Mp, w, R, r, L.zeta,
                                              contrib, &real);
  }
  float dxs = 0.0f, dxl = 0.0f;
  if (real) {
    dxs = kBeta * (cx + kEps) * (c - kGamma);
    dxl = kAlpha * (c - kDelta);
    if (PASS != kSecondPass) bad |= !(c < kGamma);
  }
  if constexpr (PASS == kFixedPass) {
    if (!real && L.skip_pad) return;
    L.xs_dst[m * L.ds] = clampf(x0 + L.dt * dxs, kEps, kXsHi);
    L.xl_dst[m * L.ds] = clampf(l0 + L.dt * dxl, 1.0f, L.xl_cap);
  } else if constexpr (PASS == kFirstPass) {
    L.d1s[m * R + r] = dxs;
    L.d1l[m * R + r] = dxl;
  } else {
    const float txs = clampf(cx + half * dxs, kEps, kXsHi);
    const float txl = clampf(cl + half * dxl, 1.0f, L.xl_cap);
    const float fxs = clampf(x0 + L.dt * e1s, kEps, kXsHi);
    const float fxl = clampf(l0 + L.dt * e1l, 1.0f, L.xl_cap);
    err = fmaxf(err, fmaxf(fabsf(fxs - txs), fabsf(fxl - txl)));
    L.xs_dst[m * L.ds] = txs;
    L.xl_dst[m * L.ds] = txl;
  }
}

// One pass over the thread's clauses in [lo, hi) (clause m belongs to group
// m mod G for the whole chunk, so a lane's clause memories are its own).
// Streamed, the next clause's memories, and for the narrow forms its slots,
// are loaded while this one is computed.
template <int FORM, int PASS, bool GLOBAL, bool PAPER, bool BF16>
__device__ __forceinline__ void clause_pass(const Lane& L, const float* __restrict__ v,
                                            float* __restrict__ contrib, int lo, int hi, int w,
                                            bool& bad, float& err) {
  constexpr int N = FORM > 0 ? FORM : 1;
  constexpr bool AHEAD = GLOBAL && FORM > 0 && FORM <= 4;  // slots loaded a clause ahead
  int m = lo + ((L.grp - lo) % L.G + L.G) % L.G;
  int cd[N], at[N];
  if constexpr (GLOBAL) {
    float xn = 0.0f, ln = 0.0f;
    int cdn[N], atn[N];
    if (m < hi) {
      xn = L.xs_src[m * L.ss];
      ln = L.xl_src[m * L.ss];
      if constexpr (AHEAD) load_slots<N, GLOBAL>(L.code, L.pos, m, L.Mp, w, cdn, atn);
    }
    for (; m < hi; m += L.G) {
      const float x0 = xn, l0 = ln;
      const bool more = m + L.G < hi;
      if constexpr (AHEAD) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          cd[k] = cdn[k];
          at[k] = atn[k];
        }
        if (more) load_slots<N, GLOBAL>(L.code, L.pos, m + L.G, L.Mp, w, cdn, atn);
      } else if constexpr (FORM > 0) {
        load_slots<N, GLOBAL>(L.code, L.pos, m, L.Mp, w, cd, at);
      }
      if (more) {
        xn = L.xs_src[(m + L.G) * L.ss];
        ln = L.xl_src[(m + L.G) * L.ss];
      }
      clause_one<FORM, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, m, w, cd, at, x0, l0, bad, err);
    }
  } else {
#pragma unroll 2
    for (; m < hi; m += L.G) {
      if constexpr (FORM > 0) load_slots<N, GLOBAL>(L.code, L.pos, m, L.Mp, w, cd, at);
      clause_one<FORM, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, m, w, cd, at,
                                                  L.xs_src[m * L.ss], L.xl_src[m * L.ss], bad,
                                                  err);
    }
  }
}

// PASS over all of the thread's clauses, segment by segment, each in the
// register form its width takes: 3 (3-SAT), 4, and with WIDE also 6 and
// the loops. A segment (m0, m1, w, m_pad) has only padded clauses in
// [m_pad, m1): those are left out where padded clauses are fixed points.
template <int PASS, bool GLOBAL, bool PAPER, bool BF16, bool WIDE>
__device__ __forceinline__ void clause_passes(const Lane& L, const float* __restrict__ v,
                                              float* __restrict__ contrib, const int* segs,
                                              int nseg, bool& bad, float& err) {
  for (int q = 0; q < nseg; ++q) {
    const int lo = __ldg(segs + 4 * q), w = __ldg(segs + 4 * q + 2);
    const int hi = __ldg(segs + 4 * q + (L.skip_pad ? 3 : 1));
    if (w == 3) {
      clause_pass<3, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, lo, hi, 3, bad, err);
    } else if (w <= 4) {
      clause_pass<4, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, lo, hi, w, bad, err);
    } else if constexpr (WIDE) {
      if (w <= 6)
        clause_pass<6, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, lo, hi, w, bad, err);
      else
        clause_pass<0, PASS, GLOBAL, PAPER, BF16>(L, v, contrib, lo, hi, w, bad, err);
    }
  }
}

template <bool RESIDENT, bool FIXED, bool PAPER, bool BF16, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads)
    lanes_chunk_kernel(State st, Formula f, Scalars s, int B, int R, int lg_r, int chunk_steps) {
  constexpr bool GLOBAL = !RESIDENT;
  const int tid = static_cast<int>(threadIdx.x), T = static_cast<int>(blockDim.x);
  const int r = tid & (R - 1), grp = tid >> lg_r, G = T >> lg_r;
  const int tile_id = static_cast<int>(blockIdx.x);
  const int traj = tile_id * R + r;
  const bool valid = traj < B;
  const int Np = f.Np, Mp = f.Mp, KM = f.K * f.Mp;
  const unsigned all_lanes = R == 32 ? kFull : (1u << R) - 1u;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* unsat = reinterpret_cast<int*>(smem_raw);  // [3]
  int* errw = unsat + 3;                          // [3][R]
  float* base = reinterpret_cast<float*>(unsat + red_words(R));
  // RESIDENT: the tables are copied to the start of the tile's shared memory
  int* tab = reinterpret_cast<int*>(base);
  const int* code = RESIDENT ? tab : f.lit_code;
  const int* ptr = RESIDENT ? tab + KM : f.occ_ptr;
  const int* slot = RESIDENT ? tab + KM + Np + 1 : f.occ_slot;
  float *v, *hv = nullptr, *fv = nullptr, *contrib, *d1s = nullptr, *d1l = nullptr;
  ClauseIO io{};
  if constexpr (RESIDENT) {
    for (int j = tid; j < KM; j += T) tab[j] = f.lit_code[j];
    for (int j = tid; j <= Np; j += T) tab[KM + j] = f.occ_ptr[j];
    for (int j = tid; j < f.nnz; j += T) tab[KM + Np + 1 + j] = f.occ_slot[j];
    v = base + KM + Np + 1 + f.nnz;
    io.xs = v + Np * R;
    io.xl = io.xs + Mp * R;
    contrib = io.xl + Mp * R;
    if constexpr (!FIXED) {
      hv = contrib + KM * R;
      fv = hv + Np * R;
      d1s = fv + Np * R;
      d1l = d1s + Mp * R;
    }
    const float* xs_in = at_or(st.at, 1, st.xs_in);
    const float* xl_in = at_or(st.at, 2, st.xl_in);
    for (int j = tid; j < Mp * R; j += T) {
      const int m = j >> lg_r, t = tile_id * R + (j & (R - 1));
      io.xs[j] = t < B ? xs_in[static_cast<size_t>(t) * Mp + m] : 0.0f;
      io.xl[j] = t < B ? xl_in[static_cast<size_t>(t) * Mp + m] : 0.0f;
    }
  } else {
    v = base;
    if constexpr (!FIXED) hv = v + Np * R;
    float* sc = st.scratch + scratch_floats(FIXED, Np, Mp, f.nnz, R) * tile_id;
    io.xs = sc;
    io.xl = sc + Mp * R;
    contrib = io.xl + Mp * R;
    if constexpr (!FIXED) {
      d1s = contrib + static_cast<size_t>(f.nnz) * R;
      d1l = d1s + Mp * R;
      fv = d1l + Mp * R;
    }
    if (valid) {
      io.xs_row = at_or(st.at, 1, st.xs_in) + static_cast<size_t>(traj) * Mp;
      io.xl_row = at_or(st.at, 2, st.xl_in) + static_cast<size_t>(traj) * Mp;
      io.xs_orow = at_or(st.at, 1, st.xs_out) + static_cast<size_t>(traj) * Mp;
      io.xl_orow = at_or(st.at, 2, st.xl_out) + static_cast<size_t>(traj) * Mp;
    }
  }
  const float* v_in = at_or(st.at, 0, st.v_in);
  for (int j = tid; j < Np * R; j += T) {
    const int i = j >> lg_r, t = tile_id * R + (j & (R - 1));
    v[j] = t < B ? v_in[static_cast<size_t>(t) * Np + i] : 0.0f;
  }
  for (int j = tid; j < red_words(R); j += T) unsat[j] = 0;
  float dt = valid ? at_or(st.at, 3, st.dt_in)[traj] : 0.0f;
  // padded lanes are done
  unsigned done = lane_mask(!valid || at_or(st.at, 4, st.done_in)[traj] != 0, R);
  float* const xs_t = io.xs + r;  // the lane's column of the tile's (Mp, R) blocks
  float* const xl_t = io.xl + r;
  if (GLOBAL && !valid)  // a padded lane reads its tile column from the first step on
    for (int m = grp; m < Mp; m += G) xs_t[m * R] = xl_t[m * R] = 0.0f;
  __syncthreads();

  Lane L{code, f.slot_pos, Mp, R, r, G, grp, xs_t, xl_t, R, xs_t, xl_t, R, contrib, d1s, d1l,
         s.zeta, s.xl_cap, 0.0f, false, false, false};
  for (int step = 0; step < chunk_steps; ++step) {
    const int b = step % 3, b_next = (step + 1) % 3;
    if (tid == 0) unsat[b_next] = 0;  // read two steps ago, behind a barrier since
    if (tid < R) errw[b_next * R + tid] = 0;
    // where this step reads and writes the lane's clause memories: the tile
    // column, or (streamed, real lanes) the row-major input at the first
    // step and the row-major output at the last
    const bool last = step == chunk_steps - 1;
    const bool from_row = GLOBAL && valid && step == 0, to_row = GLOBAL && valid && last;
    L.xs_src = from_row ? io.xs_row : xs_t;
    L.xl_src = from_row ? io.xl_row : xl_t;
    L.ss = from_row ? 1 : R;
    L.xs_dst = to_row ? io.xs_orow : xs_t;
    L.xl_dst = to_row ? io.xl_orow : xl_t;
    L.ds = to_row ? 1 : R;
    L.moved = from_row || to_row;
    L.skip_pad = FIXED && step > 0 && !(GLOBAL && last);  // adaptive: a lane's first clamp comes late
    bool bad = false;
    float err = 0.0f;
    if constexpr (FIXED) {
      L.dt = ((done >> r) & 1u) ? 0.0f : s.dt_fixed;
      clause_passes<kFixedPass, GLOBAL, PAPER, BF16, WIDE>(L, v, contrib, f.segs, f.nseg, bad, err);
      const unsigned m_bad = lane_mask(bad, R);
      if ((tid & 31) == 0 && m_bad) atomicOr(reinterpret_cast<unsigned*>(unsat + b), m_bad);
      __syncthreads();  // contributions and flags published
      const unsigned allsat = all_lanes & ~static_cast<unsigned>(unsat[b]);
      for (int i = grp; i < Np; i += G) {
        const float dv = var_sum<GLOBAL>(ptr, slot, contrib, i, R, r);
        v[i * R + r] = clampf(v[i * R + r] + L.dt * dv, -1.0f, 1.0f);
      }
      done |= allsat;
      __syncthreads();  // v published; contributions free again
    } else {
      // pass 1: derivatives at (v, xs, xl); dxs, dxl parked in d1s, d1l
      L.dt = dt;
      clause_passes<kFirstPass, GLOBAL, PAPER, BF16, WIDE>(L, v, contrib, f.segs, f.nseg, bad, err);
      const unsigned m_bad = lane_mask(bad, R);
      if ((tid & 31) == 0 && m_bad) atomicOr(reinterpret_cast<unsigned*>(unsat + b), m_bad);
      __syncthreads();
      const unsigned allsat = all_lanes & ~static_cast<unsigned>(unsat[b]);
      const unsigned adv_mask = all_lanes & ~done & ~allsat;
      done |= allsat;
      L.adv = (adv_mask >> r) & 1u;
      if (adv_mask == 0) {  // no lane of the tile advances: the state stays
        if (L.moved)
          for (int m = grp; m < Mp; m += G) {
            L.xs_dst[m * L.ds] = L.xs_src[m * L.ss];
            L.xl_dst[m * L.ds] = L.xl_src[m * L.ss];
          }
        continue;
      }

      const float half = 0.5f * dt;
      if (L.adv)
        for (int i = grp; i < Np; i += G) {
          const float dv = var_sum<GLOBAL>(ptr, slot, contrib, i, R, r);
          const float vi = v[i * R + r];
          fv[i * R + r] = clampf(vi + dt * dv, -1.0f, 1.0f);
          hv[i * R + r] = clampf(vi + half * dv, -1.0f, 1.0f);
        }
      __syncthreads();  // hv published; contributions free again

      // pass 2: derivatives at the half step; two half steps are kept
      clause_passes<kSecondPass, GLOBAL, PAPER, BF16, WIDE>(L, hv, contrib, f.segs, f.nseg, bad,
                                                          err);
      __syncthreads();  // contributions published
      if (L.adv)
        for (int i = grp; i < Np; i += G) {
          const float dv = var_sum<GLOBAL>(ptr, slot, contrib, i, R, r);
          const float tv = clampf(hv[i * R + r] + half * dv, -1.0f, 1.0f);
          err = fmaxf(err, fabsf(fv[i * R + r] - tv));
          v[i * R + r] = tv;
        }
      publish_err(err, R, errw + b * R);
      __syncthreads();  // errors and v published
      if (L.adv) {
        const float e = __int_as_float(errw[b * R + r]);
        const float ratio = s.tol / fmaxf(e, 1e-30f);
        dt = clampf(dt * sqrtf(ratio), kDtMin, kDtMax);
      }
    }
  }

  float* const v_out = at_or(st.at, 0, st.v_out);
  for (int j = tid; j < Np * R; j += T) {
    const int i = j >> lg_r, t = tile_id * R + (j & (R - 1));
    if (t < B) v_out[static_cast<size_t>(t) * Np + i] = v[j];
  }
  if constexpr (RESIDENT) {
    float* const xs_out = at_or(st.at, 1, st.xs_out);
    float* const xl_out = at_or(st.at, 2, st.xl_out);
    for (int j = tid; j < Mp * R; j += T) {
      const int m = j >> lg_r, t = tile_id * R + (j & (R - 1));
      if (t < B) {
        xs_out[static_cast<size_t>(t) * Mp + m] = io.xs[j];
        xl_out[static_cast<size_t>(t) * Mp + m] = io.xl[j];
      }
    }
  }
  if (tid < R && valid) {
    const bool lane_done = (done >> r) & 1u;
    at_or(st.at, 3, st.dt_out)[traj] = dt;
    at_or(st.at, 4, st.done_out)[traj] = lane_done ? 1 : 0;
    if (st.stop != nullptr && lane_done != (st.stop_all != 0)) *st.stop = 1;
  }
}

// Shared-memory bytes of one CTA at R lanes. RESIDENT: the lane words, the
// tables and the tile state; streamed: the lane words and v (and hv).
inline size_t smem_bytes(bool resident, bool fixed, int Np, int Mp, int K, int nnz, int R) {
  const size_t KM = static_cast<size_t>(K) * Mp;
  size_t words = red_words(R);
  if (resident) {
    words += KM + (Np + 1) + nnz;
    words += static_cast<size_t>(R) * (Np + 2 * static_cast<size_t>(Mp) + KM +
                                       (fixed ? 0 : 2 * static_cast<size_t>(Np) + 2 * Mp));
  } else {
    words += static_cast<size_t>(R) * Np * (fixed ? 1 : 2);
  }
  return words * 4;
}

template <bool RESIDENT, bool FIXED, bool PAPER, bool BF16, bool WIDE>
int launch_w(const State& st, const Formula& f, const Scalars& s, int B, int R, int threads,
             int chunk_steps, size_t smem, cudaStream_t stream) {
  int lg = 0;
  while ((1 << lg) < R) ++lg;
  auto kernel = lanes_chunk_kernel<RESIDENT, FIXED, PAPER, BF16, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + R - 1) / R;
  kernel<<<tiles, threads, smem, stream>>>(st, f, s, B, R, lg, chunk_steps);
  return static_cast<int>(cudaGetLastError());
}

// The kernel with the clause forms the formula's widths need: 3 and 4
// only (kernels of fewer registers) when no segment is wider than 4.
template <bool RESIDENT, bool FIXED, bool PAPER, bool BF16>
int launch_one(const State& st, const Formula& f, const Scalars& s, int B, int R, int threads,
               int chunk_steps, size_t smem, cudaStream_t stream) {
  if (f.K <= 4)
    return launch_w<RESIDENT, FIXED, PAPER, BF16, false>(st, f, s, B, R, threads, chunk_steps,
                                                         smem, stream);
  return launch_w<RESIDENT, FIXED, PAPER, BF16, true>(st, f, s, B, R, threads, chunk_steps, smem,
                                                      stream);
}

// One chunk launch: checks R and the thread count, then dispatches the
// integrator, rigidity gate and rounding. Returns a cudaError_t code.
template <bool RESIDENT>
int launch(const State& st, const Formula& f, const Scalars& s, int B, int R, int threads,
           int chunk_steps, bool fixed, bool paper, bool bf16, size_t smem,
           cudaStream_t stream) {
  if (R < 1 || R > tile::kR || (R & (R - 1)) != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || B < 1 || chunk_steps < 1 || f.nseg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define ODESAT_LANES(F, P, H) \
  return launch_one<RESIDENT, F, P, H>(st, f, s, B, R, threads, chunk_steps, smem, stream)
  if (fixed) {
    if (paper) {
      if (bf16) ODESAT_LANES(true, true, true);
      ODESAT_LANES(true, true, false);
    }
    if (bf16) ODESAT_LANES(true, false, true);
    ODESAT_LANES(true, false, false);
  }
  if (paper) {
    if (bf16) ODESAT_LANES(false, true, true);
    ODESAT_LANES(false, true, false);
  }
  if (bf16) ODESAT_LANES(false, false, true);
  ODESAT_LANES(false, false, false);
#undef ODESAT_LANES
}

}  // namespace lanes
