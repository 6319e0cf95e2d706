// Stochastic-engine chunk for Hopper (sm_90a): kernels B3 and B4, and below
// them B9, the clause-sharded chunk's launches, and B8, one clause shard's
// evaluation, both over the tile layout of tile.cuh.
//
// B3 (stoch_fused_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_fused_stoch_chunk, B4 (stoch_stream_launch) replaces
// make_stream_stoch_chunk. Both advance every chain `chunk_steps` steps of
// clause-weighted local search in one launch, through one device code
// (stoch_lanes_kernel) that differs only in where the formula's index
// tables live: B3 copies them into shared memory once a CTA, B4 reads them
// through the read-only path, where they stay in L2 (330 KB for the
// preprocessed n=1k instance, too large for a CTA beside its chains). The
// TPU kernel B4 replaces streamed one-hot planes per 128-clause span with
// double-buffered DMA; none of that carries over, because Hopper gathers
// from shared memory and L2 where the TPU needed matmuls.
//
// Design: one CTA runs a tile of R chains (R a power of two, at most 32)
// for the whole launch. Its T threads form G = T/R groups of R lanes; lane
// r of every group takes chain tile*R + r, and group g takes the clauses
// m with m mod G = g and the variable positions g, g + G, ... (a snake:
// every other round of positions runs backwards over the groups). The
// tile's xl (int32) and v (bytes) live in shared memory interleaved
// [x][r], so a group's access to clause m or variable i is R neighbouring
// elements, and every table word a group reads serves R chains. The
// positions map to variables through a host-side order, longest
// occurrence list first, with the CSR lists stored in that order
// (ops/stoch_chunk.py::var_order, position_lists), so the groups of a warp
// walk lists of about the same length and a group reads a position's list
// bounds beside its variable.
//
// What bounds it on the card: instruction issue (each chain's own work on
// every clause and occurrence) and the latency of the gathers (table
// words, then the state they index), for B4 from L2; not device memory,
// which the state crosses once a launch. What the design does about it: a
// table word, its address and the loop around it serve R chains; B4 loads
// a pair of clauses' codes a pair ahead, and both kernels a position's
// variable and list bounds a position ahead.
//
// Each step, unless every lane of the tile is done:
//   clause phase   (groups over clauses, segment by segment: the formula's
//                  width buckets, ops/fused_chunk.py::clause_segments, each
//                  read at its width, in registers up to 8 slots, in loops
//                  past that): sat from the literal codes and the pre-flip
//                  v; for a lane that is not done, xl_new = sat ?
//                  max(xl-1, 1) : min(xl+20, 2^24), 0 for a padded clause,
//                  stored in place with its sign carrying "unsatisfied".
//                  A segment's trailing padded clauses are written at the
//                  launch's first step only (0 is a fixed point);
//   lane flags     "some clause of my chain is unsatisfied", folded onto R
//                  bits by a ballot a warp and one shared atomicOr (at
//                  R = 1 by the barrier's own OR);
//   variable phase (groups over variables, for the lanes that are neither
//                  done nor all-satisfied): total and unsat weight sums
//                  over the variable's CSR occurrence list in CSR order, in
//                  f32 (each weight rounded to bf16 first in bf16 mode);
//                  the counter-hash uniform u and a flip when
//                  u*total < unsat (u*total < 0 never holds, so unsat = 0
//                  never flips, and a variable in no clause has both 0);
//   then each lane's done latches from its pre-flip allsat.
// Done and allsat are facts of a lane: every thread holds the tile's R-bit
// done mask (the same on every thread). A done lane writes nothing, so its
// v and xl come out bit-identical; the tile leaves the loop when every lane
// is done. No float atomics: sums run in the plain version's CSR order, so
// kernel and plain agree bit for bit, and repeats are bit-identical.
//
// The PRNG is the TPU kernels' counter hash (stoch_pallas.py:42-67), all
// uint32 arithmetic that wraps: with chain g = i*Bb + r under the Pallas
// blocking (block index i, row r, Bb from the wrapper),
//   x = r*0x9E3779B1 ^ c*0x85EBCA77 ^ (seed + i*0x632BE59B + t*0xC2B2AE3D)
// for variable column c and step t within the launch, then the murmur3
// finalizer, u = (x >> 8) * 2^-24.
//
// The kernel reads the row-major (B, .) state into its layout at entry and
// writes it back (xl as its absolute value) at exit; a ragged last tile has
// done lanes that read and write nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// bound through the plain C entry points at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bfly_tree.cuh"
#include "tile.cuh"

namespace {

constexpr int kAlpha = 20;        // STOCH_ALPHA
constexpr int kXlCap = 1 << 24;   // XL_CAP
constexpr int kLaneThreads = 1024;  // threads a CTA of B3 and B4 at most

struct Formula {
  const int* lit_code;    // (K, Mp): 2*var + (negated ? 1 : 0), -1 at padding
  const int* occ_ptr;     // (Np + 1) CSR row pointers over occ_clause
  const int* occ_clause;  // (nnz) clause column m of each occurrence
  int Np, Mp, K, nnz;
};

// A table read: shared memory for B3, the read-only data path for B4.
template <bool RESIDENT>
__device__ __forceinline__ int table(const int* p, int j) {
  if constexpr (RESIDENT) {
    return p[j];
  } else {
    return __ldg(p + j);
  }
}

// murmur3's 32-bit finalizer
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <bool BF16>
__device__ __forceinline__ float weight(int w) {
  const float a = static_cast<float>(w < 0 ? -w : w);  // exact: |w| <= 2^24
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(a));  // round to nearest even
  } else {
    return a;
  }
}

// B3's and B4's formula: the tables, whose CSR lists run in position
// order (position p's list is variable order[p]'s, in its CSR order), the
// order (Np) and the clause segments (nseg, 4): ranges [m0, m1) whose
// slots lie below width w, padded clauses only from m_pad on.
struct LaneFormula {
  Formula f;
  const int* order;
  const int* segs;
  int nseg;
};

// Shared words of the lane flags at the start of a CTA's shared memory:
// "some clause unsatisfied" masks by step parity; none at R = 1, where the
// barrier's own OR carries the one lane's flag.
__host__ __device__ inline int flag_words(int R) { return R > 1 ? 2 : 0; }

// Shared-memory bytes of one CTA at R lanes: the flags, the tables
// (RESIDENT), the tile's xl (int32) and v (bytes).
inline size_t lanes_smem_bytes(bool resident, int Np, int Mp, int K, int nnz, int R) {
  size_t words = flag_words(R) + static_cast<size_t>(R) * Mp;
  if (resident) words += static_cast<size_t>(K) * Mp + (Np + 1) + nnz;
  return 4 * words + static_cast<size_t>(R) * Np;
}

// What a thread's clause phase reads and writes.
struct Lane {
  const int* code;
  int Mp, R, r, G, grp;
  const uint8_t* v;  // the tile's (Np, R) bytes
  int* xl;           // the tile's (Mp, R) words
  bool active;       // the lane's chain is not done
};

// Clause m's new weight on lane r from its sat, in place: the sign carries
// "unsatisfied" to the variable phase.
__device__ __forceinline__ void weigh(int* x, bool sat) {
  const int w = *x;
  const int a = w < 0 ? -w : w;
  *x = sat ? max(a - 1, 1) : -min(a + kAlpha, kXlCap);
}

// The literal codes of clause m's first N slots, -1 from slot w on.
template <int N, bool RESIDENT>
__device__ __forceinline__ void load_codes(const int* code, int Mp, int m, int w, int (&cd)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) cd[k] = k < w ? table<RESIDENT>(code + k * Mp, m) : -1;
}

// A lane's literal code c is true on its v byte b.
__device__ __forceinline__ bool lit_true(int b, int c) { return ((b ^ c) & 1) != 0; }

// Clause m from its codes: a padded clause (slot 0 empty) takes weight 0;
// a real one its sat, from every slot's byte read at once (a padding slot,
// code -1, reads a byte of the word before v and ignores it; sat is an OR,
// so slot order does not matter).
template <int N>
__device__ __forceinline__ void clause_one(const Lane& L, int m, const int (&cd)[N], bool& bad) {
  int* x = L.xl + m * L.R + L.r;
  if (cd[0] < 0) {
    if (L.active) *x = 0;
    return;
  }
  bool sat = false;
#pragma unroll
  for (int k = 0; k < N; ++k)
    sat |= (cd[k] >= 0) & lit_true(L.v[(cd[k] >> 1) * L.R + L.r], cd[k]);
  if (!L.active) return;
  weigh(x, sat);
  if (!sat) bad = true;
}

// The thread's clauses of [lo, hi), whose slots lie below w: in registers
// for w <= N, two clauses' codes loaded together ahead of their work (from
// L2 for N <= 4 the next pair's too, while this pair is computed), in loops
// for N = 0. Clause m belongs to group m mod G.
template <int N, bool RESIDENT>
__device__ __forceinline__ void clause_range(const Lane& L, int lo, int hi, int w, bool& bad) {
  const int G = L.G;
  int m = lo + ((L.grp - lo) % G + G) % G;
  if constexpr (N == 0) {
    for (; m < hi; m += G) {
      int* x = L.xl + m * L.R + L.r;
      const int c0 = table<RESIDENT>(L.code, m);
      if (c0 < 0) {
        if (L.active) *x = 0;
        continue;
      }
      bool sat = lit_true(L.v[(c0 >> 1) * L.R + L.r], c0);
      for (int k = 1; k < w; ++k) {
        const int c = table<RESIDENT>(L.code + k * L.Mp, m);
        if (c >= 0) sat |= lit_true(L.v[(c >> 1) * L.R + L.r], c);
      }
      if (!L.active) continue;
      weigh(x, sat);
      if (!sat) bad = true;
    }
  } else if constexpr (RESIDENT || N > 4) {
    int a[N], b[N];
    for (; m < hi; m += 2 * G) {
      load_codes<N, RESIDENT>(L.code, L.Mp, m, w, a);
      load_codes<N, RESIDENT>(L.code, L.Mp, m + G, m + G < hi ? w : 0, b);
      clause_one<N>(L, m, a, bad);
      if (m + G < hi) clause_one<N>(L, m + G, b, bad);
    }
  } else {
    int a[N], b[N], na[N], nb[N];
    load_codes<N, false>(L.code, L.Mp, m, m < hi ? w : 0, na);
    load_codes<N, false>(L.code, L.Mp, m + G, m + G < hi ? w : 0, nb);
    for (; m < hi; m += 2 * G) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        a[k] = na[k];
        b[k] = nb[k];
      }
      load_codes<N, false>(L.code, L.Mp, m + 2 * G, m + 2 * G < hi ? w : 0, na);
      load_codes<N, false>(L.code, L.Mp, m + 3 * G, m + 3 * G < hi ? w : 0, nb);
      clause_one<N>(L, m, a, bad);
      if (m + G < hi) clause_one<N>(L, m + G, b, bad);
    }
  }
}

// The clause phase over every segment in the form its width takes; after
// the launch's first step a segment's trailing padded clauses are left out.
template <bool RESIDENT>
__device__ __forceinline__ void clause_phase(const Lane& L, const int* segs, int nseg, bool first,
                                             bool& bad) {
  for (int q = 0; q < nseg; ++q) {
    const int lo = __ldg(segs + 4 * q), w = __ldg(segs + 4 * q + 2);
    const int hi = __ldg(segs + 4 * q + (first ? 1 : 3));
    if (w <= 3) {
      clause_range<3, RESIDENT>(L, lo, hi, w, bad);
    } else if (w == 4) {
      clause_range<4, RESIDENT>(L, lo, hi, w, bad);
    } else if (w <= 8) {
      clause_range<8, RESIDENT>(L, lo, hi, w, bad);
    } else {
      clause_range<0, RESIDENT>(L, lo, hi, w, bad);
    }
  }
}

// Lane r's total and unsat weight over the occurrences [j, end) of a
// variable, in list order: the loads batched four at a time ahead of their
// adds. Past the list a batch reads weight 0, which adds nothing.
template <bool RESIDENT, bool BF16>
__device__ __forceinline__ void var_sums(const int* occ, int j, int end, const int* xl, int R,
                                         int r, float& total, float& unsat) {
  constexpr int U = 4;
  for (; j < end; j += U) {
    int w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = j + u < end ? xl[table<RESIDENT>(occ, j + u) * R + r] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = weight<BF16>(w[u]);
      total += a;
      if (w[u] < 0) unsat += a;
    }
  }
}

template <bool RESIDENT, bool BF16>
__global__ void __launch_bounds__(kLaneThreads)
    stoch_lanes_kernel(const uint8_t* __restrict__ v_in, const int* __restrict__ xl_in,
                       const uint8_t* __restrict__ done_in, uint8_t* __restrict__ v_out,
                       int* __restrict__ xl_out, uint8_t* __restrict__ done_out, LaneFormula lf,
                       int B, int R, int lg_r, int chunk_steps, uint32_t seed, int Bb) {
  const Formula& f = lf.f;
  const int tid = static_cast<int>(threadIdx.x), T = static_cast<int>(blockDim.x);
  const int r = tid & (R - 1), grp = tid >> lg_r, G = T >> lg_r;
  const int tile_id = static_cast<int>(blockIdx.x), chain = tile_id * R + r;
  const int Np = f.Np, Mp = f.Mp, KM = f.K * f.Mp;
  const unsigned all_lanes = R == 32 ? tile::kFull : (1u << R) - 1u;

  // carve-up (lanes_smem_bytes): flags, [code, ptr, occ if RESIDENT], xl, v
  extern __shared__ __align__(16) int lane_smem[];
  unsigned* flags = reinterpret_cast<unsigned*>(lane_smem);
  int* tab = lane_smem + flag_words(R);
  const int* code = f.lit_code;
  const int* ptr = f.occ_ptr;
  const int* occ = f.occ_clause;
  int* xl = tab;
  if constexpr (RESIDENT) {
    for (int j = tid; j < KM; j += T) tab[j] = f.lit_code[j];
    for (int j = tid; j <= Np; j += T) tab[KM + j] = f.occ_ptr[j];
    for (int j = tid; j < f.nnz; j += T) tab[KM + Np + 1 + j] = f.occ_clause[j];
    code = tab;
    ptr = tab + KM;
    occ = tab + KM + Np + 1;
    xl = tab + KM + Np + 1 + f.nnz;
  }
  uint8_t* v = reinterpret_cast<uint8_t*>(xl + static_cast<size_t>(R) * Mp);
  for (int q = 0; q < R; ++q) {  // the lanes' rows, read along the row; padded lanes zero
    const int g = tile_id * R + q;
    if (g < B) {
      const int* xrow = xl_in + static_cast<size_t>(g) * Mp;
      const uint8_t* vrow = v_in + static_cast<size_t>(g) * Np;
      for (int m = tid; m < Mp; m += T) xl[m * R + q] = xrow[m];
      for (int i = tid; i < Np; i += T) v[i * R + q] = vrow[i];
    } else {
      for (int m = tid; m < Mp; m += T) xl[m * R + q] = 0;
      for (int i = tid; i < Np; i += T) v[i * R + q] = 0;
    }
  }
  if (tid < flag_words(R)) flags[tid] = 0;
  unsigned done = tile::lane_mask(chain >= B || done_in[chain] != 0, R);  // padded lanes are done
  __syncthreads();

  const uint32_t row_term = static_cast<uint32_t>(chain % Bb) * 0x9E3779B1u;
  const uint32_t block_seed = seed + static_cast<uint32_t>(chain / Bb) * 0x632BE59Bu;
  Lane L{code, Mp, R, r, G, grp, v, xl, false};
  for (int t = 0; t < chunk_steps && done != all_lanes; ++t) {
    L.active = !((done >> r) & 1u);
    bool bad = false;
    clause_phase<RESIDENT>(L, lf.segs, lf.nseg, t == 0, bad);
    unsigned unsat;
    if (R == 1) {
      unsat = __syncthreads_or(bad) ? 1u : 0u;  // xl published
    } else {
      const unsigned m_bad = tile::lane_mask(bad, R);
      if ((tid & 31) == 0 && m_bad) atomicOr(flags + (t & 1), m_bad);
      __syncthreads();  // xl and flags published
      unsat = flags[t & 1];
      if (tid == 0) flags[(t & 1) ^ 1] = 0;  // read a step ago, behind two barriers since
    }
    const unsigned allsat = all_lanes & ~unsat;
    if (((~done & ~allsat) >> r) & 1u) {  // the lane's chain may flip
      const uint32_t step_term = block_seed + static_cast<uint32_t>(t) * 0xC2B2AE3Du;
      // position p of round q; a round past Np ends the group's walk
      auto position = [&](int k) { return k * G + ((k & 1) ? G - 1 - grp : grp); };
      int q = 0, p = position(0), i = 0, j0 = 0, j1 = 0;
      if (p < Np) {
        i = __ldg(lf.order + p);
        j0 = table<RESIDENT>(ptr, p);
        j1 = table<RESIDENT>(ptr, p + 1);
      }
      while (p < Np) {
        const int vi = i, a = j0, b = j1;
        p = position(++q);
        if (p < Np) {  // the next position's variable and list, loaded ahead
          i = __ldg(lf.order + p);
          j0 = table<RESIDENT>(ptr, p);
          j1 = table<RESIDENT>(ptr, p + 1);
        }
        uint8_t* vb = v + vi * R + r;
        const int was = *vb;
        float total = 0.0f, uns = 0.0f;
        var_sums<RESIDENT, BF16>(occ, a, b, xl, R, r, total, uns);
        // every lane draws and stores: a branch on unsat > 0 would diverge
        // within the warp and cost more than the draw (u*total < 0 never
        // holds, so unsat = 0 never flips)
        const uint32_t x = mix(row_term ^ (static_cast<uint32_t>(vi) * 0x85EBCA77u) ^ step_term);
        const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
        *vb = (was & 1) ^ (u * total < uns ? 1 : 0);
      }
    }
    done |= allsat;
    __syncthreads();  // v published; xl free again
  }

  for (int q = 0; q < R; ++q) {
    const int g = tile_id * R + q;
    if (g >= B) break;
    int* xrow = xl_out + static_cast<size_t>(g) * Mp;
    uint8_t* vrow = v_out + static_cast<size_t>(g) * Np;
    for (int m = tid; m < Mp; m += T) {
      const int w = xl[m * R + q];
      xrow[m] = w < 0 ? -w : w;
    }
    for (int i = tid; i < Np; i += T) vrow[i] = v[i * R + q];
  }
  if (tid < R && chain < B) done_out[chain] = (done >> r) & 1u;
}

// B9 (stoch_shard_step_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_stoch_shard_chunk (:868): the clause-sharded stoch chunk whose
// (total, unsat, sat) all-reduce the TPU kernel ran inside itself over ICI
// remote DMA (B7). On Hopper the chunk is a sequence of launches with the
// all-reduce fused into them, and everything else the TPU kernel did runs
// in them too: each launch first applies the previous step's sums (the flip
// u*total < unsat with the counter-hash uniform of that step, for a chain
// that was active, then done |= allsat), reading the S ranks' partials of
// that step (bfly::Parts: this rank's slot and the peers' IPC-mapped slots,
// made final by a stream wait on their flags; at S = 1 its own `acc`) and
// summing them in the butterfly's tree as it reads them (bfly_tree.cuh),
// then evaluates the shard for step t (the sat of each clause, the weight
// update, the weight sums), writing its partials into acc = (total | unsat
// | 1 - sat), this launch's slot on a clause mesh, and its weights in
// place. A chunk of n steps is n such launches and one apply-only launch
// (evaluate = 0). `done` in device memory between launches is the done the
// last evaluation ran with.
//
// Design: the buffers are in the tile layout of tile.cuh, R chains a tile:
// v (G, Np, R) bytes, xl and the signed post-update weights w (G, Mp, R)
// int32, acc (G, 2*Np+1, R), done (G, R). A lane group reads each table
// word once for R chains, and each gather of v or w moves R useful words;
// nothing of a chain lives in shared memory. A launch is up to four
// kernels on the stream, each over (tile, span) except the head:
//   flip    the previous step's flips, over variables, four chains a thread
//           (16-byte reads of each partial, a warp on whole rows);
//   head    one thread a chain: the done latch; the sat flag cleared;
//   clause  over clauses: sat from v, the weight update into w, xl <- |w|
//           for a chain that is not done (a done chain keeps its xl
//           verbatim), the sat flag;
//   var     over variables: total and unsat sums of w over the local CSR
//           list in a fixed order.
// What bounds it: device-memory bytes (xl and w written, xl, w and v read,
// the partials written every step and S of them read) and the gathers of w
// through L2.
//
// B8 (stoch_shard_eval_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_stoch_shard_eval (:605): one step's evaluation over one clause
// shard, for the `--shard-chunk off` path, whose caller all-reduces the
// partials and the sat flag over the clause group and then draws the flips
// in torch (parallel/sharded.py). A B8 launch is B9's launch without the
// flip prologue: head (the sat flag cleared), clause and var over the same
// tiled buffers, into the same acc = (total | unsat | 1 - sat). A chain
// that is done (not active) keeps its xl verbatim; padded clauses weigh 0;
// unit clauses are taken. What bounds it: as for B9.
// The previous step's flips over variables, from the S ranks' partials of
// its evaluation (total | unsat | 1 - sat), added in the butterfly's tree
// as they are read: a thread takes four neighbouring chains of a tile row
// (16-byte reads of each partial, R/4 threads a row). S: 1, 2, 4 at
// compile time, 0 at run time (red.s).
template <int R, int S>
__global__ void __launch_bounds__(tile::kThreads)
    stoch_tile_flip_kernel(uint8_t* __restrict__ v, const bfly::Parts red,
                           const uint8_t* __restrict__ done, int Np, uint32_t seed, int Bb,
                           int t) {
  constexpr int kPerRow = R / 4, kRows = tile::kThreads / kPerRow;
  const int g = blockIdx.x, r0 = 4 * (static_cast<int>(threadIdx.x) % kPerRow);
  const size_t chain0 = static_cast<size_t>(g) * R + r0;
  const uchar4 d = *reinterpret_cast<const uchar4*>(done + chain0);
  if (d.x && d.y && d.z && d.w) return;  // a done chain does not flip
  const bool live[4] = {!d.x, !d.y, !d.z, !d.w};
  uint32_t row_term[4], step_term[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int chain = static_cast<int>(chain0) + c;
    row_term[c] = static_cast<uint32_t>(chain % Bb) * 0x9E3779B1u;
    step_term[c] = seed + static_cast<uint32_t>(chain / Bb) * 0x632BE59Bu +
                   static_cast<uint32_t>(t - 1) * 0xC2B2AE3Du;
  }
  uint8_t* vt = v + static_cast<size_t>(g) * Np * R + r0;
  const size_t a = static_cast<size_t>(g) * (2 * Np + 1) * R + r0;
  const int per = (Np + static_cast<int>(gridDim.y) - 1) / static_cast<int>(gridDim.y);
  const int lo = static_cast<int>(blockIdx.y) * per, hi = min(Np, lo + per);
  for (int i = lo + static_cast<int>(threadIdx.x) / kPerRow; i < hi; i += kRows) {
    const size_t k = static_cast<size_t>(i) * R;
    const float4 tot4 = bfly::at4<S>(red, a + k);
    const float4 uns4 = bfly::at4<S>(red, a + static_cast<size_t>(Np) * R + k);
    const float tot[4] = {tot4.x, tot4.y, tot4.z, tot4.w};
    const float uns[4] = {uns4.x, uns4.y, uns4.z, uns4.w};
    uchar4 x4 = *reinterpret_cast<const uchar4*>(vt + k);
    uint8_t x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t h = mix(row_term[c] ^ (static_cast<uint32_t>(i) * 0x85EBCA77u) ^ step_term[c]);
      const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
      if (live[c] && u * tot[c] < uns[c]) x[c] ^= 1;
    }
    *reinterpret_cast<uchar4*>(vt + k) = make_uchar4(x[0], x[1], x[2], x[3]);
  }
}

// One thread a chain, after flip (`apply`: the done latch from the sat
// counts, word 2*Np of the red partials, summed) or alone; `evaluate` clears
// the flag of `acc` for the evaluation that follows (at S = 1 red's one
// partial may be `acc`: read before cleared).
__global__ void stoch_tile_head_kernel(const bfly::Parts red, float* acc,
                                       uint8_t* __restrict__ done, int Np, int R, int n,
                                       int apply, int evaluate) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t flag = (static_cast<size_t>(t / R) * (2 * Np + 1) + 2 * Np) * R + t % R;
  if (apply) done[t] = (done[t] || bfly::word(red, flag) == 0.0f) ? 1 : 0;
  if (evaluate) acc[flag] = 0.0f;
}

template <int R>
__global__ void __launch_bounds__(tile::kThreads)
    stoch_tile_clause_kernel(const uint8_t* __restrict__ v, int* __restrict__ xl,
                             int* __restrict__ w, const uint8_t* __restrict__ done,
                             float* __restrict__ acc, Formula f) {
  __shared__ int s_unsat[R];
  const int g = blockIdx.x, r = tile::lane<R>();
  const int Np = f.Np, Mp = f.Mp, K = f.K;
  if (threadIdx.x < R) s_unsat[threadIdx.x] = 0;
  __syncthreads();
  const bool active = !done[g * R + r];
  const uint8_t* vt = v + static_cast<size_t>(g) * Np * R;
  const size_t c0 = static_cast<size_t>(g) * Mp * R;
  int unsat = 0;
  tile::for_items<R>(Mp, [&](int m) {
    const size_t k = c0 + static_cast<size_t>(m) * R + r;
    const int c = __ldg(f.lit_code + m);
    int wm = 0;  // padded clause: weight 0, never unsatisfied
    if (c >= 0) {
      bool sat = false;
      for (int j = 0; j < K; ++j) {
        const int cj = j ? __ldg(f.lit_code + static_cast<size_t>(j) * Mp + m) : c;
        if (cj < 0) break;  // literal slots of a clause are a prefix
        sat |= __ldg(vt + static_cast<size_t>(cj >> 1) * R + r) != (cj & 1);
      }
      const int x = xl[k];
      wm = sat ? max(x - 1, 1) : -min(x + kAlpha, kXlCap);
      unsat |= !sat;
    }
    w[k] = wm;
    if (active) xl[k] = wm < 0 ? -wm : wm;
  });
  if (unsat) s_unsat[r] = 1;
  __syncthreads();
  if (threadIdx.x < R && s_unsat[threadIdx.x])
    acc[(static_cast<size_t>(g) * (2 * Np + 1) + 2 * Np) * R + threadIdx.x] = 1.0f;
}

template <int R, bool BF16>
__global__ void __launch_bounds__(tile::kThreads)
    stoch_tile_var_kernel(const int* __restrict__ w, float* __restrict__ acc, Formula f) {
  const int g = blockIdx.x, r = tile::lane<R>();
  const int Np = f.Np;
  const int* wt = w + static_cast<size_t>(g) * f.Mp * R;
  float* at = acc + static_cast<size_t>(g) * (2 * Np + 1) * R;
  tile::for_items<R>(Np, [&](int i) {
    const int j1 = __ldg(f.occ_ptr + i + 1);
    float total = 0.0f, unsat = 0.0f;
    for (int j = __ldg(f.occ_ptr + i); j < j1; ++j) {
      const int wj = __ldg(wt + static_cast<size_t>(__ldg(f.occ_clause + j)) * R + r);
      const float x = weight<BF16>(wj);
      total += x;
      if (wj < 0) unsat += x;
    }
    at[static_cast<size_t>(i) * R + r] = total;
    at[static_cast<size_t>(Np + i) * R + r] = unsat;
  });
}

template <int R>
int stoch_tile_step(uint8_t* v, int* xl, uint8_t* done, const bfly::Parts& red, float* acc,
                    int* w, const Formula& f, int G, bool bf16, uint32_t seed, int Bb, int t,
                    bool apply, bool evaluate, cudaStream_t st) {
  const dim3 vgrid = tile::grid(G, R, f.Np);
  if (apply) {
#define ODESAT_FLIP(S) \
  stoch_tile_flip_kernel<R, S><<<vgrid, tile::kThreads, 0, st>>>(v, red, done, f.Np, seed, Bb, t)
    switch (red.s) {
      case 1: ODESAT_FLIP(1); break;
      case 2: ODESAT_FLIP(2); break;
      case 4: ODESAT_FLIP(4); break;
      default: ODESAT_FLIP(0); break;
    }
#undef ODESAT_FLIP
  }
  const int n = G * R;
  stoch_tile_head_kernel<<<(n + tile::kThreads - 1) / tile::kThreads, tile::kThreads, 0, st>>>(
      red, acc, done, f.Np, R, n, apply, evaluate);
  if (evaluate) {
    stoch_tile_clause_kernel<R><<<tile::grid(G, R, f.Mp), tile::kThreads, 0, st>>>(v, xl, w, done,
                                                                                   acc, f);
    if (bf16)
      stoch_tile_var_kernel<R, true><<<vgrid, tile::kThreads, 0, st>>>(w, acc, f);
    else
      stoch_tile_var_kernel<R, false><<<vgrid, tile::kThreads, 0, st>>>(w, acc, f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

// One launch of B3 (RESIDENT) or B4: checks R, the threads and the
// segments, then asks for the CTA's shared memory. Returns a cudaError_t
// code (0 = launched).
template <bool RESIDENT>
int lanes_launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in, uint8_t* v_out,
                 int* xl_out, uint8_t* done_out, const LaneFormula& lf, int B, int chunk_steps,
                 uint32_t seed, int Bb, bool bf16, int R, int threads, cudaStream_t stream) {
  if (R < 1 || R > tile::kR || (R & (R - 1)) != 0 || threads < 32 || threads > kLaneThreads ||
      threads % 32 != 0 || B < 1 || chunk_steps < 0 || Bb < 1 || lf.nseg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int lg = 0;
  while ((1 << lg) < R) ++lg;
  const Formula& f = lf.f;
  const size_t smem = lanes_smem_bytes(RESIDENT, f.Np, f.Mp, f.K, f.nnz, R);
  auto kernel = bf16 ? stoch_lanes_kernel<RESIDENT, true> : stoch_lanes_kernel<RESIDENT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + R - 1) / R, threads, smem, stream>>>(v_in, xl_in, done_in, v_out, xl_out,
                                                     done_out, lf, B, R, lg, chunk_steps, seed, Bb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs at R lanes; the Python gates compute the
// same numbers (ops/stoch_chunk.py). B3: the lane flags, the tables, then R
// lanes of xl (int32) and v (bytes); at R = 1 exactly the one-CTA-a-chain
// kernel's carve-up, tables, xl and v.
size_t stoch_fused_smem_bytes(int Np, int Mp, int K, int nnz, int R) {
  return lanes_smem_bytes(true, Np, Mp, K, nnz, R);
}

// B4: the lane flags and R lanes of xl and v; the tables stay in global memory.
size_t stoch_stream_smem_bytes(int Np, int Mp, int R) {
  return lanes_smem_bytes(false, Np, Mp, 0, 0, R);
}

// Both take the CSR lists in position order (occ_ptr, occ_clause: position
// p's list is variable order[p]'s, ops/stoch_chunk.py::position_lists),
// `order` (Np) and `segs` (nseg, 4), the clause segments
// (ops/fused_chunk.py::clause_segments), at R lanes a CTA of `threads`
// threads. Both return a cudaError_t code (0 = launched).
int stoch_fused_launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in,
                       uint8_t* v_out, int* xl_out, uint8_t* done_out, const int* lit_code,
                       const int* occ_ptr, const int* occ_clause, const int* order,
                       const int* segs, int nseg, int B, int Np, int Mp, int K, int nnz,
                       int chunk_steps, unsigned int seed, int Bb, int bf16, int R, int threads,
                       void* stream) {
  const LaneFormula lf{{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz}, order, segs, nseg};
  return lanes_launch<true>(v_in, xl_in, done_in, v_out, xl_out, done_out, lf, B, chunk_steps,
                            seed, Bb, bf16 != 0, R, threads, static_cast<cudaStream_t>(stream));
}

int stoch_stream_launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in,
                        uint8_t* v_out, int* xl_out, uint8_t* done_out, const int* lit_code,
                        const int* occ_ptr, const int* occ_clause, const int* order,
                        const int* segs, int nseg, int B, int Np, int Mp, int K, int nnz,
                        int chunk_steps, unsigned int seed, int Bb, int bf16, int R, int threads,
                        void* stream) {
  const LaneFormula lf{{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz}, order, segs, nseg};
  return lanes_launch<false>(v_in, xl_in, done_in, v_out, xl_out, done_out, lf, B, chunk_steps,
                             seed, Bb, bf16 != 0, R, threads, static_cast<cudaStream_t>(stream));
}

// B8: one evaluation (see stoch_tile_step, with no flip) on buffers in the
// tile layout with R = tile::kR chains a tile: v (G, Np, R) bytes, xl and
// the weight scratch w (G, Mp, R) int32, done (G, R), acc (G, 2*Np+1, R).
// Returns a cudaError_t code.
int stoch_shard_eval_launch(uint8_t* v, int* xl, uint8_t* done, float* acc, int* w,
                            const int* lit_code, const int* occ_ptr, const int* occ_clause,
                            int G, int R, int Np, int Mp, int K, int nnz, int bf16,
                            void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  if (G < 1 || R != tile::kR) return static_cast<int>(cudaErrorInvalidValue);
  bfly::Parts none{};
  return stoch_tile_step<tile::kR>(v, xl, done, none, acc, w, f, G, bf16 != 0, 0u, 1, 0, false,
                                   true, static_cast<cudaStream_t>(stream));
}

// B9: one launch of the chunk (see stoch_tile_step) on buffers in the tile
// layout with R = tile::kR chains a tile; `acc` (the partials written when
// `evaluate`) and red[0..s), the S ranks' partials of the previous step
// (rank order; read, and summed in the butterfly's tree, when `apply`; at
// S = 1 `acc` itself), are (G, 2*Np+1, R), 16-byte aligned, as are v and
// done (4-byte); `w` is the chunk's (G, Mp, R) int32 scratch. Returns a
// cudaError_t code.
int stoch_shard_step_launch(uint8_t* v, int* xl, uint8_t* done, const float* const* red, int s,
                            float* acc, int* w, const int* lit_code, const int* occ_ptr,
                            const int* occ_clause, int G, int R, int Np, int Mp, int K, int nnz,
                            int bf16, unsigned int seed, int Bb, int t, int apply, int evaluate,
                            void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || R != tile::kR || s < 1 || s > bfly::kMaxRanks || red == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bfly::Parts p{};
  p.s = s;
  bool ok = reinterpret_cast<size_t>(v) % 16 == 0 && reinterpret_cast<size_t>(done) % 4 == 0;
  for (int k = 0; k < s; ++k) {
    p.p[k] = red[k];
    ok = ok && reinterpret_cast<size_t>(red[k]) % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  return stoch_tile_step<tile::kR>(v, xl, done, p, acc, w, f, G, bf16 != 0, seed, Bb, t,
                                   apply != 0, evaluate != 0, st);
}

const char* stoch_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
