// Stochastic-engine chunk for Hopper (sm_90a): kernels B3 and B4, B8, one
// clause shard's evaluation (below B4), and B9, the clause-sharded chunk's
// launches (below B8).
//
// B3 (stoch_fused_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_fused_stoch_chunk, B4 (stoch_stream_launch) replaces
// make_stream_stoch_chunk. Both advance every chain `chunk_steps` steps of
// clause-weighted local search in one launch, one CTA per chain, with the
// chain's state (v, xl) resident in shared memory, so the state crosses
// device memory once per chunk. They differ only in where the formula's
// index tables live: B3 copies them into shared memory, B4 reads them from
// global memory (read-only, L2-resident: 330 KB for the preprocessed n=1k
// instance, too large for one CTA). The TPU kernel B4 replaces streamed
// one-hot planes per 128-clause span with double-buffered DMA; none of
// that carries over, because Hopper gathers from shared memory and L2
// where the TPU needed matmuls.
//
// What bounds it on the card: shared-memory gathers and two block
// barriers per step (B3), plus L2 reads of the tables (B4); not HBM.
//
// Each step, for a chain that is not done:
//   clause phase   (threads over clauses m): sat from the literal codes and
//                  the pre-flip v; xl_new = sat ? max(xl-1, 1)
//                  : min(xl+20, 2^24), 0 for a padded clause; stored in
//                  place with its sign carrying "unsatisfied";
//   block AND      (__syncthreads_and) of sat over the real clauses;
//   variable phase (threads over variables i): total and unsat weight sums
//                  over i's CSR occurrence list in a fixed order, in f32
//                  (each weight rounded to bf16 first in bf16 mode), the
//                  counter-hash uniform u, and a flip when
//                  u*total < unsat and i occurs in some clause;
//   then done latches from the pre-flip allsat and the chain stops.
// No float atomics: sums run in the plain version's CSR order, so kernel
// and plain agree bit for bit, and repeats are bit-identical.
//
// The PRNG is the TPU kernels' counter hash (stoch_pallas.py:42-67), all
// uint32 arithmetic that wraps: with chain g = i*Bb + r under the Pallas
// blocking (block index i, row r, Bb from the wrapper),
//   x = r*0x9E3779B1 ^ c*0x85EBCA77 ^ (seed + i*0x632BE59B + t*0xC2B2AE3D)
// for variable column c and step t within the launch, then the murmur3
// finalizer, u = (x >> 8) * 2^-24.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false,
// bound through the plain C entry points at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAlpha = 20;        // STOCH_ALPHA
constexpr int kXlCap = 1 << 24;   // XL_CAP

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

template <bool RESIDENT, bool BF16>
__global__ void stoch_chunk_kernel(
    const uint8_t* __restrict__ v_in, const int* __restrict__ xl_in,
    const uint8_t* __restrict__ done_in, uint8_t* __restrict__ v_out,
    int* __restrict__ xl_out, uint8_t* __restrict__ done_out, Formula f, int B,
    int chunk_steps, uint32_t seed, int Bb) {
  const int chain = blockIdx.x;
  if (chain >= B) return;  // ragged edge: no padded rows
  const int Np = f.Np, Mp = f.Mp, K = f.K, KM = f.K * f.Mp;
  const int tid = threadIdx.x, T = blockDim.x;

  // carve-up (stoch_chunk_smem_bytes): [code, ptr, occ if RESIDENT] xl v
  extern __shared__ int smem[];
  const int* code;
  const int* ptr;
  const int* occ;
  int* xl;
  if constexpr (RESIDENT) {
    int* s_code = smem;
    int* s_ptr = s_code + KM;
    int* s_occ = s_ptr + (Np + 1);
    for (int j = tid; j < KM; j += T) s_code[j] = f.lit_code[j];
    for (int j = tid; j <= Np; j += T) s_ptr[j] = f.occ_ptr[j];
    for (int j = tid; j < f.nnz; j += T) s_occ[j] = f.occ_clause[j];
    code = s_code;
    ptr = s_ptr;
    occ = s_occ;
    xl = s_occ + f.nnz;
  } else {
    code = f.lit_code;
    ptr = f.occ_ptr;
    occ = f.occ_clause;
    xl = smem;
  }
  uint8_t* v = reinterpret_cast<uint8_t*>(xl + Mp);

  const size_t vrow = static_cast<size_t>(chain) * Np;
  const size_t crow = static_cast<size_t>(chain) * Mp;
  for (int i = tid; i < Np; i += T) v[i] = v_in[vrow + i];
  for (int m = tid; m < Mp; m += T) xl[m] = xl_in[crow + m];
  bool done = done_in[chain] != 0;
  __syncthreads();

  const uint32_t row_term = static_cast<uint32_t>(chain % Bb) * 0x9E3779B1u;
  const uint32_t block_seed = seed + static_cast<uint32_t>(chain / Bb) * 0x632BE59Bu;

  for (int t = 0; t < chunk_steps && !done; ++t) {
    int ok = 1;
    for (int m = tid; m < Mp; m += T) {
      const int c0 = table<RESIDENT>(code, m);
      if (c0 < 0) {  // padded clause: weight 0, never unsatisfied
        xl[m] = 0;
        continue;
      }
      bool sat = false;
      for (int k = 0; k < K; ++k) {
        const int ck = k ? table<RESIDENT>(code, k * Mp + m) : c0;
        if (ck < 0) break;  // literal slots of a clause are a prefix
        sat |= v[ck >> 1] != (ck & 1);
      }
      const int w = xl[m];
      const int x = w < 0 ? -w : w;
      xl[m] = sat ? max(x - 1, 1) : -min(x + kAlpha, kXlCap);
      ok &= sat;
    }
    const bool allsat = __syncthreads_and(ok) != 0;

    const uint32_t step_term = block_seed + static_cast<uint32_t>(t) * 0xC2B2AE3Du;
    for (int i = tid; i < Np; i += T) {
      const int j0 = table<RESIDENT>(ptr, i);
      const int j1 = table<RESIDENT>(ptr, i + 1);
      float total = 0.0f, unsat = 0.0f;
      for (int j = j0; j < j1; ++j) {
        const int w = xl[table<RESIDENT>(occ, j)];
        const float a = weight<BF16>(w);
        total += a;
        if (w < 0) unsat += a;
      }
      const uint32_t x =
          mix(row_term ^ (static_cast<uint32_t>(i) * 0x85EBCA77u) ^ step_term);
      const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
      if (j1 > j0 && u * total < unsat) v[i] ^= 1;
    }
    done = allsat;  // block-uniform: every thread leaves the loop together
    __syncthreads();
  }

  for (int i = tid; i < Np; i += T) v_out[vrow + i] = v[i];
  for (int m = tid; m < Mp; m += T) {
    const int w = xl[m];
    xl_out[crow + m] = w < 0 ? -w : w;
  }
  if (tid == 0) done_out[chain] = done ? 1 : 0;
}

// B8 (stoch_shard_eval_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_stoch_shard_eval: one step's evaluation over ONE clause shard, for a
// clause mesh whose caller all-reduces the weight sums and the sat flag
// and then draws the flips in torch (parallel/sharded.py). One CTA per
// chain, with B4's clause and variable phases over the shard's tables
// (literal codes of its (K, Mp) slots, its local CSR of clause columns):
//   clause phase   sat from the literal codes and v; xl_new = sat ?
//                  max(xl-1, 1) : min(xl+20, 2^24), 0 for a padded
//                  clause, kept with its sign carrying "unsatisfied" in
//                  shared memory while Mp words fit, else in the chain's
//                  scratch row;
//   block AND      of sat over the shard's real clauses -> sat_out;
//   variable phase total and unsat partial sums over each variable's local
//                  CSR list in a fixed order (each weight rounded to bf16
//                  first in bf16 mode): integers in f32, so every order is
//                  exact below 2^24;
//   write-back     xl_out = xl_new for an active chain, xl_in verbatim for
//                  a frozen one.
// What bounds it on the card: device-memory bytes (the shard's xl read and
// written, v read, two (B, Np) partials written every step) and L2 reads of
// the tables.
template <bool BF16>
__global__ void stoch_shard_eval_kernel(const uint8_t* __restrict__ v_in,
                                        const uint8_t* __restrict__ active_in,
                                        const int* __restrict__ xl_in, float* __restrict__ tot_out,
                                        float* __restrict__ uns_out, int* __restrict__ xl_out,
                                        uint8_t* __restrict__ sat_out, Formula f, int* scratch,
                                        int xl_resident) {
  const int chain = blockIdx.x;  // the grid is exactly B
  const int Np = f.Np, Mp = f.Mp, K = f.K;
  const int tid = threadIdx.x, T = blockDim.x;

  extern __shared__ int smem[];
  int* w = xl_resident ? smem : scratch + static_cast<size_t>(chain) * Mp;
  uint8_t* v = reinterpret_cast<uint8_t*>(smem + (xl_resident ? Mp : 0));
  const size_t vrow = static_cast<size_t>(chain) * Np;
  const size_t crow = static_cast<size_t>(chain) * Mp;
  for (int i = tid; i < Np; i += T) v[i] = v_in[vrow + i];
  __syncthreads();

  int ok = 1;
  for (int m = tid; m < Mp; m += T) {
    const int c0 = __ldg(f.lit_code + m);
    if (c0 < 0) {  // padded clause: weight 0, never unsatisfied
      w[m] = 0;
      continue;
    }
    bool sat = false;
    for (int k = 0; k < K; ++k) {
      const int ck = k ? __ldg(f.lit_code + static_cast<size_t>(k) * Mp + m) : c0;
      if (ck < 0) break;  // literal slots of a clause are a prefix
      sat |= v[ck >> 1] != (ck & 1);
    }
    const int x = xl_in[crow + m];
    w[m] = sat ? max(x - 1, 1) : -min(x + kAlpha, kXlCap);
    ok &= sat;
  }
  const bool allsat = __syncthreads_and(ok) != 0;

  for (int i = tid; i < Np; i += T) {
    const int j1 = __ldg(f.occ_ptr + i + 1);
    float total = 0.0f, unsat = 0.0f;
    for (int j = __ldg(f.occ_ptr + i); j < j1; ++j) {
      const int wj = w[__ldg(f.occ_clause + j)];
      const float a = weight<BF16>(wj);
      total += a;
      if (wj < 0) unsat += a;
    }
    tot_out[vrow + i] = total;
    uns_out[vrow + i] = unsat;
  }
  const bool active = active_in[chain] != 0;
  for (int m = tid; m < Mp; m += T) {
    const int wm = w[m];
    xl_out[crow + m] = active ? (wm < 0 ? -wm : wm) : xl_in[crow + m];
  }
  if (tid == 0) sat_out[chain] = allsat ? 1 : 0;
}

// B9 (stoch_shard_step_launch) replaces odesat_tpu/ops/stoch_pallas.py::
// make_stoch_shard_chunk (:868): the clause-sharded stoch chunk whose
// (total, unsat, sat) all-reduce the TPU kernel ran inside itself over ICI
// remote DMA (B7). A CUDA kernel cannot wait on other ranks, so on Hopper
// the chunk is a sequence of launches with the all-reduce (torch.distributed)
// between them, and everything else the TPU kernel did runs in them: each
// launch first applies the previous step's reduced sums (the flip
// u*total < unsat with the counter-hash uniform of that step, for a chain
// that was active, then done |= allsat), then evaluates the shard for step
// t as B8 does, writing its partials into acc = (total | unsat | 1 - sat)
// and its weights in place. A chunk of n steps is n such launches and one
// apply-only launch (evaluate = 0). `done` in device memory between
// launches is the done the last evaluation ran with. What bounds it: B8's
// bytes plus the (B, 2*Np+1) reduced buffer read back and v written.
template <bool BF16>
__global__ void stoch_shard_step_kernel(uint8_t* __restrict__ v_g, int* __restrict__ xl_g,
                                        uint8_t* __restrict__ done_g, float* __restrict__ acc,
                                        Formula f, int* scratch, int xl_resident, uint32_t seed,
                                        int Bb, int t, int apply, int evaluate) {
  const int chain = blockIdx.x;  // the grid is exactly B
  const int Np = f.Np, Mp = f.Mp, K = f.K;
  const int tid = threadIdx.x, T = blockDim.x;

  extern __shared__ int smem[];
  int* w = xl_resident ? smem : scratch + static_cast<size_t>(chain) * Mp;
  uint8_t* v = reinterpret_cast<uint8_t*>(smem + (xl_resident ? Mp : 0));
  const size_t vrow = static_cast<size_t>(chain) * Np;
  const size_t crow = static_cast<size_t>(chain) * Mp;
  float* a = acc + static_cast<size_t>(chain) * (2 * Np + 1);
  bool done = done_g[chain] != 0;

  if (apply) {
    const bool active = !done;
    const uint32_t row_term = static_cast<uint32_t>(chain % Bb) * 0x9E3779B1u;
    const uint32_t step_term = seed + static_cast<uint32_t>(chain / Bb) * 0x632BE59Bu +
                               static_cast<uint32_t>(t - 1) * 0xC2B2AE3Du;
    for (int i = tid; i < Np; i += T) {
      uint8_t x = v_g[vrow + i];
      if (active) {
        const uint32_t h =
            mix(row_term ^ (static_cast<uint32_t>(i) * 0x85EBCA77u) ^ step_term);
        const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
        if (u * a[i] < a[Np + i]) x ^= 1;
        v_g[vrow + i] = x;
      }
      v[i] = x;
    }
    done = done || a[2 * Np] == 0.0f;
  } else {
    for (int i = tid; i < Np; i += T) v[i] = v_g[vrow + i];
  }
  __syncthreads();  // publishes v; every thread has read a[2*Np]
  if (!evaluate) {
    if (tid == 0) done_g[chain] = done ? 1 : 0;
    return;
  }

  int ok = 1;
  for (int m = tid; m < Mp; m += T) {
    const int c0 = __ldg(f.lit_code + m);
    if (c0 < 0) {  // padded clause: weight 0, never unsatisfied
      w[m] = 0;
      continue;
    }
    bool sat = false;
    for (int k = 0; k < K; ++k) {
      const int ck = k ? __ldg(f.lit_code + static_cast<size_t>(k) * Mp + m) : c0;
      if (ck < 0) break;  // literal slots of a clause are a prefix
      sat |= v[ck >> 1] != (ck & 1);
    }
    const int x = xl_g[crow + m];
    w[m] = sat ? max(x - 1, 1) : -min(x + kAlpha, kXlCap);
    ok &= sat;
  }
  const bool allsat = __syncthreads_and(ok) != 0;

  for (int i = tid; i < Np; i += T) {
    const int j1 = __ldg(f.occ_ptr + i + 1);
    float total = 0.0f, unsat = 0.0f;
    for (int j = __ldg(f.occ_ptr + i); j < j1; ++j) {
      const int wj = w[__ldg(f.occ_clause + j)];
      const float x = weight<BF16>(wj);
      total += x;
      if (wj < 0) unsat += x;
    }
    a[i] = total;
    a[Np + i] = unsat;
  }
  if (!done) {  // a frozen chain keeps its weights verbatim
    for (int m = tid; m < Mp; m += T) {
      const int wm = w[m];
      xl_g[crow + m] = wm < 0 ? -wm : wm;
    }
  }
  if (tid == 0) {
    a[2 * Np] = allsat ? 0.0f : 1.0f;
    done_g[chain] = done ? 1 : 0;
  }
}

}  // namespace

namespace {

template <bool RESIDENT, bool BF16>
int launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in, uint8_t* v_out,
           int* xl_out, uint8_t* done_out, const Formula& f, int B, int chunk_steps,
           uint32_t seed, int Bb, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = stoch_chunk_kernel<RESIDENT, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(v_in, xl_in, done_in, v_out, xl_out, done_out, f, B,
                                       chunk_steps, seed, Bb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs; the Python gates compute the same
// numbers (ops/stoch_chunk.py). B3: tables, then xl (int32) and v (bytes).
size_t stoch_fused_smem_bytes(int Np, int Mp, int K, int nnz) {
  return 4 * (static_cast<size_t>(K) * Mp + (Np + 1) + nnz + Mp) + Np;
}

// B4: the chain's xl and v only; the tables stay in global memory.
size_t stoch_stream_smem_bytes(int Np, int Mp) {
  return 4 * static_cast<size_t>(Mp) + Np;
}

// Both return a cudaError_t code (0 = launched).
int stoch_fused_launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in,
                       uint8_t* v_out, int* xl_out, uint8_t* done_out, const int* lit_code,
                       const int* occ_ptr, const int* occ_clause, int B, int Np, int Mp, int K,
                       int nnz, int chunk_steps, unsigned int seed, int Bb, int bf16,
                       int threads, void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  const size_t smem = stoch_fused_smem_bytes(Np, Mp, K, nnz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<true, true>(v_in, xl_in, done_in, v_out, xl_out, done_out, f, B,
                              chunk_steps, seed, Bb, threads, smem, st);
  return launch<true, false>(v_in, xl_in, done_in, v_out, xl_out, done_out, f, B, chunk_steps,
                             seed, Bb, threads, smem, st);
}

int stoch_stream_launch(const uint8_t* v_in, const int* xl_in, const uint8_t* done_in,
                        uint8_t* v_out, int* xl_out, uint8_t* done_out, const int* lit_code,
                        const int* occ_ptr, const int* occ_clause, int B, int Np, int Mp, int K,
                        int nnz, int chunk_steps, unsigned int seed, int Bb, int bf16,
                        int threads, void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  const size_t smem = stoch_stream_smem_bytes(Np, Mp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<false, true>(v_in, xl_in, done_in, v_out, xl_out, done_out, f, B,
                               chunk_steps, seed, Bb, threads, smem, st);
  return launch<false, false>(v_in, xl_in, done_in, v_out, xl_out, done_out, f, B,
                              chunk_steps, seed, Bb, threads, smem, st);
}

// B8's shared memory: v (bytes), after the shard's xl when it is resident.
size_t stoch_shard_smem_bytes(int Np, int Mp, int xl_resident) {
  return (xl_resident ? 4 * static_cast<size_t>(Mp) : 0) + Np;
}

// B8. `scratch` holds Mp ints a chain when xl is not resident. Returns a
// cudaError_t code (0 = launched).
int stoch_shard_eval_launch(const uint8_t* v_in, const uint8_t* active_in, const int* xl_in,
                            float* tot_out, float* uns_out, int* xl_out, uint8_t* sat_out,
                            const int* lit_code, const int* occ_ptr, const int* occ_clause,
                            int* scratch, int B, int Np, int Mp, int K, int nnz,
                            int xl_resident, int bf16, int threads, void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  const size_t smem = stoch_shard_smem_bytes(Np, Mp, xl_resident);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? stoch_shard_eval_kernel<true> : stoch_shard_eval_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, st>>>(v_in, active_in, xl_in, tot_out, uns_out, xl_out, sat_out, f,
                                   scratch, xl_resident);
  return static_cast<int>(cudaGetLastError());
}

// B9: one launch of the chunk (see stoch_shard_step_kernel); its shared
// memory and scratch are B8's. Returns a cudaError_t code.
int stoch_shard_step_launch(uint8_t* v, int* xl, uint8_t* done, float* acc, const int* lit_code,
                            const int* occ_ptr, const int* occ_clause, int* scratch, int B,
                            int Np, int Mp, int K, int nnz, int xl_resident, int bf16,
                            int threads, unsigned int seed, int Bb, int t, int apply,
                            int evaluate, void* stream) {
  const Formula f{lit_code, occ_ptr, occ_clause, Np, Mp, K, nnz};
  const size_t smem = stoch_shard_smem_bytes(Np, Mp, xl_resident);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? stoch_shard_step_kernel<true> : stoch_shard_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, st>>>(v, xl, done, acc, f, scratch, xl_resident, seed, Bb, t, apply,
                                   evaluate);
  return static_cast<int>(cudaGetLastError());
}

const char* stoch_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
