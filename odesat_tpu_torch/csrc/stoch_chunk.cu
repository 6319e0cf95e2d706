// Stochastic-engine chunk for Hopper (sm_90a): kernels B3 and B4.
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

const char* stoch_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
