// Resident multi-step ODE chunk for Hopper (sm_90a).
//
// Replaces odesat_tpu/ops/fused_pallas.py::make_fused_chunk (the Pallas
// TPU kernel). One CTA owns one trajectory and advances it `chunk_steps`
// Euler steps with its whole state (v, xs, xl, dt, done) and the formula's
// index tables resident in shared memory, so the state is read from HBM
// once per chunk and written once.
//
// What bounds it on the card: shared-memory traffic and the two or five
// block barriers per step, not HBM. Each step gathers K*Mp values of v
// and K*Mp contributions (one per literal slot) from shared memory; the
// TPU kernel's one-hot matmuls are replaced by those gathers, because
// Hopper gathers from shared memory cheaply where the TPU could not.
//
// Each step:
//   clause phase   (threads over clauses m): gather v[lit_var], running
//                  top-2 min over the K slots, c = m1/2, the hoisted
//                  coefficients a, b, A1 = a*m1, A2 = a*m2, the rigidity
//                  gate, per-slot contributions (sign-flipped by -q, the
//                  TPU kernel's sign-baked plane factor) into contrib[K*Mp],
//                  dxs/dxl for the clause's own memories, and the clause's
//                  satisfaction bit;
//   block AND      (__syncthreads_and) gives the trajectory's allsat;
//   variable phase (threads over variables i): dv[i] = sum over i's
//                  occurrence list (CSR, fixed order) of contrib[slot].
// No float atomics anywhere: dv sums run in a fixed order and the adaptive
// error is a max, so repeats with the same input are bit-identical.
//
// Semantics kept from the TPU kernel: padding slots never win the min
// (+inf here, where-masked; the TPU's finite 1e9 only existed for its
// matmul), fixed mode updates on the step that detects allsat then
// freezes (dt = 0 updates, clamps only), adaptive mode never advances a
// satisfied or done trajectory and clips dt into [2^-7, 1e3]. In bf16 mode
// v is rounded to bf16 before the literal values and each contribution is
// rounded to bf16 before the f32 dv sum (the TPU kernel's two roundings).
// Unit clauses (infinite gradients) and float64 are rejected by the
// Python wrapper before launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no contraction into FMA, so the kernel rounds where its plain torch
// version does), bound through the plain C entry point at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kAlpha = 5.0f;
constexpr float kBeta = 20.0f;
constexpr float kGamma = 0.25f;
constexpr float kDelta = 0.05f;
constexpr float kEps = 1e-3f;
constexpr float kXsHi = 0.999f;  // 1 - EPSILON, rounded once as Python does
constexpr float kDtMin = 0.0078125f;  // 2^-7
constexpr float kDtMax = 1000.0f;

struct Formula {
  const int* lit_code;  // (K, Mp): 2*var + (negated ? 1 : 0), -1 at padding
  const int* occ_ptr;   // (Np + 1) CSR row pointers over occ_slot
  const int* occ_slot;  // (nnz) flat slot k*Mp + m of each occurrence
  int Np, Mp, K, nnz;
};

struct Scalars {
  float zeta, dt_fixed, tol, xl_cap;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // fmaxf/fminf ignore NaN like jnp.fmax/fmin and Rust's f64::max/min
  return fminf(fmaxf(x, lo), hi);
}

template <bool BF16>
__device__ __forceinline__ float lit_value(const float* v, int code) {
  float vi = v[code >> 1];
  if (BF16) vi = __bfloat162float(__float2bfloat16_rn(vi));
  const float qv = (code & 1) ? -vi : vi;  // q * v, exact
  return 1.0f - qv;
}

// Clause phase for clause m: writes the K signed contributions and
// returns c (0 for a padded clause, which has no occurrences).
template <bool PAPER, bool BF16>
__device__ __forceinline__ float clause_terms(
    const int* code, const float* v, float xs, float xl, int m,
    int Mp, int K, float zeta, float* contrib, bool* real) {
  const int c0 = code[m];
  *real = c0 >= 0;
  if (c0 < 0) return 0.0f;
  float m1 = lit_value<BF16>(v, c0);
  float m2 = __int_as_float(0x7f800000);  // +inf
  for (int k = 1; k < K; ++k) {
    const int ck = code[k * Mp + m];
    if (ck < 0) continue;  // padding slot: +inf never changes m1, m2
    const float val = lit_value<BF16>(v, ck);
    m2 = fminf(m2, fmaxf(m1, val));
    m1 = fminf(m1, val);
  }
  const float c = 0.5f * m1;
  const float a = -0.5f * (xl * xs);
  const float b = -0.5f * ((1.0f + zeta * xl) * (1.0f - xs));
  const float A1 = a * m1;
  const float A2 = a * m2;
  for (int k = 0; k < K; ++k) {
    const int ck = code[k * Mp + m];
    if (ck < 0) continue;
    const float val = lit_value<BF16>(v, ck);
    const bool is_min = val <= m1;
    float cp;
    if (PAPER) {
      cp = is_min ? (A2 + b * val) : A1;
    } else {
      const float gate = (val == c) ? 1.0f : 0.0f;
      cp = (is_min ? A2 : A1) + b * (val * gate);
    }
    if (BF16) cp = __bfloat162float(__float2bfloat16_rn(cp));
    contrib[k * Mp + m] = (ck & 1) ? cp : -cp;  // times -q
  }
  return c;
}

__device__ __forceinline__ float var_sum(const float* contrib, int i, const int* ptr,
                                         const int* slot) {
  float dv = 0.0f;
  for (int j = ptr[i]; j < ptr[i + 1]; ++j) dv += contrib[slot[j]];
  return dv;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

template <bool FIXED, bool PAPER, bool BF16>
__global__ void fused_chunk_kernel(
    const float* __restrict__ v_in, const float* __restrict__ xs_in,
    const float* __restrict__ xl_in, const float* __restrict__ dt_in,
    const unsigned char* __restrict__ done_in,
    float* __restrict__ v_out, float* __restrict__ xs_out,
    float* __restrict__ xl_out, float* __restrict__ dt_out,
    unsigned char* __restrict__ done_out,
    Formula f, Scalars s, int B, int chunk_steps) {
  const int traj = blockIdx.x;
  if (traj >= B) return;  // ragged edge: no padded rows
  const int Np = f.Np, Mp = f.Mp, K = f.K, KM = f.K * f.Mp;
  const int tid = threadIdx.x, T = blockDim.x;

  extern __shared__ float smem[];
  int* code = reinterpret_cast<int*>(smem);
  int* ptr = code + KM;
  int* slot = ptr + (Np + 1);
  float* v = reinterpret_cast<float*>(slot + f.nnz);
  float* xs = v + Np;
  float* xl = xs + Mp;
  float* contrib = xl + Mp;
  float* red = contrib + KM;  // 32 floats
  // adaptive only: half-step and full-step trial states
  float* hv = red + 32;
  float* hxs = hv + Np;
  float* hxl = hxs + Mp;
  float* fv = hxl + Mp;
  float* fxs = fv + Np;
  float* fxl = fxs + Mp;

  for (int j = tid; j < KM; j += T) code[j] = f.lit_code[j];
  for (int j = tid; j <= Np; j += T) ptr[j] = f.occ_ptr[j];
  for (int j = tid; j < f.nnz; j += T) slot[j] = f.occ_slot[j];
  const size_t vrow = static_cast<size_t>(traj) * Np;
  const size_t crow = static_cast<size_t>(traj) * Mp;
  for (int i = tid; i < Np; i += T) v[i] = v_in[vrow + i];
  for (int m = tid; m < Mp; m += T) {
    xs[m] = xs_in[crow + m];
    xl[m] = xl_in[crow + m];
  }
  float dt = dt_in[traj];
  bool done = done_in[traj] != 0;
  __syncthreads();

  for (int step = 0; step < chunk_steps; ++step) {
    if (FIXED) {
      const float dtc = done ? 0.0f : s.dt_fixed;
      int ok = 1;
      for (int m = tid; m < Mp; m += T) {
        bool real;
        const float c = clause_terms<PAPER, BF16>(code, v, xs[m], xl[m], m, Mp, K,
                                                  s.zeta, contrib, &real);
        float dxs = 0.0f, dxl = 0.0f;
        if (real) {
          dxs = kBeta * (xs[m] + kEps) * (c - kGamma);
          dxl = kAlpha * (c - kDelta);
          ok &= (c < kGamma);
        }
        xs[m] = clampf(xs[m] + dtc * dxs, kEps, kXsHi);
        xl[m] = clampf(xl[m] + dtc * dxl, 1.0f, s.xl_cap);
      }
      const bool allsat = __syncthreads_and(ok) != 0;
      for (int i = tid; i < Np; i += T) {
        const float dv = var_sum(contrib, i, ptr, slot);
        v[i] = clampf(v[i] + dtc * dv, -1.0f, 1.0f);
      }
      done = done || allsat;
      __syncthreads();
    } else {
      // pass 1: derivatives at (v, xs, xl); dxs/dxl parked in fxs/fxl
      int ok = 1;
      for (int m = tid; m < Mp; m += T) {
        bool real;
        const float c = clause_terms<PAPER, BF16>(code, v, xs[m], xl[m], m, Mp, K,
                                                  s.zeta, contrib, &real);
        float dxs = 0.0f, dxl = 0.0f;
        if (real) {
          dxs = kBeta * (xs[m] + kEps) * (c - kGamma);
          dxl = kAlpha * (c - kDelta);
          ok &= (c < kGamma);
        }
        fxs[m] = dxs;
        fxl[m] = dxl;
      }
      const bool allsat = __syncthreads_and(ok) != 0;
      const bool advance = !done && !allsat;
      done = done || allsat;
      if (!advance) continue;  // uniform over the block; state untouched

      const float half = 0.5f * dt;
      for (int m = tid; m < Mp; m += T) {
        const float dxs = fxs[m], dxl = fxl[m];
        fxs[m] = clampf(xs[m] + dt * dxs, kEps, kXsHi);
        fxl[m] = clampf(xl[m] + dt * dxl, 1.0f, s.xl_cap);
        hxs[m] = clampf(xs[m] + half * dxs, kEps, kXsHi);
        hxl[m] = clampf(xl[m] + half * dxl, 1.0f, s.xl_cap);
      }
      for (int i = tid; i < Np; i += T) {
        const float dv = var_sum(contrib, i, ptr, slot);
        fv[i] = clampf(v[i] + dt * dv, -1.0f, 1.0f);
        hv[i] = clampf(v[i] + half * dv, -1.0f, 1.0f);
      }
      __syncthreads();

      // pass 2: derivatives at the half step; two half steps are kept
      float err = 0.0f;
      for (int m = tid; m < Mp; m += T) {
        bool real;
        const float c = clause_terms<PAPER, BF16>(code, hv, hxs[m], hxl[m], m, Mp, K,
                                                  s.zeta, contrib, &real);
        float dxs = 0.0f, dxl = 0.0f;
        if (real) {
          dxs = kBeta * (hxs[m] + kEps) * (c - kGamma);
          dxl = kAlpha * (c - kDelta);
        }
        const float txs = clampf(hxs[m] + half * dxs, kEps, kXsHi);
        const float txl = clampf(hxl[m] + half * dxl, 1.0f, s.xl_cap);
        err = fmaxf(err, fmaxf(fabsf(fxs[m] - txs), fabsf(fxl[m] - txl)));
        xs[m] = txs;
        xl[m] = txl;
      }
      __syncthreads();
      for (int i = tid; i < Np; i += T) {
        const float dv = var_sum(contrib, i, ptr, slot);
        const float tv = clampf(hv[i] + half * dv, -1.0f, 1.0f);
        err = fmaxf(err, fabsf(fv[i] - tv));
        v[i] = tv;
      }
      err = block_max(err, red);  // its barrier also publishes v
      const float ratio = s.tol / fmaxf(err, 1e-30f);
      dt = clampf(dt * sqrtf(ratio), kDtMin, kDtMax);
      __syncthreads();  // red[] is reused next step
    }
  }

  for (int i = tid; i < Np; i += T) v_out[vrow + i] = v[i];
  for (int m = tid; m < Mp; m += T) {
    xs_out[crow + m] = xs[m];
    xl_out[crow + m] = xl[m];
  }
  if (tid == 0) {
    dt_out[traj] = dt;
    done_out[traj] = done ? 1 : 0;
  }
}

template <bool FIXED, bool PAPER, bool BF16>
int launch(const float* v_in, const float* xs_in, const float* xl_in, const float* dt_in,
           const unsigned char* done_in, float* v_out, float* xs_out, float* xl_out,
           float* dt_out, unsigned char* done_out, const Formula& f, const Scalars& s,
           int B, int chunk_steps, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = fused_chunk_kernel<FIXED, PAPER, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(v_in, xs_in, xl_in, dt_in, done_in, v_out, xs_out,
                                       xl_out, dt_out, done_out, f, s, B, chunk_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs; the Python gate uses the same formula.
size_t fused_chunk_smem_bytes(int Np, int Mp, int K, int nnz, int fixed) {
  const size_t words = static_cast<size_t>(K) * Mp       // lit codes
                       + (Np + 1) + nnz                  // CSR occurrences
                       + Np + 2 * static_cast<size_t>(Mp)  // v, xs, xl
                       + static_cast<size_t>(K) * Mp     // contributions
                       + 32                              // reduction scratch
                       + (fixed ? 0 : 2 * (Np + 2 * static_cast<size_t>(Mp)));
  return words * 4;
}

// Returns a cudaError_t code (0 = launched).
int fused_chunk_launch(const float* v_in, const float* xs_in, const float* xl_in,
                       const float* dt_in, const unsigned char* done_in, float* v_out,
                       float* xs_out, float* xl_out, float* dt_out, unsigned char* done_out,
                       const int* lit_code, const int* occ_ptr, const int* occ_slot, int B,
                       int Np, int Mp, int K, int nnz, int chunk_steps, int fixed, int paper,
                       int bf16, int threads, float zeta, float dt_fixed, float tol,
                       float xl_cap, void* stream) {
  const Formula f{lit_code, occ_ptr, occ_slot, Np, Mp, K, nnz};
  const Scalars s{zeta, dt_fixed, tol, xl_cap};
  const size_t smem = fused_chunk_smem_bytes(Np, Mp, K, nnz, fixed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ODESAT_LAUNCH(F, P, H)                                                              \
  return launch<F, P, H>(v_in, xs_in, xl_in, dt_in, done_in, v_out, xs_out, xl_out, dt_out, \
                         done_out, f, s, B, chunk_steps, threads, smem, st)
  if (fixed) {
    if (paper) {
      if (bf16) ODESAT_LAUNCH(true, true, true);
      ODESAT_LAUNCH(true, true, false);
    }
    if (bf16) ODESAT_LAUNCH(true, false, true);
    ODESAT_LAUNCH(true, false, false);
  }
  if (paper) {
    if (bf16) ODESAT_LAUNCH(false, true, true);
    ODESAT_LAUNCH(false, true, false);
  }
  if (bf16) ODESAT_LAUNCH(false, false, true);
  ODESAT_LAUNCH(false, false, false);
#undef ODESAT_LAUNCH
}

const char* fused_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
