// Large-formula ODE chunk (B2) and single-step RHS (B10) for Hopper (sm_90a).
//
// B2 (stream_chunk_launch) replaces odesat_tpu/ops/stream_pallas.py::
// make_stream_chunk; B10 (rhs_launch) replaces odesat_tpu/ops/rhs_pallas.py::
// make_pallas_rhs. They share the clause-phase and variable-phase device
// functions below.
//
// B2 computes exactly what B1 (csrc/fused_chunk.cu) computes, for formulas
// whose tables and state do not fit one CTA's shared memory. One CTA owns
// one trajectory for the whole chunk. The formula's tables (a literal code
// per (k, m) slot, each variable's CSR occurrence list) are read from
// global memory, where every CTA reads the same bytes and they stay in the
// 50 MB L2. The trajectory's arrays are placed by the Python wrapper: in
// shared memory while they fit, in a per-trajectory scratch row in global
// memory after that (ops/stream_chunk.py::stream_layout). `v` (and the
// adaptive half step `hv`) must be in shared memory: the clause phase
// gathers them K times per clause.
//
// B1 keeps one contribution per (k, m) slot, K*Mp words, which is what does
// not scale (9 x 6528 x 4 = 235 KB for the preprocessed n=1k instance).
// B2 keeps two words per clause instead, the running min m1 and second min
// m2, and the variable phase recomputes each occurrence's contribution from
// v[i], its sign, m1, m2 and the clause's xs and xl with the same operations
// in the same order as B1's clause phase. With --fmad=false that is
// bit-identical to B1 and to its plain version (ops/fused_chunk.py::
// fused_chunk_plain). Because the variable phase needs the xs and xl the
// step started from, the clause memories are updated in a third pass after
// it.
//
// Fixed step, per step (two barriers):
//   clause phase   (threads over clauses m): m1, m2 from v; satisfaction bit;
//   block AND      (__syncthreads_and) gives allsat;
//   variable phase (threads over variables i): dv[i] summed over i's CSR
//                  list in a fixed order; v[i] updated;
//   barrier; clause memories xs, xl updated from m1 and the old xs.
// Adaptive step (step doubling), per step (five barriers):
//   pass 1 clause phase on (v); AND; if the trajectory advances:
//   variable phase -> full-step fv and half-step hv; clause memories ->
//   fxs, fxl, hxs, hxl; barrier; pass 2 clause phase on (hv); barrier;
//   variable phase on (hv, hxs, hxl) -> v, and the error against fv;
//   clause memories -> xs, xl and the error against fxs, fxl; block max of
//   the error; dt <- clip(dt*sqrt(tol/max(err, 1e-30)), 2^-7, 1e3).
// No float atomics: dv sums run in the plain version's CSR order and the
// error is a max, so repeats with the same input are bit-identical.
//
// What bounds it on the card: gathers (v from shared memory, m1/m2/xs/xl
// from wherever they were placed) and L2 reads of the tables, not HBM.
// At Mp=17280 a trajectory's adaptive state is 415 KB; what does not fit
// the CTA lives in its scratch row and is read through L1 and L2.
//
// B10 is one RHS pass, (v, xs, xl) -> (dv, dxs, dxl, allsat), in float or
// double: v, m1 and m2 placed as above, xs and xl read from the inputs.
//
// Unit clauses (infinite gradients), float64 chunks and a batch-shared
// adaptive dt are rejected by the Python wrappers before launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (no
// contraction into FMA, so the kernels round where their plain torch
// versions do), bound through the plain C entry points at the bottom.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Placement of the per-trajectory arrays: off >= 0 is an element offset in
// shared memory, off < 0 is -(offset + 1) in the trajectory's scratch row.
enum Item { V = 0, HV, FV, M1, M2, XS, XL, HXS, HXL, FXS, FXL, kItems };
struct Place {
  long long off[kItems];
};
constexpr int kRed = 32;  // elements of reduction scratch at the start of shared memory

struct Tables {
  const int* lit_code;  // (K, Mp): 2*var + (negated ? 1 : 0), -1 at padding
  const int* occ_ptr;   // (Np + 1) CSR row pointers over occ_code
  const int* occ_code;  // (nnz): 2*m + negated, clause column and sign of each occurrence
  int Np, Mp, K;
};

template <typename T>
__device__ __forceinline__ T* placed(long long off, T* smem, T* row) {
  return off >= 0 ? smem + off : row + (-off - 1);
}

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

// Clause phase for clause m: the running top-2 min over its literal values
// (B1's loop, the reference's scan semantics). Returns false for a padded
// clause (its slot 0 holds -1), which has no occurrences.
template <typename T, bool BF16>
__device__ __forceinline__ bool clause_min2(const Tables& f, const T* v, int m, T* m1o,
                                            T* m2o) {
  const int c0 = __ldg(f.lit_code + m);
  if (c0 < 0) {
    *m1o = T(0);
    *m2o = T(0);
    return false;
  }
  T m1 = lit_value<T, BF16>(v[c0 >> 1], c0 & 1);
  T m2 = T(__int_as_float(0x7f800000));  // +inf
  for (int k = 1; k < f.K; ++k) {
    const int ck = __ldg(f.lit_code + static_cast<size_t>(k) * f.Mp + m);
    if (ck < 0) continue;  // padding slot: +inf never changes m1, m2
    const T val = lit_value<T, BF16>(v[ck >> 1], ck & 1);
    m2 = vmin(m2, vmax(m1, val));
    m1 = vmin(m1, val);
  }
  *m1o = m1;
  *m2o = m2;
  return true;
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

// Variable phase for variable i: dv[i] over its CSR list in a fixed order.
template <typename T, bool PAPER, bool BF16>
__device__ __forceinline__ T var_dv(const Tables& f, int i, T vi, const T* m1, const T* m2,
                                    const T* xs, const T* xl, T zeta) {
  T dv = T(0);
  const int end = __ldg(f.occ_ptr + i + 1);
  for (int j = __ldg(f.occ_ptr + i); j < end; ++j) {
    const int oc = __ldg(f.occ_code + j);
    const int m = oc >> 1;
    const T val = lit_value<T, BF16>(vi, oc & 1);
    dv += contribution<T, PAPER, BF16>(val, m1[m], m2[m], xs[m], xl[m], zeta, oc & 1);
  }
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

struct Scalars {
  float zeta, dt_fixed, tol, xl_cap;
};

template <bool FIXED, bool PAPER, bool BF16>
__global__ void stream_chunk_kernel(
    const float* __restrict__ v_in, const float* __restrict__ xs_in,
    const float* __restrict__ xl_in, const float* __restrict__ dt_in,
    const unsigned char* __restrict__ done_in, float* __restrict__ v_out,
    float* __restrict__ xs_out, float* __restrict__ xl_out, float* __restrict__ dt_out,
    unsigned char* __restrict__ done_out, Tables f, Scalars s, Place p, float* scratch,
    long long row_words, int chunk_steps) {
  using C = K_<float>;
  const int traj = blockIdx.x;  // the grid is exactly B: no padded rows
  const int Np = f.Np, Mp = f.Mp;
  const int tid = threadIdx.x, T = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* red = smem;  // kRed floats
  float* row = scratch + static_cast<size_t>(traj) * row_words;
  float* v = placed(p.off[V], smem, row);
  float* m1 = placed(p.off[M1], smem, row);
  float* m2 = placed(p.off[M2], smem, row);
  float* xs = placed(p.off[XS], smem, row);
  float* xl = placed(p.off[XL], smem, row);
  // adaptive only: half-step and full-step trial states
  float* hv = placed(p.off[HV], smem, row);
  float* fv = placed(p.off[FV], smem, row);
  float* hxs = placed(p.off[HXS], smem, row);
  float* hxl = placed(p.off[HXL], smem, row);
  float* fxs = placed(p.off[FXS], smem, row);
  float* fxl = placed(p.off[FXL], smem, row);

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
    int ok = 1;
    for (int m = tid; m < Mp; m += T) {
      float a, b;
      if (clause_min2<float, BF16>(f, v, m, &a, &b)) ok &= (0.5f * a < C::gamma);
      m1[m] = a;
      m2[m] = b;
    }
    const bool allsat = __syncthreads_and(ok) != 0;
    if (FIXED) {
      const float dtc = done ? 0.0f : s.dt_fixed;
      for (int i = tid; i < Np; i += T) {
        const float dv = var_dv<float, PAPER, BF16>(f, i, v[i], m1, m2, xs, xl, s.zeta);
        v[i] = clampf(v[i] + dtc * dv, -1.0f, 1.0f);
      }
      __syncthreads();  // the variable phase read xs, xl of every clause
      for (int m = tid; m < Mp; m += T) {
        float dxs = 0.0f, dxl = 0.0f;
        if (__ldg(f.lit_code + m) >= 0) {
          const float c = 0.5f * m1[m];
          dxs = C::beta * (xs[m] + C::eps) * (c - C::gamma);
          dxl = C::alpha * (c - C::delta);
        }
        xs[m] = clampf(xs[m] + dtc * dxs, C::eps, C::xs_hi);
        xl[m] = clampf(xl[m] + dtc * dxl, 1.0f, s.xl_cap);
      }
      // the next clause phase reads v (published by the barrier above) and
      // writes m1, m2 of its own clauses only
      done = done || allsat;
    } else {
      const bool advance = !done && !allsat;
      done = done || allsat;
      if (!advance) continue;  // uniform over the block; state untouched

      const float half = 0.5f * dt;
      for (int i = tid; i < Np; i += T) {
        const float dv = var_dv<float, PAPER, BF16>(f, i, v[i], m1, m2, xs, xl, s.zeta);
        fv[i] = clampf(v[i] + dt * dv, -1.0f, 1.0f);
        hv[i] = clampf(v[i] + half * dv, -1.0f, 1.0f);
      }
      for (int m = tid; m < Mp; m += T) {
        float dxs = 0.0f, dxl = 0.0f;
        if (__ldg(f.lit_code + m) >= 0) {
          const float c = 0.5f * m1[m];
          dxs = C::beta * (xs[m] + C::eps) * (c - C::gamma);
          dxl = C::alpha * (c - C::delta);
        }
        fxs[m] = clampf(xs[m] + dt * dxs, C::eps, C::xs_hi);
        fxl[m] = clampf(xl[m] + dt * dxl, 1.0f, s.xl_cap);
        hxs[m] = clampf(xs[m] + half * dxs, C::eps, C::xs_hi);
        hxl[m] = clampf(xl[m] + half * dxl, 1.0f, s.xl_cap);
      }
      __syncthreads();

      // pass 2: derivatives at the half step; two half steps are kept
      for (int m = tid; m < Mp; m += T) {
        float a, b;
        clause_min2<float, BF16>(f, hv, m, &a, &b);
        m1[m] = a;
        m2[m] = b;
      }
      __syncthreads();
      float err = 0.0f;
      for (int i = tid; i < Np; i += T) {
        const float dv = var_dv<float, PAPER, BF16>(f, i, hv[i], m1, m2, hxs, hxl, s.zeta);
        const float tv = clampf(hv[i] + half * dv, -1.0f, 1.0f);
        err = fmaxf(err, fabsf(fv[i] - tv));
        v[i] = tv;
      }
      for (int m = tid; m < Mp; m += T) {
        float dxs = 0.0f, dxl = 0.0f;
        if (__ldg(f.lit_code + m) >= 0) {
          const float c = 0.5f * m1[m];
          dxs = C::beta * (hxs[m] + C::eps) * (c - C::gamma);
          dxl = C::alpha * (c - C::delta);
        }
        const float txs = clampf(hxs[m] + half * dxs, C::eps, C::xs_hi);
        const float txl = clampf(hxl[m] + half * dxl, 1.0f, s.xl_cap);
        err = fmaxf(err, fmaxf(fabsf(fxs[m] - txs), fabsf(fxl[m] - txl)));
        xs[m] = txs;
        xl[m] = txl;
      }
      err = block_max(err, red);  // its barrier also publishes v
      const float ratio = s.tol / fmaxf(err, 1e-30f);
      dt = clampf(dt * sqrtf(ratio), kDtMin, kDtMax);
      __syncthreads();  // red[] is reused next step
    }
  }

  // each thread writes back the entries it last wrote itself
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

template <typename T, bool PAPER>
__global__ void rhs_kernel(const T* __restrict__ v_in, const T* __restrict__ xs_in,
                           const T* __restrict__ xl_in, T* __restrict__ dv_out,
                           T* __restrict__ dxs_out, T* __restrict__ dxl_out,
                           unsigned char* __restrict__ allsat_out, Tables f, T zeta, Place p,
                           T* scratch, long long row_words) {
  using C = K_<T>;
  const int traj = blockIdx.x;
  const int Np = f.Np, Mp = f.Mp;
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* row = scratch + static_cast<size_t>(traj) * row_words;
  T* v = placed(p.off[V], smem, row);
  T* m1 = placed(p.off[M1], smem, row);
  T* m2 = placed(p.off[M2], smem, row);
  const size_t vrow = static_cast<size_t>(traj) * Np;
  const size_t crow = static_cast<size_t>(traj) * Mp;
  const T* xs = xs_in + crow;
  const T* xl = xl_in + crow;

  for (int i = tid; i < Np; i += nt) v[i] = v_in[vrow + i];
  __syncthreads();
  int ok = 1;
  for (int m = tid; m < Mp; m += nt) {
    T a, b;
    T dxs = T(0), dxl = T(0);
    if (clause_min2<T, false>(f, v, m, &a, &b)) {
      const T c = T(0.5) * a;
      dxs = C::beta * (xs[m] + C::eps) * (c - C::gamma);
      dxl = C::alpha * (c - C::delta);
      ok &= (c < C::gamma);
    }
    m1[m] = a;
    m2[m] = b;
    dxs_out[crow + m] = dxs;
    dxl_out[crow + m] = dxl;
  }
  const bool allsat = __syncthreads_and(ok) != 0;
  for (int i = tid; i < Np; i += nt)
    dv_out[vrow + i] = var_dv<T, PAPER, false>(f, i, v[i], m1, m2, xs, xl, zeta);
  if (tid == 0) allsat_out[traj] = allsat ? 1 : 0;
}

// Refuse a placement that would run off the shared memory it is launched
// with: every used item placed there must lie inside it, past the
// reduction scratch.
bool placement_ok(const Place& p, const bool* used, int Np, int Mp, size_t smem,
                  size_t itemsize) {
  const long long elems = static_cast<long long>(smem / itemsize);
  for (int i = 0; i < kItems; ++i) {
    if (!used[i] || p.off[i] < 0) continue;
    const long long n = (i == V || i == HV || i == FV) ? Np : Mp;
    if (p.off[i] < kRed || p.off[i] + n > elems) return false;
  }
  return true;
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int threads, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most dynamic shared memory a CTA may use on the current device.
int stream_chunk_smem_limit(void) { return smem_optin(); }

// B2. Returns a cudaError_t code (0 = launched).
int stream_chunk_launch(const float* v_in, const float* xs_in, const float* xl_in,
                        const float* dt_in, const unsigned char* done_in, float* v_out,
                        float* xs_out, float* xl_out, float* dt_out, unsigned char* done_out,
                        const int* lit_code, const int* occ_ptr, const int* occ_code,
                        float* scratch, const long long* place, long long row_words,
                        int smem_bytes, int B, int Np, int Mp, int K, int chunk_steps,
                        int fixed, int paper, int bf16, int threads, float zeta,
                        float dt_fixed, float tol, float xl_cap, void* stream) {
  Place p;
  for (int i = 0; i < kItems; ++i) p.off[i] = place[i];
  bool used[kItems];
  for (int i = 0; i < kItems; ++i) used[i] = !fixed || i == V || i == M1 || i == M2 ||
                                             i == XS || i == XL;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (smem_bytes > smem_optin() || !placement_ok(p, used, Np, Mp, smem, sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables f{lit_code, occ_ptr, occ_code, Np, Mp, K};
  const Scalars s{zeta, dt_fixed, tol, xl_cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ODESAT_LAUNCH(F, P, H)                                                                \
  return launch(stream_chunk_kernel<F, P, H>, B, threads, smem, st, v_in, xs_in, xl_in, dt_in, \
                done_in, v_out, xs_out, xl_out, dt_out, done_out, f, s, p, scratch, row_words, \
                chunk_steps)
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

// B10, in float (is_double = 0) or double. Returns a cudaError_t code.
int rhs_launch(int is_double, const void* v_in, const void* xs_in, const void* xl_in,
               void* dv_out, void* dxs_out, void* dxl_out, unsigned char* allsat_out,
               const int* lit_code, const int* occ_ptr, const int* occ_code, void* scratch,
               const long long* place, long long row_words, int smem_bytes, int B, int Np,
               int Mp, int K, int paper, int threads, double zeta, void* stream) {
  Place p;
  for (int i = 0; i < kItems; ++i) p.off[i] = place[i];
  bool used[kItems] = {};
  used[V] = used[M1] = used[M2] = true;
  const size_t smem = static_cast<size_t>(smem_bytes);
  const size_t itemsize = is_double ? sizeof(double) : sizeof(float);
  if (smem_bytes > smem_optin() || !placement_ok(p, used, Np, Mp, smem, itemsize))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables f{lit_code, occ_ptr, occ_code, Np, Mp, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ODESAT_RHS(TYPE, P)                                                                  \
  return launch(rhs_kernel<TYPE, P>, B, threads, smem, st, static_cast<const TYPE*>(v_in),  \
                static_cast<const TYPE*>(xs_in), static_cast<const TYPE*>(xl_in),           \
                static_cast<TYPE*>(dv_out), static_cast<TYPE*>(dxs_out),                    \
                static_cast<TYPE*>(dxl_out), allsat_out, f, static_cast<TYPE>(zeta), p,     \
                static_cast<TYPE*>(scratch), row_words)
  if (is_double) {
    if (paper) ODESAT_RHS(double, true);
    ODESAT_RHS(double, false);
  }
  if (paper) ODESAT_RHS(float, true);
  ODESAT_RHS(float, false);
#undef ODESAT_RHS
}

const char* stream_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
