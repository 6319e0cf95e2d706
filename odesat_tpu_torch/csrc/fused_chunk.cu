// Resident multi-step ODE chunk (B1) for Hopper (sm_90a).
//
// Replaces odesat_tpu/ops/fused_pallas.py::make_fused_chunk (the Pallas
// TPU kernel). One CTA owns one tile of R trajectories, one a lane of each
// of its thread groups (ode_lanes.cuh), and advances it `chunk_steps`
// Euler steps with the formula's index tables and the tile's whole state
// (v, xs, xl and the per-slot contributions, interleaved [x][r]) resident
// in shared memory, so the state is read from device memory once per
// chunk and written once. The kernel reads the row-major (B, .) state
// straight into its interleaved layout at entry and writes it back at
// exit; a ragged last tile has done lanes that read and write nothing.
//
// What bounds it on the card: shared-memory wavefronts and instruction
// issue, not device memory. Each step gathers K*Mp values of v and K*Mp
// contributions per trajectory from shared memory; the TPU kernel's
// one-hot matmuls are replaced by those gathers. What the design does about
// it: every table word is one broadcast read for the tile's R
// trajectories, every per-trajectory access is R neighbouring words (no
// bank conflicts), and the block barriers (two a fixed step, four an
// adaptive one) and the table copy are shared by R trajectories. R is the
// largest power of two up to 32 whose footprint fits the CTA
// (ops/fused_chunk.py::fused_lanes): 32 for hard.cnf fixed, smaller for
// larger formulas and for the adaptive integrator's extra state.
//
// Unit clauses (infinite gradients) and float64 are rejected by the Python
// wrapper before launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no contraction into FMA, so the kernel rounds where its plain torch
// version does), bound through the plain C entry point at the bottom.

#include "ode_lanes.cuh"

extern "C" {

// Shared-memory bytes one CTA needs at R lanes; the Python gate uses the
// same formula.
size_t fused_chunk_smem_bytes(int Np, int Mp, int K, int nnz, int fixed, int R) {
  return lanes::smem_bytes(true, fixed != 0, Np, Mp, K, nnz, R);
}

// `segs` (nseg, 4) lists the clause ranges [m0, m1), the width their slots
// lie below and where their trailing padded clauses start
// (ops/fused_chunk.py::clause_segments). `stop` (null: none) and
// `stop_all` are the device loop's stop hook and `at` (null: none) its
// pointer block (ode_lanes.cuh State); the state in and out may be the
// same buffers. Returns a cudaError_t code (0 = launched).
int fused_chunk_launch(const float* v_in, const float* xs_in, const float* xl_in,
                       const float* dt_in, const unsigned char* done_in, float* v_out,
                       float* xs_out, float* xl_out, float* dt_out, unsigned char* done_out,
                       const int* lit_code, const int* occ_ptr, const int* occ_slot,
                       const int* segs, int nseg, int B, int Np, int Mp, int K, int nnz,
                       int chunk_steps, int fixed, int paper, int bf16, int R, int threads,
                       float zeta, float dt_fixed, float tol, float xl_cap, int* stop,
                       int stop_all, void* const* at, void* stream) {
  const lanes::State st{v_in,   xs_in,  xl_in,  dt_in,    done_in, v_out, xs_out,
                        xl_out, dt_out, done_out, nullptr, stop,    stop_all, at};
  const lanes::Formula f{lit_code, occ_ptr, occ_slot, nullptr, segs, Np, Mp, K, nnz, nseg};
  const lanes::Scalars s{zeta, dt_fixed, tol, xl_cap};
  const size_t smem = lanes::smem_bytes(true, fixed != 0, Np, Mp, K, nnz, R);
  return lanes::launch<true>(st, f, s, B, R, threads, chunk_steps, fixed != 0, paper != 0,
                             bf16 != 0, smem, static_cast<cudaStream_t>(stream));
}

const char* fused_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
