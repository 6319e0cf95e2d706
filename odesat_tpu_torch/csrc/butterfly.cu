// B7 (bfly_reduce) replaces odesat_tpu/ops/butterfly.py::butterfly_allreduce
// (:99), the recursive-doubling all-reduce over the clause axis that the
// whole-chunk kernels B6 (odesat_tpu/ops/shard_chunk.py:605) and B9
// (odesat_tpu/ops/stoch_pallas.py:1161) run inside themselves: round r swaps
// the accumulator with partner index ^ 2^r over ICI remote DMA and both sides
// combine, so every shard sums in the same pairwise order and ends with the
// same bits.
//
// On Hopper the ranks of a clause group are processes. Each exports one
// device allocation through CUDA IPC (bfly_alloc): a page of flags, then two
// partial slots chosen by call parity. Its peers map it once (bfly_open). A
// call on rank r, all in stream order:
//   1. the partial of call i is in slot i % 2 (B6's or B9's pass wrote it);
//   2. cuStreamWriteValue32 sets r's flag to i + 1, behind a memory fence;
//   3. cuStreamWaitValue32 (GEQ) on every peer's mapped flag for i + 1;
//   4. bfly_kernel reads the S partials of slot i % 2, its own and the mapped
//      peers', combines them in the butterfly's tree order and writes the
//      result into a buffer private to the rank.
// The waits sit in the stream, not on an SM: without MPS the contexts of the
// ranks that share a card are time-sliced, and a kernel that spun on a
// peer's flag would hold its slice while that peer cannot run.
//
// The tree: the S partials in rank order, paired level by level, (a0 + a1)
// at S = 2, (a0 + a1) + (a2 + a3) at S = 4, an absent partner skipped at an
// S that is not a power of two ((a0 + a1) + a2 at S = 3). IEEE addition is
// commutative, so reading all S partials and adding them in that tree gives
// the bits that log2(S) rounds of the TPU kernel give, on every rank. An
// optional max zone, the last n_max words of every period of `period` words,
// combines by max instead (JAX's combine max-combines the flag zone of its
// second pass): NaN if either is NaN (the canonical quiet NaN), else the
// larger, the lower rank's of two equal values. A NaN in the sum zone
// comes out as the card's NaN (0x7fffffff), whatever its payload was.
// Built with --fmad=false like every kernel of the package (there is
// nothing to contract here).
//
// What bounds it on the card: device-memory bytes, S partials read and one
// result written a call, (S + 1) * 4 * n bytes. The pass is a grid-stride
// loop with 16-byte loads where every pointer and the length allow, and a
// scalar tail.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxRanks = 64;
constexpr int kThreads = 256;

// Error codes of this file: cudaError_t values are positive, CUresult values
// are returned negated, and these two are its own.
constexpr int kNoEntryPoint = 1 << 20;  // the driver entry points did not resolve
constexpr int kNoMemOps = (1 << 20) + 1;  // the device refuses stream memory operations

using WriteFn = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
using WaitFn = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
using ErrFn = CUresult (*)(CUresult, const char**);

WriteFn g_write = nullptr;
WaitFn g_wait = nullptr;
ErrFn g_error = nullptr;

template <typename F>
bool resolve(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || p == nullptr) return false;
  *fn = reinterpret_cast<F>(p);
  return true;
}

struct Parts {
  const float* p[kMaxRanks];
};

__device__ __forceinline__ float combine(float a, float b, bool mx) {
  if (!mx) return a + b;
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? b : a;
}

// The tree over the S values of one word, in place in v (the lower block is
// the left operand).
template <int S>
__device__ __forceinline__ float tree(float* v, int s, bool mx) {
  const int n = S > 0 ? S : s;
#pragma unroll
  for (int w = 1; w < (S > 0 ? S : kMaxRanks); w <<= 1) {
    if (w >= n) break;
#pragma unroll
    for (int i = 0; i + w < (S > 0 ? S : kMaxRanks); i += 2 * w) {
      if (i + w >= n) break;
      v[i] = combine(v[i], v[i + w], mx);
    }
  }
  return v[0];
}

__device__ __forceinline__ bool in_max(long long e, long long period, long long n_max) {
  return n_max > 0 && e % period >= period - n_max;
}

// S > 0: the group size at compile time (2 and 4, the meshes the smoke
// runs); S = 0: any other group, `s` ranks at run time.
template <int S, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bfly_kernel(Parts parts, int s, float* __restrict__ out, long long n, long long period,
                long long n_max) {
  constexpr int kSlots = S > 0 ? S : kMaxRanks;
  const int n_ranks = S > 0 ? S : s;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if constexpr (VEC) {
    const long long quads = n / 4;
    for (long long q = first; q < quads; q += stride) {
      float4 in[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (k < n_ranks) in[k] = __ldg(reinterpret_cast<const float4*>(parts.p[k]) + q);
      float res[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          if (k < n_ranks) v[k] = c == 0 ? in[k].x : c == 1 ? in[k].y : c == 2 ? in[k].z : in[k].w;
        res[c] = tree<S>(v, n_ranks, in_max(4 * q + c, period, n_max));
      }
      reinterpret_cast<float4*>(out)[q] = make_float4(res[0], res[1], res[2], res[3]);
    }
    done = quads * 4;
  }
  for (long long e = done + first; e < n; e += stride) {
    float v[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (k < n_ranks) v[k] = __ldg(parts.p[k] + e);
    out[e] = tree<S>(v, n_ranks, in_max(e, period, n_max));
  }
}

template <int S>
cudaError_t launch_tree(const Parts& parts, int s, float* out, long long n, long long period,
                        long long n_max, bool vec, int blocks, cudaStream_t st) {
  if (vec)
    bfly_kernel<S, true><<<blocks, kThreads, 0, st>>>(parts, s, out, n, period, n_max);
  else
    bfly_kernel<S, false><<<blocks, kThreads, 0, st>>>(parts, s, out, n, period, n_max);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Make `device` current and resolve cuStreamWriteValue32 and
// cuStreamWaitValue32 through cudaGetDriverEntryPoint (the build links no
// libcuda). Returns 0 or an error code (bfly_error_string).
int bfly_init(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g_write == nullptr) {
    WriteFn w = nullptr;
    WaitFn wt = nullptr;
    if (!resolve("cuStreamWriteValue32", &w) || !resolve("cuStreamWaitValue32", &wt))
      return kNoEntryPoint;
    resolve("cuGetErrorString", &g_error);
    g_write = w;
    g_wait = wt;
  }
  return 0;
}

// Whether `device` runs stream memory operations: a trial write and wait
// of a flag. (The attribute CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1
// describes the deprecated v1 operations and reads 0 on an H100 under CUDA
// 12.8, where the v2 operations this file calls run, so it cannot decide.)
// Returns 0, kNoMemOps when the trial is refused, or an error code.
int bfly_check_mem_ops(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned int* flag = nullptr;
  if ((e = cudaMalloc(&flag, sizeof(unsigned int))) != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = nullptr;
  int rc = 0;
  if ((e = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking)) != cudaSuccess) {
    rc = static_cast<int>(e);
  } else {
    const CUdeviceptr at = reinterpret_cast<CUdeviceptr>(flag);
    CUresult r = g_write(reinterpret_cast<CUstream>(st), at, 7u, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r == CUDA_SUCCESS)
      r = g_wait(reinterpret_cast<CUstream>(st), at, 7u, CU_STREAM_WAIT_VALUE_GEQ);
    if (r == CUDA_ERROR_NOT_SUPPORTED) rc = kNoMemOps;
    else if (r != CUDA_SUCCESS) rc = -static_cast<int>(r);
    else if ((e = cudaStreamSynchronize(st)) != cudaSuccess) rc = static_cast<int>(e);
    cudaStreamDestroy(st);
  }
  cudaFree(flag);
  return rc;
}

// `bytes` of device memory on the current device, zeroed, and its IPC handle
// (CUDA_IPC_HANDLE_SIZE = 64 bytes into `handle`).
int bfly_alloc(size_t bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaIpcMemHandle_t h;
  if ((e = cudaMemset(*ptr, 0, bytes)) != cudaSuccess ||
      (e = cudaDeviceSynchronize()) != cudaSuccess ||
      (e = cudaIpcGetMemHandle(&h, *ptr)) != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(e);
  }
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

int bfly_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// A peer's allocation mapped into this process (peer access enabled as
// needed for a peer on another card).
int bfly_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int bfly_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

// The PCI bus id of `device` (a card's name across processes), and the
// device of this process with that bus id.
int bfly_bus_id(int device, char* out, int len) {
  return static_cast<int>(cudaDeviceGetPCIBusId(out, len, device));
}

int bfly_device_of(const char* bus_id, int* device) {
  return static_cast<int>(cudaDeviceGetByPCIBusId(device, bus_id));
}

int bfly_can_access_peer(int device, int peer, int* ok) {
  return static_cast<int>(cudaDeviceCanAccessPeer(ok, device, peer));
}

// One call of B7 on `stream`: this rank's flag (own_flag, in its own
// allocation) := count + 1; a wait for every other flag (flags[k], k != rank:
// the peers' mapped flags) >= count + 1; then the tree over the s partials
// parts[0..s) (rank order; parts[rank] is this rank's own slot) into `out`, n
// words, the last n_max of every `period` max-combined (n_max = 0: all sum).
// Returns 0 or an error code.
int bfly_reduce(const float* const* parts, unsigned int* const* flags, int s, int rank,
                unsigned int count, float* out, long long n, long long period, long long n_max,
                int sms, void* stream) {
  if (s < 2 || s > kMaxRanks || rank < 0 || rank >= s || n < 0 || period < 1 || n_max < 0 ||
      n_max > period)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_write == nullptr) return kNoEntryPoint;
  const CUstream cst = static_cast<CUstream>(stream);
  CUresult r = g_write(cst, reinterpret_cast<CUdeviceptr>(flags[rank]), count + 1u,
                       CU_STREAM_WRITE_VALUE_DEFAULT);
  for (int k = 0; k < s && r == CUDA_SUCCESS; ++k)
    if (k != rank)
      r = g_wait(cst, reinterpret_cast<CUdeviceptr>(flags[k]), count + 1u,
                 CU_STREAM_WAIT_VALUE_GEQ);
  if (r == CUDA_ERROR_NOT_SUPPORTED) return kNoMemOps;
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  if (n == 0) return 0;
  Parts p{};
  bool vec = aligned16(out);
  for (int k = 0; k < s; ++k) {
    p.p[k] = parts[k];
    vec = vec && aligned16(parts[k]);
  }
  const long long items = vec ? n / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms > 0 ? sms : 132) * 8;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const int b = static_cast<int>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (s) {
    case 2: e = launch_tree<2>(p, s, out, n, period, n_max, vec, b, st); break;
    case 4: e = launch_tree<4>(p, s, out, n, period, n_max, vec, b, st); break;
    default: e = launch_tree<0>(p, s, out, n, period, n_max, vec, b, st); break;
  }
  return static_cast<int>(e);
}

const char* bfly_error_string(int code) {
  if (code == kNoEntryPoint)
    return "cuStreamWriteValue32/cuStreamWaitValue32 did not resolve through "
           "cudaGetDriverEntryPoint";
  if (code == kNoMemOps)
    return "the device refuses stream memory operations (cuStreamWaitValue32)";
  if (code < 0) {
    const char* s = nullptr;
    if (g_error != nullptr && g_error(static_cast<CUresult>(-code), &s) == CUDA_SUCCESS && s)
      return s;
    return "CUDA driver error";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
