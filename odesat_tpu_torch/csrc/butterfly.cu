// B7 replaces odesat_tpu/ops/butterfly.py::butterfly_allreduce (:99), the
// recursive-doubling all-reduce over the clause axis that the whole-chunk
// kernels B6 (odesat_tpu/ops/shard_chunk.py:605) and B9
// (odesat_tpu/ops/stoch_pallas.py:1161) run inside themselves: round r swaps
// the accumulator with partner index ^ 2^r over ICI remote DMA and both sides
// combine, so every shard sums in the same pairwise order and ends with the
// same bits.
//
// On Hopper the ranks of a clause group are processes. Each exports one
// device allocation through CUDA IPC (bfly_alloc): a page of flags, then the
// partial slots; its peers map it once (bfly_open). B6's and B9's kernels
// read the S ranks' slots themselves and add them as they read them
// (bfly_tree.cuh, the tree's one definition: B7 fused). This file holds
// what they and the standalone call share: the flags, written and awaited
// in stream order (bfly_signal: cuStreamWriteValue32 behind a memory fence;
// bfly_wait: cuStreamWaitValue32 GEQ on every peer's mapped flag), and the
// standalone call for sums that torch operations consume (bfly_reduce: the
// flag raised, the peers awaited, then bfly_kernel over the S slots into a
// buffer of the caller's; bfly_tree: the kernel alone, on any S buffers).
// The waits sit in the stream, not on an SM: without MPS the contexts of
// the ranks that share a card are time-sliced, and a kernel that spun on a
// peer's flag would hold its slice while that peer cannot run. Which slot
// a launch writes and which flag value it awaits is ops/butterfly.py's
// schedule: one counter a rank, K slots a mode.
//
// An optional max zone, the last n_max words of every period of `period`
// words, combines by max instead (JAX's combine max-combines the flag zone
// of its second pass). A NaN in the sum zone comes out as the card's NaN
// (0x7fffffff), whatever its payload was. Built with --fmad=false like
// every kernel of the package (there is nothing to contract here).
//
// What bounds the standalone kernel on the card: device-memory bytes, S
// partials read and one result written a call, (S + 1) * 4 * n bytes. The
// pass is a grid-stride loop with 16-byte loads where every pointer and the
// length allow, and a scalar tail.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "bfly_tree.cuh"

namespace {

constexpr int kMaxRanks = bfly::kMaxRanks;
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

using bfly::Parts;

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
        res[c] = bfly::tree<S>(v, n_ranks, in_max(4 * q + c, period, n_max));
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
    out[e] = bfly::tree<S>(v, n_ranks, in_max(e, period, n_max));
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

// Stream-ordered flag operations (the waits sit in the stream, never on an
// SM): bfly_signal sets `flag` (this rank's own) to `value` once the work
// before it on `stream` is done, behind a memory fence; bfly_wait holds
// `stream` until every flags[k], k != rank (the peers' mapped flags), is
// >= value. Both return 0 or an error code.
int bfly_signal(unsigned int* flag, unsigned int value, void* stream) {
  if (g_write == nullptr) return kNoEntryPoint;
  const CUresult r = g_write(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(flag),
                             value, CU_STREAM_WRITE_VALUE_DEFAULT);
  if (r == CUDA_ERROR_NOT_SUPPORTED) return kNoMemOps;
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

int bfly_wait(unsigned int* const* flags, int s, int rank, unsigned int value, void* stream) {
  if (s < 1 || s > kMaxRanks || rank < 0 || rank >= s)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_wait == nullptr) return kNoEntryPoint;
  CUresult r = CUDA_SUCCESS;
  for (int k = 0; k < s && r == CUDA_SUCCESS; ++k)
    if (k != rank)
      r = g_wait(static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(flags[k]), value,
                 CU_STREAM_WAIT_VALUE_GEQ);
  if (r == CUDA_ERROR_NOT_SUPPORTED) return kNoMemOps;
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// The tree over the s partials parts[0..s) (rank order) into `out`, n
// words, the last n_max of every `period` max-combined (n_max = 0: all
// sum), with no flag: the kernel alone, on any s device buffers (a call's
// slots, or buffers of this process). Returns 0 or an error code.
int bfly_tree(const float* const* parts, int s, float* out, long long n, long long period,
              long long n_max, int sms, void* stream) {
  if (s < 1 || s > kMaxRanks || n < 0 || period < 1 || n_max < 0 || n_max > period)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Parts p{};
  p.s = s;
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
  switch (s) {
    case 2: return static_cast<int>(launch_tree<2>(p, s, out, n, period, n_max, vec, b, st));
    case 4: return static_cast<int>(launch_tree<4>(p, s, out, n, period, n_max, vec, b, st));
    default: return static_cast<int>(launch_tree<0>(p, s, out, n, period, n_max, vec, b, st));
  }
}

// One standalone call of B7 on `stream`, once this rank's partial of call
// `count` is in its slot: its flag (flags[rank], in its own allocation) :=
// count + 1; a wait for every peer's flag >= count + 1; then the tree over
// the slots parts[0..s) into `out` (bfly_tree). Returns 0 or an error code.
int bfly_reduce(const float* const* parts, unsigned int* const* flags, int s, int rank,
                unsigned int count, float* out, long long n, long long period, long long n_max,
                int sms, void* stream) {
  if (s < 2 || s > kMaxRanks || rank < 0 || rank >= s)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = bfly_signal(flags[rank], count + 1u, stream);
  if (rc == 0) rc = bfly_wait(flags, s, rank, count + 1u, stream);
  if (rc == 0) rc = bfly_tree(parts, s, out, n, period, n_max, sms, stream);
  return rc;
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
