// The on-device multi-chunk loop for Hopper (sm_90a): a CUDA graph whose
// conditional WHILE node runs a chunk kernel, then decides on the card
// whether to run another.
//
// Replaces the lax.while_loop of odesat_tpu/models/ode.py:443-538
// (make_multi_chunk_runner), odesat_tpu/models/stoch.py:267-309
// (make_multi_stoch_runner) and the one-dispatch path of
// odesat_tpu/utils/tts.py:180-232, whose `cond` tests the done flags before
// each chunk and whose body runs one chunk. The TPU program is one XLA
// while loop around a Pallas call; on the card it is one graph:
//
//   head kernel (one CTA)   ctrl[RAN] = 0, ctrl[STOP] = 0, and the WHILE
//                           node's condition = bound > 0 && !stopped(done),
//                           stopped = any(done) (all(done) with stop_all)
//   WHILE node, its body captured once from the chunk kernel's own launch
//   entry (fused_chunk_launch, stream_chunk_launch, stoch_*_launch) on the
//   loop's capture stream, with the kernel's stop hook pointed at
//   ctrl[STOP], then:
//   decide kernel (1 thread) ctrl[RAN] += 1; condition = ran < bound &&
//                           !stopped, stopped = ctrl[STOP] (inverted with
//                           stop_all: there the word says "keep going");
//                           ctrl[STOP] = 0 for the next chunk
//
// The scan tier's chunk (ops/scan_chunk.py) is many kernels captured by
// torch into a graph of its own. Its body is that graph as a child graph
// node (device_loop_add_graph, added to the capture through the stream's
// capture dependencies), then:
//
//   stop kernel (one CTA)   ctrl[STOP] = any(done) (stop_all: !all(done)),
//                           the head kernel's reduction over the chunk's
//                           result, written to the word the chunk kernels
//                           raise themselves
//
// A conditional body takes only kernel, memset, device-to-device memcpy,
// empty, child-graph and conditional nodes; device_loop_add_graph walks the
// child graph and refuses any other node, naming its type.
//
// The chunk kernels write a constant 1 to the stop word (order-free, no
// float atomics), so the body's outcome does not depend on the order of
// the CTAs. The host writes ctrl[BOUND] before each launch and reads
// ctrl[RAN] after it: one word a dispatch, where the host loop read the
// done flags after every chunk. One graph serves every bound (JAX's traced
// bound), so a runner builds it once for its buffers.
//
// What bounds it: nothing of the card's rates. The head reads B done bytes
// once a dispatch; the decide kernel reads and writes three words a chunk.
// What it removes is the host between chunks: each chunk used to end in a
// device-to-host read and a round trip before the next launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false (the
// flags of every source here). cudaGraphSetConditional is a device runtime
// builtin that needs no separate compilation; WHILE nodes need CUDA 12.4 or
// later on both sides of the build, and every failure is returned as a
// cudaError_t code for the caller to raise: there is no other loop to fall
// back to.

#include <cuda_runtime.h>

#include <vector>

namespace {

constexpr int kBound = 0;  // ctrl words: the chunks this dispatch may run,
constexpr int kRan = 1;    // the chunks it has run,
constexpr int kStop = 2;   // and the stop word of the chunk running now
constexpr int kHeadThreads = 1024;

// Whether the B done flags stop the loop: any set (every one set with
// stop_all). Called by every thread of one CTA.
__device__ bool stopped_by(const unsigned char* done, int B, int stop_all) {
  bool any = false, all = true;
  for (int i = static_cast<int>(threadIdx.x); i < B; i += blockDim.x) {
    const bool d = done[i] != 0;
    any |= d;
    all &= d;
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  return stop_all ? all : any;
}

__global__ void __launch_bounds__(kHeadThreads)
    loop_head_kernel(int* ctrl, const unsigned char* done, int B, int stop_all,
                     cudaGraphConditionalHandle handle) {
  const bool stopped = stopped_by(done, B, stop_all);
  if (threadIdx.x == 0) {
    ctrl[kRan] = 0;
    ctrl[kStop] = 0;
    cudaGraphSetConditional(handle, (ctrl[kBound] > 0 && !stopped) ? 1u : 0u);
  }
}

// The stop word in the chunk kernels' sense: 1 to stop, or with stop_all
// 1 to keep going.
__global__ void __launch_bounds__(kHeadThreads)
    loop_stop_kernel(int* stop, const unsigned char* done, int B, int stop_all) {
  const bool stopped = stopped_by(done, B, stop_all);
  if (threadIdx.x == 0) *stop = (stop_all ? !stopped : stopped) ? 1 : 0;
}

__global__ void loop_decide_kernel(int* ctrl, int stop_all, cudaGraphConditionalHandle handle) {
  const int ran = ctrl[kRan] + 1;
  const bool stopped = stop_all ? ctrl[kStop] == 0 : ctrl[kStop] != 0;
  ctrl[kRan] = ran;
  ctrl[kStop] = 0;
  cudaGraphSetConditional(handle, (ran < ctrl[kBound] && !stopped) ? 1u : 0u);
}

// A loop: the graph (head node -> WHILE node), the body graph the WHILE
// node owns, its executable, and the stream the body is captured on.
struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
  cudaStream_t capture = nullptr;
  int* ctrl = nullptr;
  int stop_all = 0;
};

bool on_device(const void* ptr) {
  cudaPointerAttributes a = {};
  if (cudaPointerGetAttributes(&a, ptr) != cudaSuccess) {
    cudaGetLastError();  // not a pointer the runtime knows: clear the error, refuse it
    return false;
  }
  return a.type == cudaMemoryTypeDevice;
}

// Whether a conditional body may hold every node of `graph` (child graphs
// walked); else the type of the first node it may not, in *bad_type.
cudaError_t check_body(cudaGraph_t graph, int* bad_type) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) err = cudaGraphGetNodes(graph, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    bool ok = type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemset ||
              type == cudaGraphNodeTypeEmpty || type == cudaGraphNodeTypeConditional;
    if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      err = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      ok = err == cudaSuccess &&
           (p.kind == cudaMemcpyDeviceToDevice ||
            (p.kind == cudaMemcpyDefault && on_device(p.srcPtr.ptr) && on_device(p.dstPtr.ptr)));
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = check_body(child, bad_type);
      if (err != cudaSuccess) return err;
      ok = true;
    }
    if (err != cudaSuccess) break;
    if (!ok) {
      *bad_type = static_cast<int>(type);
      return cudaErrorNotSupported;
    }
  }
  return err;
}

void destroy(Loop* loop) {
  if (loop->exec) cudaGraphExecDestroy(loop->exec);
  if (loop->graph) cudaGraphDestroy(loop->graph);  // owns the body graph
  if (loop->capture) cudaStreamDestroy(loop->capture);
  delete loop;
}

}  // namespace

extern "C" {

// The graph up to its body: the head node reading `done` (B bytes) and the
// WHILE node after it. `ctrl` is the loop's int32 control block (at least
// three words, on the device). On success *out holds the loop; returns a
// cudaError_t code.
int device_loop_create(void** out, int* ctrl, const unsigned char* done, int B, int stop_all) {
  *out = nullptr;
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  Loop* loop = new Loop();
  loop->ctrl = ctrl;
  loop->stop_all = stop_all != 0;
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&loop->handle, loop->graph, 0, 0);
  cudaGraphNode_t head = nullptr;
  if (err == cudaSuccess) {
    void* args[] = {&loop->ctrl, const_cast<unsigned char**>(&done), &B, &loop->stop_all,
                    &loop->handle};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(loop_head_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(kHeadThreads);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&head, loop->graph, nullptr, 0, &kp);
  }
  if (err == cudaSuccess) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = loop->handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, loop->graph, &head, 1, &cp);
    if (err == cudaSuccess) loop->body = cp.conditional.phGraph_out[0];
  }
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&loop->capture, cudaStreamNonBlocking);
  if (err != cudaSuccess) {
    destroy(loop);
    return static_cast<int>(err);
  }
  *out = loop;
  return 0;
}

// Start capturing the body: the launches the caller then makes on
// *stream (the chunk kernel's) become the body's first nodes.
int device_loop_begin_body(void* handle, void** stream) {
  Loop* loop = static_cast<Loop*>(handle);
  *stream = loop->capture;
  return static_cast<int>(cudaStreamBeginCaptureToGraph(loop->capture, loop->body, nullptr,
                                                        nullptr, 0,
                                                        cudaStreamCaptureModeRelaxed));
}

// Append to the body being captured on `stream` (the loop's capture
// stream) a child graph node running `child` (cloned), after everything
// captured so far. Refuses a graph that holds a node a conditional body
// cannot take: returns cudaErrorNotSupported with the node's
// cudaGraphNodeType in *bad_type (left as it was on any other outcome).
int device_loop_add_graph(void* stream, void* child, int* bad_type) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = static_cast<cudaGraph_t>(child);
  cudaError_t err = check_body(graph, bad_type);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t body = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &body, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphNode_t node = nullptr;
  err = cudaGraphAddChildGraphNode(&node, body, deps, ndeps, graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies));
}

// The stop kernel on `stream`, after what it has captured: the B flags at
// `done` into the word at `stop`.
int device_loop_stop(void* stream, int* stop, const unsigned char* done, int B, int stop_all) {
  loop_stop_kernel<<<1, kHeadThreads, 0, static_cast<cudaStream_t>(stream)>>>(stop, done, B,
                                                                            stop_all);
  return static_cast<int>(cudaGetLastError());
}

// End the body with the decide kernel and instantiate the graph.
int device_loop_end_body(void* handle) {
  Loop* loop = static_cast<Loop*>(handle);
  loop_decide_kernel<<<1, 1, 0, loop->capture>>>(loop->ctrl, loop->stop_all, loop->handle);
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t body = loop->body;
  cudaError_t err = cudaStreamEndCapture(loop->capture, &body);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGraphInstantiate(&loop->exec, loop->graph, 0));
}

// One dispatch: the whole graph on `stream` (the caller's), after the
// caller has written ctrl[BOUND] there.
int device_loop_launch(void* handle, void* stream) {
  Loop* loop = static_cast<Loop*>(handle);
  if (!loop->exec) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(loop->exec, static_cast<cudaStream_t>(stream)));
}

void device_loop_destroy(void* handle) {
  if (handle) destroy(static_cast<Loop*>(handle));
}

const char* device_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
