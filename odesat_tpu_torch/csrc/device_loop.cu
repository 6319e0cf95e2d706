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

namespace {

constexpr int kBound = 0;  // ctrl words: the chunks this dispatch may run,
constexpr int kRan = 1;    // the chunks it has run,
constexpr int kStop = 2;   // and the stop word of the chunk running now
constexpr int kHeadThreads = 1024;

__global__ void __launch_bounds__(kHeadThreads)
    loop_head_kernel(int* ctrl, const unsigned char* done, int B, int stop_all,
                     cudaGraphConditionalHandle handle) {
  bool any = false, all = true;
  for (int i = static_cast<int>(threadIdx.x); i < B; i += blockDim.x) {
    const bool d = done[i] != 0;
    any |= d;
    all &= d;
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    const bool stopped = stop_all ? all : any;
    ctrl[kRan] = 0;
    ctrl[kStop] = 0;
    cudaGraphSetConditional(handle, (ctrl[kBound] > 0 && !stopped) ? 1u : 0u);
  }
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
