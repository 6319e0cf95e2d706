// The on-device multi-chunk loop for Hopper (sm_90a): a CUDA graph whose
// conditional WHILE node runs a chunk kernel, then decides on the card
// whether to run another.
//
// Replaces the lax.while_loop of odesat_tpu/models/ode.py:443-538
// (make_multi_chunk_runner), odesat_tpu/models/stoch.py:267-309
// (make_multi_stoch_runner), the one-dispatch path of
// odesat_tpu/utils/tts.py:180-232 and, on a trajectory-only mesh,
// odesat_tpu/parallel/sharded.py:332-414 and :862-922, whose `cond` tests
// the done flags before each chunk (pmax- or pmin-reduced over `traj` on a
// mesh) and whose body runs one chunk. The TPU program is one XLA while
// loop around a Pallas call; on the card it is one graph:
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
// On a trajectory-only mesh (ops/device_loop.py MeshPeers) the ranks are
// processes, each running this graph over its own rows, and `stopped` is
// the group's: the head kernel (when bound > 0) and the decide kernel
// (when ran < bound) each make one exchange of the rank's own stopped bit
// through pages shared once over CUDA IPC (ops/butterfly.share_pages), a
// page a rank: word 0 the rank's count of exchanges (its own page only,
// never reset, shared by every graph of the group), words 1 and 2 a ring.
// Exchange s (one thread):
//
//   1. publish (s << 1) | bit to word 1 + (s & 1) of its own page, with a
//      system-scope release (st.release.sys);
//   2. poll every peer's word 1 + (s & 1) (ld.acquire.sys, __nanosleep
//      back-off) until it holds (s << 1) | bit of that peer;
//   3. stopped = OR of the bits (AND with stop_all).
//
// Every rank reads the same bits, so every rank takes the same decision at
// every exchange, runs the same chunks and returns the same count: a state
// stopped at entry on any rank (on every rank with stop_all) runs no chunk
// anywhere. Two words a rank suffice: a peer can publish s + 1 before this
// rank has read s (it has read every word of s, decided and gone on, or
// ended its dispatch and begun the next), but not s + 2, which needs this
// rank's s + 1; one word would let s + 1 overwrite s unread
// (tests/test_torch_mesh_loop.py model-checks both). The poll is a kernel,
// not a stream wait: a wait must time out, and the value it waits for
// changes every exchange while a captured body is fixed. It reads
// %globaltimer and gives up after the peers' timeout (the run's collective
// timeout): ctrl[ERROR] = 1, the missing ranks' bits in ctrl[MISS_LO/HI],
// and the loop stops; the host raises. Without MPS the contexts of ranks
// that share a card are time-sliced, and a rank polling holds its slice
// while its peer needs the card; one rank a card does not share.
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
// The state a dispatch runs on (ops/device_loop.py): B1's and B2's graphs
// read its buffers' addresses from a pointer block on the card, which the
// host writes with the bound before each launch, and the head kernel reads
// the done flags through it. So the graph runs in place on the caller's own
// buffers, whichever they are, as XLA runs a while loop on a donated buffer;
// nothing is copied in or out. B3's, B4's and the scan chunk's graphs hold
// their buffers' addresses themselves; their loops read done there
// directly.
//
// The chunk kernels write a constant 1 to the stop word (order-free, no
// float atomics), so the body's outcome does not depend on the order of
// the CTAs. The host writes ctrl[BOUND] before each launch and reads
// ctrl[RAN] after it: one word a dispatch, where the host loop read the
// done flags after every chunk. One graph serves every bound (JAX's traced
// bound), so a runner builds it once for its buffers.
//
// What bounds it: nothing of the card's rates. The head reads B done bytes
// once a dispatch; the decide kernel reads and writes three words a chunk,
// and on a mesh one word a rank (T words).
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

constexpr int kBound = 0;   // ctrl words: the chunks this dispatch may run,
constexpr int kRan = 1;     // the chunks it has run,
constexpr int kStop = 2;    // the stop word of the chunk running now,
constexpr int kError = 3;   // 1 after an exchange that timed out,
constexpr int kMissLo = 4;  // and the ranks it missed (bit q: rank q),
constexpr int kMissHi = 5;  // ranks 32-63
constexpr int kHeadThreads = 1024;
constexpr int kMaxPeers = 64;
constexpr unsigned int kMaxPause = 1024;  // ns, the poll's longest sleep

// A trajectory group's exchange pages (n = 0: no mesh), rank order.
struct Peers {
  unsigned int* page[kMaxPeers];
  int n;
  int rank;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ void store_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One exchange of the group (one thread): this rank's `bit` (its rows
// stopped by the loop's rule) against every peer's. Returns whether the
// group stops: OR of the bits (AND with stop_all), or true after a wait
// past the timeout, with ctrl's error words written.
__device__ bool exchange(const Peers& p, bool bit, int stop_all, int* ctrl) {
  unsigned int* own = p.page[p.rank];
  const unsigned int s = *reinterpret_cast<volatile unsigned int*>(own) + 1u;
  *reinterpret_cast<volatile unsigned int*>(own) = s;
  const int slot = 1 + static_cast<int>(s & 1u);
  const unsigned int want = s & 0x7fffffffu;
  store_release(own + slot, (s << 1) | (bit ? 1u : 0u));
  bool any = bit, all = bit;
  unsigned long long waiting = 0;  // bit q: peer q not read yet
  for (int q = 0; q < p.n; ++q)
    if (q != p.rank) waiting |= 1ull << q;
  const unsigned long long t0 = global_ns();
  unsigned int pause = 32;
  while (waiting != 0) {
    for (int q = 0; q < p.n; ++q) {
      if (((waiting >> q) & 1ull) == 0) continue;
      const unsigned int w = load_acquire(p.page[q] + slot);
      if ((w >> 1) != want) continue;
      any |= (w & 1u) != 0;
      all &= (w & 1u) != 0;
      waiting &= ~(1ull << q);
    }
    if (waiting == 0) break;
    if (global_ns() - t0 > p.timeout_ns) {
      ctrl[kMissLo] = static_cast<int>(waiting & 0xffffffffull);
      ctrl[kMissHi] = static_cast<int>(waiting >> 32);
      ctrl[kError] = 1;
      return true;
    }
    __nanosleep(pause);
    if (pause < kMaxPause) pause *= 2;
  }
  return stop_all ? all : any;
}

// Whether the loop goes on from a state whose own rows are `stopped`: no
// when they are, off a mesh; else the group's exchange decides.
__device__ bool go_on(const Peers& p, bool stopped, int stop_all, int* ctrl) {
  return !(p.n > 0 ? exchange(p, stopped, stop_all, ctrl) : stopped);
}

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
    loop_head_kernel(int* ctrl, const unsigned char* done, const unsigned char* const* done_at,
                     int B, int stop_all, Peers peers, cudaGraphConditionalHandle handle) {
  const bool stopped = stopped_by(done_at != nullptr ? *done_at : done, B, stop_all);
  if (threadIdx.x == 0) {
    ctrl[kRan] = 0;
    ctrl[kStop] = 0;
    ctrl[kError] = 0;
    ctrl[kMissLo] = 0;
    ctrl[kMissHi] = 0;
    const bool go = ctrl[kBound] > 0 && go_on(peers, stopped, stop_all, ctrl);
    cudaGraphSetConditional(handle, go ? 1u : 0u);
  }
}

// The stop word in the chunk kernels' sense: 1 to stop, or with stop_all
// 1 to keep going.
__global__ void __launch_bounds__(kHeadThreads)
    loop_stop_kernel(int* stop, const unsigned char* done, int B, int stop_all) {
  const bool stopped = stopped_by(done, B, stop_all);
  if (threadIdx.x == 0) *stop = (stop_all ? !stopped : stopped) ? 1 : 0;
}

__global__ void loop_decide_kernel(int* ctrl, int stop_all, Peers peers,
                                   cudaGraphConditionalHandle handle) {
  const int ran = ctrl[kRan] + 1;
  const bool stopped = stop_all ? ctrl[kStop] == 0 : ctrl[kStop] != 0;
  ctrl[kRan] = ran;
  ctrl[kStop] = 0;
  const bool go = ran < ctrl[kBound] && go_on(peers, stopped, stop_all, ctrl);
  cudaGraphSetConditional(handle, go ? 1u : 0u);
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
  Peers peers = {};
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

// The graph up to its body: the head node reading `done` (B bytes; or,
// where `done_at` is not null, the buffer whose address the dispatch
// writes there, the pointer block's) and the WHILE node after it. `ctrl` is the loop's int32 control block (six
// words, on the device). On a trajectory mesh `pages` holds the n >= 2
// ranks' exchange pages (rank order; this rank's own at `rank`) and
// `timeout_ns` bounds each exchange's wait; n = 0 off a mesh. On success
// *out holds the loop; returns a cudaError_t code.
int device_loop_create(void** out, int* ctrl, const unsigned char* done,
                       const unsigned char* const* done_at, int B, int stop_all,
                       void* const* pages, int n, int rank, unsigned long long timeout_ns) {
  *out = nullptr;
  if (B < 0 || n < 0 || n == 1 || n > kMaxPeers || (n > 0 && (rank < 0 || rank >= n)))
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* loop = new Loop();
  loop->ctrl = ctrl;
  loop->stop_all = stop_all != 0;
  loop->peers.n = n;
  loop->peers.rank = rank;
  loop->peers.timeout_ns = timeout_ns;
  for (int q = 0; q < n; ++q) {
    if (pages[q] == nullptr) {
      delete loop;
      return static_cast<int>(cudaErrorInvalidValue);
    }
    loop->peers.page[q] = static_cast<unsigned int*>(pages[q]);
  }
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&loop->handle, loop->graph, 0, 0);
  cudaGraphNode_t head = nullptr;
  if (err == cudaSuccess) {
    void* args[] = {&loop->ctrl, const_cast<unsigned char**>(&done), &done_at, &B,
                    &loop->stop_all, &loop->peers, &loop->handle};
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
  loop_decide_kernel<<<1, 1, 0, loop->capture>>>(loop->ctrl, loop->stop_all, loop->peers,
                                                 loop->handle);
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
