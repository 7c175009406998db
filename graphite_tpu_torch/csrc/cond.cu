// Conditional regions of a CUDA graph capture: the device-side branch and
// loop of the captured LM iteration (ops/device_loop.py, cond and
// while_loop).
//
// Replaces no TPU kernel. It is the port's counterpart of the JAX
// package's control flow under jit_loop: jax.lax.cond's accept / reject
// (graphite_tpu/optimizers/lm.py, on_accept) and the lax.while_loop exits
// of the LM (lm.py, levenberg_marquardt) and of the PCG
// (graphite_tpu/ops/pcg_loop.py, run_pcg). XLA compiles those into device
// control flow; a CUDA graph gets it from a conditional node (CUDA 12.4):
// a node holding a body graph that runs on a replay while (a "while"
// node) or once if (an "if" node) the node's handle is non-zero.
//
// gt_cond_begin, called while `parent` is capturing:
//   1. creates a conditional handle in the graph `parent` captures into;
//   2. captures gt_cond_set, a one-thread kernel that sets the handle from
//      the 0-d bool `pred` (read on the device at replay time, never on the
//      host);
//   3. adds an "if" or a "while" conditional node after it and makes that
//      node the capture's only dependency, so what `parent` captures next
//      runs after the whole region;
//   4. starts capturing `body` into the node's body graph.
// A while body ends with gt_cond_set_handle: gt_cond_set again, on the
// loop's next predicate, captured as the body's last node. gt_cond_end
// ends the body's capture. Regions nest: a body stream may itself be the
// parent of another region (each depth has its own stream).
//
// A body graph holds kernel, memset, memcpy (device memory), child graph
// and conditional nodes: the kernels launched on `body` by PyTorch, cuBLAS
// / cuSOLVER and K1-K6 (a thread-block cluster launch included). No host
// node, no event node, no host memory and no host read may lie inside a
// region: gt_cond_end names the first node that does (the graph would
// not instantiate).
//
// Bound: launch latency. gt_cond_set moves one byte; a replay pays one
// tiny kernel and the node's evaluation per region (per pass of a loop).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

namespace {

__global__ void gt_cond_set(cudaGraphConditionalHandle handle,
                            const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The capture state of `s`: its graph and its current dependencies. CUDA 13
// adds the edge data to these calls (left null: no edge carries data).
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  n_deps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n_deps);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

cudaError_t set_dependency(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      s, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      s, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

// The first node of `graph` (child graphs included) that a conditional
// body cannot hold: its type, and for a memcpy or memset node the memory
// types of its source and destination (cudaMemoryType; -1 where none).
// out = {-1, -1, -1} when every node may stay. A node whose parameters
// cannot be read is passed over (the instantiation still judges it).
void find_refused(cudaGraph_t graph, int* out) {
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess || n == 0) return;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  if (cudaGraphGetNodes(graph, nodes, &n) != cudaSuccess) n = 0;
  for (size_t i = 0; i < n && out[0] < 0; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) continue;
    const void* ptrs[2] = {nullptr, nullptr};  // source, destination
    if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p = {};
      if (cudaGraphMemcpyNodeGetParams(nodes[i], &p) != cudaSuccess) continue;
      ptrs[0] = p.srcArray ? nullptr : p.srcPtr.ptr;
      ptrs[1] = p.dstArray ? nullptr : p.dstPtr.ptr;
    } else if (type == cudaGraphNodeTypeMemset) {
      cudaMemsetParams p = {};
      if (cudaGraphMemsetNodeGetParams(nodes[i], &p) != cudaSuccess) continue;
      ptrs[1] = p.dst;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if (cudaGraphChildGraphNodeGetGraph(nodes[i], &child) == cudaSuccess)
        find_refused(child, out);
      continue;
    } else {
      if (type != cudaGraphNodeTypeKernel && type != cudaGraphNodeTypeEmpty &&
          type != cudaGraphNodeTypeConditional)
        out[0] = static_cast<int>(type);
      continue;
    }
    // memcpy / memset: device memory only
    int kinds[2] = {-1, -1};
    bool refused = false;
    for (int j = 0; j < 2; ++j) {
      cudaPointerAttributes a;
      if (!ptrs[j] || cudaPointerGetAttributes(&a, ptrs[j]) != cudaSuccess)
        continue;
      kinds[j] = static_cast<int>(a.type);
      refused |= a.type != cudaMemoryTypeDevice;
    }
    if (refused) {
      out[0] = static_cast<int>(type);
      out[1] = kinds[0];
      out[2] = kinds[1];
    }
  }
  delete[] nodes;
}

}  // namespace

#define GT_TRY(call)                         \
  do {                                       \
    cudaError_t err_ = (call);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

extern "C" int gt_cond_stream_create(void** out) {
  // stream creation is not a capture operation: relax this thread's
  // capture mode around it, as PyTorch's allocator does around cudaMalloc
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  GT_TRY(cudaThreadExchangeStreamCaptureMode(&mode));
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaThreadExchangeStreamCaptureMode(&mode);
  *out = s;
  return static_cast<int>(err);
}

// loop: 0 for an "if" node, 1 for a "while" node; *handle_out gets the
// node's handle (for gt_cond_set_handle)
extern "C" int gt_cond_begin(void* parent, const void* pred, void* body,
                             int loop, void** body_graph,
                             unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  GT_TRY(capture_info(ps, &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  GT_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  gt_cond_set<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  GT_TRY(cudaGetLastError());
  GT_TRY(capture_info(ps, &status, &graph, &deps, &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  GT_TRY(add_node(&node, graph, deps, n_deps, &params));
  GT_TRY(set_dependency(ps, &node));
  *body_graph = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal));
}

// Captures gt_cond_set on `stream`: the handle from `pred` (a while body's
// last node, which decides whether the loop runs its body again).
extern "C" int gt_cond_set_handle(void* stream, unsigned long long handle,
                                  const void* pred) {
  gt_cond_set<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gt_cond_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

// find_refused on a body graph; `refused` gets its answer. The queries'
// own errors are cleared, so that no later launch check reports them; an
// error pending before the walk is left for its owner (and no answer).
extern "C" int gt_cond_check(void* body_graph, int* refused) {
  refused[0] = refused[1] = refused[2] = -1;
  if (cudaPeekAtLastError() != cudaSuccess) return 0;
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  GT_TRY(cudaThreadExchangeStreamCaptureMode(&mode));
  find_refused(static_cast<cudaGraph_t>(body_graph), refused);
  cudaGetLastError();
  cudaThreadExchangeStreamCaptureMode(&mode);
  return 0;
}

extern "C" const char* gt_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
