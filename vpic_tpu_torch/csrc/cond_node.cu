// Conditional nodes of a CUDA graph under stream capture: the port's
// counterpart of the branch that lax.cond takes on the device
// (vpic_tpu/engine/step.py:93-119, 252-255, 411-424;
// vpic_tpu/particles/sort_pallas.py:347, 355).  CUDA C++ for sm_90a
// (H100), CUDA 12.4 or later.
//
// Replaces no TPU kernel: XLA lowers lax.cond to its own control flow.
// The port captures its step into CUDA graphs (engine/graphs.py), and the
// PyTorch on the card binds no conditional node to Python, so these
// entries build one into the graph that a stream is capturing
// (engine/cond.py drives them):
//
// vpic_cond_begin(parent, body, pred, negate) adds an if-node after the
// work the parent stream has captured so far, and begins capturing the
// body stream into the node's body graph.  The node's handle is set at
// every launch of the graph by set_if_kernel, one thread on the parent
// stream just before the node, from the 0-d bool *pred (its negation
// where `negate`).  Work issued to the body stream until vpic_cond_end
// runs only where the handle is 1.  A body may hold kernels, copies,
// sets and further conditional nodes; the parent stream's capture goes
// on after the node.
//
// Bound: one thread reads one byte; the node's cost is a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const unsigned char* pred, int negate) {
  cudaGraphSetConditional(handle, (*pred != 0) != (negate != 0) ? 1u : 0u);
}

}  // namespace

extern "C" {

// A stream of its own for conditional bodies (never one of PyTorch's
// pooled streams, which other code may be capturing on).
int vpic_cond_stream(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = (void*)s;
  return (int)err;
}

int vpic_cond_begin(void* parent, void* body, const void* pred, int negate) {
  const cudaStream_t ps = (cudaStream_t)parent;
  // the launch check below must see the set kernel's own error only, not
  // one a failed call left as this thread's last error
  (void)cudaGetLastError();
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph,
                                             nullptr, nullptr, nullptr);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if_kernel<<<1, 1, 0, ps>>>(handle, (const unsigned char*)pred, negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the node depends on what the parent stream captured, set kernel last
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, nullptr,
                                 &n_deps);
#else
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  // the parent stream's capture goes on after the node
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      ps, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeGlobal);
}

// End the body's capture begun by vpic_cond_begin (the node keeps its
// body graph).  A capture that a call inside the body invalidated ends
// with its error, which is returned and not left as this thread's last
// error.
int vpic_cond_end(void* body) {
  cudaGraph_t graph = nullptr;
  const cudaError_t err = cudaStreamEndCapture((cudaStream_t)body, &graph);
  if (err != cudaSuccess) (void)cudaGetLastError();
  return (int)err;
}

}  // extern "C"
