// Conditional nodes of a CUDA graph: the device-side `if` and `while` of a
// captured frame (pipeline.py's transparent peel loop, the JAX package's
// lax.while_loop in tpu_renderer/pipeline.py). PyTorch captures the frame
// through stream capture; these entry points splice a conditional node into
// the graph being captured on `stream` and start capturing its body on
// `body_stream`, so the torch operations that follow run in the body.
//
// The node's handle is set on the device from a one-byte bool on the card
// by set_conditional (one thread): before the node, for its first test,
// and, for a WHILE node, at the end of each pass of the body for the next
// one. Nothing here reads the predicate on the host, so the loop never
// waits for the host and the host never waits for the card.
//
// Needs CUDA 12.4 or later (conditional nodes, cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Add a conditional node (kind 0: IF, 1: WHILE) after the work captured so
// far on `stream`, tested on *pred, and begin capturing its body on
// `body_stream` (which must not be capturing). *handle_out receives the
// node's handle, for graph_conditional_set and graph_conditional_end.
extern "C" int graph_conditional_begin(void* stream, void* body_stream, int kind,
                                       const void* pred,
                                       unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end at the set_conditional launch
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                      params.conditional.phGraph_out[0], nullptr,
                                      nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaSuccess;
}

// Capture, on the body's stream, a launch that sets the node's handle from
// *pred: a WHILE body ends with it (0 leaves the loop).
extern "C" int graph_conditional_set(void* body_stream, unsigned long long handle,
                                     const void* pred) {
  set_conditional<<<1, 1, 0, static_cast<cudaStream_t>(body_stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
  return cudaGetLastError();
}

// End the capture of a conditional node's body.
extern "C" int graph_conditional_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// A stream for capturing conditional bodies (never destroyed: a few are
// made in a process, one a nesting depth).
extern "C" int graph_body_stream(void** stream_out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  *stream_out = s;
  return cudaSuccess;
}
