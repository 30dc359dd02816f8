// The decode chunk as one CUDA graph with a conditional WHILE node: the
// counterpart of the reference's lax.while_loop over decode steps
// (src/repro/serving/programs.py, cond `(i < chunk) & any(~done)`).
//
// Graph:  [set_condition] -> WHILE(h) { [step graph (child)] -> [set_condition] }
//
// The step graph is a PyTorch capture of one decode step (its raw
// cudaGraph_t); it advances `step` and `done` in place. set_condition
// writes `step < nsteps && any(!done)` into the loop's handle, before the
// first iteration and after every step, so the chunk ends on the device
// once every row is done, with no host sync. Needs CUDA 12.4 or later.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const long long* step, const int* nsteps,
                              const bool* done, int rows) {
  __shared__ int live;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    if (!done[i]) live = 1;
  __syncthreads();
  if (threadIdx.x == 0)
    cudaGraphSetConditional(handle, (live && *step < *nsteps) ? 1u : 0u);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, ndeps, params);
#else
  return cudaGraphAddNode(node, graph, deps, ndeps, params);
#endif
}

}  // namespace

#define TRY(x)                              \
  do {                                      \
    cudaError_t e_ = (x);                   \
    if (e_ != cudaSuccess) {                \
      if (graph) cudaGraphDestroy(graph);   \
      return (int)e_;                       \
    }                                       \
  } while (0)

// Build and instantiate the loop around `body` (not consumed: the child
// node holds a copy of it). `step` int64[1], `nsteps` int32[1] and `done`
// bool[rows] are device buffers the step graph reads and writes in place.
extern "C" int decode_loop_build(void* body, const void* step,
                                 const void* nsteps, const void* done,
                                 int rows, void** exec_out) {
  cudaGraph_t graph = nullptr;
  TRY(cudaGraphCreate(&graph, 0));
  cudaGraphConditionalHandle handle;
  TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault));
  void* args[] = {&handle, (void*)&step, (void*)&nsteps, (void*)&done, &rows};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)set_condition;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(128);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t first, loop, child, tail;
  TRY(cudaGraphAddKernelNode(&first, graph, nullptr, 0, &kp));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  TRY(add_node(&loop, graph, &first, 1, &cp));
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  TRY(cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, (cudaGraph_t)body));
  TRY(cudaGraphAddKernelNode(&tail, inner, &child, 1, &kp));
  cudaGraphExec_t exec;
  TRY(cudaGraphInstantiate(&exec, graph, 0));
  cudaGraphDestroy(graph);
  *exec_out = (void*)exec;
  return 0;
}

extern "C" int decode_loop_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int decode_loop_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
