// Device-gated CUDA graphs: captured step graphs under IF conditional nodes.
//
// The counterpart of the JAX package's device-gated executors,
// strainer_gan_tpu/train/steps.py:476 make_gated_chunked_train_step (a
// lax.cond per scan iteration, `pos < n_valid`, and one outer lax.cond that
// skips a wholly dead chunk) and :575 make_gated_tail_step (a lax.cond on
// `tail_count > 0`).  No TPU kernel is replaced: this is the executor's
// control flow, which XLA compiled into the TPU program and which on the
// card becomes graph structure.
//
// The caller (train/steps.py GatedChunkedStep) captures each step of a
// chunk as its own PyTorch CUDA graph, kept un-instantiated, and hands
// their cudaGraph_t handles here.  sg_gated_build makes one graph:
//
//   [outer]  set_if(h_o: c0 < bound) -> IF h_o {
//              set_if(h_0: c0 + 0 < bound) -> IF h_0 { step 0 }
//           -> set_if(h_1: c0 + 1 < bound) -> IF h_1 { step 1 }
//           -> ... }
//
// where each step graph is cloned into its IF body as a child graph node,
// and c0, bound are int64 device scalars the caller fills before each
// launch (static buffers: the graph keeps their addresses).  Each
// predicate is computed inside the graph by a one-thread kernel that calls
// cudaGraphSetConditional (CUDA 12.3+, sm_90), so no host read decides
// which steps run; a dead step launches none of its kernels, and a wholly
// dead chunk costs its outer predicate kernel alone.  The handles are
// created with cudaGraphCondAssignDefault and default 0: a predicate that
// did not run leaves its body off.
//
// Bound: launch latency, not bytes or operations.  Each live step adds one
// one-thread kernel and a conditional node to the step's own kernels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const long long* c0,
                              const long long* bound, long long offset) {
  cudaGraphSetConditional(handle, (c0[0] + offset < bound[0]) ? 1u : 0u);
}

// Adds to `graph`, after `dep` (null: no dependency), the predicate kernel
// of a new handle and the IF node it drives; returns the IF node and its
// body graph.
cudaError_t add_gate(cudaGraph_t graph, cudaGraphNode_t dep, const long long* c0,
                     const long long* bound, long long offset, cudaGraphNode_t* if_node,
                     cudaGraph_t* body) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                                     cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  void* args[] = {&handle, &c0, &bound, &offset};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_if_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t pred;
  err = cudaGraphAddKernelNode(&pred, graph, dep ? &dep : nullptr, dep ? 1 : 0, &kp);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  err = cudaGraphAddNode(if_node, graph, &pred, 1, &cp);
  if (err != cudaSuccess) return err;
  *body = cp.conditional.phGraph_out[0];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Builds and instantiates the gated graph of `n` captured graphs (see the
// file's comment).  `outer` != 0 puts the chain under one more IF on
// c0 < bound.  On success *exec_out holds the executable graph and
// *conditionals_out the number of conditional nodes; on failure nothing is
// left allocated and the CUDA error is returned.
int sg_gated_build(int device, void* const* graphs, int n, const void* c0, const void* bound,
                   int outer, void** exec_out, int* conditionals_out) {
  *exec_out = nullptr;
  *conditionals_out = 0;
  if (n <= 0) return cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  const long long* c0p = static_cast<const long long*>(c0);
  const long long* bp = static_cast<const long long*>(bound);
  cudaGraph_t root;
  err = cudaGraphCreate(&root, 0);
  if (err != cudaSuccess) return err;
  int conds = 0;
  cudaGraph_t chain = root;
  cudaGraphNode_t prev = nullptr;
  if (outer) {
    err = add_gate(root, nullptr, c0p, bp, 0, &prev, &chain);
    conds += err == cudaSuccess;
    prev = nullptr;  // the chain starts inside the outer body
  }
  for (int j = 0; j < n && err == cudaSuccess; ++j) {
    cudaGraphNode_t if_node;
    cudaGraph_t body;
    err = add_gate(chain, prev, c0p, bp, j, &if_node, &body);
    if (err != cudaSuccess) break;
    ++conds;
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                     static_cast<cudaGraph_t>(graphs[j]));
    prev = if_node;
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, root, 0);
  cudaGraphDestroy(root);
  if (err != cudaSuccess) return err;
  *exec_out = exec;
  *conditionals_out = conds;
  return cudaSuccess;
}

int sg_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

int sg_graph_exec_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

}  // extern "C"
