// Kernel K12: the heaviest-path DP of many POA graphs.
//
// Replaces otter_tpu/ops/poa_device.py::_heaviest_step (jnp: Ip >= depth
// Jacobi sweeps, each a gather and a scatter-max over every edge, then a
// tie pass with a scatter-min of edge ids; OTTER_TPU_POA_DEVICE=1 sends
// the consensus of ops/consensus.py there). Per node v of each graph:
//
//   h[v]       = 0 for a node with no in-edge, else
//                max over in-edges e = (u, v, w) of fl32(h[u] + w);
//   min_eid[v] = the least edge id e whose fl32(h[u] + w) == h[v]
//                (the graph's edge count for a node with no in-edge).
//
// Edge ids number the edges by ascending source node, then out-list
// position (the oracle's order, ops/poa.py). The sweeps converge to the one
// fixed point of this recurrence on a DAG, and max is exact and does not
// depend on order, so walking the nodes level by level (Kahn levels: a
// node's longest path from a source) gives the same float32 values with
// O(E) work in place of O(E Ip).
//
// What bounds it: the chain of levels. Each level needs the one before it,
// and hifi-tr-1.5k's graphs have ~1.5-1.8 k levels of a few nodes each, so
// a graph is ~1.5 k dependent steps of a load or two each, not bytes or
// operations (~20 operations an edge).
//
// Design: one warp per graph, h in shared memory while the graph has at
// most kSmemNodes nodes (device memory past that). The host lists each
// graph's nodes in level order with their in-edges (CSR by node, in
// ascending edge id), so a level is a run of positions and a lane walks a
// node's in-edges in id order: the first candidate equal to the maximum is
// the least id, and the tie pass costs nothing. One __syncwarp a level.
// The next level's bounds and each lane's first node of it (its id and
// in-edge range) are loaded while the current level runs, so a level
// waits on its edges' loads alone.

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#ifndef __CUDACC__
// host build of this source (the CPU tests' warp emulation)
inline float __fadd_rn(float a, float b) { return a + b; }
#endif

namespace {

constexpr int kSmemNodes = 49152;  // 192 KB of h
constexpr int kMeta = 5;  // node offset, nodes, level offset, levels, edges

struct NodeRef {
  int v, e0, e1;  // global node id, in-edge range
};

__device__ __forceinline__ NodeRef fetch(const int32_t* node_of,
                                         const int32_t* in_ptr, int pos,
                                         int hi) {
  if (pos >= hi) return {0, 0, 0};
  return {node_of[pos], in_ptr[pos], in_ptr[pos + 1]};
}

__global__ void __launch_bounds__(32)
poa_heaviest_kernel(const int32_t* __restrict__ node_of,
                    const int32_t* __restrict__ lvl_ptr,
                    const int32_t* __restrict__ in_ptr,
                    const int32_t* __restrict__ e_src,
                    const float* __restrict__ e_w,
                    const int32_t* __restrict__ e_id,
                    const int32_t* __restrict__ meta, bool in_smem,
                    float* __restrict__ h_out,
                    int32_t* __restrict__ min_eid) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x;
  const int32_t* m = meta + blockIdx.x * kMeta;
  const int node_off = m[0];
  const int n_nodes = m[1];
  const int32_t* lp = lvl_ptr + m[2];
  const int n_levels = m[3];
  const int n_edges = m[4];
  // h indexed by graph-local node id
  float* h = in_smem ? reinterpret_cast<float*>(smem_raw) : h_out + node_off;
  int lo = lp[0];
  int hi = lp[1];
  NodeRef first = fetch(node_of, in_ptr, lo + lane, hi);
#pragma unroll 1
  for (int l = 0; l < n_levels; ++l) {
    const int nhi = l + 1 < n_levels ? lp[l + 2] : hi;
    const NodeRef next = fetch(node_of, in_ptr, hi + lane, nhi);
    for (int pos = lo + lane; pos < hi; pos += 32) {
      const NodeRef nd =
          pos == lo + lane ? first : fetch(node_of, in_ptr, pos, hi);
      float best = 0.f;
      int arg = n_edges;
      for (int e = nd.e0; e < nd.e1; ++e) {
        const float cand = __fadd_rn(h[e_src[e] - node_off], e_w[e]);
        if (e == nd.e0 || cand > best) best = cand, arg = e_id[e];
      }
      h[nd.v - node_off] = best;
      min_eid[nd.v] = arg;
    }
    __syncwarp();
    lo = hi;
    hi = nhi;
    first = next;
  }
  if (in_smem) {
    for (int v = lane; v < n_nodes; v += 32) h_out[node_off + v] = h[v];
  }
}

}  // namespace

// A batch of n_graphs graphs, their nodes numbered globally (graph b's are
// meta[5 b] .. + meta[5 b + 1]). node_of: node ids in level order, each
// graph's nodes a run starting at its node offset; lvl_ptr: per graph
// (from meta[5 b + 2]) its meta[5 b + 3] + 1 level bounds, as positions in
// node_of; in_ptr: total nodes + 1 bounds of each position's in-edges in
// e_src (global source ids), e_w (float32 weights), e_id (graph-local edge
// ids, ascending within a node); meta[5 b + 4]: graph b's edge count.
// max_nodes: the most nodes of a graph. h, min_eid: total nodes each, by
// global node id. Returns the CUDA error of the launch (0 on success).
extern "C" int otter_poa_heaviest(const int32_t* node_of,
                                  const int32_t* lvl_ptr,
                                  const int32_t* in_ptr,
                                  const int32_t* e_src, const float* e_w,
                                  const int32_t* e_id, const int32_t* meta,
                                  int n_graphs, int max_nodes, float* h,
                                  int32_t* min_eid, cudaStream_t stream) {
  if (n_graphs <= 0) return 0;
  const bool in_smem = max_nodes <= kSmemNodes;
  const int smem = in_smem ? 4 * max_nodes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_heaviest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  poa_heaviest_kernel<<<n_graphs, 32, smem, stream>>>(
      node_of, lvl_ptr, in_ptr, e_src, e_w, e_id, meta, in_smem, h,
      min_eid);
  return static_cast<int>(cudaGetLastError());
}
