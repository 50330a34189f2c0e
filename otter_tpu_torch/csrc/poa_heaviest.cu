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
// Design: one warp per graph, h by graph-local position in shared memory
// while the graph has at most kSmemNodes nodes (device-memory scratch past
// that). The host lists each graph's nodes in level order with their
// in-edges (CSR by node, in ascending edge id), so a level is a run of
// positions and a lane walks a node's in-edges in id order: the first
// candidate equal to the maximum is the least id, and the tie pass costs
// nothing. One __syncwarp a level.
// The next level's bounds and each lane's first node of it (its id and
// in-edge range) are loaded while the current level runs, so a level
// waits on its edges' loads alone. That kernel (poa_heaviest_kernel) still
// takes graphs past the streamed kernel's shared memory; each of its
// levels waits on a device-memory round trip or two (~0.34 us).
//
// Both kernels read each in-edge as one 12-byte record: the source's
// graph-local position, the weight and the edge id.
//
// The streamed kernel (poa_stream_kernel, h up to kStreamNodes nodes): a
// block of three warps a graph. The host lays each graph's CSR out in
// level order, so the walk reads it front to back; h and min_eid are kept
// by position in shared memory. Two
// producer warps stream the in-edge bounds and the edge records into rings
// of S chunks in shared memory with 1-D bulk asynchronous copies
// (cp.async.bulk, completion on a "full" mbarrier a slot), each a slot
// ahead as soon as the walker frees it ("empty" mbarrier). Chunks lie on
// the arrays' own grid, so element x of a stream sits at ring[x mod (S x
// chunk)]. Level order is a topological order, so one lane walks the
// positions one after another: a node reads its in-edge bounds, its
// records and h of its sources from shared memory, with no barrier
// between nodes (the levels, a few nodes each, would cost a warp
// barrier and the bookkeeping of a level apiece). It runs without a check
// up to the end of what the rings hold; there the warp waits for the next
// chunk and frees the ones behind it. A node's in-edges must fit the edge
// ring (at most S chunks); the host routes a batch with a larger in-degree
// to the kernel above.

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#ifndef __CUDACC__
// host build of this source (the CPU tests' warp emulation, which also
// provides the mbarrier and bulk-copy helpers below)
inline float __fadd_rn(float a, float b) { return a + b; }
inline void mbar_fence_init() {}
#else
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// the initialised barriers visible to the bulk-copy unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile("{\n\t.reg .pred p;\n\tWAIT:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
               "@!p bra WAIT;\n\t}"
               :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, their completion counted on bar
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}
#endif

namespace {

constexpr int kSmemNodes = 49152;  // 192 KB of h
constexpr int kMeta = 5;  // node offset, nodes, level offset, levels, edges

struct NodeRef {
  int v, e0, e1;  // global node id, in-edge range
};

struct EdgeRec {
  int32_t src;  // the source's graph-local position
  float w;
  int32_t id;
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
                    const EdgeRec* __restrict__ e_rec,
                    const int32_t* __restrict__ meta,
                    float* __restrict__ h_pos, float* __restrict__ h_out,
                    int32_t* __restrict__ min_eid) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x;
  const int32_t* m = meta + blockIdx.x * kMeta;
  const int node_off = m[0];
  const int n_nodes = m[1];
  const int32_t* lp = lvl_ptr + m[2];
  const int n_levels = m[3];
  const int n_edges = m[4];
  // h by graph-local position, in shared memory unless h_pos is given
  float* h = h_pos == nullptr ? reinterpret_cast<float*>(smem_raw)
                              : h_pos + node_off;
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
        const EdgeRec r = e_rec[e];
        const float cand = __fadd_rn(h[r.src], r.w);
        if (e == nd.e0 || cand > best) best = cand, arg = r.id;
      }
      h[pos - node_off] = best;
      min_eid[nd.v] = arg;
    }
    __syncwarp();
    lo = hi;
    hi = nhi;
    first = next;
  }
  for (int v = lane; v < n_nodes; v += 32) {
    h_out[node_of[node_off + v]] = h[v];
  }
}

constexpr int kStreamThreads = 96;   // warp 0 walks, warps 1-2 stream
constexpr int kStreamNodes = 24576;  // h and min_eid: 192 KB
constexpr int kMaxSlots = 16;
constexpr int kStreamSmemBytes = 227 * 1024;
enum Stream { kPositions = 0, kEdges = 1 };

// the rings: 2^lg_slots chunks a stream, 2^lg[k] elements a chunk
struct Ring {
  int lg_slots;
  int lg[2];
};

__host__ __device__ __forceinline__ int elem_bytes(int k) {
  return k == kEdges ? 12 : 4;
}

struct StreamLayout {
  int ring[2];  // byte offsets of the two rings
  int h, me, bytes;
};

__host__ __device__ inline StreamLayout stream_layout(const Ring& g,
                                                      int max_nodes) {
  StreamLayout L;
  int off = 2 * 2 * kMaxSlots * 8;  // the full and empty mbarriers
  for (int k = 0; k < 2; ++k) {
    L.ring[k] = off;
    off += (elem_bytes(k) << g.lg[k]) << g.lg_slots;
  }
  L.h = off;
  L.me = L.h + 4 * ((max_nodes + 3) & ~3);
  L.bytes = L.me + 4 * ((max_nodes + 3) & ~3);
  return L;
}

// The walker's view of one stream: chunks [first, have) acquired, [first,
// freed) handed back; element x at ring[x & mask], readable while
// x < ready().
struct Cursor {
  uint64_t* full;
  uint64_t* empty;
  int lg, lg_slots, mask, first, have, freed;
  __device__ Cursor(uint64_t* f, uint64_t* e, const Ring& g, int k, int lo)
      : full(f + k * kMaxSlots), empty(e + k * kMaxSlots), lg(g.lg[k]),
        lg_slots(g.lg_slots), mask((1 << (g.lg[k] + g.lg_slots)) - 1),
        first(lo >> g.lg[k]), have(lo >> g.lg[k]), freed(lo >> g.lg[k]) {}
  __device__ __forceinline__ int ready() const { return have << lg; }
  // wait for every chunk up to element x's (the whole warp)
  __device__ __forceinline__ void need(int x) {
    for (; have <= (x >> lg); ++have) {
      mbar_wait(full + (have & ((1 << lg_slots) - 1)),
                ((have - first) >> lg_slots) & 1);
    }
  }
  // hand back the chunks below element x's, read by lane 0 only
  __device__ __forceinline__ void drop(int x, int lane) {
    const int c = min(x >> lg, have);
    for (; freed < c; ++freed) {
      if (lane == 0) mbar_arrive(empty + (freed & ((1 << lg_slots) - 1)));
    }
  }
};

__global__ void __launch_bounds__(kStreamThreads)
poa_stream_kernel(const int32_t* __restrict__ in_ptr,
                  const EdgeRec* __restrict__ e_rec,
                  const int32_t* __restrict__ node_of,
                  const int32_t* __restrict__ meta, int n_pos, int n_edge,
                  Ring g, StreamLayout L, float* __restrict__ h_out,
                  int32_t* __restrict__ min_eid) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int32_t* m = meta + blockIdx.x * kMeta;
  const int node_off = m[0];
  const int n_nodes = m[1];
  const int n_edges = m[4];
  const int S = 1 << g.lg_slots;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + 2 * kMaxSlots;
  float* h = reinterpret_cast<float*>(smem_raw + L.h);
  int32_t* me = reinterpret_cast<int32_t*>(smem_raw + L.me);
  if (t < 2 * S) {
    const int k = t / S;
    mbar_init(full + k * kMaxSlots + t % S, 1);
    mbar_init(empty + k * kMaxSlots + t % S, 1);
  }
  mbar_fence_init();
  __syncthreads();
  // the graph's in-edge bounds [node_off, node_off + n] and records
  // [e_lo, e_hi)
  const int e_lo = in_ptr[node_off];
  const int e_hi = in_ptr[node_off + n_nodes];
  if (warp > 0) {
    // producer of stream k: every chunk of its elements [lo, hi] in
    // order, each as soon as the walker has freed its slot
    const int k = warp - 1;
    const int lg = g.lg[k];
    const int esz = elem_bytes(k);
    const int len = k == kPositions ? n_pos : n_edge;
    const int lo = k == kPositions ? node_off : e_lo;
    const int hi = k == kPositions ? node_off + n_nodes : e_hi - 1;
    const uint8_t* base = k == kPositions
        ? reinterpret_cast<const uint8_t*>(in_ptr)
        : reinterpret_cast<const uint8_t*>(e_rec);
    uint8_t* ring = smem_raw + L.ring[k];
    uint64_t* full_k = full + k * kMaxSlots;
    uint64_t* empty_k = empty + k * kMaxSlots;
    const int c0 = lo >> lg;
    const int c1 = hi < lo ? c0 - 1 : hi >> lg;
#pragma unroll 1
    for (int c = c0; c <= c1; ++c) {
      const int rel = c - c0;
      const int slot = c & (S - 1);
      if (rel >= S) mbar_wait(empty_k + slot, ((rel >> g.lg_slots) - 1) & 1);
      if (lane == 0) {
        const int first = c << lg;
        const int elems = min(1 << lg, len - first);
        const unsigned bytes = static_cast<unsigned>(elems * esz);
        const unsigned bulk = bytes & ~15u;
        uint8_t* dst = ring + ((slot * esz) << lg);
        const uint8_t* src = base + static_cast<size_t>(first) * esz;
        // the array's last few words, past its last 16-byte unit
        for (unsigned q = bulk; q < bytes; q += 4) {
          *reinterpret_cast<int32_t*>(dst + q) =
              *reinterpret_cast<const int32_t*>(src + q);
        }
        mbar_arrive_expect_tx(full_k + slot, bulk);
        if (bulk) bulk_copy_g2s(dst, src, bulk, full_k + slot);
      }
      __syncwarp();
    }
  } else {
    // the walker: lane 0 takes the nodes in level order while their
    // bounds and records are in the rings; then the warp waits for the
    // chunk the next node needs and hands back the ones behind
    const int32_t* ip = reinterpret_cast<const int32_t*>(smem_raw + L.ring[0]);
    const EdgeRec* er = reinterpret_cast<const EdgeRec*>(smem_raw + L.ring[1]);
    Cursor cp(full, empty, g, kPositions, node_off);
    Cursor ce(full, empty, g, kEdges, e_lo);
    const int p_end = node_off + n_nodes;
    int p = node_off;  // the next node's position
    int e = e_lo;      // its first in-edge
    while (p < p_end) {
      cp.need(p + 1);
      const int e1 = ip[(p + 1) & cp.mask];
      if (e1 > e) ce.need(e1 - 1);
      if (lane == 0) {
        const int p_ready = cp.ready() - 1;  // ip[x + 1] readable: x < this
        const int e_ready = ce.ready();      // er[x] readable: x < this
        // node p's in-edges are [e, e_end), its first record r; the next
        // node's bound and first record load while node p waits on h
        int e_end = e1;
        EdgeRec r = {0, 0.f, 0};
        if (e < e_end) r = er[e & ce.mask];
        int prev = -1;     // the last node's graph-local position
        float h_prev = 0.f;  // and its h
        for (;;) {
          const int q = p + 1;
          const bool next = q < p_end && q < p_ready;
          const int e2 = next ? ip[(q + 1) & cp.mask] : e_end;
          EdgeRec rn = r;
          if (e_end < e_ready) rn = er[e_end & ce.mask];
          float best = 0.f;
          int arg = n_edges;
          if (e < e_end) {
            float hs = h_prev;
            if (r.src != prev) hs = h[r.src];
            best = __fadd_rn(hs, r.w);
            arg = r.id;
            for (int x = e + 1; x < e_end; ++x) {
              const EdgeRec o = er[x & ce.mask];
              float ho = h_prev;
              if (o.src != prev) ho = h[o.src];
              const float cand = __fadd_rn(ho, o.w);
              if (cand > best) best = cand, arg = o.id;
            }
          }
          prev = p - node_off;
          h_prev = best;
          h[prev] = best;
          me[prev] = arg;
          p = q;
          e = e_end;
          if (!next || e2 > e_ready) break;
          e_end = e2;
          r = rn;
        }
      }
      p = __shfl_sync(0xffffffffu, p, 0);
      e = __shfl_sync(0xffffffffu, e, 0);
      cp.drop(p, lane);
      ce.drop(e, lane);
    }
  }
  __syncthreads();
  for (int v = t; v < n_nodes; v += kStreamThreads) {
    const int node = node_of[node_off + v];
    h_out[node] = h[v];
    min_eid[node] = me[v];
  }
}

}  // namespace

// A batch of n_graphs graphs, their nodes numbered globally (graph b's are
// meta[5 b] .. + meta[5 b + 1]). node_of: node ids in level order, each
// graph's nodes a run starting at its node offset; lvl_ptr: per graph
// (from meta[5 b + 2]) its meta[5 b + 3] + 1 level bounds, as positions in
// node_of; in_ptr: total nodes + 1 bounds of each position's in-edges in
// e_rec (12-byte records: the source's graph-local position, the float32
// weight, the graph-local edge id, ascending within a node); meta[5 b +
// 4]: graph b's edge count. max_nodes: the most nodes of a graph; h_pos:
// total nodes floats of scratch where max_nodes > kSmemNodes (else
// unused). h, min_eid: total nodes each, by global node id. Returns the
// CUDA error of the launch (0 on success).
extern "C" int otter_poa_heaviest(const int32_t* node_of,
                                  const int32_t* lvl_ptr,
                                  const int32_t* in_ptr, const void* e_rec,
                                  const int32_t* meta, int n_graphs,
                                  int max_nodes, float* h_pos, float* h,
                                  int32_t* min_eid, cudaStream_t stream) {
  if (n_graphs <= 0) return 0;
  const bool in_smem = max_nodes <= kSmemNodes;
  if (!in_smem && h_pos == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = in_smem ? 4 * max_nodes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_heaviest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  poa_heaviest_kernel<<<n_graphs, 32, smem, stream>>>(
      node_of, lvl_ptr, in_ptr, static_cast<const EdgeRec*>(e_rec), meta,
      in_smem ? nullptr : h_pos, h, min_eid);
  return static_cast<int>(cudaGetLastError());
}

// The streamed kernel on the same batch: in_ptr (n_pos = total nodes + 1),
// e_rec (n_edge 12-byte records: source's graph-local position, weight,
// edge id; in in_ptr's order), node_of and meta as above, each 16-byte
// aligned; the rings 2^lg_slots chunks of 2^lg_pos and 2^lg_edge elements.
// max_nodes at most kStreamNodes, and every node's in-edges must fit the
// edge ring (the caller's check). Returns the CUDA error of the launch (0
// on success; invalid value for a batch or ring the kernel does not take).
extern "C" int otter_poa_heaviest_stream(
    const int32_t* in_ptr, const void* e_rec, const int32_t* node_of,
    const int32_t* meta, int n_graphs, int max_nodes, int n_pos, int n_edge,
    int lg_slots, int lg_pos, int lg_edge, float* h, int32_t* min_eid,
    cudaStream_t stream) {
  if (n_graphs <= 0) return 0;
  const Ring g = {lg_slots, {lg_pos, lg_edge}};
  const bool ok_ring = lg_slots >= 1 && (1 << lg_slots) <= kMaxSlots &&
                       lg_pos >= 2 && lg_edge >= 2 && lg_pos <= 12 &&
                       lg_edge <= 12;
  if (!ok_ring || max_nodes > kStreamNodes || max_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StreamLayout L = stream_layout(g, max_nodes);
  if (L.bytes > kStreamSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        poa_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  poa_stream_kernel<<<n_graphs, kStreamThreads, L.bytes, stream>>>(
      in_ptr, static_cast<const EdgeRec*>(e_rec), node_of, meta, n_pos,
      n_edge, g, L, h, min_eid);
  return static_cast<int>(cudaGetLastError());
}
