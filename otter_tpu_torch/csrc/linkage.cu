// Kernel K11: global-minimum average linkage in float32.
//
// Replaces otter_tpu/ops/hclust_device.py::average_linkage_device (jnp
// lax.scan over a padded (n, n) matrix; OTTER_TPU_HCLUST_DEVICE routes
// ops/cluster.py::_hclust_route to it). Each of the n - 1 steps takes the
// least D[i][j] over active i < j, the lowest (i, j) in row-major order on
// ties (jnp.argmin's flat index), records (i, j) and that height, then folds
// cluster j into i:
//
//   D[i][c] = D[c][i] = fl(fma(si, D[i][c], fl(sj D[j][c])) / max(si + sj, 1))
//
// for every active c, with si, sj the clusters' sizes; j becomes inactive.
// XLA on the CPU contracts the JAX function's si * D[i, :] + sj * D[j, :]
// into that fma (one rounding), and a separate multiply and add differ in
// ~10% of rows, so the kernel writes the fma and the product with the _rn
// intrinsics, which the compiler neither contracts nor splits.
//
// What bounds it: the chain of n - 1 dependent steps. Its work is O(n^2)
// in all (a row and a column rewritten a step, and a few rows rescanned),
// ~4 n^2 reads and writes of 4 bytes, so each step is a few barriers and
// one pass over a row or two: latency, not bytes or operations.
//
// Design: one block of kThreads per matrix. A full scan of the active upper
// triangle at every step, as the JAX function does, would be O(n^3); the
// block keeps instead, for every row r, the least D[r][c] over active
// c > r and the lowest such c (rowmin, rowarg), in shared memory. A step:
//   1. the lexicographic least (rowmin[r], r) over the rows (an inactive
//      row or one with no active c > r holds +inf) is the JAX argmin:
//      (value, i, j) least in that order;
//   2. row i and column i are rewritten (each thread its columns);
//   3. row i, and every row whose cached column was i or j, goes on a list
//      to be rescanned; any other row r < i takes the new D[r][i] if it is
//      less, or equal with i below its cached column;
//   4. the warps rescan the listed rows, a row a warp, lanes striding over
//      the columns, then a shuffle reduction.
// Four barriers a step, one after each part: every thread reduces the
// warps' partial minima of part 1 itself, so no barrier hands out the
// pair; a thread's columns in part 2 are its rows in part 3, so it reads
// the new D[r][i] back from its own writes to row i; a rescan loads every
// column, active or not, so its loads do not wait on one another.
// D lives in shared memory while it fits (n <= ~220), else in the
// matrix's n x n floats of device-memory scratch (at n = 1,001, 4 MB, held
// in L2), where a step waits on L2 most of its time.
//
// The cluster route (linkage_cluster_kernel) keeps larger matrices on chip:
// a thread block cluster of up to 16 blocks holds D's upper triangle in its
// distributed shared memory (exact: D is symmetric and the fold writes row
// i and column i alike). The rows are split over the blocks by triangle
// area; block b keeps its rows' segments D[r][r+1..n), their rowmin and
// rowarg, and a copy of the sizes. Every write a block makes is to its own
// shared memory; it reads other blocks' only what no block writes in that
// step. One cluster barrier a step (cluster_step_sync: a relaxed arrival
// between fences restricted to shared memory). A step:
//   A. warp 0 of each block writes the block's least (rowmin[r], r) into
//      its slot; step barrier; every warp reads the C slots and reduces
//      them in one order, so all agree on (i, j) with no barrier more;
//   B. each block folds its rows c < i, where D[c][i] and D[c][j] both lie
//      in row c, here, and keeps their caches as in part 3 above;
//   C. i's block folds row i's segment, reading D[c][j] (c < j) or
//      D[j][c] from the blocks that hold them;
//   D. block barrier; each block rescans its listed rows, a warp each; a
//      block barrier; the sizes. Column j keeps its values in these
//      rescans (they skip it by index) and becomes +inf in the next step,
//      when no block reads it any more, so a rescan reads no sizes.
// The route is chosen by n: one block while D fits, the cluster while the
// triangle fits in 16 blocks (the smallest cluster of two or more that
// holds it) and the card can place such a cluster, the L2 kernel beyond.

#include <cstdint>
#include <math.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef __CUDACC__
// host build of this source (the CPU tests' warp emulation): g++ in ISO mode
// contracts nothing either
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 12288;
constexpr int kSmemBytes = 200 * 1024;
// the cluster route: at most 16 blocks (a non-portable cluster size), each
// with up to the 227 KB of shared memory a Hopper block may take
constexpr int kMaxCluster = 16;
constexpr int kClusterSmemBytes = 227 * 1024;
enum Route { kRouteShared = 0, kRouteCluster = 1, kRouteL2 = 2 };

__device__ __forceinline__ bool before(float v, int r, float bv, int br) {
  return v < bv || (v == bv && r < br);
}

// the lexicographic least (v, r) over the warp, in every lane
__device__ __forceinline__ void warp_least(float& v, int& r) {
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, d);
    const int orr = __shfl_xor_sync(0xffffffffu, r, d);
    if (before(ov, orr, v, r)) v = ov, r = orr;
  }
}

struct Shared {
  float* rowmin;
  int* rowarg;
  float* size;
  int* list;
  int* count;
  float* part_v;
  int* part_r;
};

// rowmin[r], rowarg[r]: the least D[r][c] over active c > r and the lowest
// such c (+inf and n when there is none), by one warp. Every column's
// value is loaded, active or not, so the loads do not wait on the sizes
// and the loop's loads overlap.
__device__ void rescan(const float* M, int n, int r, const Shared& s,
                       int lane) {
  float v = INFINITY;
  int c_best = n;
  const float* row = M + static_cast<size_t>(r) * n;
#pragma unroll 8
  for (int c = r + 1 + lane; c < n; c += 32) {
    const float x = row[c];
    // c ascends: the first of equals stays
    if (x < v && s.size[c] > 0.f) v = x, c_best = c;
  }
  warp_least(v, c_best);
  if (lane == 0) {
    s.rowmin[r] = v;
    s.rowarg[r] = c_best;
  }
}

__global__ void __launch_bounds__(kThreads)
linkage_kernel(const float* __restrict__ D, int n, bool in_smem,
               float* __restrict__ scratch, int32_t* __restrict__ recs,
               float* __restrict__ heights) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  Shared s;
  s.rowmin = reinterpret_cast<float*>(smem_raw);
  s.rowarg = reinterpret_cast<int*>(s.rowmin + n);
  s.size = reinterpret_cast<float*>(s.rowarg + n);
  s.list = reinterpret_cast<int*>(s.size + n);
  s.count = s.list + n;
  s.part_v = reinterpret_cast<float*>(s.count + 1);
  s.part_r = reinterpret_cast<int*>(s.part_v + kWarps);
  const size_t nn = static_cast<size_t>(n) * n;
  float* M = in_smem ? reinterpret_cast<float*>(s.part_r + kWarps)
                     : scratch + b * nn;
  const float* src = D + b * nn;
  for (size_t q = t; q < nn; q += kThreads) M[q] = src[q];
  for (int r = t; r < n; r += kThreads) s.size[r] = 1.f;
  __syncthreads();
  for (int r = warp; r < n; r += kWarps) rescan(M, n, r, s, lane);
  __syncthreads();
  int32_t* rec = recs + static_cast<size_t>(b) * 2 * (n - 1);
  float* hgt = heights + static_cast<size_t>(b) * (n - 1);
#pragma unroll 1
  for (int step = 0; step < n - 1; ++step) {
    // 1. the pair: the least (rowmin[r], r), each warp's, then every
    // thread reduces the warps' (so no barrier hands the pair out)
    float v = INFINITY;
    int i = n;
    for (int r = t; r < n; r += kThreads) {
      if (before(s.rowmin[r], r, v, i)) v = s.rowmin[r], i = r;
    }
    warp_least(v, i);
    if (lane == 0) {
      s.part_v[warp] = v;
      s.part_r[warp] = i;
    }
    __syncthreads();
    v = s.part_v[0];
    i = s.part_r[0];
    for (int w = 1; w < kWarps; ++w) {
      if (before(s.part_v[w], s.part_r[w], v, i)) {
        v = s.part_v[w], i = s.part_r[w];
      }
    }
    const int j = s.rowarg[i];
    const float si = s.size[i];
    const float sj = s.size[j];
    if (t == 0) {
      rec[2 * step] = i;
      rec[2 * step + 1] = j;
      hgt[step] = v;
      *s.count = 0;  // every thread read it last step, before a barrier
    }
    // 2. row i and column i, over the active columns but i and j; a
    // thread keeps the columns it writes, and step 3 gives it the same
    // rows, so it reads row i back from its own writes
    const float denom = fmaxf(__fadd_rn(si, sj), 1.f);
    float* row_i = M + static_cast<size_t>(i) * n;
    const float* row_j = M + static_cast<size_t>(j) * n;
#pragma unroll 4
    for (int c = t; c < n; c += kThreads) {
      const float a = row_i[c];
      const float bj = row_j[c];
      if (c != i && c != j && s.size[c] > 0.f) {
        const float x = __fdiv_rn(__fmaf_rn(si, a, __fmul_rn(sj, bj)),
                                  denom);
        row_i[c] = x;
        M[static_cast<size_t>(c) * n + i] = x;
      }
    }
    __syncthreads();
    // 3. each thread its rows: j leaves, i grows and is rescanned, and so
    // is every row whose cached column was i or j; the rest of the rows
    // above i take the new D[r][i] (= row i's, written by this thread)
    for (int r = t; r < n; r += kThreads) {
      if (r == j) {
        s.size[j] = 0.f;
        s.rowmin[j] = INFINITY;
        s.rowarg[j] = n;
        continue;
      }
      if (s.size[r] == 0.f) continue;
      const int a = s.rowarg[r];
      if (r == i) {
        s.size[i] = __fadd_rn(si, sj);
        s.list[atomicAdd(s.count, 1)] = r;
      } else if (a == i || a == j) {
        s.list[atomicAdd(s.count, 1)] = r;
      } else if (r < i) {
        const float x = row_i[r];
        if (before(x, i, s.rowmin[r], a)) {
          s.rowmin[r] = x;
          s.rowarg[r] = i;
        }
      }
    }
    __syncthreads();
    // 4. the listed rows, a warp each
    const int listed = *s.count;
    for (int q = warp; q < listed; q += kWarps) {
      rescan(M, n, s.list[q], s, lane);
    }
    __syncthreads();
  }
}


// The triangle's split: rows [bound[b], bound[b + 1]) go to block b, the
// first row where the area of the rows before it reaches b / C of the
// whole. area(r): the entries D[q][q+1..n) of the rows q < r.
__host__ __device__ __forceinline__ int64_t tri_area(int64_t r, int64_t n) {
  return r * (n - 1) - r * (r - 1) / 2;
}

__host__ __device__ __forceinline__ int tri_bound(int b, int C, int n) {
  if (b >= C) return n;  // the last block also takes row n - 1 (no area)
  const int64_t total = tri_area(n, n);
  const int64_t want = (total * b + C - 1) / C;
  int lo = 0, hi = n;  // the least r with tri_area(r) >= want
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (tri_area(mid, n) >= want) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// the cluster kernel's shared memory, the same offsets in every block
struct ClusterLayout {
  int cap;   // floats of triangle a block holds (the largest block's area)
  int rows;  // rows a block holds at most
  int tri, rowmin, rowarg, list, size, loc, bound, count, pub, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(int n, int C) {
  ClusterLayout L;
  L.cap = 0;
  L.rows = 0;
  for (int b = 0; b < C; ++b) {
    const int r0 = tri_bound(b, C, n), r1 = tri_bound(b + 1, C, n);
    const int64_t area = tri_area(r1, n) - tri_area(r0, n);
    L.cap = area > L.cap ? static_cast<int>(area) : L.cap;
    L.rows = r1 - r0 > L.rows ? r1 - r0 : L.rows;
  }
  L.cap = (L.cap + 3) & ~3;
  const int rows = (L.rows + 3) & ~3;
  const int nn = (n + 3) & ~3;
  L.tri = 0;
  L.rowmin = L.tri + 4 * L.cap;
  L.rowarg = L.rowmin + 4 * rows;
  L.list = L.rowarg + 4 * rows;
  L.size = L.list + 4 * rows;
  L.loc = L.size + 4 * nn;
  L.bound = L.loc + 4 * nn;
  L.count = L.bound + 4 * (kMaxCluster + 4);
  L.pub = L.count + 16;
  L.bytes = L.pub + 2 * 16;
  return L;
}

struct Partial {
  float v;
  int r, j, pad;
};

#ifdef __CUDACC__
// The cluster's step barrier, ordering shared memory only: what this block
// wrote to its own shared memory before it is visible to every block's
// reads of it (through map_shared_rank) after it. The arrival is relaxed
// and the fences are restricted to shared memory; on an H100 the pair of
// fences and a relaxed barrier take ~430 cycles where a cluster barrier
// with release and acquire semantics (cluster.sync()) takes ~920 and a
// release fence alone ~870 (they also order device memory).
__device__ __forceinline__ void cluster_step_sync() {
  asm volatile("fence.release.sync_restrict::shared::cta.cluster;\n\t"
               "barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;\n\t"
               "fence.acquire.sync_restrict::shared::cluster.cluster;"
               ::: "memory");
}
#else
// the host emulation's: the emulated cluster barrier
inline void cluster_step_sync() { cooperative_groups::this_cluster().sync(); }
#endif

// the lexicographic least (v, r) over the warp, with its j, in every lane
__device__ __forceinline__ void warp_least3(float& v, int& r, int& j) {
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, d);
    const int orr = __shfl_xor_sync(0xffffffffu, r, d);
    const int oj = __shfl_xor_sync(0xffffffffu, j, d);
    if (before(ov, orr, v, r)) v = ov, r = orr, j = oj;
  }
}

// row r's cache from its segment (D[r][c] at tri[off + c - r - 1] for
// c > r), by one warp. The columns that left before this step hold +inf,
// so no size is read; the one that left at this step, skip, is passed by
// (a column of +inf distances is never cached, as in rescan above)
__device__ __forceinline__ void rescan_row(const float* tri, int off, int n,
                                           int r, int skip, float& v_out,
                                           int& c_out, int lane) {
  float v = INFINITY;
  int c_best = n;
  const float* seg = tri + off;
#pragma unroll 8
  for (int c = r + 1 + lane; c < n; c += 32) {
    const float x = seg[c - r - 1];
    if (x < v && c != skip) v = x, c_best = c;
  }
  warp_least(v, c_best);
  v_out = v;
  c_out = c_best;
}

__global__ void __launch_bounds__(kThreads)
linkage_cluster_kernel(const float* __restrict__ D, int n, ClusterLayout L,
                       int32_t* __restrict__ recs,
                       float* __restrict__ heights) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / C;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  float* tri = reinterpret_cast<float*>(smem_raw + L.tri);
  float* rowmin = reinterpret_cast<float*>(smem_raw + L.rowmin);
  int* rowarg = reinterpret_cast<int*>(smem_raw + L.rowarg);
  int* list = reinterpret_cast<int*>(smem_raw + L.list);
  float* size = reinterpret_cast<float*>(smem_raw + L.size);
  int* loc = reinterpret_cast<int*>(smem_raw + L.loc);
  int* bound = reinterpret_cast<int*>(smem_raw + L.bound);
  int* count = reinterpret_cast<int*>(smem_raw + L.count);
  Partial* pub = reinterpret_cast<Partial*>(smem_raw + L.pub);
  if (t <= C) bound[t] = tri_bound(t, C, n);
  if (t == 0) *count = 0;
  __syncthreads();
  const int r0 = bound[rank];
  const int r1 = bound[rank + 1];
  // loc[r]: the block holding row r and the offset of its segment there
  for (int r = t; r < n; r += kThreads) {
    int b = 0;
    while (bound[b + 1] <= r) ++b;
    loc[r] = (b << 20) | static_cast<int>(tri_area(r, n) -
                                          tri_area(bound[b], n));
    size[r] = 1.f;
  }
  const float* src = D + static_cast<size_t>(mat) * n * n;
  const int base = static_cast<int>(tri_area(r0, n));
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float* seg = tri + (tri_area(r, n) - base);
    const float* row = src + static_cast<size_t>(r) * n;
    for (int c = r + 1 + lane; c < n; c += 32) seg[c - r - 1] = row[c];
  }
  __syncthreads();
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float v;
    int c;
    rescan_row(tri, static_cast<int>(tri_area(r, n) - base), n, r, -1, v,
               c, lane);
    if (lane == 0) rowmin[r - r0] = v, rowarg[r - r0] = c;
  }
  // every block's shared memory is live before any block reads it
  cluster.sync();
  int32_t* rec = recs + static_cast<size_t>(mat) * 2 * (n - 1);
  float* hgt = heights + static_cast<size_t>(mat) * (n - 1);
  int gone = -1;  // the column that left at the last step (none yet)
#pragma unroll 1
  for (int step = 0; step < n - 1; ++step) {
    // A. warp 0: this block's least (rowmin[r], r) into its slot; after
    // the step barrier every warp reads the C blocks' slots and reduces
    // them in one order, so all agree on (i, j) with no more barriers
    Partial* slot = pub + (step & 1);
    if (warp == 0) {
      float v = INFINITY;
      int i = n, j = n;
      for (int r = r0 + lane; r < r1; r += 32) {
        const float x = rowmin[r - r0];
        if (before(x, r, v, i)) v = x, i = r, j = rowarg[r - r0];
      }
      warp_least3(v, i, j);
      if (lane == 0) *slot = Partial{v, i, j, 0};
    }
    if (C > 1) {
      cluster_step_sync();
    } else {
      __syncthreads();
    }
    float v = INFINITY;
    int i = n, j = n;
    if (lane < C) {
      const Partial p = *cluster.map_shared_rank(slot, lane);
      v = p.v, i = p.r, j = p.j;
    }
    warp_least3(v, i, j);
    // no active pair (only where D holds infinities or NaNs): stay in
    // bounds, whatever the records then say
    i = min(i, n - 1);
    j = min(j, n - 1);
    const float si = size[i];
    const float sj = size[j];
    if (rank == 0 && t == kThreads - 1) {
      rec[2 * step] = i;
      rec[2 * step + 1] = j;
      hgt[step] = v;
    }
    // B. the fold of this block's rows c < i (D[c][i] and D[c][j] both
    // in row c, here), their caches and the rows to rescan
    const float denom = fmaxf(__fadd_rn(si, sj), 1.f);
    for (int c = r0 + t; c < r1; c += kThreads) {
      const int q = c - r0;
      if (c == j) {
        rowmin[q] = INFINITY;
        rowarg[q] = n;
        continue;
      }
      const int oc = (loc[c] & 0xfffff) - c - 1;  // row c's, here
      if (c < gone) tri[oc + gone] = INFINITY;  // read by no one since
      if (size[c] == 0.f) continue;
      if (c == i) {
        list[atomicAdd(count, 1)] = c;
        continue;
      }
      const int ra = rowarg[q];
      if (c < i) {
        const float x = __fdiv_rn(
            __fmaf_rn(si, tri[oc + i], __fmul_rn(sj, tri[oc + j])), denom);
        tri[oc + i] = x;
        if (ra != i && ra != j && before(x, i, rowmin[q], ra)) {
          rowmin[q] = x;
          rowarg[q] = i;
        }
      }
      if (ra == i || ra == j) list[atomicAdd(count, 1)] = c;
    }
    // C. row i's block folds its segment (c > i), reading D[c][j] (c < j)
    // or D[j][c] where they lie; no block writes those at this step
    const int li = loc[i];
    if ((li >> 20) == rank) {
      const int oi = (li & 0xfffff) - i - 1;  // row i's, here
      const int lj = loc[j];
      const float* tri_j = cluster.map_shared_rank(tri, lj >> 20);
      const int oj = (lj & 0xfffff) - j - 1;
      constexpr int kU = 4;  // the remote loads of kU columns in flight
#pragma unroll 1
      for (int c0 = i + 1 + t; c0 < n; c0 += kU * kThreads) {
        float bj[kU];
        bool on[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + u * kThreads;
          on[u] = c < n && c != j && size[c] > 0.f;
          bj[u] = 0.f;
          if (on[u]) {
            if (c < j) {
              const int lc = loc[c];
              bj[u] = cluster.map_shared_rank(tri, lc >> 20)
                          [(lc & 0xfffff) + j - c - 1];
            } else {
              bj[u] = tri_j[oj + c];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + u * kThreads;
          if (on[u]) {
            tri[oi + c] = __fdiv_rn(
                __fmaf_rn(si, tri[oi + c], __fmul_rn(sj, bj[u])), denom);
          }
        }
      }
    }
    __syncthreads();
    // D. the listed rows, a warp each, here
    const int listed = *count;
    for (int q = warp; q < listed; q += kWarps) {
      const int r = list[q];
      float rv;
      int rc;
      rescan_row(tri, loc[r] & 0xfffff, n, r, j, rv, rc, lane);
      if (lane == 0) rowmin[r - r0] = rv, rowarg[r - r0] = rc;
    }
    __syncthreads();
    if (t == 0) {
      size[i] = __fadd_rn(si, sj);
      size[j] = 0.f;
      *count = 0;
    }
    gone = j;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// linkage_cluster_kernel's attributes for clusters of C blocks of smem
// bytes each, and its launch configuration for n_mats matrices (attr: the
// cluster dimension's storage)
static cudaError_t cluster_config(int n_mats, int C, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      linkage_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess && C > 8) {
    err = cudaFuncSetAttribute(linkage_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  *cfg = {};
  cfg->gridDim = dim3(n_mats * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// how many clusters of C blocks of smem bytes each the current card can
// hold at once (0: it cannot place one)
static cudaError_t clusters_placed(int C, int smem, int* placed) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(1, C, smem, nullptr, &attr, &cfg);
  *placed = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(placed, linkage_cluster_kernel,
                                         &cfg);
  }
  return err;
}

// The route of an n x n matrix (kRouteShared, kRouteCluster, kRouteL2) and,
// on the cluster route, the cluster size (the smallest of at least two
// blocks that holds the triangle: one block alone walks all the rows each
// step, and on an H100 took 2.6-3.0 us a step at n = 225-300 against 2.4
// with two) and each block's shared memory; by n and by whether the
// current card can place that cluster (cudaOccupancyMaxActiveClusters: a
// card or a slice of one with fewer SMs a GPC may not), the L2 kernel
// where it cannot.
static int plan(int n, int* route, int* cluster, int* smem) {
  if (n > kMaxN || n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int fixed = 16 * n + 4 + 8 * kWarps;
  const int64_t with_d = fixed + 4 * static_cast<int64_t>(n) * n;
  if (with_d <= kSmemBytes) {
    *route = kRouteShared, *cluster = 1, *smem = static_cast<int>(with_d);
    return 0;
  }
  for (int C = 2; C <= kMaxCluster; ++C) {
    const ClusterLayout L = cluster_layout(n, C);
    if (L.bytes <= kClusterSmemBytes) {
      int placed;
      const cudaError_t err = clusters_placed(C, L.bytes, &placed);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (placed == 0) break;
      *route = kRouteCluster, *cluster = C, *smem = L.bytes;
      return 0;
    }
  }
  *route = kRouteL2, *cluster = 1, *smem = fixed;
  return 0;
}

static int launch(const float* D, int n, int n_mats, float* scratch,
                  int32_t* recs, float* heights, int route, int C, int smem,
                  cudaStream_t stream) {
  if (route == kRouteCluster) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t err = cluster_config(n_mats, C, smem, stream, &attr, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, linkage_cluster_kernel, D, n,
                             cluster_layout(n, C), recs, heights);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const bool in_smem = route == kRouteShared;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        linkage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  linkage_kernel<<<n_mats, kThreads, smem, stream>>>(
      D, n, in_smem, scratch, recs, heights);
  return static_cast<int>(cudaGetLastError());
}

// route, cluster size and shared memory a block of an n x n matrix's
// launch on the current card (see plan); 0, or an error for n outside
// 2 .. kMaxN
extern "C" int otter_linkage_plan(int n, int* route, int* cluster,
                                  int* smem) {
  return plan(n, route, cluster, smem);
}

// D: n_mats symmetric n x n float32 matrices (diagonals ignored; the
// cluster route reads the upper triangle only); scratch: n_mats x n x n
// floats, used on the L2 route; recs: n_mats x (n - 1) x 2 int32 (i, j)
// slot pairs; heights: n_mats x (n - 1) float32. The route is plan's.
// Returns the CUDA error of the launch (0 on success).
extern "C" int otter_linkage(const float* D, int n, int n_mats,
                             float* scratch, int32_t* recs, float* heights,
                             cudaStream_t stream) {
  if (n_mats <= 0 || n < 2) return 0;
  int route, C, smem;
  const int err = plan(n, &route, &C, &smem);
  if (err) return err;
  return launch(D, n, n_mats, scratch, recs, heights, route, C, smem,
                stream);
}

// otter_linkage on a given route: on the cluster route with a cluster of C
// blocks (an error if the triangle does not fit or the card refuses the
// launch), the shared-memory route only where D fits; for tests of every
// route at small n.
extern "C" int otter_linkage_route(const float* D, int n, int n_mats,
                                   float* scratch, int32_t* recs,
                                   float* heights, int route, int C,
                                   cudaStream_t stream) {
  if (n_mats <= 0 || n < 2) return 0;
  int natural, nc, smem;
  const int err = plan(n, &natural, &nc, &smem);
  if (err) return err;
  if (route == kRouteCluster) {
    if (C < 1 || C > kMaxCluster) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = cluster_layout(n, C).bytes;
    if (smem > kClusterSmemBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int placed;
    const cudaError_t perr = clusters_placed(C, smem, &placed);
    if (perr != cudaSuccess) return static_cast<int>(perr);
    if (placed == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  } else if (route == kRouteShared) {
    if (natural != kRouteShared) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    C = 1;
  } else if (route == kRouteL2) {
    C = 1;
    smem = 16 * n + 4 + 8 * kWarps;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(D, n, n_mats, scratch, recs, heights, route, C, smem,
                stream);
}
