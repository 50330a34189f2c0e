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
// in L2).

#include <cstdint>
#include <math.h>

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

}  // namespace

// D: n_mats symmetric n x n float32 matrices (diagonals ignored); scratch:
// n_mats x n x n floats, used when a matrix does not fit in shared memory;
// recs: n_mats x (n - 1) x 2 int32 (i, j) slot pairs; heights: n_mats x
// (n - 1) float32. Returns the CUDA error of the launch (0 on success).
extern "C" int otter_linkage(const float* D, int n, int n_mats,
                             float* scratch, int32_t* recs, float* heights,
                             cudaStream_t stream) {
  if (n_mats <= 0 || n < 2) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  // rowmin, rowarg, size, list (n each), count, the warps' partials; then
  // D when it fits
  const int fixed = 16 * n + 4 + 8 * kWarps;
  const int64_t with_d = fixed + 4 * static_cast<int64_t>(n) * n;
  const bool in_smem = with_d <= kSmemBytes;
  const int smem = in_smem ? static_cast<int>(with_d) : fixed;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        linkage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  linkage_kernel<<<n_mats, kThreads, smem, stream>>>(
      D, n, in_smem, scratch, recs, heights);
  return static_cast<int>(cudaGetLastError());
}
