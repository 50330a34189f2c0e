// Kernel K14: per-region Gaussian KDE of a cross-region batch of pair
// distances over a linspace grid, the KDE half of the sharded forward step.
//
// Replaces otter_tpu/parallel/mesh.py::region_batch_step's KDE (:64-77, jnp,
// not Pallas; its distances are K7's). For pair p with distance d, lengths
// m, n and region r (bandwidth h = bw[r]), and grid point x_g:
//
//   norm  = f32(d) / max(f32(max(m, n)), 1)
//   term  = fl(INV_SQRT_2PI / h) * exp(-(z * z) / 2),  z = (x_g - norm) / h
//   raw   = the sum of a region's valid pairs' terms, in input order
//   dens  = raw / max(count, 1), then / max(row total, 1e-30)
//
// (IEEE f32 throughout, as jnp writes it). An INF distance (2^24) stays in:
// its terms are 0 but it is counted. XLA leaves the order of the segment sum
// unspecified; here it is fixed, so the densities are deterministic and the
// same at every mesh size: a region's pairs in their input order (the
// wrapper groups them by a stable sort), each grid point's sum taken by one
// thread, no atomics. The row total is kde_rows.cuh's halving tree.
//
// What bounds it: one expf a (pair, grid point) at the MUFU rate (132 SMs x
// 16 a clock); the inputs are ~20 bytes a pair and the output 4 bytes a
// cell. Design: one block a region, a thread a grid point; the block stages
// a chunk of its pairs' normalised distances in shared memory (each read
// once from device memory, by one thread) and every thread walks the chunk
// in order. Every quotient is __fdiv_rn and every product and sum an _rn
// intrinsic, so the compiler contracts nothing into an fma: each term is the
// plain version's bit for bit but for expf against torch.exp.

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#include "kde_rows.cuh"

namespace {

constexpr int kChunk = 1024;                   // pairs staged at a time

// grid: a block a region; blockDim.x >= n_cells (a multiple of 32). order
// (the region's valid pairs grouped, in input order) from starts[r] to
// starts[r + 1]. raw (R, n_cells) the sums, div (R,) max(count, 1).
__global__ void __launch_bounds__(kMaxLanes)
kde_pairs_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ m,
                 const int32_t* __restrict__ n,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts,
                 const float* __restrict__ bw, const float* __restrict__ xs,
                 int n_cells, float* __restrict__ raw,
                 float* __restrict__ div) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* norm = reinterpret_cast<float*>(smem_raw);
  const int r = blockIdx.x;
  const int g = threadIdx.x;
  const int lo = starts[r], hi = starts[r + 1];
  const float h = bw[r];
  const float c = __fdiv_rn(kInvSqrt2Pi, h);
  const float x = g < n_cells ? xs[g] : 0.0f;
  float acc = 0.0f;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int count = min(kChunk, hi - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = g; i < count; i += blockDim.x) {
      const int p = order[c0 + i];
      const float len = static_cast<float>(max(m[p], n[p]));
      norm[i] = __fdiv_rn(static_cast<float>(d[p]), fmaxf(len, 1.0f));
    }
    __syncthreads();
    if (g < n_cells) {
      for (int i = 0; i < count; ++i) {
        const float z = __fdiv_rn(__fsub_rn(x, norm[i]), h);
        const float e = __fmul_rn(__fmul_rn(z, z), -0.5f);
        acc = __fadd_rn(acc, __fmul_rn(c, expf(e)));
      }
    }
  }
  if (g < n_cells) raw[static_cast<size_t>(r) * n_cells + g] = acc;
  if (g == 0) div[r] = fmaxf(static_cast<float>(hi - lo), 1.0f);
}

}  // namespace

// d, m, n (B,) i32 (any B; only the pairs in order are read), order (V,)
// i32 the valid pairs grouped by region, starts (R + 1,) i32 their offsets,
// bw (R,) f32, xs (n_cells,) f32 -> out (R, n_cells) f32 densities; raw
// (R, n_cells) and div (R,) f32 are scratch. n_cells <= 1024.
extern "C" int otter_kde_pairs(const int32_t* d, const int32_t* m,
                               const int32_t* n, const int32_t* order,
                               const int32_t* starts, const float* bw,
                               const float* xs, int n_cells, int n_regions,
                               float* raw, float* div, float* out,
                               void* stream) {
  if (n_regions <= 0 || n_cells <= 0) return 0;
  if (row_lanes(n_cells) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (n_cells + 31) / 32 * 32;
  kde_pairs_kernel<<<n_regions, threads, kChunk * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      d, m, n, order, starts, bw, xs, n_cells, raw, div);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return normalize_rows(raw, div, n_cells, n_regions, out, stream);
}
