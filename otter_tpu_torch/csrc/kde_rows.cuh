// The last step of kernels K13 and K14: each region's density row divided
// by the region's divisor, then by the row's total (at least 1e-30), as
// otter_tpu/parallel/mesh.py's kde_tree_step (:104-107) and
// region_batch_step (:75-77) finish. XLA leaves the order of the row total
// unspecified; here it is a fixed halving tree over the row padded with
// zeros to kRowLanes (or the next power of two past it): lane i is added to
// lane i + w / 2 while w halves, as the plain versions add it.
//
// normalize_kernel: one block a row, one thread a padded lane, the tree in
// shared memory with one barrier a level; the work is a few thousand
// floats, so the launch is the cost. row_total is the tree alone, for a
// kernel that finishes its rows itself (K14).

#pragma once

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#ifndef __CUDACC__
// host build of the sources that include this (the CPU tests' warp
// emulation): g++ in ISO mode contracts nothing either
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
#endif

namespace {

constexpr float kInvSqrt2Pi = 0x1.988454p-2f;  // f32(1 / sqrt(2 pi))
constexpr int kRowLanes = 512;   // a row's padded lanes, at least
constexpr int kMaxLanes = 1024;  // a block's threads, at most

// the padded lanes of a row of n_cells values, or 0 past kMaxLanes
inline int row_lanes(int n_cells) {
  int lanes = kRowLanes;
  while (lanes < n_cells) lanes *= 2;
  return lanes <= kMaxLanes ? lanes : 0;
}

// the halving tree over t[0 .. lanes) in shared memory (lanes a power of
// two, the row's values then zeros), by the whole block; returns the total
// (max 1e-30) to every thread. The block's threads stop writing t before it.
__device__ __forceinline__ float row_total(float* t, int lanes) {
  for (int w = lanes; w > 1; w >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < w / 2; i += blockDim.x) {
      t[i] = __fadd_rn(t[i], t[i + w / 2]);
    }
  }
  __syncthreads();
  return fmaxf(t[0], 1e-30f);
}

// raw (R, n_cells) and div (R,) -> out (R, n_cells): d = raw / div[r],
// out = d / max(sum d, 1e-30) with the sum in the halving order; blockDim.x
// = the row's padded lanes (a power of two), shared memory one float each.
__global__ void __launch_bounds__(kMaxLanes)
normalize_kernel(const float* __restrict__ raw, const float* __restrict__ div,
                 int n_cells, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* t = reinterpret_cast<float*>(smem_raw);
  const int r = blockIdx.x;
  const int g = threadIdx.x;
  const size_t at = static_cast<size_t>(r) * n_cells + g;
  const float d = g < n_cells ? __fdiv_rn(raw[at], div[r]) : 0.0f;
  t[g] = d;
  const float total = row_total(t, blockDim.x);
  if (g < n_cells) out[at] = __fdiv_rn(d, total);
}

// launch normalize_kernel on ``stream``; returns the CUDA error
inline int normalize_rows(const float* raw, const float* div, int n_cells,
                     int n_regions, float* out, void* stream) {
  const int lanes = row_lanes(n_cells);
  if (lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  normalize_kernel<<<n_regions, lanes, lanes * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(raw, div, n_cells,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
