// Kernel K8: scaled Gaussian KDE of many regions' pair distances over the
// clustering grid, with the JAX package's pairwise-halving sum order.
//
// Replaces otter_tpu/parallel/mesh.py::kde_tree_step_scaled (jnp, not
// Pallas; launched by pooled_kde_scaled for the assemble pipeline's
// per-region densities). For region r and grid cell g, with the region's
// first nvals[r] values v_i and bandwidth h = bw[r]:
//
//   e_i = -(z * z) / 2,  z = (xs[g] - v_i) / h       (IEEE f32, as jnp)
//   m   = max_i e_i
//   s   = sum_i exp(e_i - m), summed in the halving order of mesh.py:131-134:
//         over n_pad lanes (padding lanes are 0), lane i is added to lane
//         i + w / 2 while w halves from n_pad to 1.
//
// The host certifies every clustering decision against an error model of
// exactly that order (ops/kde.py::kde_decision_certified_scaled), so the sum
// order is part of the contract. Zeros add exactly, so any power of two
// n_pad >= nvals gives the same s: the kernel takes the least power of two
// that is >= nvals and >= 128.
//
// What bounds it: one expf a (cell, value) at the MUFU rate (132 SMs x 16 a
// clock), beside ~7 f32 operations (sub, div, 2 mul, max, sub, add); the
// inputs are read once (a region's values are staged in shared memory and
// reused by every cell of the block), the outputs are 8 bytes a cell.
//
// Design: a warp per grid cell, 16 cells a block, a block per (16 cells,
// region) on a 1-D grid. Pass 1 takes m (a max, in any order). Pass 2 keeps
// the halving order: lane j of 32 owns the value lanes j + 32 k, k < K =
// n_pad / 32. The first log2 K halving levels only ever add lanes of one
// residue class mod 32, so they are the halving tree over that lane's own K
// values. Its first two levels add k, k + K/2, k + K/4 and k + 3K/4 for each
// k < K/4: a step takes those four values (four independent exps) and adds
// them as the tree does. The rest of the tree is the halving tree over the
// K/4 step sums, which the lane visits in bit-reversed order of k (there
// the tree pairs neighbours) and folds with a stack of partial sums (a
// binary counter: one sum a level). The last 5 levels are
// __shfl_down_sync(16 ... 1), the classic reduction, which pairs lane i
// with lane i + d as the halving does. The division is IEEE (no fast math),
// and the products and sums are written with the _rn intrinsics so the
// compiler contracts nothing into an fma: e is bit for bit the plain
// version's, and so is m.

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#ifndef __CUDACC__
// host build of this source (the CPU tests' warp emulation): g++ in ISO mode
// contracts nothing either
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int b = 0; b < 32; ++b) r |= ((x >> b) & 1u) << (31 - b);
  return r;
}
#endif

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLevels = 22;              // K / 4 up to 2^21: 268 M values
constexpr int kMaxStagedBytes = 200 * 1024;  // values staged up to this size

__device__ __forceinline__ float exponent(float x, float v, float h) {
  const float z = __fdiv_rn(__fsub_rn(x, v), h);
  return __fmul_rn(__fmul_rn(z, z), -0.5f);  // == -(z * z) / 2, exactly
}

// exp(e_i - m) of value lane i, 0 past the region's values
__device__ __forceinline__ float term(const float* v, int i, int n, float x,
                                     float h, float m) {
  return i < n ? expf(__fsub_rn(exponent(x, v[i], h), m)) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
kde_scaled_kernel(const float* __restrict__ vals, int n_pad,
                  const int32_t* __restrict__ nvals,
                  const float* __restrict__ bw, const float* __restrict__ xs,
                  int n_cells, int cell_blocks, int stage,
                  float* __restrict__ m_out, float* __restrict__ s_out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int r = blockIdx.x / cell_blocks;
  const int n = nvals[r];
  const float h = bw[r];
  const float* row = vals + static_cast<size_t>(r) * n_pad;
  const float* v = row;
  if (n <= stage) {  // uniform in the block
    float* sv = reinterpret_cast<float*>(smem_raw);
    for (int i = threadIdx.x; i < n; i += kThreads) sv[i] = row[i];
    __syncthreads();
    v = sv;
  }
  const int lane = threadIdx.x & 31;
  const int g = (blockIdx.x % cell_blocks) * kWarps + (threadIdx.x >> 5);
  if (g >= n_cells) return;
  const float x = xs[g];

  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, exponent(x, v[i], h));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  }

  int bits = 0;  // log2 (K / 4)
  while ((32 << (bits + 2)) < n) ++bits;
  const int quarter = 32 << bits;  // lanes apart of k and k + K/4
  float stack[kMaxLevels];
  float t = 0.0f;
  for (int q = 0; q < (1 << bits); ++q) {
    // k = q with its log2 (K / 4) bits reversed
    const int k = bits ? static_cast<int>(__brev(q) >> (32 - bits)) : 0;
    const int i = lane + 32 * k;
    const float a = term(v, i, n, x, h, m);
    const float b = term(v, i + 2 * quarter, n, x, h, m);
    const float c = term(v, i + quarter, n, x, h, m);
    const float d = term(v, i + 3 * quarter, n, x, h, m);
    t = __fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d));
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (!(q & (1 << l))) {
        stack[l] = t;
        break;
      }
      t = __fadd_rn(stack[l], t);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, d));
  }
  if (lane == 0) {
    m_out[static_cast<size_t>(r) * n_cells + g] = m;
    s_out[static_cast<size_t>(r) * n_cells + g] = t;
  }
}

}  // namespace

// vals (R, n_pad) f32, nvals (R,) i32 with nvals <= n_pad, bw (R,) f32, xs
// (n_cells,) f32 -> m_out, s_out (R, n_cells) f32. n_max: the largest
// nvals (the caller knows it on the host); it sizes the shared-memory stage.
extern "C" int otter_kde_scaled(const float* vals, int n_pad,
                                const int32_t* nvals, const float* bw,
                                const float* xs, int n_cells, int n_regions,
                                int n_max, float* m_out, float* s_out,
                                void* stream) {
  if (n_regions <= 0 || n_cells <= 0) return 0;
  if (n_max > n_pad || n_pad > (128 << (kMaxLevels - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stage =
      n_max * static_cast<int>(sizeof(float)) <= kMaxStagedBytes ? n_max : 0;
  const int smem = stage * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kde_scaled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cell_blocks = (n_cells + kWarps - 1) / kWarps;
  kde_scaled_kernel<<<cell_blocks * n_regions, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, n_pad, nvals, bw, xs, n_cells, cell_blocks, stage, m_out, s_out);
  return static_cast<int>(cudaGetLastError());
}
