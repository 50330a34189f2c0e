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
// N >= nvals gives the same s: the kernel takes the least power of two that
// is >= nvals and >= 4 P (P below).
//
// What bounds it: one expf a (cell, value) at the MUFU rate (132 SMs x 16 a
// clock), beside ~7 f32 operations (sub, div, 2 mul, max, sub, add); the
// inputs are read once (a region's values are staged in shared memory and
// reused by every cell of the block), the outputs are 8 bytes a cell. At 4
// warp instructions a clock an SM issues 8 non-MUFU instructions for each
// exp, so the design's aim is few instructions a (cell, value).
//
// Design. A thread holds C neighbouring grid cells (C = 4, or 8 when the
// batch has >= 4 groups of 8 cells an SM), so each value it loads feeds C
// independent chains (sub, div, square, exp) and the bookkeeping of a step
// is paid once for C cells. A cell group (C cells) is W warps, P = 32 W
// threads; thread j of a group owns the value lanes j + P k, k < K = N / P
// (consecutive threads read consecutive words). A block is Q cell groups of
// one region, Q W <= 16 warps. The launcher picks W (1 ... 16) by a rule: it
// doubles W until the grid of full blocks (Q = 16 / W) has a block an SM,
// as long as each lane keeps >= 16 values, so one region of 19,900 values
// still spreads over 101 SMs; W also grows until a lane's fold stack fits
// the common instance's kFastLevels. On a grid of a few rounds it then
// takes the Q (>= 8 warps a block) that leaves an SM the fewest groups.
//
// Max pass, without divisions: fl(a / h), squaring and the product by -0.5
// are each monotone in |a|, and round-to-nearest is symmetric, so the
// largest e_i is e of the value nearest x: m = e(min_i |fl(x - v_i)|), bit
// for bit the max of the e_i. A value costs a subtraction and a min;
// the division is paid once a cell.
//
// The division: fl(a / h) as fl(a fl(1 / h)) and one FMA correction (see
// div_by), three f32 operations where __fdiv_rn takes ~10 and a MUFU.RCP,
// for the cells whose every a is inside the range the CPU tests check it
// over; the others keep __fdiv_rn. A cell decides once, from its x, its m
// and the region's largest |v| and whether a nonzero |v| is below 2^-55
// (taken while staging).
//
// Sum pass, in the halving order: the first log2 K levels of the tree over
// N lanes only add lanes of one residue class mod P, so they are the
// halving tree over the lane's own K values. Its first two levels add k,
// k + K/2, k + K/4 and k + 3K/4 for each k < K/4: a step takes those four
// values and adds them as the tree does. Values at or past nvals are the
// tree's zeros and a suffix of the four, so a step branches once on how
// many are real (warp-uniform but at one step of a warp) and skips the
// others' exps: no term costs a bounds check, and no exp is spent on
// padding. The rest of the lane's tree is the halving tree over the K/4
// step sums, which the lane visits in bit-reversed order of k (there the
// tree pairs neighbours) and folds with a stack of partial sums (a binary
// counter: one sum a level). Then the halving levels over the P lane sums:
// the first log2 W pair lanes of different warps (j and j + P/2 ...), so
// each lane of the group's first warp folds its own column of the W warps'
// sums in shared memory in that order; the last 5 are
// __shfl_down_sync(16 ... 1), which pairs lane i with lane i + d as the
// halving does. Every quotient is the IEEE one (__fdiv_rn, or div_by where
// it equals it; no fast math), and the products and sums are written with
// the _rn intrinsics so the compiler contracts nothing into an fma that
// would change a bit: m and every exp(e - m) are the plain version's bit
// for bit (e - m itself may differ in the sign of a zero, see term).

#include <atomic>
#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#include "kde_rows.cuh"

#ifndef __CUDACC__
// host build of this source (the CPU tests' warp emulation)
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int b = 0; b < 32; ++b) r |= ((x >> b) & 1u) << (31 - b);
  return r;
}
#endif

namespace {

constexpr int kNarrowCells = 4;              // grid cells a thread: few
constexpr int kWideCells = 8;                //   regions, or many
constexpr int kWideGroupsPerSm = 4;          // wide cell groups for 8 cells
constexpr int kWarps = 16;                   // warps a block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kFastLevels = 8;               // fold stack: K / 4 up to 128
constexpr int kMaxLevels = 22;               // K / 4 up to 2^21: 268 M values
constexpr int kMaxStagedBytes = 200 * 1024;  // values staged up to this size
constexpr int kMinLaneValues = 16;           // values a lane before W doubles
constexpr int kFewRounds = 4;                // blocks an SM where Q is tuned
constexpr int kMinBlockWarps = 8;            // warps a block when Q is tuned

// Where div_by is IEEE division (tests/test_torch_kde.py checks it on the
// g++ build of this source): |h| in [2^-40, 2^40] and a = 0 or |a| in
// [2^-80, 2^80], so a / h, its products and its remainder are normal.
// A cell takes it when every a = fl(x - v) of its region is inside: |x| +
// max |v| <= 2^78 bounds |a| above, and |x| >= 2^-56 (or x = 0 and no
// nonzero |v| below 2^-55) bounds a nonzero |a| below by 2^-80.
constexpr float kDivHMin = 0x1p-40f, kDivHMax = 0x1p40f;
constexpr float kDivSumMax = 0x1p78f, kDivXMin = 0x1p-56f;
constexpr float kDivTinyV = 0x1p-55f;
constexpr float kFmaMMin = 0x1p-100f;  // see term

// fl(a / h) from y = fl(1 / h): q = fl(a y) and one correction with the
// remainder a - h q (Markstein), in the range above. Three f32 operations
// and no MUFU; __fdiv_rn is ~10 SASS and a MUFU.RCP. For a = -0 it gives
// +0, which the kernel only squares.
__device__ __forceinline__ float div_by(float a, float h, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-h, q, a), y, q);
}

// -(z * z) / 2 of z, exactly as the plain version computes it
__device__ __forceinline__ float neg_half_sq(float z) {
  return __fmul_rn(__fmul_rn(z, z), -0.5f);
}

// exp(e - m) of the value v. The fast path also folds e - m into one FMA,
// fl(fl(z z) (-0.5) - m): the product by -0.5 is exact unless fl(z z) is
// below 2^-125, and then it cannot move fl(e - m) when |m| >= 2^-100; when
// m = -0 it can only give -0 where fl(e) - m gives +0, and exp(-0) is
// exp(+0) (the cell's condition for the fast path holds one of the two).
template <bool kFast>
__device__ __forceinline__ float term(float x, float v, float h, float y,
                                      float m) {
  const float a = __fsub_rn(x, v);
  if (kFast) {
    const float z = div_by(a, h, y);
    return expf(__fmaf_rn(__fmul_rn(z, z), -0.5f, -m));
  }
  return expf(__fsub_rn(neg_half_sq(__fdiv_rn(a, h)), m));
}

// One step of a lane's tree: of the values i, i + qr, i + 2 qr, i + 3 qr the
// first kReal are real (the rest are the tree's zeros); t = (a + b) +
// (c + d) with a = i, b = i + 2 qr, c = i + qr, d = i + 3 qr, each zero
// left out (x + 0 is x).
// With kUnscaled (K13), m is 0 and each term is multiplied by cst, as
// kde_tree_step's (INV_SQRT_2PI / h) * exp(-(z z) / 2).
template <int kC, int kReal, bool kFast, bool kUnscaled>
__device__ __forceinline__ void step_sum(const float* v, int i, int qr,
                                         const float (&x)[kC], float h,
                                         float y, const float (&m)[kC],
                                         float cst, float (&t)[kC]) {
  const float va = kReal >= 1 ? v[i] : 0.0f;
  const float vc = kReal >= 2 ? v[i + qr] : 0.0f;
  const float vb = kReal >= 3 ? v[i + 2 * qr] : 0.0f;
  const float vd = kReal >= 4 ? v[i + 3 * qr] : 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    auto e = [&](float vv) {
      const float u = term<kFast>(x[c], vv, h, y, m[c]);
      return kUnscaled ? __fmul_rn(cst, u) : u;
    };
    if constexpr (kReal == 4) {
      t[c] = __fadd_rn(__fadd_rn(e(va), e(vb)), __fadd_rn(e(vc), e(vd)));
    } else if constexpr (kReal == 3) {
      t[c] = __fadd_rn(__fadd_rn(e(va), e(vb)), e(vc));
    } else if constexpr (kReal == 2) {
      t[c] = __fadd_rn(e(va), e(vc));
    } else if constexpr (kReal == 1) {
      t[c] = e(va);
    } else {
      t[c] = 0.0f;
    }
  }
}

// The halving tree over lane j's values j + P k (n of the region's values
// real), for kC cells: the steps in bit-reversed order of k, folded with a
// stack of kLevels sums a cell.
template <int kC, int kLevels, bool kFast, bool kUnscaled>
__device__ __forceinline__ void lane_sum(const float* v, int j, int P, int n,
                                         const float (&x)[kC], float h,
                                         float y, const float (&m)[kC],
                                         float cst, float (&t)[kC]) {
  int bits = 0;  // log2 (K / 4)
  while ((P << (bits + 2)) < n) ++bits;
  const int quarter = P << bits;  // lanes apart of k and k + K/4
  const int shift = __ffs(quarter) - 1;
  float stack[kLevels][kC];
  for (int q = 0; q < (1 << bits); ++q) {
    // k = q with its log2 (K / 4) bits reversed
    const int k = bits ? static_cast<int>(__brev(q) >> (32 - bits)) : 0;
    const int i = j + P * k;
    // how many of i, i + quarter, i + 2 quarter, i + 3 quarter are < n
    const int real = min(4, max(0, (n - i + quarter - 1) >> shift));
    if (real == 2) {
      step_sum<kC, 2, kFast, kUnscaled>(v, i, quarter, x, h, y, m, cst,
                                         t);
    } else if (real == 3) {
      step_sum<kC, 3, kFast, kUnscaled>(v, i, quarter, x, h, y, m, cst,
                                         t);
    } else if (real == 4) {
      step_sum<kC, 4, kFast, kUnscaled>(v, i, quarter, x, h, y, m, cst,
                                         t);
    } else if (real == 1) {
      step_sum<kC, 1, kFast, kUnscaled>(v, i, quarter, x, h, y, m, cst,
                                         t);
    } else {
      step_sum<kC, 0, kFast, kUnscaled>(v, i, quarter, x, h, y, m, cst,
                                         t);
    }
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (!(q & (1 << l))) {
#pragma unroll
        for (int c = 0; c < kC; ++c) stack[l][c] = t[c];
        break;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) t[c] = __fadd_rn(stack[l][c], t[c]);
    }
  }
}

// min |x - v| over lane j's values j + P k < n, for kC cells
template <int kC>
__device__ __forceinline__ void lane_min(const float* v, int j, int P, int n,
                                         const float (&x)[kC],
                                         float (&d)[kC]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) d[c] = INFINITY;
  for (int i = j; i < n; i += P) {
    const float vi = v[i];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      d[c] = fminf(d[c], fabsf(__fsub_rn(x[c], vi)));
    }
  }
}

// grid: cell_blocks x n_regions blocks of Q cell groups of W = warps warps
// (blockDim.x = 32 W Q <= kThreads). Shared memory: the staged row (stage
// floats), the warps' row statistics (kWarps x 2), the warps' minima
// (kWarps x kC), and with W > 1 the lane sums (kC x blockDim.x).
// kUnscaled (K13, kde_tree_step): no max pass (m = 0), each term times
// INV_SQRT_2PI / h, s_out the raw sums and div_out (R,) h * nvals; m_out
// is not written.
template <int kC, int kLevels, bool kUnscaled>
__global__ void __launch_bounds__(kThreads)
kde_scaled_kernel(const float* __restrict__ vals, int n_pad,
                  const int32_t* __restrict__ nvals,
                  const float* __restrict__ bw, const float* __restrict__ xs,
                  int n_cells, int warps, int cell_blocks, int stage,
                  float* __restrict__ m_out, float* __restrict__ s_out,
                  float* __restrict__ div_out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* sv = reinterpret_cast<float*>(smem_raw);
  float* stat_part = sv + stage;
  float* dmin_part = stat_part + kWarps * 2;
  float* sum_part = dmin_part + kWarps * kC;
  const int r = blockIdx.x / cell_blocks;
  const int n_real = nvals[r];
  const float h = bw[r];
  const float* row = vals + static_cast<size_t>(r) * n_pad;
  const bool staged = n_real <= stage;  // uniform in the block
  const int lane = threadIdx.x & 31;
  float vmax = 0.0f;  // max |v| and whether a nonzero |v| is below kDivTinyV
  bool tiny = false;
  const int threads = blockDim.x;
  for (int i = threadIdx.x; i < n_real; i += threads) {
    const float vi = row[i];
    if (staged) sv[i] = vi;
    vmax = fmaxf(vmax, fabsf(vi));
    tiny |= fabsf(vi) > 0.0f && fabsf(vi) < kDivTinyV;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  tiny = __any_sync(0xffffffffu, tiny);
  if (lane == 0) {
    stat_part[(threadIdx.x >> 5) * 2] = vmax;
    stat_part[(threadIdx.x >> 5) * 2 + 1] = tiny ? 1.0f : 0.0f;
  }
  const int P = 32 * warps;
  const int group = threadIdx.x / P;
  const int j = threadIdx.x - group * P;
  const int g0 = ((blockIdx.x % cell_blocks) * (threads / P) + group) * kC;
  const int n = g0 < n_cells ? n_real : 0;  // a group past the grid idles
  float x[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) x[c] = xs[min(g0 + c, n_cells - 1)];
  __syncthreads();

  float m[kC];
  if constexpr (kUnscaled) {
#pragma unroll
    for (int c = 0; c < kC; ++c) m[c] = 0.0f;
  } else {
    // the staged row through a pointer the compiler knows is shared (LDS)
    float d[kC];
    if (staged) {
      lane_min(sv, j, P, n, x, d);
    } else {
      lane_min(row, j, P, n, x, d);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        d[c] = fminf(d[c], __shfl_xor_sync(0xffffffffu, d[c], o));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dmin_part[(threadIdx.x >> 5) * kC + c] = d[c];
      }
    }
    __syncthreads();
    const float* dm = dmin_part + group * warps * kC;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float least = dm[c];
      for (int w = 1; w < warps; ++w) least = fminf(least, dm[w * kC + c]);
      m[c] = neg_half_sq(__fdiv_rn(least, h));  // -inf without values
    }
  }
  for (int w = 0; w < threads / 32; ++w) {
    vmax = fmaxf(vmax, stat_part[2 * w]);
    tiny |= stat_part[2 * w + 1] != 0.0f;
  }
  bool fast = fabsf(h) >= kDivHMin && fabsf(h) <= kDivHMax;
#pragma unroll
  for (int c = 0; c < kC; ++c) {  // the same for the group's threads
    const float ax = fabsf(x[c]);
    fast = fast && __fadd_rn(ax, vmax) <= kDivSumMax &&
           (ax >= kDivXMin || (ax == 0.0f && !tiny)) &&
           (m[c] == 0.0f || fabsf(m[c]) >= kFmaMMin);
  }

  float t[kC];
  const float y = __frcp_rn(h);
  const float cst = kUnscaled ? __fdiv_rn(kInvSqrt2Pi, h) : 0.0f;
  if (staged && fast) {
    lane_sum<kC, kLevels, true, kUnscaled>(sv, j, P, n, x, h, y, m, cst, t);
  } else if (staged) {
    lane_sum<kC, kLevels, false, kUnscaled>(sv, j, P, n, x, h, y, m, cst, t);
  } else if (fast) {
    lane_sum<kC, kLevels, true, kUnscaled>(row, j, P, n, x, h, y, m, cst, t);
  } else {
    lane_sum<kC, kLevels, false, kUnscaled>(row, j, P, n, x, h, y, m, cst,
                                            t);
  }

  if (warps > 1) {  // uniform in the block
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      sum_part[c * threads + threadIdx.x] = t[c];
    }
    __syncthreads();
    if (j < 32) {
      // lane j's column of its group: the sums of lanes j + 32 u, u < W
      float* col = sum_part + threadIdx.x;
      for (int w = warps; w > 1; w >>= 1) {
        for (int u = 0; u < w / 2; ++u) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float* p = col + c * threads;
            p[32 * u] = __fadd_rn(p[32 * u], p[32 * (u + w / 2)]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) t[c] = col[c * threads];
    }
  }
  if (j < 32) {  // the group's first warp
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        t[c] = __fadd_rn(t[c], __shfl_down_sync(0xffffffffu, t[c], o));
      }
    }
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (g0 + c < n_cells) {
          if (!kUnscaled) {
            m_out[static_cast<size_t>(r) * n_cells + g0 + c] = m[c];
          }
          s_out[static_cast<size_t>(r) * n_cells + g0 + c] = t[c];
        }
      }
    }
  }
  if (kUnscaled && threadIdx.x == 0 && blockIdx.x % cell_blocks == 0) {
    div_out[r] = __fmul_rn(h, static_cast<float>(n_real));
  }
}

// The SM count of the calling thread's current device (the card the launch
// goes to), read once a device index and cached; a thread that races
// another on a first read stores the same value. An index past the cache
// is read every time; a failed read gives the H100's 132.
int sm_count() {
  constexpr int kCachedDevices = 64;
  static std::atomic<int> cached[kCachedDevices];  // 0: not read yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 132;
  if (dev < kCachedDevices) {
    const int sms = cached[dev].load(std::memory_order_relaxed);
    if (sms > 0) return sms;
  }
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0) {
    return 132;
  }
  if (dev < kCachedDevices) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

// fold-stack levels a lane needs for rows of up to n_pad values at W warps
int levels(int n_pad, int warps) {
  int bits = 0;
  while ((static_cast<int64_t>(32 * warps) << (bits + 2)) < n_pad) ++bits;
  return bits + 1;
}

struct Geometry {
  int cells, warps, groups, cell_blocks, blocks;  // C, W, Q
  bool fast;                                      // the kFastLevels instance
};

// cells, warps: C and W, or 0 for the rule (see the note at the top)
Geometry geometry(int n_pad, int n_max, int n_cells, int n_regions,
                  int cells, int warps) {
  const int sms = sm_count();
  auto groups = [&](int c) {
    return static_cast<int64_t>((n_cells + c - 1) / c) * n_regions;
  };
  if (cells <= 0) {
    cells = groups(kWideCells) >= kWideGroupsPerSm * sms ? kWideCells
                                                         : kNarrowCells;
  }
  const int per_region = (n_cells + cells - 1) / cells;
  auto blocks = [&](int q) {
    return static_cast<int64_t>((per_region + q - 1) / q) * n_regions;
  };
  if (warps <= 0) {
    warps = 1;
    while (warps < kWarps &&
           (levels(n_pad, warps) > kFastLevels ||
            (blocks(kWarps / warps) < sms &&
             64 * warps * kMinLaneValues <= n_max))) {
      warps *= 2;
    }
  }
  // Q: full blocks, except on a grid of a few rounds, where an SM's share
  // of cell groups, ceil(blocks / SMs) Q, is least at some smaller Q (of at
  // least 8 warps a block); ties to the larger Q
  int q_best = kWarps / warps;
  if (blocks(q_best) <= kFewRounds * sms) {
    int64_t best = INT64_MAX;
    for (int q = kWarps / warps; q * warps >= kMinBlockWarps && q >= 1;
         --q) {
      const int64_t share = (blocks(q) + sms - 1) / sms * q;
      if (share < best) best = share, q_best = q;
    }
  }
  const int cb = (per_region + q_best - 1) / q_best;
  return {cells, warps, q_best, cb, cb * n_regions,
          levels(n_pad, warps) <= kFastLevels};
}

using Kernel = void (*)(const float*, int, const int32_t*, const float*,
                        const float*, int, int, int, int, float*, float*,
                        float*);

template <bool kUnscaled>
Kernel pick(const Geometry& geo) {
  if (geo.cells == kWideCells) {
    return geo.fast ? kde_scaled_kernel<kWideCells, kFastLevels, kUnscaled>
                    : kde_scaled_kernel<kWideCells, kMaxLevels, kUnscaled>;
  }
  return geo.fast ? kde_scaled_kernel<kNarrowCells, kFastLevels, kUnscaled>
                  : kde_scaled_kernel<kNarrowCells, kMaxLevels, kUnscaled>;
}

// launch K8 (m_out, s_out) or with kUnscaled K13's sums (s_out, div_out)
template <bool kUnscaled>
int launch(const float* vals, int n_pad, const int32_t* nvals,
           const float* bw, const float* xs, int n_cells, int n_regions,
           int n_max, int cells, int warps, float* m_out, float* s_out,
           float* div_out, void* stream) {
  if (n_max > n_pad || n_pad > (128 << (kMaxLevels - 1)) || warps < 0 ||
      warps > kWarps || (warps & (warps - 1)) ||
      (cells != 0 && cells != kNarrowCells && cells != kWideCells)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry geo =
      geometry(n_pad, n_max, n_cells, n_regions, cells, warps);
  const int stage =
      n_max * static_cast<int>(sizeof(float)) <= kMaxStagedBytes ? n_max : 0;
  const int threads = 32 * geo.warps * geo.groups;
  const int smem = static_cast<int>(sizeof(float)) *
                   (stage + kWarps * (2 + geo.cells) +
                    (geo.warps > 1 ? geo.cells * threads : 0));
  const Kernel kernel = pick<kUnscaled>(geo);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<geo.blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, n_pad, nvals, bw, xs, n_cells, geo.warps, geo.cell_blocks, stage,
      m_out, s_out, div_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (R, n_pad) f32, nvals (R,) i32 with nvals <= n_pad, bw (R,) f32, xs
// (n_cells,) f32 -> m_out, s_out (R, n_cells) f32. n_max: the largest
// nvals (the caller knows it on the host); it sizes the shared-memory stage.
// cells: the grid cells a thread (4 or 8), warps: the warps of a cell group
// (1, 2, 4, 8 or 16); 0 takes the rule.
extern "C" int otter_kde_scaled_launch(const float* vals, int n_pad,
                                       const int32_t* nvals, const float* bw,
                                       const float* xs, int n_cells,
                                       int n_regions, int n_max, int cells,
                                       int warps, float* m_out, float* s_out,
                                       void* stream) {
  if (n_regions <= 0 || n_cells <= 0) return 0;
  return launch<false>(vals, n_pad, nvals, bw, xs, n_cells, n_regions, n_max,
                       cells, warps, m_out, s_out, nullptr, stream);
}

// Kernel K13 (otter_tpu/parallel/mesh.py::kde_tree_step, jnp): the same
// traversal without the max pass, each term (INV_SQRT_2PI / h) exp(-(z z) /
// 2), then each row / (h nvals) and / max(row total, 1e-30) (kde_rows.cuh).
// vals, nvals, bw, xs, n_max as otter_kde_scaled -> out (R, n_cells) f32;
// raw (R, n_cells) and div (R,) f32 are scratch; n_cells <= 1024.
extern "C" int otter_kde_tree(const float* vals, int n_pad,
                              const int32_t* nvals, const float* bw,
                              const float* xs, int n_cells, int n_regions,
                              int n_max, int cells, int warps, float* raw,
                              float* div, float* out, void* stream) {
  if (n_regions <= 0 || n_cells <= 0) return 0;
  if (row_lanes(n_cells) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = launch<true>(vals, n_pad, nvals, bw, xs, n_cells,
                               n_regions, n_max, cells, warps, nullptr, raw,
                               div, stream);
  if (err != 0) return err;
  return normalize_rows(raw, div, n_cells, n_regions, out, stream);
}

extern "C" int otter_kde_scaled(const float* vals, int n_pad,
                                const int32_t* nvals, const float* bw,
                                const float* xs, int n_cells, int n_regions,
                                int n_max, float* m_out, float* s_out,
                                void* stream) {
  return otter_kde_scaled_launch(vals, n_pad, nvals, bw, xs, n_cells,
                                 n_regions, n_max, 0, 0, m_out, s_out,
                                 stream);
}

// The launch otter_kde_scaled picks: out = {W, cells a thread, blocks,
// threads a block}.
extern "C" int otter_kde_scaled_geometry(int n_pad, int n_max, int n_cells,
                                         int n_regions, int* out) {
  const Geometry geo = geometry(n_pad, n_max, n_cells, n_regions, 0, 0);
  out[0] = geo.warps;
  out[1] = geo.cells;
  out[2] = geo.blocks;
  out[3] = 32 * geo.warps * geo.groups;
  return 0;
}
