// Kernel K14: per-region Gaussian KDE of a cross-region batch of pair
// distances over a linspace grid, the KDE half of the sharded forward step.
//
// Replaces otter_tpu/parallel/mesh.py::region_batch_step's KDE (:64-77, jnp,
// not Pallas; its distances are K7's). For pair p with distance d, lengths
// m, n and region r (bandwidth h = bw[r]), and grid point x_g:
//
//   norm  = f32(d) / max(f32(max(m, n)), 1)
//   term  = fl(INV_SQRT_2PI / h) * exp(-(z * z) / 2),  z = (x_g - norm) / h
//   raw   = the sum of a region's valid pairs' terms, in the order below
//   dens  = raw / max(count, 1), then / max(row total, 1e-30)
//
// (IEEE f32 throughout, as jnp writes it). An INF distance (2^24) stays in:
// its terms are 0 but it is counted. XLA leaves the order of the segment sum
// unspecified; here it is fixed and independent of the card, so the
// densities are deterministic and the same at every mesh size: a region's
// valid pairs in input order (the wrapper groups them by a stable sort) are
// cut into consecutive chunks of kChunk pairs; a chunk's sum at a grid point
// is taken in pair order, and the region's raw sum is its chunk sums added
// in chunk order (a region of at most kChunk pairs: one sequential sum).
// The row total is kde_rows.cuh's halving tree.
//
// What bounds it: one expf a (pair, grid point) at the MUFU rate (132 SMs x 16
// a clock), and in practice a second MUFU op, __fdiv_rn's reciprocal; the
// inputs are ~20 bytes a pair and the output 4 bytes a cell. Design: a block a
// (region, chunk), so a few large regions still fill every SM; the block
// stages its chunk's normalised distances in shared memory (each read once
// from device memory) and each thread sums one grid point's terms over the
// staged chunk. (Four or two points a thread, fewer warps, measured slower:
// each __fdiv_rn ends in a branch to its slow path, so one thread's chains
// hardly overlap, and warps hide the latency better.) A region of one chunk
// finishes in its block. Otherwise each block writes its chunk sums to
// `partial` and takes a ticket of its region; the last block of the region
// adds the region's chunk sums in chunk order and sets the ticket back to 0,
// so the ticket array is zero again for the next launch. Then the finishing
// block divides by the count and normalises the row with the halving tree: one
// launch in all. Every quotient is __fdiv_rn and every product and sum an _rn
// intrinsic, so the compiler contracts nothing into an fma: each term is the
// plain version's bit for bit but for expf against torch.exp.

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

#include "kde_rows.cuh"

namespace {

constexpr int kChunk = 256;   // pairs a chunk (kernels/kde_pairs.py CHUNK)
// shared ints after the staged floats: the warps' chunk counts, the found
// region and chunk, the ticket's verdict
constexpr int kScanInts = 32 + 3;
static_assert(kChunk <= kRowLanes, "a chunk is staged in the row's lanes");

// the chunks of a region of c valid pairs (an empty region has one, empty)
__device__ __forceinline__ int chunks_of(int c) {
  return c > kChunk ? (c + kChunk - 1) / kChunk : 1;
}

// Chunk b of the launch, the chunks numbered region after region: its
// region (*r) and its index in the region (*j); false past the last chunk.
// Every thread of the block calls it; scan holds kScanInts ints.
__device__ bool find_chunk(const int32_t* __restrict__ starts, int n_regions,
                           int b, int* scan, int* r, int* j) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (n_regions + blockDim.x - 1) / blockDim.x;
  const int r0 = min(t * per, n_regions), r1 = min(r0 + per, n_regions);
  int own = 0;
  for (int q = r0; q < r1; ++q) own += chunks_of(starts[q + 1] - starts[q]);
  int incl = own;
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += v;
  }
  if (lane == 31) scan[w] = incl;
  if (t == 0) scan[32] = -1;
  __syncthreads();
  int first = incl - own;  // the chunk number of region r0's first chunk
  for (int q = 0; q < w; ++q) first += scan[q];
  if (b >= first && b < first + own) {
    int q = r0;
    for (int c = chunks_of(starts[q + 1] - starts[q]); b >= first + c;
         c = chunks_of(starts[q + 1] - starts[q])) {
      first += c;
      ++q;
    }
    scan[32] = q;
    scan[33] = b - first;
  }
  __syncthreads();
  *r = scan[32];
  *j = scan[33];
  return *r >= 0;
}

// grid: the chunks' upper bound (n_pairs / kChunk + R blocks; the blocks
// past the last chunk return at once); blockDim.x >= n_cells (a multiple
// of 32), a thread a grid point. order (the valid pairs grouped by region,
// in input order) from starts[r] to starts[r + 1]. partial (blocks,
// n_cells) scratch; tickets (R,) int32, zero. Shared memory: `lanes` floats
// (the staged chunk, then the row's tree), then kScanInts ints.
__global__ void __launch_bounds__(kMaxLanes)
kde_pairs_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ m,
                 const int32_t* __restrict__ n,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts,
                 const float* __restrict__ bw, const float* __restrict__ xs,
                 int n_cells, int n_regions, int lanes,
                 float* __restrict__ partial, int32_t* __restrict__ tickets,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  int* scan = reinterpret_cast<int*>(stage + lanes);
  const int g = threadIdx.x;
  int r, j;
  if (!find_chunk(starts, n_regions, blockIdx.x, scan, &r, &j)) return;
  const int lo = starts[r], hi = starts[r + 1];
  const int n_chunks = chunks_of(hi - lo);
  const int c0 = lo + j * kChunk;
  const int count = max(0, min(kChunk, hi - c0));
  for (int i = g; i < count; i += blockDim.x) {
    const int p = order[c0 + i];
    const float len = static_cast<float>(max(m[p], n[p]));
    stage[i] = __fdiv_rn(static_cast<float>(d[p]), fmaxf(len, 1.0f));
  }
  const float h = bw[r];
  const float c = __fdiv_rn(kInvSqrt2Pi, h);
  const float x = g < n_cells ? xs[g] : 0.0f;
  __syncthreads();
  float acc = 0.0f;  // the chunk's sum, pair by pair in order
  if (g < n_cells) {
    for (int i = 0; i < count; ++i) {
      const float z = __fdiv_rn(__fsub_rn(x, stage[i]), h);
      const float e = __fmul_rn(__fmul_rn(z, z), -0.5f);
      acc = __fadd_rn(acc, __fmul_rn(c, expf(e)));
    }
  }
  if (n_chunks > 1) {
    if (g < n_cells) {
      partial[static_cast<size_t>(blockIdx.x) * n_cells + g] = acc;
    }
    __threadfence();  // the sums are visible before the ticket is taken
    __syncthreads();
    if (g == 0) scan[34] = atomicAdd(tickets + r, 1) == n_chunks - 1;
    __syncthreads();
    if (!scan[34]) return;
    if (g == 0) tickets[r] = 0;
    __threadfence();
    if (g < n_cells) {
      // the region's chunk sums, in chunk order, past the L1
      const float* col = partial + static_cast<size_t>(blockIdx.x - j) *
                                       n_cells + g;
      acc = __ldcg(col);
#pragma unroll 4
      for (int q = 1; q < n_chunks; ++q) {
        acc = __fadd_rn(acc, __ldcg(col + static_cast<size_t>(q) * n_cells));
      }
    }
  }
  // the row: / max(count, 1), then / its halving total
  const float dens = __fdiv_rn(acc, fmaxf(static_cast<float>(hi - lo), 1.0f));
  __syncthreads();  // the staged chunk is read
  for (int i = g; i < lanes; i += blockDim.x) {
    stage[i] = i == g && g < n_cells ? dens : 0.0f;
  }
  const float total = row_total(stage, lanes);
  if (g < n_cells) {
    out[static_cast<size_t>(r) * n_cells + g] = __fdiv_rn(dens, total);
  }
}

}  // namespace

// d, m, n (B,) i32 (any B; only the pairs in order are read), order
// (n_pairs,) i32 the pairs grouped by region (valid ones first), starts
// (R + 1,) i32 the valid pairs' offsets, bw (R,) f32, xs (n_cells,) f32 ->
// out (R, n_cells) f32 densities. partial (n_pairs / 256 + R, n_cells) f32
// is scratch; tickets (R,) int32 must be zero and are zero again when the
// launch ends (one array a stream: launches on one stream take their
// tickets in turn). n_cells <= 1024.
extern "C" int otter_kde_pairs(const int32_t* d, const int32_t* m,
                               const int32_t* n, const int32_t* order,
                               const int32_t* starts, const float* bw,
                               const float* xs, int n_cells, int n_regions,
                               int n_pairs, float* partial, int32_t* tickets,
                               float* out, void* stream) {
  if (n_regions <= 0 || n_cells <= 0) return 0;
  if (row_lanes(n_cells) == 0 || n_pairs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = n_pairs / kChunk + n_regions;
  const int lanes = row_lanes(n_cells);
  const int threads = (n_cells + 31) / 32 * 32;
  const int smem = lanes * static_cast<int>(sizeof(float)) +
                   kScanInts * static_cast<int>(sizeof(int));
  kde_pairs_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      d, m, n, order, starts, bw, xs, n_cells, n_regions, lanes, partial,
      tickets, out);
  return static_cast<int>(cudaGetLastError());
}
