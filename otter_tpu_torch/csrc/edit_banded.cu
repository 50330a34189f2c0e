// Kernel K7: banded Levenshtein row DP over any byte alphabet.
//
// Replaces otter_tpu/kernels/edit_pallas.py::_edit_kernel (launched by
// edit_banded_pallas). The distance engine sends it the pairs no Myers kernel
// takes (a non-ACGT character, or a side over 32 kb) on a ladder of bands k.
//
// Inputs, as the TPU launch takes them (edit_pallas.py::_pack_bucket): a
// (B, L) int32 codes of the longer side (the rows), bpad (B, L + W + 2) int32
// codes of the shorter side shifted right by k + 1 (the band's columns), and
// mn (B, 2) = (m, n), with W = 2 (k + 1). Row i keeps W lanes; lane w is
// column j = i + w - (k + 1). Lanes with j < 0 or j > n hold INF = 2^24, the
// column j = 0 holds i, and a lane is min(up + 1, diag + sub, left + 1), the
// left term as the running minimum along the row. The result is the lane of
// column n after row m: exact when it is <= k, INF when |m - n| > k. The
// arithmetic is the TPU kernel's, value for value, INF lanes included.
//
// What bounds it: one thread walks its pair's m rows of W lanes with ~10
// int32 operations per cell, and the row lives in global scratch (one load
// and one store of 4 bytes per cell, from L2 for the band widths of the
// ladder's first rungs), so it is bound by that traffic: the TPU kernel's
// row-parallel prefix-min scan has no counterpart here. A simple kernel that
// is right, for pairs that are rare on HiFi data (reads with N bases).
//
// Design: one thread per pair and the row updated in place (lane w reads the
// old lanes w and w + 1 before it is written); scratch is lane-major
// ([W][B]) so a warp's accesses coalesce.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInf = 1 << 24;

__global__ void __launch_bounds__(kThreads)
edit_banded_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ bpad,
                   const int32_t* __restrict__ mn, int L, int k,
                   int32_t* __restrict__ out, int n_pairs,
                   int32_t* __restrict__ scratch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_pairs) return;
  const int W = 2 * (k + 1);
  const int m = min(mn[2 * b], L);
  const int n = mn[2 * b + 1];
  const size_t stride = static_cast<size_t>(n_pairs);
  int32_t* row = scratch + b;
  for (int w = 0; w < W; ++w) {
    const int j = w - (k + 1);
    row[w * stride] = (j >= 0 && j <= n) ? j : kInf;
  }
  const int32_t* arow = a + static_cast<size_t>(b) * L;
  const int32_t* brow = bpad + static_cast<size_t>(b) * (L + W + 2);
  for (int i = 1; i <= m; ++i) {
    const int ac = arow[i - 1];
    int run = 0;
    int next = row[0];
    for (int w = 0; w < W; ++w) {
      const int j = i + w - (k + 1);
      const int prev = next;
      next = w + 1 < W ? row[(w + 1) * stride] : kInf;
      int v = min(next + 1, prev + (brow[i - 1 + w] != ac ? 1 : 0));
      if (j == 0) v = i;
      const bool invalid = j < 0 || j > n;
      if (invalid) v = kInf;
      run = w == 0 ? v : min(v, run + 1);
      row[w * stride] = invalid ? kInf : run;
    }
  }
  const int target = n - m + (k + 1);
  const bool valid = (m - n <= k) && (n - m <= k);
  out[b] = valid ? row[target * stride] : kInf;
}

}  // namespace

// scratch holds 2 (k + 1) * n_pairs int32, allocated by the caller.
extern "C" int otter_edit_banded(const int32_t* a, const int32_t* bpad,
                                 const int32_t* mn, int L, int k, int32_t* out,
                                 int n_pairs, void* scratch, void* stream) {
  if (k < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  edit_banded_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, bpad, mn, L, k, out, n_pairs, static_cast<int32_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
