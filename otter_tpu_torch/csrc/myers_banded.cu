// Kernels K3 and K4: Ukkonen-banded Myers/Hyyro on 64-bit pattern blocks,
// global (K3) and with one-sided ends-free text boundaries (K4).
//
// K3 replaces otter_tpu/kernels/myers_banded.py::_banded_kernel (launched by
// myers_banded_pallas through myers_banded_pool_pallas); K4 replaces
// _banded_ef_kernel (myers_banded_ef_pool_pallas). Both serve ACGT pairs and
// jobs whose shorter side is past K1's 2048 chars: the distance engine runs a
// ladder of bands k and sends what no rung resolves to K2.
//
// Per job (pattern = pool row idx_pat of m = minit chars, text = pool row
// idx_txt of n = nlen chars, K4 also tb free leading and te free trailing text
// chars): at text column j only the pattern blocks that meet rows
// [j - tb - k, j + k] are computed. The block above the band feeds a top
// boundary whose horizontal delta is +1, and a block entering the band at
// the bottom starts from vertical deltas of +1: both only raise DP values, so
// every computed value is an upper bound of the true one, and every cell of an
// alignment of cost <= k lies inside the band (its prefix cost is at least
// max(i - j, j - i - tb)) and is exact. The result is therefore exact when it
// is <= k, and an upper bound above k otherwise; the score of row m is
// captured over j in [n - te, n] while row m is in the band, starting from
// 2^30. This is the contract of the TPU kernels (the engine reads a result
// <= k as exact and escalates the rest); above k the two may differ.
//
// What bounds it: as K2, the DP state of patterns of up to 512 64-bit words
// lives in global scratch (4 loads and 2 stores of 8 bytes per 64 cells), but
// a column touches only ceil((2k + tb) / 64) + 1 blocks, not the whole
// pattern: O(n (2k + tb) / 64) block steps per job instead of O(n m / 64).
//
// Design: one thread per job, word-major scratch ([4][n_words64][n_jobs]) so a
// warp's accesses coalesce, one launch per rung for every job of the rung.
// The block step is K1's (myers_common.cuh); the top block of the band gets
// the boundary carry, the bottom block's last row is the tracked score.

#include <cstdint>

#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNoCapture = 1 << 30;

template <bool kEndsFree>
__global__ void __launch_bounds__(kThreads)
myers_banded_kernel(const uint32_t* __restrict__ pool, int w_pool,
                    const int32_t* __restrict__ idx_pat,
                    const int32_t* __restrict__ idx_txt,
                    const int32_t* __restrict__ nlen,
                    const int32_t* __restrict__ minit,
                    const int32_t* __restrict__ tb,
                    const int32_t* __restrict__ te, int k,
                    int32_t* __restrict__ out, int n_jobs, int n_words64,
                    int text_len, uint64_t* __restrict__ scratch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_jobs) return;
  const int m = minit[b];
  const int n = nlen[b];
  if (m <= 0 || m > 64 * n_words64 || n <= 0 || n > text_len) {
    out[b] = kNoCapture;
    return;
  }
  const int tbv = kEndsFree ? tb[b] : 0;
  const int tev = kEndsFree ? te[b] : 0;
  const int nwp = (m + 63) >> 6;
  const size_t stride = static_cast<size_t>(n_jobs);
  const size_t plane = static_cast<size_t>(n_words64) * stride;
  uint64_t* lo_g = scratch + b;
  uint64_t* hi_g = lo_g + plane;
  uint64_t* pv_g = hi_g + plane;
  uint64_t* mv_g = pv_g + plane;
  const uint32_t* prow = pool + static_cast<size_t>(idx_pat[b]) * w_pool;
  for (int w = 0; w < nwp; ++w) {
    uint64_t lo, hi;
    otter::pattern_word(prow, w, lo, hi);
    lo_g[w * stride] = lo;
    hi_g[w * stride] = hi;
    pv_g[w * stride] = ~0ull;
    mv_g[w * stride] = 0ull;
  }
  int w_hi = min(nwp - 1, k >> 6);
  int score = min(64 * (w_hi + 1), m);  // D[last row of block w_hi][0]
  int captured = kNoCapture;
  const uint32_t* trow = pool + static_cast<size_t>(idx_txt[b]) * w_pool;
  for (int j = 1; j <= n; ++j) {
    const int w_lo = max(0, j - tbv - k - 1) >> 6;
    const int hi_now = min(nwp - 1, (j + k - 1) >> 6);
    if (hi_now > w_hi) {  // a block enters: vertical deltas +1 below score
      w_hi = hi_now;
      score += min(64, m - 64 * w_hi);
    }
    if (w_lo > w_hi) break;  // row m has left the band for good
    const otter::CharFlip f((trow[(j - 1) >> 4] >> (2 * ((j - 1) & 15))) &
                            3u);
    uint64_t ca = 0, cm = 0;
    uint64_t cp = (w_lo > 0 || j > tbv) ? 1ull : 0ull;
    const uint64_t sb = w_hi == nwp - 1 ? 1ull << ((m - 1) & 63)
                                        : 1ull << 63;
    for (int w = w_lo; w <= w_hi; ++w) {
      const size_t o = w * stride;
      uint64_t pv = pv_g[o], mv = mv_g[o], ph, mh;
      otter::myers_step(f.eq(lo_g[o], hi_g[o]), pv, mv, ca, cp, cm, ph, mh);
      pv_g[o] = pv;
      mv_g[o] = mv;
      if (w == w_hi) {
        score += static_cast<int>((ph & sb) != 0) -
                 static_cast<int>((mh & sb) != 0);
      }
    }
    if (w_hi == nwp - 1 && j >= n - tev) captured = min(captured, score);
  }
  out[b] = captured;
}

template <bool kEndsFree>
int launch(const int32_t* pool, int w_pool, const int32_t* idx_pat,
           const int32_t* idx_txt, const int32_t* nlen, const int32_t* minit,
           const int32_t* tb, const int32_t* te, int k, int32_t* out,
           int n_jobs, int n_words, int text_len, void* scratch,
           void* stream) {
  if (n_words < 2 || (n_words & 1) || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_jobs + kThreads - 1) / kThreads;
  myers_banded_kernel<kEndsFree>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const uint32_t*>(pool), w_pool, idx_pat, idx_txt,
          nlen, minit, tb, te, k, out, n_jobs, n_words / 2, text_len,
          static_cast<uint64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_words counts 32-bit pattern words (even, >= 2); scratch holds
// 4 * (n_words / 2) * n_jobs 64-bit words, allocated by the caller.
extern "C" int otter_myers_banded(const int32_t* pool, int w_pool,
                                  const int32_t* idx_pat,
                                  const int32_t* idx_txt, const int32_t* nlen,
                                  const int32_t* minit, int k, int32_t* out,
                                  int n_jobs, int n_words, int text_len,
                                  void* scratch, void* stream) {
  return launch<false>(pool, w_pool, idx_pat, idx_txt, nlen, minit, nullptr,
                       nullptr, k, out, n_jobs, n_words, text_len, scratch,
                       stream);
}

extern "C" int otter_myers_banded_ef(const int32_t* pool, int w_pool,
                                     const int32_t* idx_pat,
                                     const int32_t* idx_txt,
                                     const int32_t* nlen, const int32_t* minit,
                                     const int32_t* tb, const int32_t* te,
                                     int k, int32_t* out, int n_jobs,
                                     int n_words, int text_len, void* scratch,
                                     void* stream) {
  return launch<true>(pool, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, k,
                      out, n_jobs, n_words, text_len, scratch, stream);
}
