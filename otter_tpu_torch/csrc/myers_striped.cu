// Kernel K2: full-matrix Myers/Hyyro for patterns of any length (up to
// 32 kb), with one-sided ends-free boundaries on the text.
//
// Replaces the TPU kernel otter_tpu/kernels/myers_striped.py::
// _myers_stripe_kernel (launched by myers_stripe from _striped_launch).
// The TPU kernel keeps at most 32 pattern words in VMEM and chains stripes of
// 32 words through three per-character carry planes (adder, Ph, Mh). Here one
// thread walks the whole pattern for every text character, so no carry ever
// leaves the thread and there are no stripes; the result is the same value.
//
// Per job (pattern = pool row idx_pat of length m = minit, text = pool row
// idx_txt of length nlen): the first tb text characters are free at the
// begin (their top-row Ph carry-in is 0: D[0][j] = max(0, j - tb)), and the
// last te are free at the end (the score is the minimum of D[m][j] over
// j in [nlen - te, nlen], j >= 1). The result starts at 2^30 as on the TPU;
// tb = te = 0 gives the global distance D[m][nlen].
//
// What bounds it: memory traffic of the DP state. A pattern of up to 512
// 64-bit words does not fit in registers, so Pv/Mv and the two pattern bit
// planes live in global scratch: 4 loads and 2 stores of 8 bytes per 64 DP
// cells, ~0.75 bytes per cell, served mostly from L2 (a 1024-job launch
// with 2 kb patterns holds 8 MB of state, under the 50 MB L2). The integer
// work is the same ~0.6 int32 instructions per cell as K1.
//
// Design: the scratch is laid out word-major ([4][n_words64][n_jobs]), so the
// threads of a warp touch 32 consecutive 8-byte words on every access
// (coalesced). Each job runs only its own ceil(m/64) words and its own
// min(nlen, text_len) characters. All jobs of a call are one launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
myers_striped_kernel(const uint32_t* __restrict__ pool, int w_pool,
                     const int32_t* __restrict__ idx_pat,
                     const int32_t* __restrict__ idx_txt,
                     const int32_t* __restrict__ nlen,
                     const int32_t* __restrict__ minit,
                     const int32_t* __restrict__ tb,
                     const int32_t* __restrict__ te,
                     int32_t* __restrict__ out, int n_jobs, int n_words64,
                     int text_len, uint64_t* __restrict__ scratch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_jobs) return;
  const int m = minit[b];
  const int n_all = nlen[b];
  const int n = min(n_all, text_len);
  // rows past 64 * n_words64 have no score bit, as on the TPU: score stays m
  const int nwp = (m > 0 && m <= 64 * n_words64) ? (m + 63) >> 6 : 0;
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
  const int sw = nwp - 1;
  const uint64_t sb = nwp ? 1ull << ((m - 1) & 63) : 0ull;
  const int tb_b = tb[b];
  const int first_capture = n_all - te[b];  // capture once j + 1 >= this
  int score = m;
  int captured = 1 << 30;
  const uint32_t* trow = pool + static_cast<size_t>(idx_txt[b]) * w_pool;
  for (int j0 = 0; j0 < n; j0 += 16) {
    const uint32_t tw = trow[j0 >> 4];
    const int jn = min(16, n - j0);
    for (int c = 0; c < jn; ++c) {
      const int j = j0 + c;
      const otter::CharFlip f((tw >> (2 * c)) & 3u);
      uint64_t ca = 0, cm = 0;
      uint64_t cp = j >= tb_b ? 1ull : 0ull;  // free leading text: carry 0
      for (int w = 0; w < nwp; ++w) {
        const size_t o = w * stride;
        uint64_t pv = pv_g[o], mv = mv_g[o], ph, mh;
        otter::myers_step(f.eq(lo_g[o], hi_g[o]), pv, mv, ca, cp, cm, ph, mh);
        if (w == sw) {
          score += static_cast<int>((ph & sb) != 0) -
                   static_cast<int>((mh & sb) != 0);
        }
        pv_g[o] = pv;
        mv_g[o] = mv;
      }
      if (j + 1 >= first_capture) captured = min(captured, score);
    }
  }
  out[b] = captured;
}

}  // namespace

// n_words counts 32-bit pattern words (even, >= 2); scratch holds
// 4 * (n_words / 2) * n_jobs 64-bit words, allocated by the caller.
extern "C" int otter_myers_striped(const int32_t* pool, int w_pool,
                                   const int32_t* idx_pat,
                                   const int32_t* idx_txt,
                                   const int32_t* nlen, const int32_t* minit,
                                   const int32_t* tb, const int32_t* te,
                                   int32_t* out, int n_jobs, int n_words,
                                   int text_len, void* scratch,
                                   void* stream) {
  if (n_words < 2 || (n_words & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_jobs + kThreads - 1) / kThreads;
  myers_striped_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(pool), w_pool, idx_pat, idx_txt, nlen,
      minit, tb, te, out, n_jobs, n_words / 2, text_len,
      static_cast<uint64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
