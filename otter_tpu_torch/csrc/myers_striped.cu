// Kernel K2: full-matrix Myers/Hyyro for patterns of any length (up to
// 32 kb), with one-sided ends-free boundaries on the text.
//
// Replaces the TPU kernel otter_tpu/kernels/myers_striped.py::
// _myers_stripe_kernel (launched by myers_stripe from _striped_launch).
// The TPU kernel keeps at most 32 pattern words in VMEM and chains stripes of
// 32 words through three per-character carry planes (adder, Ph, Mh). Here a
// group of G lanes of one warp runs a job, each lane holding a stripe of
// consecutive pattern words, and the carries go from stripe to stripe by a
// shuffle; the result is the same value.
//
// Per job (pattern = pool row idx_pat of length m = minit, text = pool row
// idx_txt of length nlen): the first tb text characters are free at the
// begin (their top-row Ph carry-in is 0: D[0][j] = max(0, j - tb)), and the
// last te are free at the end (the score is the minimum of D[m][j] over
// j in [nlen - te, nlen], j >= 1). The result starts at 2^30 as on the TPU;
// tb = te = 0 gives the global distance D[m][nlen].
//
// Design: the job's nwp = ceil(m / 64) 64-bit words are split over its group
// of G lanes (G a power of two, at most 32, a launch argument): lane g holds
// words [g qe, g qe + qe), qe = ceil(nwp / G) <= Q, with Q a template
// parameter (1, 2, 4, 8, 16 or 32), so Pv and Mv live in registers. The
// pattern's two bit planes stay in registers too for Q <= 8, and go to
// shared memory ([2][Q][block], 16 bytes per word per thread, as in K1) for
// Q = 16 and 32. The group runs a diagonal pipeline over steps of kCols = 4
// text columns: at step s, lane g advances columns [4 (s - g), 4 (s - g) + 4)
// over its words. It takes the adder, Ph and Mh carries of those columns out
// of the word above its stripe from lane g - 1 by one __shfl_up_sync of
// width G (lane g - 1 ran the same columns at step s - 1; 12 bits); lane 0
// starts every column with ca = 0, cm = 0 and cp = (j >= tb). Within a step,
// word u of column c + 1 follows word u of column c, so the columns' carry
// chains overlap, and the step's fixed cost (the shuffle, the capture, the
// loop) is paid once for 4 columns. So that only the carries' own
// arithmetic waits on the shuffle, every lane reads the text itself (16
// chars a word, the next word loaded 16 columns ahead) and does the first
// word's carry-free half of the first column (the match mask and
// (eq & pv) + pv) before the shuffle. The lane that holds word nwp - 1 keeps
// the score and the running capture over j + 1 in [nlen - te, nlen],
// starting from 2^30. A job takes ceil(n / 4) + G - 1 steps; the wrapper
// sorts a launch's jobs by the words a lane runs and then by text length, so
// the groups of a warp run alike and finish together, and picks (G, Q) from
// the longest pattern and the job count: a small launch (the reassignment
// jobs of a few loci) gets many lanes on each job and so a short serial
// chain, a large one fills the card with groups. G = 1 is K1's design (one
// thread walks every word of a column) plus tb/te. Patterns over 2048 (up
// to 512 words) take a whole warp, Q <= 16.
//
// What bounds it: INT32 issue. A word step is ~36 int32 operations for 64
// DP cells (myers.cu's note; ~50 SASS instructions, as in K1), and a step
// adds a fixed cost per lane for the shuffle, the carries and the capture,
// which weighs less as qe grows. Device memory holds only the inputs and
// the result.

#include <cstdint>

#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kRegQ = 8;  // bit planes in registers up to this Q
constexpr int kCols = 4;  // text columns a step (a divisor of 16)

// The pattern's bit planes of a lane's Q words: registers, or a column of
// shared memory with stride kThreads.
template <int Q, bool kShared>
struct Planes;

template <int Q>
struct Planes<Q, false> {
  uint64_t lo[Q], hi[Q];
  __device__ __forceinline__ Planes(uint8_t*, int) {}
  // u is a constant of an unrolled loop, so the arrays stay in registers
  __device__ __forceinline__ void set(int u, uint64_t l, uint64_t h) {
    lo[u] = l;
    hi[u] = h;
  }
  __device__ __forceinline__ uint64_t eq(int u,
                                         const otter::CharFlip& f) const {
    return f.eq(lo[u], hi[u]);
  }
};

template <int Q>
struct Planes<Q, true> {
  uint64_t* lo;
  uint64_t* hi;
  __device__ __forceinline__ Planes(uint8_t* smem, int tid)
      : lo(reinterpret_cast<uint64_t*>(smem) + tid),
        hi(reinterpret_cast<uint64_t*>(smem) + Q * kThreads + tid) {}
  __device__ __forceinline__ void set(int u, uint64_t l, uint64_t h) {
    lo[u * kThreads] = l;
    hi[u * kThreads] = h;
  }
  __device__ __forceinline__ uint64_t eq(int u,
                                         const otter::CharFlip& f) const {
    return f.eq(lo[u * kThreads], hi[u * kThreads]);
  }
};

template <int Q>
__global__ void __launch_bounds__(kThreads)
myers_striped_kernel(const uint32_t* __restrict__ pool, int w_pool,
                     const int32_t* __restrict__ idx_pat,
                     const int32_t* __restrict__ idx_txt,
                     const int32_t* __restrict__ nlen,
                     const int32_t* __restrict__ minit,
                     const int32_t* __restrict__ tb,
                     const int32_t* __restrict__ te,
                     int32_t* __restrict__ out, int n_jobs, int n_words64,
                     int text_len, int G, const int32_t* __restrict__ order) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int g = tid & (G - 1);
  const int slot = blockIdx.x * (kThreads / G) + tid / G;
  // a slot past the last job still takes part in its warp's shuffles
  const bool live = slot < n_jobs;
  const int b = live ? (order != nullptr ? order[slot] : slot) : 0;
  const int m = live ? minit[b] : 0;
  const int n_all = live ? nlen[b] : 0;
  const int n = min(n_all, text_len);
  // rows past 64 * n_words64 have no score bit, as on the TPU: score stays m
  const int nwp = (m > 0 && m <= 64 * n_words64) ? (m + 63) >> 6 : 0;
  const int qe = nwp > 0 ? (nwp + G - 1) / G : 1;
  const int last = nwp > 0 ? (nwp - 1) / qe : 0;  // the lane of the score row
  const int wbase = g * qe;
  const int sl = nwp - 1 - wbase;  // the score word, on lane `last`
  const uint64_t sb = nwp ? 1ull << ((m - 1) & 63) : 0ull;

  Planes<Q, (Q > kRegQ)> planes(smem_raw, tid);
  uint64_t Pv[Q], Mv[Q];
  const uint32_t* prow = pool + static_cast<size_t>(live ? idx_pat[b] : 0) *
                                    w_pool;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    uint64_t lo = 0, hi = 0;
    if (u < qe && wbase + u < nwp) {
      otter::pattern_word(prow, wbase + u, lo, hi);
    }
    planes.set(u, lo, hi);
    Pv[u] = ~0ull;
    Mv[u] = 0ull;
  }
  const int tb_b = live ? tb[b] : 0;
  const int first_capture = n_all - (live ? te[b] : 0);  // j + 1 >= this
  int score = m;
  int captured = 1 << 30;
  const uint32_t* trow = pool + static_cast<size_t>(live ? idx_txt[b] : 0) *
                                    w_pool;
  // a step runs kCols columns; every lane of the warp runs the warp's
  // longest job's steps
  const int n_steps = (n + kCols - 1) / kCols;
  int steps = n > 0 ? n_steps + last : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    steps = max(steps, __shfl_xor_sync(kAll, steps, d));
  }
  uint32_t tw = 0;
  uint32_t tnext = n > 0 ? trow[0] : 0u;
  uint32_t msg = 0;  // per column, the carries out of the stripe: ca, cp, cm
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int sp = s - g;
    const int j0 = kCols * sp;  // this lane's first column
    const bool on = g <= last && sp >= 0 && sp < n_steps;
    if (on && (j0 & 15) == 0) {  // its chars, the next word 16 columns ahead
      tw = tnext;
      tnext = j0 + 16 < n ? trow[(j0 >> 4) + 1] : 0u;
    }
    otter::CharFlip f[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      f[c] = otter::CharFlip((tw >> (2 * ((j0 & 15) + c))) & 3u);
    }
    // the first word's carry-free half of the first column, before the
    // carries arrive
    const uint64_t eq0 = planes.eq(0, f[0]);
    uint64_t s0, c1;
    otter::myers_add(eq0, Pv[0], s0, c1);
    uint32_t in = __shfl_up_sync(kAll, msg, 1, G);
    if (g == 0) {  // the top row: cp = (j >= tb)
      in = 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) in |= (j0 + c >= tb_b ? 2u : 0u) << 3 * c;
    }
    if (!on) continue;
    uint64_t ca[kCols], cp[kCols], cm[kCols];
    int delta[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      ca[c] = (in >> 3 * c) & 1u;
      cp[c] = (in >> (3 * c + 1)) & 1u;
      cm[c] = (in >> (3 * c + 2)) & 1u;
      delta[c] = 0;
    }
    // every lane runs qe words, the same count across the group (words
    // past nwp are rows past m, which never reach the score row); word u of
    // column c + 1 follows word u of column c, so the columns' carry chains
    // overlap. A column past n (the last step of an odd n) is run and never
    // read.
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      if (u < qe) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          uint64_t ph, mh;
          if (u == 0 && c == 0) {
            otter::myers_carry(eq0, s0, c1, Pv[0], Mv[0], ca[0], cp[0], cm[0],
                               ph, mh);
          } else {
            otter::myers_step(planes.eq(u, f[c]), Pv[u], Mv[u], ca[c], cp[c],
                              cm[c], ph, mh);
          }
          if (u == sl) {
            delta[c] = static_cast<int>((ph & sb) != 0) -
                       static_cast<int>((mh & sb) != 0);
          }
        }
      }
    }
    msg = 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      msg |= static_cast<uint32_t>(ca[c] | (cp[c] << 1) | (cm[c] << 2))
             << 3 * c;
      score += delta[c];
      const int j = j0 + c;
      if (g == last && j < n && j + 1 >= first_capture) {
        captured = min(captured, score);
      }
    }
  }
  if (live && g == last) out[b] = captured;
}

template <int Q>
cudaError_t launch(const uint32_t* pool, int w_pool, const int32_t* idx_pat,
                   const int32_t* idx_txt, const int32_t* nlen,
                   const int32_t* minit, const int32_t* tb, const int32_t* te,
                   int32_t* out, int n_jobs, int n_words64, int text_len,
                   int G, const int32_t* order, cudaStream_t stream) {
  const int smem =
      Q > kRegQ ? 2 * Q * kThreads * static_cast<int>(sizeof(uint64_t)) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      myers_striped_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int per_block = kThreads / G;
  const int blocks = (n_jobs + per_block - 1) / per_block;
  myers_striped_kernel<Q><<<blocks, kThreads, smem, stream>>>(
      pool, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out, n_jobs,
      n_words64, text_len, G, order);
  return cudaGetLastError();
}

}  // namespace

// n_words counts 32-bit pattern words (even, >= 2). group is G (1, 2, 4, 8,
// 16 or 32) and q is Q (1, 2, 4, 8, 16 or 32), with G q >= n_words / 2.
// order (may be null) lists the jobs in the order the launch's slots take
// them.
extern "C" int otter_myers_striped(const int32_t* pool, int w_pool,
                                   const int32_t* idx_pat,
                                   const int32_t* idx_txt,
                                   const int32_t* nlen, const int32_t* minit,
                                   const int32_t* tb, const int32_t* te,
                                   int32_t* out, int n_jobs, int n_words,
                                   int text_len, int group, int q,
                                   const int32_t* order, void* stream) {
  const int nw64 = n_words / 2;
  if (n_words < 2 || (n_words & 1) || group < 1 || group > 32 ||
      (group & (group - 1)) || group * q < nw64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_jobs <= 0) return static_cast<int>(cudaSuccess);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(pool);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 1:
      return launch<1>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                       n_jobs, nw64, text_len, group, order, s);
    case 2:
      return launch<2>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                       n_jobs, nw64, text_len, group, order, s);
    case 4:
      return launch<4>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                       n_jobs, nw64, text_len, group, order, s);
    case 8:
      return launch<8>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                       n_jobs, nw64, text_len, group, order, s);
    case 16:
      return launch<16>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                        n_jobs, nw64, text_len, group, order, s);
    case 32:
      return launch<32>(p, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, out,
                        n_jobs, nw64, text_len, group, order, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
