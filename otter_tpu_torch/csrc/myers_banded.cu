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
// idx_txt of n = nlen chars, K4 also tb free leading and te free trailing
// text chars): at text column j only the pattern blocks that meet rows
// [j - tb - k, j + k] are computed, blocks w_lo = max(0, j - tb - k - 1) / 64
// to w_hi = min(nwp - 1, (j + k - 1) / 64). The block above the band feeds a
// top boundary whose horizontal delta is +1 (cp = w_lo > 0 || j > tb), and a
// block entering the band at the bottom starts from vertical deltas of +1
// (Pv = ~0, Mv = 0; the score gains min(64, m - 64 w_hi)): both only raise DP
// values, so every computed value is an upper bound of the true one, and
// every cell of an alignment of cost <= k lies inside the band (its prefix
// cost is at least max(i - j, j - i - tb)) and is exact. The result is
// therefore exact when it is <= k, and an upper bound above k otherwise; the
// score of row m is captured over j in [n - te, n] while row m is in the
// band, starting from 2^30, and the job stops when w_lo passes w_hi. This
// is the contract of the TPU kernels (the engine reads a result <= k as
// exact and escalates the rest); the plain version in
// kernels/myers_banded.py runs this same schedule, so the two agree above k
// too.
//
// What bounds it: INT32 issue. A 64-cell block step is ~36 int32
// operations in the source (myers.cu's note; ~51 SASS instructions, the
// 64-bit words as 32-bit pairs) and a column runs only the band's
// floor((2k + tb) / 64) + 2 blocks or fewer; device memory holds only the
// inputs and the result.
//
// Design: a group of G lanes of one warp runs a job (G a power of two, at
// most 32, a launch argument), and the group holds the band's window of
// G Q consecutive blocks in registers, Q per lane (Q a template parameter,
// 1 to 8): lane g holds window slots [g Q, g Q + Q), with Pv, Mv and the
// pattern's two bit planes of each. Slot 0 is always block w_lo.
//
// The lanes run as a pipeline over the text: at each step lane g runs the
// kCols columns that lane g - 1 ran the step before, taking their adder and
// Ph / Mh carries out of lane g - 1's last block from one __shfl_up_sync
// (3 bits a column). Inside a lane the adder carry is looked ahead over
// its Q blocks, so they overlap. w_lo is fixed between two columns where it
// advances (every 64 columns); such a segment of columns runs in
// ceil(len / kCols) + G - 1 steps, and at its end, with every lane through
// its last column, the window slides down one block: every slot takes the
// next one's state, across lanes by one __shfl_down_sync, and the group's
// top slot takes a fresh block (Pv = ~0, Mv = 0, its planes unpacked from
// the pool row). A block that enters the band at the bottom is already in
// its slot, untouched since it was loaded; slots above w_hi keep their
// state.
//
// The score (the DP value at the bottom row of block w_hi) is kept by the
// lane that holds w_hi. It moves down a lane with w_hi, in the same shuffle
// as the carries, and at a slide the group takes it from its holder. Each
// lane keeps the minimum of the scores it captured; the group's minimum is
// the result. A step whose columns all run and where no block enters takes
// a path with its slots, w_hi's slot and score row fixed for the step; the
// others take one that decides them column by column.
//
// The wrapper picks (G, Q) from the job count and the widest window of the
// launch (G Q at least the window; at most a warp a scheduler where the
// window allows) and sorts the jobs by window, then text length, so the
// groups of a warp run alike.

#include <cstdint>

#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kNoCapture = 1 << 30;
constexpr int kMaxQ = 8;
constexpr int kCols = 4;  // text columns a lane runs a step

// The 16 even bits of a 32-bit word, packed into its low half.
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

// Block w's two bit planes (bit i: code bit 0 / 1 of char 64 w + i, as
// otter::pattern_word), or zeros past the pattern's nwp blocks.
__device__ __forceinline__ void block_planes(const uint32_t* prow, int w,
                                             int nwp, uint64_t& lo,
                                             uint64_t& hi) {
  lo = 0;
  hi = 0;
  if (w >= nwp) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t pw = prow[4 * w + i];
    lo |= static_cast<uint64_t>(even_bits(pw)) << (16 * i);
    hi |= static_cast<uint64_t>(even_bits(pw >> 1)) << (16 * i);
  }
}

__device__ __forceinline__ uint64_t shfl_down64(uint64_t v, int G) {
  return __shfl_down_sync(kAll, static_cast<unsigned long long>(v), 1, G);
}

// One text column over a lane's Q slots: Myers' step with the adder carry
// looked ahead over the slots (the slots overlap). cin holds the carries
// into slot 0 (bit 0 the adder's, 1 Ph's, 2 Mh's); slots 0 .. lim take
// their new state. Returns the carries out of slot Q - 1, in the same
// bits, and in delta the score row's horizontal delta: +1 / -1 where Ph /
// Mh has a bit under a slot's mask sbu (one slot's at most), else 0.
template <int Q>
__device__ __forceinline__ uint32_t lane_column(
    const otter::CharFlip& f, uint32_t cin, uint64_t (&Pv)[Q],
    uint64_t (&Mv)[Q], const uint64_t (&lo)[Q], const uint64_t (&hi)[Q],
    int lim, const uint64_t (&sbu)[Q], int& delta) {
  uint64_t eq[Q], s0[Q];
  uint32_t cy[Q + 1];
  cy[0] = cin & 1u;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    eq[u] = f.eq(lo[u], hi[u]);
    const uint64_t x = eq[u] & Pv[u];
    s0[u] = x + Pv[u];
    cy[u + 1] = static_cast<uint32_t>(s0[u] < x) |
                (cy[u] & static_cast<uint32_t>(s0[u] == ~0ull));
  }
  uint64_t cp = (cin >> 1) & 1u, cm = (cin >> 2) & 1u, phb = 0, mhb = 0;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const uint64_t xv = eq[u] | Mv[u];
    const uint64_t xh = ((s0[u] + cy[u]) ^ Pv[u]) | eq[u];
    const uint64_t ph = Mv[u] | ~(xh | Pv[u]);
    const uint64_t mh = Pv[u] & xh;
    const uint64_t phs = (ph << 1) | cp;
    const uint64_t mhs = (mh << 1) | cm;
    cp = ph >> 63;
    cm = mh >> 63;
    phb |= ph & sbu[u];
    mhb |= mh & sbu[u];
    if (u <= lim) {
      Pv[u] = mhs | ~(xv | phs);
      Mv[u] = phs & xv;
    }
  }
  delta = static_cast<int>(phb != 0) - static_cast<int>(mhb != 0);
  return cy[Q] | static_cast<uint32_t>(cp) << 1 |
         static_cast<uint32_t>(cm) << 2;
}

template <int Q, bool kEndsFree>
__global__ void __launch_bounds__(kThreads, 1)
myers_banded_kernel(const uint32_t* __restrict__ pool, int w_pool,
                    const int32_t* __restrict__ idx_pat,
                    const int32_t* __restrict__ idx_txt,
                    const int32_t* __restrict__ nlen,
                    const int32_t* __restrict__ minit,
                    const int32_t* __restrict__ tb,
                    const int32_t* __restrict__ te, int k,
                    int32_t* __restrict__ out, int n_jobs, int n_words64,
                    int text_len, int G, const int32_t* __restrict__ order) {
  const int tid = threadIdx.x;
  const int g = tid & (G - 1);
  const int slot = blockIdx.x * (kThreads / G) + tid / G;
  // a slot past the last job still takes part in its warp's shuffles
  const bool live = slot < n_jobs;
  const int b = live ? (order != nullptr ? order[slot] : slot) : 0;
  const int m = live ? minit[b] : 0;
  const int n_all = live ? nlen[b] : 0;
  const bool ok = live && m > 0 && m <= 64 * n_words64 && n_all > 0 &&
                  n_all <= text_len;
  const int n = ok ? n_all : 0;
  const int tbv = kEndsFree && ok ? tb[b] : 0;
  const int tev = kEndsFree && ok ? te[b] : 0;
  const int nwp = ok ? (m + 63) >> 6 : 1;
  const int top = G * Q;  // window slots of the group
  const uint32_t* prow = pool + static_cast<size_t>(ok ? idx_pat[b] : 0) *
                                    w_pool;
  const uint32_t* trow = pool + static_cast<size_t>(ok ? idx_txt[b] : 0) *
                                    w_pool;
  uint64_t Pv[Q], Mv[Q], lo[Q], hi[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    block_planes(prow, g * Q + u, ok ? nwp : 0, lo[u], hi[u]);
    Pv[u] = ~0ull;
    Mv[u] = 0ull;
  }
  // the job's columns are 1 .. last: it stops where w_lo passes nwp - 1
  const int last = ok ? min(n, 64 * nwp + tbv + k) : 0;
  // segments: w_lo is constant on [c0, c1), and c1 is the next column at
  // which it advances (the slide) or one past the last column; a segment
  // of len columns takes ceil(len / kCols) + G - 1 steps
  const int first_end = 64 + tbv + k + 1;
  const int len0 = min(first_end, last + 1) - 1;
  const int rest = max(0, last + 1 - first_end);
  int steps = 0;
  if (last > 0) {
    steps = (len0 + kCols - 1) / kCols + G - 1 +
            rest / 64 * (64 / kCols + G - 1);
    if (rest % 64) steps += (rest % 64 + kCols - 1) / kCols + G - 1;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    steps = max(steps, __shfl_xor_sync(kAll, steps, d));
  }
  int base = 0;  // the block in slot 0: w_lo
  int c0 = 1;
  int c1 = len0 + 1;
  int t = 0;  // step in the segment: lane g runs kCols columns from
              // c0 + (t - g) kCols
  int sc = min(64 * (min(nwp - 1, k >> 6) + 1), m);  // D[row of w_hi][c]
  int captured = kNoCapture;
  // lane g - 1's carries out of the kCols columns lane g runs next (3 bits
  // each) and its score (below 2^20: the wrapper checks m + n)
  uint32_t in = 0;
  // text chars 16 a word: tbuf holds words twi and twi + 1, tnext word
  // twi + 2 (loaded ahead)
  int twi = 0;
  uint64_t tbuf = 0;
  uint32_t tnext = 0;
  if (ok) {
    tbuf = trow[0] | static_cast<uint64_t>(1 < w_pool ? trow[1] : 0u) << 32;
    tnext = 2 < w_pool ? trow[2] : 0u;
  }
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    // the group's segment ends: the lane that holds w_hi hands the score
    // to the group, and the window slides by one block
    const bool seg_end =
        c0 <= last && t == (c1 - c0 + kCols - 1) / kCols + G - 1;
    if (__any_sync(kAll, seg_end)) {
      const int own = (min(nwp - 1, (c1 + k - 2) >> 6) - base) / Q;
      const int s_own = G > 1 ? __shfl_sync(kAll, sc, own, G) : sc;
      const uint64_t npv = shfl_down64(Pv[0], G);
      const uint64_t nmv = shfl_down64(Mv[0], G);
      const uint64_t nlo = shfl_down64(lo[0], G);
      const uint64_t nhi = shfl_down64(hi[0], G);
      if (seg_end) {
        sc = s_own;
        if (c1 <= last) {
#pragma unroll
          for (int u = 0; u + 1 < Q; ++u) {
            Pv[u] = Pv[u + 1];
            Mv[u] = Mv[u + 1];
            lo[u] = lo[u + 1];
            hi[u] = hi[u + 1];
          }
          if (g + 1 < G) {
            Pv[Q - 1] = npv;
            Mv[Q - 1] = nmv;
            lo[Q - 1] = nlo;
            hi[Q - 1] = nhi;
          } else {
            Pv[Q - 1] = ~0ull;
            Mv[Q - 1] = 0ull;
            block_planes(prow, base + top, nwp, lo[Q - 1], hi[Q - 1]);
          }
          base += 1;
        }
        c0 = c1;
        c1 = min(c1 + 64, last + 1);
        t = 0;
      }
    }
    const int cb = c0 + (t - g) * kCols;
    const bool busy = c0 <= last && t >= g && cb < c1;
    if (busy && ((cb - 1) >> 4) != twi) {  // the step's chars: one word on
      tbuf = (tbuf >> 32) | static_cast<uint64_t>(tnext) << 32;
      twi += 1;
      tnext = twi + 2 < w_pool ? trow[twi + 2] : 0u;
    }
    const uint32_t chars =
        static_cast<uint32_t>(tbuf >> (2 * ((cb - 1) & 15)));
    // lane g - 1's carries; the top boundary's horizontal delta into lane
    // 0 (+1 unless the text char is free)
    uint32_t cin = in;
    if (g == 0) {
      cin = 0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        cin |= static_cast<uint32_t>(base > 0 || cb + i > tbv)
               << (3 * i + 1);
      }
    }
    uint32_t carries = 0;
    // a plain step: all kCols columns run (or none) and no block enters, so
    // the active slots, w_hi's slot and its score row hold for the step
    const int ncol = busy ? min(kCols, c1 - cb) : 0;
    const int e = cb + k - 1;  // w_hi before the clamp: (e + i) >> 6
    const int off = (64 - (e & 63)) & 63;  // the column that crosses
    const bool plain = ncol == 0 ||
                       (ncol == kCols &&
                        !(off < kCols && cb + off >= 2 &&
                          ((e + off) >> 6) <= nwp - 1));
    if (!__any_sync(kAll, !plain)) {
      const int w_hi = min(nwp - 1, e >> 6);
      const int rel = w_hi - base - g * Q;  // w_hi's slot in the lane
      const int lim = ncol > 0 ? rel : -1;   // slots 0 .. lim run
      const bool own = ncol > 0 && rel >= 0 && rel < Q;
      // the score row's bit in w_hi's slot, zero in every other slot
      uint64_t sbu[Q];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        sbu[u] = !own || u != rel ? 0ull
                 : w_hi == nwp - 1 ? 1ull << ((m - 1) & 63)
                                   : 1ull << 63;
      }
      const int cap_from = own && w_hi == nwp - 1 ? n - tev : 1 << 30;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        int delta;
        carries |= lane_column<Q>(otter::CharFlip((chars >> (2 * i)) & 3u),
                                  cin >> (3 * i), Pv, Mv, lo, hi, lim, sbu,
                                  delta)
                   << (3 * i);
        sc += delta;
        if (cb + i >= cap_from) captured = min(captured, sc);
      }
    } else {
#pragma unroll 1
      for (int i = 0; i < kCols; ++i) {
        const int c = cb + i;
        const bool run = busy && c < c1;
        const int w_hi = min(nwp - 1, (c + k - 1) >> 6);
        const int rel = w_hi - base - g * Q;
        const bool own = run && rel >= 0 && rel < Q;
        // a block enters at the bottom: its rows start from vertical
        // deltas +1
        const bool grow = c >= 2 && ((c + k - 1) & 63) == 0 &&
                          ((c + k - 1) >> 6) <= nwp - 1;
        uint64_t sbu[Q];
#pragma unroll
        for (int u = 0; u < Q; ++u) {
          sbu[u] = !own || u != rel ? 0ull
                   : w_hi == nwp - 1 ? 1ull << ((m - 1) & 63)
                                     : 1ull << 63;
        }
        int delta;
        carries |= lane_column<Q>(otter::CharFlip((chars >> (2 * i)) & 3u),
                                  cin >> (3 * i), Pv, Mv, lo, hi,
                                  run ? rel : -1, sbu, delta)
                   << (3 * i);
        if (own) {
          // the score moves down a lane with w_hi: lane g - 1 holds it
          if (grow && rel == 0 && g > 0) {
            sc = static_cast<int>(in >> (3 * kCols));
          }
          sc += (grow ? min(64, m - 64 * w_hi) : 0) + delta;
          if (w_hi == nwp - 1 && c >= n - tev) captured = min(captured, sc);
        }
      }
    }
    if (G > 1) {
      in = __shfl_up_sync(
          kAll, carries | static_cast<uint32_t>(sc) << (3 * kCols), 1, G);
    }
    t += 1;
  }
  for (int d = 1; d < G; d <<= 1) {
    captured = min(captured, __shfl_xor_sync(kAll, captured, d));
  }
  if (live && g == 0) out[b] = captured;
}

template <int Q, bool kEndsFree>
cudaError_t launch_q(const uint32_t* pool, int w_pool, const int32_t* idx_pat,
                     const int32_t* idx_txt, const int32_t* nlen,
                     const int32_t* minit, const int32_t* tb,
                     const int32_t* te, int k, int32_t* out, int n_jobs,
                     int n_words64, int text_len, int G,
                     const int32_t* order, cudaStream_t stream) {
  const int per_block = kThreads / G;
  const int blocks = (n_jobs + per_block - 1) / per_block;
  auto kernel = myers_banded_kernel<Q, kEndsFree>;
  kernel<<<blocks, kThreads, 0, stream>>>(pool, w_pool, idx_pat, idx_txt,
                                          nlen, minit, tb, te, k, out,
                                          n_jobs, n_words64, text_len, G,
                                          order);
  return cudaGetLastError();
}

template <bool kEndsFree>
int launch(const int32_t* pool, int w_pool, const int32_t* idx_pat,
           const int32_t* idx_txt, const int32_t* nlen, const int32_t* minit,
           const int32_t* tb, const int32_t* te, int k, int32_t* out,
           int n_jobs, int n_words, int text_len, int group, int q,
           const int32_t* order, void* stream) {
  if (n_words < 2 || (n_words & 1) || k < 0 || group < 1 || group > 32 ||
      (group & (group - 1)) || q < 1 || q > kMaxQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_jobs <= 0) return static_cast<int>(cudaSuccess);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(pool);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw64 = n_words / 2;
  cudaError_t err = cudaErrorInvalidValue;
  switch (q) {
#define OTTER_BANDED_Q(Q)                                                   \
  case Q:                                                                   \
    err = launch_q<Q, kEndsFree>(p, w_pool, idx_pat, idx_txt, nlen, minit,  \
                                 tb, te, k, out, n_jobs, nw64, text_len,    \
                                 group, order, s);                          \
    break;
    OTTER_BANDED_Q(1)
    OTTER_BANDED_Q(2)
    OTTER_BANDED_Q(3)
    OTTER_BANDED_Q(4)
    OTTER_BANDED_Q(5)
    OTTER_BANDED_Q(6)
    OTTER_BANDED_Q(7)
    OTTER_BANDED_Q(8)
#undef OTTER_BANDED_Q
  }
  return static_cast<int>(err);
}

}  // namespace

// n_words counts 32-bit pattern words (even, >= 2). group is G (1, 2, 4, 8,
// 16 or 32) and q is Q (1 to 8); G q must be at least every job's window,
// floor((2k + tb) / 64) + 2 blocks (the caller checks it). order (may be
// null) lists the jobs in the order the launch's slots take them.
extern "C" int otter_myers_banded(const int32_t* pool, int w_pool,
                                  const int32_t* idx_pat,
                                  const int32_t* idx_txt, const int32_t* nlen,
                                  const int32_t* minit, int k, int32_t* out,
                                  int n_jobs, int n_words, int text_len,
                                  int group, int q, const int32_t* order,
                                  void* stream) {
  return launch<false>(pool, w_pool, idx_pat, idx_txt, nlen, minit, nullptr,
                       nullptr, k, out, n_jobs, n_words, text_len, group, q,
                       order, stream);
}

extern "C" int otter_myers_banded_ef(const int32_t* pool, int w_pool,
                                     const int32_t* idx_pat,
                                     const int32_t* idx_txt,
                                     const int32_t* nlen, const int32_t* minit,
                                     const int32_t* tb, const int32_t* te,
                                     int k, int32_t* out, int n_jobs,
                                     int n_words, int text_len, int group,
                                     int q, const int32_t* order,
                                     void* stream) {
  return launch<true>(pool, w_pool, idx_pat, idx_txt, nlen, minit, tb, te, k,
                      out, n_jobs, n_words, text_len, group, q, order,
                      stream);
}
