// Kernels K5 and K6: banded gap-affine (mismatch 4, gap open 6, gap
// extend 2) ends-free DP with the traceback walked on the card, for the
// consensus member alignments.
//
// K5 replaces otter_tpu/kernels/affine_pallas.py::_affine_tb_kernel
// (launched by affine_tb_pallas): the traceback bits of every cell are kept
// (one byte per cell, in device memory) and the walk reads them. K6 replaces
// _affine_tb_ckpt_kernel (affine_tb_ckpt_pallas): the forward pass keeps only
// the H and F rows of every 256th row, and the walk recomputes the bits of
// one 256-row block at a time from its checkpoint. On the TPU the split is
// about VMEM; here it is about device memory per member: a member of a wide
// band or a long pattern needs rows * W bytes of bits (16 MiB at k = 511 and
// 16384 rows), which caps how many members one launch can hold, while K6
// needs 2 W int32 per checkpoint and 256 W bytes of block bits. The engine
// sends a bucket to K6 when its bits would reach 1 MiB per member. K6 does
// about twice K5's DP work for the walked blocks; the results are the same.
//
// Inputs, as the TPU launch takes them (affine_pallas.py::pack_affine_jobs):
// a (B, La) int8 pattern codes (pad -2), bpad (B, Lb) int8 text codes
// shifted right by k + 1 (pad -1), mn (B, 8) int32 = (m, n, pb, tb, pe, te,
// cap, 0) with cap = band_validity_cap. Lane w of row i is column
// j = i + w - (k + 1), W = 2 (k + 1) lanes. Per cell, as on the TPU:
//   F = min(H[i-1][j] + 8, F[i-1][j] + 2)
//   B = min(H[i-1][j-1] + sub, F)          (B[i][0] = pattern-begin cost)
//   E = min over j' < j of B[i][j'] + 6 + 2 (j - j')   (no gap chaining)
//   H = min(B, E)
// with 4 traceback bits (H == F, H == E, F extends, E extends). The end
// cell follows the reference's tie order ((m, n) wins ties, the last-row
// window prefers larger j, the last column takes strict improvements with
// the largest i); a member whose score is not below cap is not walked. The
// walk emits 2-bit op codes (1 diag, 2 ins, 3 del) in walk order, 16 per
// int32; end (B, 4) = (score, i, j, walked to (0, 0)). The walk's decisions
// are the TPU kernel's, so the cigars are the same; the TPU walks a tile's
// members in one frontier sweep under a shared step budget, here each member
// walks alone under the same budget (t_words * 16 steps), which the
// proof in affine_pallas.py::_t_words bounds for every walked member.
//
// What bounds it: one thread per member runs ~30 int32 operations per cell
// and moves 17 bytes per cell through global memory (H and F rows in and
// out, one traceback byte out); the E recurrence is a running minimum along
// the row, so a thread's lanes are sequential. With one thread per member, a
// consensus batch of a few thousand members fills only a fraction of the
// card's 132 SMs x 64 warps: latency, not the ALU, bounds it.
//
// Design: scratch is lane-major ([W][B] for H and F, [rows][W][B] for the
// bits, [checkpoints][2 W][B] for K6) so a warp's accesses coalesce; H and F
// are updated in place (lane w reads the old lanes w and w + 1 before it
// writes w). One row update, the end cell and the walk are shared device
// functions; the two kernels differ only in where the walk's bits come
// from.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInf = 1 << 28;
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 2;
constexpr int kOpDiag = 1, kOpIns = 2, kOpDel = 3;
constexpr int kBlock = 256;  // K6 checkpoint interval, in rows

struct Member {
  int m, n, pb, tb, pe, te, cap;
};

// H and F before row 1: the free-begin text boundary.
__device__ void init_rows(int32_t* H, int32_t* F, size_t B, int W, int k1,
                          const Member& j) {
  for (int w = 0; w < W; ++w) {
    const int j0 = w - k1;
    H[w * B] = (j0 >= 0 && j0 <= j.n)
                   ? (j0 <= j.tb ? 0 : kGapOpen + kGapExt * (j0 - j.tb))
                   : kInf;
    F[w * B] = kInf;
  }
}

// Row i of the DP in place over H and F; writes the row's traceback bits
// when row_bits is set. Returns H at the lane of column n.
__device__ int dp_row(int i, const int8_t* arow, const int8_t* brow,
                      int32_t* H, int32_t* F, size_t B, int W, int k1,
                      const Member& jb, uint8_t* row_bits) {
  const int ac = arow[i - 1];
  const int hb = i <= jb.pb ? 0 : kGapOpen + kGapExt * (i - jb.pb);
  const int wcol = jb.n - i + k1;
  int h_next = H[0];
  int scan = 0, e_left = kInf, hv = kInf;
  for (int w = 0; w < W; ++w) {
    const int j = i + w - k1;
    const int h_diag = h_next;
    h_next = w + 1 < W ? H[(w + 1) * B] : kInf;
    const int f_up = w + 1 < W ? F[(w + 1) * B] : kInf;
    const int sub = brow[i - 1 + w] == ac ? 0 : kMismatch;
    const int f_row = min(h_next + kGapOpen + kGapExt, f_up + kGapExt);
    int bv = min(h_diag + sub, f_row);
    if (j == 0) bv = hb;
    const bool invalid = j < 0 || j > jb.n;
    if (invalid) bv = kInf;
    int e_row = w == 0 ? kInf : scan + kGapExt * w + kGapOpen;
    if (invalid) e_row = kInf;
    scan = w == 0 ? bv : min(scan, bv - kGapExt * w);
    int h_row = min(bv, e_row);
    if (j == 0) h_row = hb;
    if (invalid) h_row = kInf;
    const int f_rowm = invalid ? kInf : f_row;
    if (row_bits != nullptr) {
      row_bits[w * B] = static_cast<uint8_t>(
          (h_row == f_rowm ? 1 : 0) | (h_row == e_row ? 2 : 0) |
          (f_rowm == f_up + kGapExt ? 4 : 0) |
          (e_row == e_left + kGapExt ? 8 : 0));
    }
    e_left = e_row;
    H[w * B] = h_row;
    F[w * B] = f_rowm;
    if (w == wcol) hv = h_row;
  }
  return hv;
}

// End cell after row m: (m, n) first, then the last row's window (larger j
// on ties), then the last column on strict improvement. Returns the score;
// a member whose score is not below cap gets (0, 0), so it does not walk.
__device__ int end_cell(const int32_t* H, size_t B, int W, int k1,
                        const Member& jb, int colv, int coli, int& ei,
                        int& ej) {
  const int wmn = jb.n - jb.m + k1;
  int best_s = (wmn >= 0 && wmn < W) ? H[wmn * B] : kInf;
  ei = jb.m;
  ej = jb.n;
  const int lower = max(0, jb.n - jb.te);
  int smin = kInf, jbest = -1;
  for (int w = 0; w < W; ++w) {
    const int jw = w - k1 + jb.m;
    if (jw >= lower && jw <= jb.n - 1 && H[w * B] <= smin) {
      smin = H[w * B];
      jbest = jw;
    }
  }
  if (smin < best_s) {
    best_s = smin;
    ej = jbest;
  }
  if (jb.pe > 0 && colv < best_s) {
    best_s = colv;
    ei = coli;
    ej = jb.n;
  }
  if (best_s >= jb.cap) ei = ej = 0;
  return best_s;
}

// Forward pass over rows 1..m; K6 saves H and F after every kBlock-th row
// (row 0 included) into ckpt. Returns the score, end cell in ei / ej.
__device__ int forward(const int8_t* arow, const int8_t* brow, int32_t* H,
                       int32_t* F, size_t B, int W, int k1, const Member& jb,
                       uint8_t* bits, int32_t* ckpt, int& ei, int& ej) {
  init_rows(H, F, B, W, k1, jb);
  int colv = kInf, coli = 0;
  for (int i = 1; i <= jb.m; ++i) {
    if (ckpt != nullptr && (i - 1) % kBlock == 0) {
      int32_t* c = ckpt + static_cast<size_t>((i - 1) / kBlock) * 2 * W * B;
      for (int w = 0; w < 2 * W; ++w) c[w * B] = H[w * B];
    }
    uint8_t* row_bits =
        bits != nullptr ? bits + static_cast<size_t>(i - 1) * W * B : nullptr;
    const int hv = dp_row(i, arow, brow, H, F, B, W, k1, jb, row_bits);
    const int wcol = jb.n - i + k1;
    if (jb.m - i <= jb.pe && wcol >= 0 && wcol < W && hv <= colv) {
      colv = hv;
      coli = i;
    }
  }
  return end_cell(H, B, W, k1, jb, colv, coli, ei, ej);
}

// One traceback step from (ci, cj) in state (0 = H, 1 = F, 2 = E), given
// the traceback byte of row ci, lane cj - ci + k + 1 (0 where there is
// none); returns the op code it emits (0 for a state change).
__device__ int walk_step(int& ci, int& cj, int& state, int byte) {
  if (state == 0) {
    if (ci == 0) {
      --cj;
      return kOpIns;
    }
    if (cj == 0) {
      --ci;
      return kOpDel;
    }
    if (byte & 1) {
      state = 1;
      return 0;
    }
    if (byte & 2) {
      state = 2;
      return 0;
    }
    --ci;
    --cj;
    return kOpDiag;
  }
  if (state == 1) {
    if (!((byte & 4) && ci > 1)) state = 0;
    --ci;
    return kOpDel;
  }
  if (!((byte & 8) && cj > 1)) state = 0;
  --cj;
  return kOpIns;
}

// Appends op (if any) to the walk codes, 16 per int32, in walk order.
__device__ void emit(int32_t* orow, int& n_ops, int op) {
  if (op) {
    orow[n_ops >> 4] |= static_cast<int32_t>(static_cast<uint32_t>(op)
                                             << (2 * (n_ops & 15)));
    ++n_ops;
  }
}

__device__ int lane_of(int ci, int cj, int W, int k1) {
  const int wc = cj - ci + k1;
  return (ci >= 1 && wc >= 0 && wc < W) ? wc : -1;
}

__device__ Member load_member(const int32_t* mn, int b, int La) {
  const int32_t* r = mn + 8 * b;
  return Member{min(r[0], La), r[1], r[2], r[3], r[4], r[5], r[6]};
}

// end row: (score, end i, end j, walked to (0, 0)); a member that was not
// walked (score not below cap) reports (0, 0) and 0.
__device__ void store_end(int32_t* end, int b, int score, int ei, int ej,
                          bool reached, const Member& jb) {
  int32_t* e = end + 4 * b;
  e[0] = score;
  e[1] = ei;
  e[2] = ej;
  e[3] = (score < jb.cap && reached) ? 1 : 0;
}

// K5: every row's bits kept in bits ([m][W][B]).
__global__ void __launch_bounds__(kThreads)
affine_tb_kernel(const int8_t* __restrict__ a, int La,
                 const int8_t* __restrict__ bpad, int Lb,
                 const int32_t* __restrict__ mn, int k, int t_words,
                 int32_t* __restrict__ ops, int32_t* __restrict__ end,
                 int n_jobs, int32_t* __restrict__ hf,
                 uint8_t* __restrict__ bits) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_jobs) return;
  const int W = 2 * (k + 1), k1 = k + 1;
  const size_t B = static_cast<size_t>(n_jobs);
  const Member jb = load_member(mn, b, La);
  int32_t* H = hf + b;
  int32_t* F = H + static_cast<size_t>(W) * B;
  uint8_t* bt = bits + b;
  int ei, ej;
  const int score = forward(a + static_cast<size_t>(b) * La,
                            bpad + static_cast<size_t>(b) * Lb, H, F, B, W,
                            k1, jb, bt, nullptr, ei, ej);
  int32_t* orow = ops + static_cast<size_t>(b) * t_words;
  for (int q = 0; q < t_words; ++q) orow[q] = 0;
  int ci = ei, cj = ej, state = 0, n_ops = 0;
  for (int t = 0; t < 16 * t_words && (ci != 0 || cj != 0); ++t) {
    const int wc = lane_of(ci, cj, W, k1);
    const int byte =
        wc < 0 ? 0 : bt[(static_cast<size_t>(ci - 1) * W + wc) * B];
    emit(orow, n_ops, walk_step(ci, cj, state, byte));
  }
  const bool done = ci == 0 && cj == 0;
  store_end(end, b, score, ei, ej, done, jb);
}

// K6: checkpoints of H and F every kBlock rows in ckpt
// ([ceil(m / kBlock)][2 W][B]); the walk recomputes one block of bits at a
// time into bits ([kBlock][W][B]).
__global__ void __launch_bounds__(kThreads)
affine_tb_ckpt_kernel(const int8_t* __restrict__ a, int La,
                      const int8_t* __restrict__ bpad, int Lb,
                      const int32_t* __restrict__ mn, int k, int t_words,
                      int32_t* __restrict__ ops, int32_t* __restrict__ end,
                      int n_jobs, int32_t* __restrict__ hf,
                      uint8_t* __restrict__ bits,
                      int32_t* __restrict__ ckpt) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_jobs) return;
  const int W = 2 * (k + 1), k1 = k + 1;
  const size_t B = static_cast<size_t>(n_jobs);
  const Member jb = load_member(mn, b, La);
  int32_t* H = hf + b;
  int32_t* F = H + static_cast<size_t>(W) * B;
  uint8_t* bt = bits + b;
  int32_t* ck = ckpt + b;
  const int8_t* arow = a + static_cast<size_t>(b) * La;
  const int8_t* brow = bpad + static_cast<size_t>(b) * Lb;
  int ei, ej;
  const int score =
      forward(arow, brow, H, F, B, W, k1, jb, nullptr, ck, ei, ej);
  // The walk goes block by block, from the last block down: every thread
  // of a warp recomputes its own block blk in the same iteration (a thread
  // whose walk starts in a lower block skips it), so the recompute, the
  // costly part, never diverges within a warp.
  int32_t* orow = ops + static_cast<size_t>(b) * t_words;
  for (int q = 0; q < t_words; ++q) orow[q] = 0;
  int ci = ei, cj = ej, state = 0, n_ops = 0, t = 0;
  const int t_max = 16 * t_words;
  const int top = ci >= 1 ? (ci - 1) / kBlock : -1;
  for (int blk = (La + kBlock - 1) / kBlock - 1; blk >= 0; --blk) {
    if (blk > top || (ci == 0 && cj == 0) || t >= t_max) continue;
    const int32_t* c = ck + static_cast<size_t>(blk) * 2 * W * B;
    for (int w = 0; w < 2 * W; ++w) H[w * B] = c[w * B];
    const int last = min(jb.m, (blk + 1) * kBlock);
    for (int i = blk * kBlock + 1; i <= last; ++i) {
      dp_row(i, arow, brow, H, F, B, W, k1, jb,
             bt + static_cast<size_t>(i - 1 - blk * kBlock) * W * B);
    }
    // steps while the cursor's row is in this block (or is row 0)
    for (; t < t_max && (ci != 0 || cj != 0) &&
           (ci == 0 || (ci - 1) / kBlock == blk);
         ++t) {
      const int wc = lane_of(ci, cj, W, k1);
      const int byte =
          wc < 0 ? 0
                 : bt[(static_cast<size_t>(ci - 1 - blk * kBlock) * W + wc) *
                      B];
      emit(orow, n_ops, walk_step(ci, cj, state, byte));
    }
  }
  const bool done = ci == 0 && cj == 0;
  store_end(end, b, score, ei, ej, done, jb);
}

cudaError_t check_args(int k, int t_words, int La, int Lb) {
  return (k < 0 || t_words <= 0 || Lb < La + 2 * (k + 1) + 2)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

}  // namespace

// hf holds 2 * W * n_jobs int32 and bits La * W * n_jobs bytes
// (W = 2 (k + 1)); both are allocated by the caller.
extern "C" int otter_affine_tb(const int8_t* a, int La, const int8_t* bpad,
                               int Lb, const int32_t* mn, int k, int t_words,
                               int32_t* ops, int32_t* end, int n_jobs,
                               void* hf, void* bits, void* stream) {
  const cudaError_t bad = check_args(k, t_words, La, Lb);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  const int blocks = (n_jobs + kThreads - 1) / kThreads;
  affine_tb_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, La, bpad, Lb, mn, k, t_words, ops, end, n_jobs,
      static_cast<int32_t*>(hf), static_cast<uint8_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

// hf as above; bits holds 256 * W * n_jobs bytes and ckpt
// ceil(La / 256) * 2 * W * n_jobs int32.
extern "C" int otter_affine_tb_ckpt(const int8_t* a, int La,
                                    const int8_t* bpad, int Lb,
                                    const int32_t* mn, int k, int t_words,
                                    int32_t* ops, int32_t* end, int n_jobs,
                                    void* hf, void* bits, void* ckpt,
                                    void* stream) {
  const cudaError_t bad = check_args(k, t_words, La, Lb);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  const int blocks = (n_jobs + kThreads - 1) / kThreads;
  affine_tb_ckpt_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, La, bpad, Lb, mn, k, t_words, ops, end, n_jobs,
      static_cast<int32_t*>(hf), static_cast<uint8_t*>(bits),
      static_cast<int32_t*>(ckpt));
  return static_cast<int>(cudaGetLastError());
}
