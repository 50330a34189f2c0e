// Kernels K5 and K6: banded gap-affine (mismatch 4, gap open 6, gap
// extend 2) ends-free DP with the traceback walked on the card, for the
// consensus member alignments.
//
// K5 replaces otter_tpu/kernels/affine_pallas.py::_affine_tb_kernel
// (launched by affine_tb_pallas): the traceback codes of every cell are
// kept, 4 bits per cell, in device memory, and the walk reads them. K6
// replaces _affine_tb_ckpt_kernel (affine_tb_ckpt_pallas): the forward pass
// keeps only the H and F rows of every 256th row, and the walk recomputes
// the codes of one 256-row block at a time from its checkpoint, into shared
// memory. The engine sends a bucket to K6 when a member's rows * W reach
// 1 Mi (affine_tb.py::CKPT_CELLS); K6 does about twice K5's DP work, and
// its results are K5's.
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
// window prefers larger j, the last column takes the smallest score and
// the largest i among equal ones); a member whose score is not below cap
// is not walked. The walk emits 2-bit op codes (1 diag, 2 ins, 3 del) in
// walk order, 16 per int32; end (B, 4) = (score, i, j, walked to (0, 0)).
// The walk's decisions and its step budget (16 t_words) are the TPU
// kernel's, so the cigars are the same. The walk also writes each
// member's cigar into cig as finished bytes (struct Cigar):
// 'M' / 'X' resolved against the pattern and text, 'I', 'D', and the free
// ends' tails, so the host takes a slice of a row and decodes nothing.
//
// Design: one warp per member. W = 32 L with L = 4, 8, 16, 32 for k = 63,
// 127, 255, 511 (a template parameter), and thread t keeps lanes
// [t L, t L + L) of H and F in registers. A row update reads its "up"
// operands from the thread's next register, or for its last lane from
// thread t + 1 by __shfl_down_sync, taken before the row is overwritten; the
// diagonal operand is the thread's own old lane. The text window of a row
// lives in registers, 4 chars a word, and moves one char a row (a funnel
// shift per word and one shuffle); the pattern chars and the text chars
// that enter the window are loaded coalesced, 128 rows at a time, and
// handed out by shuffles, so no cell waits on a dependent global load. E's
// in-row dependency is an exclusive prefix-min of B[w] - 2w: a running
// minimum over the thread's L lanes, then a 5-step __shfl_up_sync scan of
// the 32 thread minima (and one shift to make it exclusive); min is exact
// in any order, so the values are those of the sequential scan. The 4-bit
// codes of a thread's L lanes are packed into an L / 2-byte word per row and
// stored coalesced: in K5 to device memory ([member][row][W / 2] bytes), in
// K6 to shared memory (the 256 rows of the block being walked: 16, 32, 64,
// 128 KB per member). K6 stores its checkpoints coalesced too
// ([member][block][H | F][W] int32), and the walk recomputes each block with
// the whole warp. The end cell is a warp reduction that keeps the tie order:
// the smallest score, then the largest j (last-row window) or the largest i
// (last column). All 32 lanes run the same walk, so every branch stays
// uniform; lane 0 stores the op words. In K5 the warp first stages the 32
// rows the cursor is about to enter into shared memory (16 L bytes a row),
// so the walk reads shared memory, not a chain of dependent global loads.
// The cigar bytes leave the walk 32 ops at a time (struct Cigar), so no
// step of the walk waits on a load of the sequences.
//
// What bounds it: INT32 issue. A cell costs about 30 integer operations
// (two passes over the thread's lanes: the row update, then E, H and the
// codes), and a row adds about 14 shuffles per warp: the scan's 6, the two
// "up" operands, E's left neighbour, the window's entering char, and the
// pattern and text chars. The scan is a dependent chain of shuffles per
// row; the design hides it with several members per SM (K5 packs 4 warps a
// block, K6 one, and both run a bucket's members at once) rather than with
// wider rows. The walk is serial in the member (about one step a row); K5's
// staging makes each step a shared-memory read, and K6's walk reads the
// block it has just recomputed in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kInf = 1 << 28;
constexpr int kNone = 0x7fffffff;  // identity of min: above every value
constexpr int kMismatch = 4;
constexpr int kGapOpen = 6;
constexpr int kGapExt = 2;
constexpr int kOpDiag = 1, kOpIns = 2, kOpDel = 3;
constexpr int kBlock = 256;   // K6 checkpoint interval, in rows
constexpr int kChunk = 128;   // rows of chars loaded at a time
constexpr int kStage = 32;    // K5: rows of codes staged for the walk
constexpr int kWarpsK5 = 4;   // K5 members per block (K6: one)

struct Member {
  int m, n, pb, tb, pe, te, cap;
};

__device__ Member load_member(const int32_t* mn, int b, int La) {
  const int32_t* r = mn + 8 * b;
  return Member{min(r[0], La), r[1], r[2], r[3], r[4], r[5], r[6]};
}

// H and F before row 1: the free-begin text boundary.
template <int L>
__device__ __forceinline__ void init_rows(int (&H)[L], int (&F)[L],
                                          const Member& jb, int k1,
                                          int lane) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j0 = lane * L + l - k1;
    H[l] = (j0 >= 0 && j0 <= jb.n)
               ? (j0 <= jb.tb ? 0 : kGapOpen + kGapExt * (j0 - jb.tb))
               : kInf;
    F[l] = kInf;
  }
}

// Bytes p[idx .. idx + 4) as one word (0 past len).
__device__ __forceinline__ uint32_t load4(const int8_t* p, int len, int idx) {
  const uint8_t* q = reinterpret_cast<const uint8_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (idx + c < len) v |= static_cast<uint32_t>(q[idx + c]) << (8 * c);
  }
  return v;
}

// The text chars of row i's lanes (bpad[i - 1 + w]), 4 to a word.
template <int L>
__device__ __forceinline__ void load_window(uint32_t (&txt)[L / 4],
                                            const int8_t* brow, int Lb,
                                            int i, int lane) {
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    txt[q] = load4(brow, Lb, i - 1 + lane * L + 4 * q);
  }
}

// Row i's window from row i - 1's: every lane takes its right neighbour's
// char; the warp's last lane takes the entering char nc.
template <int L>
__device__ __forceinline__ void shift_window(uint32_t (&txt)[L / 4],
                                             uint32_t nc, int lane) {
  uint32_t next = __shfl_down_sync(kAll, txt[0], 1);
  if (lane == 31) next = nc;
#pragma unroll
  for (int q = 0; q + 1 < L / 4; ++q) {
    txt[q] = __funnelshift_r(txt[q], txt[q + 1], 8);
  }
  txt[L / 4 - 1] = __funnelshift_r(txt[L / 4 - 1], next, 8);
}

// Row i of the DP in place over the warp's H and F; ac is the pattern char
// of the row, txt the row's text window. nib gets the row's 4-bit codes,
// lane l of the thread at bits 4 (l % 8) of word l / 8.
template <int L>
__device__ __forceinline__ void dp_row(int i, uint32_t ac,
                                       const uint32_t (&txt)[L / 4],
                                       int (&H)[L], int (&F)[L],
                                       const Member& jb, int k1, int lane,
                                       uint32_t (&nib)[(L + 7) / 8]) {
  const int hb = i <= jb.pb ? 0 : kGapOpen + kGapExt * (i - jb.pb);
  const int w0 = lane * L;
  const int j0 = i + w0 - k1;  // column of the thread's first lane
  // the "up" operands of the thread's last lane, before they are replaced
  int h_next = __shfl_down_sync(kAll, H[0], 1);
  int f_next = __shfl_down_sync(kAll, F[0], 1);
  if (lane == 31) h_next = f_next = kInf;
  uint32_t neq[L / 4];
#pragma unroll
  for (int q = 0; q < L / 4; ++q) neq[q] = ~__vcmpeq4(txt[q], ac * 0x01010101u);

  // pass 1: F and B of every lane (H[l] holds B until pass 2), F's extend
  // bits, and the running minimum of B - 2w over the thread's lanes
  uint32_t fext = 0;
  int run = kNone, run_head = kNone;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j = j0 + l;
    const int h_up = l + 1 < L ? H[l + 1] : h_next;
    const int f_up = l + 1 < L ? F[l + 1] : f_next;
    const int sub = static_cast<int>((neq[l >> 2] >> (8 * (l & 3))) &
                                     static_cast<uint32_t>(kMismatch));
    const int f_row = min(h_up + kGapOpen + kGapExt, f_up + kGapExt);
    int bv = min(H[l] + sub, f_row);
    if (j == 0) bv = hb;
    const bool invalid =
        static_cast<unsigned>(j) > static_cast<unsigned>(jb.n);
    if (invalid) bv = kInf;
    const int f_rowm = invalid ? kInf : f_row;
    fext |= (f_rowm == f_up + kGapExt ? 1u : 0u) << l;
    H[l] = bv;
    F[l] = f_rowm;
    if (l == L - 1) run_head = run;  // lanes before the last
    run = min(run, bv - kGapExt * (w0 + l));
  }

  // exclusive prefix-min of the thread minima across the warp
  int incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl = min(incl, y);
  }
  int pre = __shfl_up_sync(kAll, incl, 1);
  if (lane == 0) pre = kNone;
  // E of the thread's last lane (never lane 0), for the next thread's first
  const int w_last = w0 + L - 1;
  const bool inv_last =
      static_cast<unsigned>(j0 + L - 1) > static_cast<unsigned>(jb.n);
  const int e_last =
      inv_last ? kInf : min(pre, run_head) + kGapExt * w_last + kGapOpen;
  int e_left = __shfl_up_sync(kAll, e_last, 1);
  if (lane == 0) e_left = kInf;

  // pass 2: E, H and the codes
#pragma unroll
  for (int q = 0; q < (L + 7) / 8; ++q) nib[q] = 0;
  int ecur = pre;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int w = w0 + l;
    const int j = j0 + l;
    const bool invalid =
        static_cast<unsigned>(j) > static_cast<unsigned>(jb.n);
    const int e_row =
        (w == 0 || invalid) ? kInf : ecur + kGapExt * w + kGapOpen;
    ecur = min(ecur, H[l] - kGapExt * w);
    int h_row = min(H[l], e_row);
    if (j == 0) h_row = hb;
    if (invalid) h_row = kInf;
    const uint32_t code = (h_row == F[l] ? 1u : 0u) |
                          (h_row == e_row ? 2u : 0u) |
                          (((fext >> l) & 1u) << 2) |
                          (e_row == e_left + kGapExt ? 8u : 0u);
    nib[l >> 3] |= code << (4 * (l & 7));
    e_left = e_row;
    H[l] = h_row;
  }
}

// The thread's L / 2 bytes of codes of one row, in one store.
template <int L>
__device__ __forceinline__ void store_codes(uint8_t* dst,
                                            const uint32_t (&nib)[(L + 7) /
                                                                  8]) {
  if constexpr (L == 4) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(nib[0]);
  } else if constexpr (L == 8) {
    *reinterpret_cast<uint32_t*>(dst) = nib[0];
  } else if constexpr (L == 16) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(nib[0], nib[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(nib[0], nib[1], nib[2], nib[3]);
  }
}

// Rows first .. last over H and F (the state after row first - 1); after
// each row, sink(i, H, nib). The pattern chars and the text chars entering
// the window come kChunk rows at a time, one coalesced load per lane.
template <int L, class Sink>
__device__ __forceinline__ void run_rows(int first, int last,
                                         const int8_t* arow, int La,
                                         const int8_t* brow, int Lb,
                                         const Member& jb, int k1, int lane,
                                         int (&H)[L], int (&F)[L],
                                         Sink&& sink) {
  constexpr int W = 32 * L;
  uint32_t txt[L / 4];
  load_window<L>(txt, brow, Lb, first, lane);
  uint32_t a4 = 0, n4 = 0;
#pragma unroll 1
  for (int i = first; i <= last; ++i) {
    const int r = (i - first) % kChunk;
    if (r == 0) {  // rows i .. i + kChunk - 1: 4 of them per lane
      a4 = load4(arow, La, i - 1 + 4 * lane);
      n4 = load4(brow, Lb, i + W - 2 + 4 * lane);
    }
    const int sh = 8 * (r & 3);
    const uint32_t ac = (__shfl_sync(kAll, a4, r >> 2) >> sh) & 0xffu;
    const uint32_t nc = (__shfl_sync(kAll, n4, r >> 2) >> sh) & 0xffu;
    if (i > first) shift_window<L>(txt, nc, lane);
    uint32_t nib[(L + 7) / 8];
    dp_row<L>(i, ac, txt, H, F, jb, k1, lane, nib);
    sink(i, H, nib);
  }
}

// Last-column tracking after row i: only the last pe + 1 rows count, and
// only the thread that holds column n. (colv, coli) keeps the smallest H and
// the largest i among equal ones, as the sequential "hv <= colv" does.
template <int L>
__device__ __forceinline__ void track_column(const int (&H)[L],
                                             const Member& jb, int k1,
                                             int lane, int i, int& colv,
                                             int& coli) {
  if (jb.pe <= 0 || jb.m - i > jb.pe) return;
  const int lc = jb.n - i + k1 - lane * L;
  if (lc < 0 || lc >= L) return;
  int hv = H[0];
#pragma unroll
  for (int l = 1; l < L; ++l) {
    if (l == lc) hv = H[l];
  }
  if (hv <= colv) {
    colv = hv;
    coli = i;
  }
}

// (value, index) pairs reduced over the warp: the smallest value, then the
// largest index among equal ones; every lane gets the result.
__device__ __forceinline__ void reduce_min_last(int& v, int& idx) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kAll, v, d);
    const int oi = __shfl_xor_sync(kAll, idx, d);
    if (ov < v || (ov == v && oi > idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// End cell after row m: (m, n) first, then the last row's window (larger j
// on ties), then the last column on strict improvement. Returns the score;
// a member whose score is not below cap gets (0, 0), so it does not walk.
// Every lane gets the same result.
template <int L>
__device__ int end_cell(const int (&H)[L], const Member& jb, int k1,
                        int lane, int colv, int coli, int& ei, int& ej) {
  constexpr int W = 32 * L;
  const int w0 = lane * L;
  const int wmn = jb.n - jb.m + k1;
  const bool mn_in = wmn >= 0 && wmn < W;
  int hmn = kInf;
  int smin = kInf, jbest = -1;
  const int lower = max(0, jb.n - jb.te);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (w0 + l == wmn) hmn = H[l];
    const int jw = w0 + l - k1 + jb.m;
    if (jw >= lower && jw <= jb.n - 1 && H[l] <= smin) {
      smin = H[l];
      jbest = jw;
    }
  }
  hmn = __shfl_sync(kAll, hmn, mn_in ? wmn / L : 0);
  int best_s = mn_in ? hmn : kInf;
  reduce_min_last(smin, jbest);
  reduce_min_last(colv, coli);
  ei = jb.m;
  ej = jb.n;
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

// One traceback step from (ci, cj) in state (0 = H, 1 = F, 2 = E), given
// the 4-bit code of row ci, lane cj - ci + k + 1 (0 where there is none);
// returns the op code it emits (0 for a state change).
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

__device__ __forceinline__ int lane_of(int ci, int cj, int W, int k1) {
  const int wc = cj - ci + k1;
  return (ci >= 1 && wc >= 0 && wc < W) ? wc : -1;
}

// The 4-bit code of lane wc in a row of packed codes.
__device__ __forceinline__ int code_at(const uint8_t* row, int wc) {
  return (row[wc >> 1] >> (4 * (wc & 1))) & 15;
}

// A member's cigar as finished bytes in its row of cig (stride bytes):
// bytes [0, 4) hold the int32 offset of the cigar's first byte; the walk's
// n_ops ops fill [top - n_ops, top), top = 4 + ei + ej, in forward order
// ('M' or 'X' as the pattern and text chars of a diagonal step are equal or
// not, 'I', 'D'); the free ends' 'D' * (m - ei) and 'I' * (n - ej) follow,
// up to 4 + m + n. A row shorter than 4 + m + n bytes gets offset 0 and no
// other byte. The walk hands over its ops 32 at a time: lane r keeps the
// r-th op of the batch and the cell the op left, and the warp resolves and
// stores the batch's bytes together.
struct Cigar {
  uint8_t* row;        // null: a row too short
  const int8_t* arow;  // pattern chars
  const int8_t* trow;  // text chars (bpad's row from lane k + 1)
  int top;
  int op = 0, ci = 0, cj = 0;  // this lane's op of the batch and its cell

  __device__ Cigar(uint8_t* cig, int stride, int b, const int8_t* arow_,
                   const int8_t* trow_, const Member& jb, int ei, int ej,
                   int lane)
      : row(nullptr), arow(arow_), trow(trow_), top(4 + ei + ej) {
    uint8_t* r = cig + static_cast<size_t>(b) * stride;
    if (4 + jb.m + jb.n <= stride) {
      row = r;
    } else if (lane == 0) {
      *reinterpret_cast<int32_t*>(r) = 0;
    }
  }

  // Ops first .. first + count - 1 of the walk, one a lane.
  __device__ void put(int first, int count, int lane) const {
    if (lane >= count) return;
    const uint8_t c = op == kOpIns   ? 'I'
                      : op == kOpDel ? 'D'
                      : arow[ci - 1] == trow[cj - 1] ? 'M'
                                                     : 'X';
    row[top - 1 - first - lane] = c;
  }

  // Op r of the walk, which left cell (i, j).
  __device__ void take(int r, int o, int i, int j, int lane) {
    if (row == nullptr) return;
    if ((r & 31) == lane) {
      op = o;
      ci = i;
      cj = j;
    }
    if ((r & 31) == 31) put(r - 31, 32, lane);
  }

  // The last, partly filled batch, the free ends' tails and the offset.
  __device__ void finish(int n_ops, const Member& jb, int ei, int ej,
                         int lane) const {
    if (row == nullptr) return;
    put(n_ops & ~31, n_ops & 31, lane);
    const int dels = jb.m - ei;
    const int tail = dels + jb.n - ej;
    for (int p = lane; p < tail; p += 32) row[top + p] = p < dels ? 'D' : 'I';
    if (lane == 0) *reinterpret_cast<int32_t*>(row) = top - n_ops;
  }
};

// A member's walk, run alike by all 32 lanes; lane 0 stores the op words
// (16 codes each, in walk order), and every op goes to the cigar bytes.
struct Walk {
  int ci, cj, state, n_ops, t;
  uint32_t word;

  __device__ Walk(int ei, int ej)
      : ci(ei), cj(ej), state(0), n_ops(0), t(0), word(0) {}

  __device__ bool active(int t_max) const {
    return t < t_max && (ci != 0 || cj != 0);
  }

  __device__ void step(int code, int32_t* orow, int lane, Cigar& cg) {
    const int i0 = ci, j0 = cj;
    const int op = walk_step(ci, cj, state, code);
    ++t;
    if (op) {
      cg.take(n_ops, op, i0, j0, lane);
      word |= static_cast<uint32_t>(op) << (2 * (n_ops & 15));
      if ((++n_ops & 15) == 0) {
        if (lane == 0) orow[(n_ops >> 4) - 1] = static_cast<int32_t>(word);
        word = 0;
      }
    }
  }

  // The partly filled word, and zeros in every word after it.
  __device__ void finish(int32_t* orow, int t_words, int lane) const {
    const int q = n_ops >> 4;
    if (lane == 0 && q < t_words) orow[q] = static_cast<int32_t>(word);
    for (int p = q + 1 + lane; p < t_words; p += 32) orow[p] = 0;
  }
};

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

// K5: every row's codes kept in bits ([B][La][W / 2] bytes); kWarpsK5
// members a block, each warp with kStage rows of staged codes in shared
// memory.
template <int L>
__global__ void __launch_bounds__(32 * kWarpsK5)
affine_tb_kernel(const int8_t* __restrict__ a, int La,
                 const int8_t* __restrict__ bpad, int Lb,
                 const int32_t* __restrict__ mn, int t_words,
                 int32_t* __restrict__ ops, int32_t* __restrict__ end,
                 int n_jobs, uint8_t* __restrict__ bits,
                 uint8_t* __restrict__ cig, int cig_stride) {
  constexpr int W = 32 * L;
  constexpr int kRow = W / 2;  // bytes of codes per row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsK5 + warp;
  if (b >= n_jobs) return;
  const int k1 = W / 2;
  const Member jb = load_member(mn, b, La);
  uint8_t* mbits = bits + static_cast<size_t>(b) * La * kRow;
  const int8_t* arow = a + static_cast<size_t>(b) * La;
  const int8_t* brow = bpad + static_cast<size_t>(b) * Lb;
  int H[L], F[L];
  init_rows<L>(H, F, jb, k1, lane);
  int colv = kInf, coli = 0;
  run_rows<L>(1, jb.m, arow, La, brow, Lb, jb, k1, lane, H, F,
              [&](int i, const int (&Hr)[L], const uint32_t(&nib)[(L + 7) / 8]) {
                store_codes<L>(mbits + static_cast<size_t>(i - 1) * kRow +
                                   lane * (L / 2),
                               nib);
                track_column<L>(Hr, jb, k1, lane, i, colv, coli);
              });
  int ei, ej;
  const int score = end_cell<L>(H, jb, k1, lane, colv, coli, ei, ej);

  uint8_t* stage = smem_raw + warp * kStage * kRow;
  int32_t* orow = ops + static_cast<size_t>(b) * t_words;
  const int t_max = 16 * t_words;
  Walk wk(ei, ej);
  Cigar cg(cig, cig_stride, b, arow, brow + k1, jb, ei, ej, lane);
  int lo = 1, hi = 0;  // rows (from 1) held in stage
  while (wk.active(t_max)) {
    const int wc = lane_of(wk.ci, wk.cj, W, k1);
    int code = 0;
    if (wc >= 0) {
      if (wk.ci < lo || wk.ci > hi) {  // the rows the cursor enters next
        hi = wk.ci;
        lo = max(1, hi - kStage + 1);
        __syncwarp();  // the codes written above; the old stage read
        const uint4* src = reinterpret_cast<const uint4*>(
            mbits + static_cast<size_t>(lo - 1) * kRow);
        uint4* dst = reinterpret_cast<uint4*>(stage);
        for (int p = lane; p < (hi - lo + 1) * kRow / 16; p += 32) {
          dst[p] = src[p];
        }
        __syncwarp();
      }
      code = code_at(stage + (wk.ci - lo) * kRow, wc);
    }
    wk.step(code, orow, lane, cg);
  }
  wk.finish(orow, t_words, lane);
  cg.finish(wk.n_ops, jb, ei, ej, lane);
  if (lane == 0) {
    store_end(end, b, score, ei, ej, wk.ci == 0 && wk.cj == 0, jb);
  }
}

// H and F of the thread's lanes to or from a checkpoint ([H | F][W]).
template <int L>
__device__ __forceinline__ void save_ckpt(int32_t* c, const int (&H)[L],
                                          const int (&F)[L], int lane) {
  constexpr int W = 32 * L;
  int4* h = reinterpret_cast<int4*>(c + lane * L);
  int4* f = reinterpret_cast<int4*>(c + W + lane * L);
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    h[q] = make_int4(H[4 * q], H[4 * q + 1], H[4 * q + 2], H[4 * q + 3]);
    f[q] = make_int4(F[4 * q], F[4 * q + 1], F[4 * q + 2], F[4 * q + 3]);
  }
}

template <int L>
__device__ __forceinline__ void load_ckpt(const int32_t* c, int (&H)[L],
                                          int (&F)[L], int lane) {
  constexpr int W = 32 * L;
  const int4* h = reinterpret_cast<const int4*>(c + lane * L);
  const int4* f = reinterpret_cast<const int4*>(c + W + lane * L);
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    const int4 x = h[q], y = f[q];
    H[4 * q] = x.x;
    H[4 * q + 1] = x.y;
    H[4 * q + 2] = x.z;
    H[4 * q + 3] = x.w;
    F[4 * q] = y.x;
    F[4 * q + 1] = y.y;
    F[4 * q + 2] = y.z;
    F[4 * q + 3] = y.w;
  }
}

__device__ int ckpt_blocks(int La) {
  return La > 0 ? (La + kBlock - 1) / kBlock : 1;
}

// K6: one member a block (one warp); H and F after every kBlock-th row in
// ckpt ([B][ckpt_blocks(La)][2][W] int32); the walk recomputes one block of
// codes at a time into shared memory ([kBlock][W / 2] bytes).
template <int L>
__global__ void __launch_bounds__(32)
affine_tb_ckpt_kernel(const int8_t* __restrict__ a, int La,
                      const int8_t* __restrict__ bpad, int Lb,
                      const int32_t* __restrict__ mn, int t_words,
                      int32_t* __restrict__ ops, int32_t* __restrict__ end,
                      int n_jobs, int32_t* __restrict__ ckpt,
                      uint8_t* __restrict__ cig, int cig_stride) {
  constexpr int W = 32 * L;
  constexpr int kRow = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  if (b >= n_jobs) return;
  const int k1 = W / 2;
  const Member jb = load_member(mn, b, La);
  const int8_t* arow = a + static_cast<size_t>(b) * La;
  const int8_t* brow = bpad + static_cast<size_t>(b) * Lb;
  int32_t* mck = ckpt + static_cast<size_t>(b) * ckpt_blocks(La) * 2 * W;
  int H[L], F[L];
  init_rows<L>(H, F, jb, k1, lane);
  save_ckpt<L>(mck, H, F, lane);
  int colv = kInf, coli = 0;
  run_rows<L>(1, jb.m, arow, La, brow, Lb, jb, k1, lane, H, F,
              [&](int i, const int (&Hr)[L], const uint32_t(&)[(L + 7) / 8]) {
                if (i % kBlock == 0 && i < jb.m) {
                  save_ckpt<L>(mck + static_cast<size_t>(i / kBlock) * 2 * W,
                               Hr, F, lane);
                }
                track_column<L>(Hr, jb, k1, lane, i, colv, coli);
              });
  int ei, ej;
  const int score = end_cell<L>(H, jb, k1, lane, colv, coli, ei, ej);

  // the walk, block by block from the cursor's down; the whole warp
  // recomputes each block from its checkpoint
  int32_t* orow = ops + static_cast<size_t>(b) * t_words;
  const int t_max = 16 * t_words;
  Walk wk(ei, ej);
  Cigar cg(cig, cig_stride, b, arow, brow + k1, jb, ei, ej, lane);
  for (int blk = wk.ci >= 1 ? (wk.ci - 1) / kBlock : -1;
       blk >= 0 && wk.active(t_max); --blk) {
    load_ckpt<L>(mck + static_cast<size_t>(blk) * 2 * W, H, F, lane);
    const int first = blk * kBlock + 1;
    __syncwarp();  // the previous block's codes have been read
    run_rows<L>(first, min(jb.m, first + kBlock - 1), arow, La, brow, Lb, jb,
                k1, lane, H, F,
                [&](int i, const int (&)[L],
                    const uint32_t(&nib)[(L + 7) / 8]) {
                  store_codes<L>(smem_raw + (i - first) * kRow +
                                     lane * (L / 2),
                                 nib);
                });
    __syncwarp();
    // steps while the cursor's row is in this block (or is row 0)
    while (wk.active(t_max) &&
           (wk.ci == 0 || (wk.ci - 1) / kBlock == blk)) {
      const int wc = lane_of(wk.ci, wk.cj, W, k1);
      wk.step(wc < 0 ? 0 : code_at(smem_raw + (wk.ci - first) * kRow, wc),
              orow, lane, cg);
    }
  }
  wk.finish(orow, t_words, lane);
  cg.finish(wk.n_ops, jb, ei, ej, lane);
  if (lane == 0) {
    store_end(end, b, score, ei, ej, wk.ci == 0 && wk.cj == 0, jb);
  }
}

template <int L>
cudaError_t launch_k5(const int8_t* a, int La, const int8_t* bpad, int Lb,
                      const int32_t* mn, int t_words, int32_t* ops,
                      int32_t* end, int n_jobs, uint8_t* bits,
                      uint8_t* cig, int cig_stride, cudaStream_t stream) {
  const int smem = kWarpsK5 * kStage * 16 * L;
  cudaError_t err = cudaFuncSetAttribute(
      affine_tb_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_jobs + kWarpsK5 - 1) / kWarpsK5;
  affine_tb_kernel<L><<<blocks, 32 * kWarpsK5, smem, stream>>>(
      a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, bits, cig, cig_stride);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_k6(const int8_t* a, int La, const int8_t* bpad, int Lb,
                      const int32_t* mn, int t_words, int32_t* ops,
                      int32_t* end, int n_jobs, int32_t* ckpt,
                      uint8_t* cig, int cig_stride, cudaStream_t stream) {
  const int smem = kBlock * 16 * L;
  cudaError_t err = cudaFuncSetAttribute(
      affine_tb_ckpt_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  affine_tb_ckpt_kernel<L><<<n_jobs, 32, smem, stream>>>(
      a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, ckpt, cig, cig_stride);
  return cudaGetLastError();
}

cudaError_t check_args(int k, int t_words, int La, int Lb, const void* cig,
                       int cig_stride) {
  const bool bad_cig = cig == nullptr || cig_stride < 4 || cig_stride % 4;
  return (t_words <= 0 || Lb < La + 2 * (k + 1) + 2 || bad_cig)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

}  // namespace

// bits holds La * (k + 1) * n_jobs bytes (W / 2 per row and member),
// allocated by the caller, and cig n_jobs rows of cig_stride bytes (a
// multiple of 4; a member's row wants 4 + m + n). k is 63, 127, 255 or 511.
extern "C" int otter_affine_tb(const int8_t* a, int La, const int8_t* bpad,
                               int Lb, const int32_t* mn, int k, int t_words,
                               int32_t* ops, int32_t* end, int n_jobs,
                               void* bits, void* cig, int cig_stride,
                               void* stream) {
  const cudaError_t bad = check_args(k, t_words, La, Lb, cig, cig_stride);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* bt = static_cast<uint8_t*>(bits);
  uint8_t* cg = static_cast<uint8_t*>(cig);
  switch (k) {
    case 63:
      return launch_k5<4>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, bt,
                          cg, cig_stride, s);
    case 127:
      return launch_k5<8>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, bt,
                          cg, cig_stride, s);
    case 255:
      return launch_k5<16>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs,
                           bt, cg, cig_stride, s);
    case 511:
      return launch_k5<32>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs,
                           bt, cg, cig_stride, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ckpt holds max(1, ceil(La / 256)) * 4 (k + 1) * n_jobs int32 (H and F of
// W lanes per checkpoint and member), allocated by the caller; cig as for
// otter_affine_tb. k is 63, 127, 255 or 511.
extern "C" int otter_affine_tb_ckpt(const int8_t* a, int La,
                                    const int8_t* bpad, int Lb,
                                    const int32_t* mn, int k, int t_words,
                                    int32_t* ops, int32_t* end, int n_jobs,
                                    void* ckpt, void* cig, int cig_stride,
                                    void* stream) {
  const cudaError_t bad = check_args(k, t_words, La, Lb, cig, cig_stride);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* ck = static_cast<int32_t*>(ckpt);
  uint8_t* cg = static_cast<uint8_t*>(cig);
  switch (k) {
    case 63:
      return launch_k6<4>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, ck,
                          cg, cig_stride, s);
    case 127:
      return launch_k6<8>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs, ck,
                          cg, cig_stride, s);
    case 255:
      return launch_k6<16>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs,
                           ck, cg, cig_stride, s);
    case 511:
      return launch_k6<32>(a, La, bpad, Lb, mn, t_words, ops, end, n_jobs,
                           ck, cg, cig_stride, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
