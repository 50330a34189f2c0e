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
// The running minimum run = min(v, run + 1) is, for every lane w, the
// prefix-min of v[w'] - w' over w' <= w, plus w. Both designs below take it
// that way: a running minimum over a thread's own lanes, then a scan of the
// thread minima. min is exact in any order, so the values are those of the
// sequential chain, INF lanes included.
//
// k <= 511 (W <= 1024), the rungs the engine's ladder starts with: one warp
// per pair (edit_banded_warp_kernel), 4 pairs a block. W is rounded up to
// 32 L lanes, L = 1, 2, 4, 8, 12, 16, 24 or 32 (a template parameter: k = 7
// takes L = 1, 31 L = 2, 63 L = 4, 127 L = 8, 130 and 383 L = 12, 255
// L = 16, 511 L = 32), and thread t keeps lanes [t L, t L + L) of the row in
// registers; the extra lanes past W are held at INF (the lane bound of row i
// is j <= min(n, i + k)), so the "up" value of lane W - 1 stays INF. A row
// update reads its "up" operand from the thread's next register, or for its
// last lane from thread t + 1 by __shfl_down_sync, taken before the row is
// overwritten. The text chars of a thread's lanes (bpad[i - 1 + w]) live in L
// registers and move one lane a row: a register move each and one shuffle,
// the warp's last lane taking the entering char. The pattern char of the row
// and the entering text char come 32 rows at a time in one coalesced load
// per lane and go out by shuffles, so no cell waits on a dependent global
// load. The prefix-min is a 5-step __shfl_up_sync scan of the 32 thread
// minima and one shift to make it exclusive.
//
// k > 511 (W > 1024; the doubling rungs from 1023, and the last rung of
// sides over 32 kb): one block per pair (edit_banded_block_kernel), T =
// min(1024, W / 8 rounded up to a warp) threads, each with a contiguous run
// of ceil(W / T) lanes. The row lives in shared memory while 4 W bytes fit
// in kSmemLanes (k <= 16383), and in device-memory scratch beyond (the
// caller's W * B int32). A row is three steps with a __syncthreads() after
// each: every thread reads the first lane of the next thread's run; every
// thread updates its run in place (ascending, so lane w + 1 is still the old
// row when lane w is written) to the running minimum of v[w] - w and scans
// the thread minima within its warp, the warp totals going to shared memory;
// every thread takes its exclusive prefix from its warp's scan and the
// totals of the warps before it, and writes the row.
//
// What bounds it: INT32 issue. A band cell costs about 12 integer operations
// (the row update, then the prefix and the write-back), and a row adds ~10
// shuffles per warp (the scan's 6, the "up" operand, the text window's
// entering char, the pattern and entering chars). The scan is a dependent
// chain of shuffles per row; the design hides it with several pairs per SM
// (a launch holds up to K7_CHUNK = 1024 pairs, 256 blocks of 4 warps) rather
// than with wider rows.
//
// Kernel K9: banded two-sided ends-free Levenshtein row DP over any byte
// alphabet: K7's warp kernel instantiated with kEndsFree = true for
// k <= 511, a kernel of its own for 511 < k <= k_max = 8447, and K7's
// block kernel with kEndsFree beyond.
//
// Replaces otter_tpu/kernels/edit_pallas.py::edit_banded_ends_free_jnp (jnp,
// the fixed-k pass of the ends-free doubling ladder that the JAX package's
// mesh mode shards over its devices, edit_pallas.py::_ends_free_mesh_runner).
// The engine's mesh mode sends it the jobs with frees on both sides or a
// non-ACGT character (ops/align_batch.py::edit_ends_free_batch's passes).
//
// Inputs, as the jnp function takes them: ax (B, Lp) int32 pattern codes
// (padding -2), bxp (B, Lb) int32 text codes after k + 2 sentinel -1 columns
// (Lb = k + 2 + Np + W + 2), and meta (B, 6) int32 = (m, n, pb, pe, tb, te).
// Row i's window is bxp[i + w] (K7's bpad[i - 1 + w], one column on: the
// kernels take the text row from its second column). What differs from K7:
// row 0 is max(0, j - tb), the column j = 0 is max(0, i - pb), and `best`
// is the minimum of the last column over rows m - i <= pe (the lane
// wcol = n - i + k + 1, one lane left every row: each thread checks its own
// lanes) and of the last row over j >= n - te; a warp (or the block) takes
// the minimum of the threads' candidates at the end. INF = 2^24 when there
// is none. Validity (best <= k - reach) is the caller's check, as in the jnp
// function. Rows past m are not run: the jnp function keeps the row there.
//
// K9 at 511 < k <= k_max (the ladder's rungs 512 to 8192; the block
// kernel paid ~1 us a row there: three barriers, the row in shared memory,
// a global load of the text on every lane): one block of P warps per job
// (edit_banded_warps_kernel<P, L>), the warp kernel's layout stretched over
// P warps: thread t of warp p keeps lanes [(32 p + t) L, + L) in
// registers, W rounded up to 32 P L lanes, the extra ones held at INF. The
// text window moves one lane a row in registers; each warp loads the
// pattern chars and the chars entering its last lane 32 rows at a time (the
// next 32 ahead), one coalesced load per lane, and hands them out by
// shuffles. "Up" comes from thread t + 1 by __shfl_down_sync, and for a
// warp's last thread from the next warp's first lane, which it computes
// itself (below). A row has one __syncthreads(): before it every warp
// publishes its inclusive scan total (the least v - w over its lanes) and
// its first lane's v - w into slots double-buffered by row parity; after
// it warp p takes the least total of warps 0 .. p - 1 as its exclusive
// prefix (P - 1 broadcast reads) and, as the next row's "up", the next
// warp's first lane after this row: min(that prefix, its own total, the
// next warp's first v - w) + w, INF outside the band. A warp writes a
// parity's slots again only two rows later, after the next barrier, which
// every warp reaches after its reads of them. Every warp runs the job's m
// rows.
//
// What bounds it: a row's latency, since rows depend on one another and a
// pass holds few jobs (10 to 64 at k = 512; a job is one block on one SM).
// A row is L cell updates with a dependent running minimum, a 5-step
// shuffle scan, one barrier of P warps and P - 1 shared reads, and the
// L-lane write-back: a few hundred cycles, where the block kernel took
// ~2,000. The instance is the one of fewest lanes that holds W: P = 4
// warps of L = 9 lanes, 8 warps of 9 or 17, 16 warps of 17 or 33 (512
// threads under 128 registers; k_max = 8447). Two warps a scheduler hide
// some of a row's latency; four or more lose it again to the barrier and
// the broadcast reads (on 10 kb reads 8 x 9 lanes beat 4 x 17 at k = 1023,
// 8 x 17 beat 16 x 9 at 2047, 16 x 17 beat 32 x 9 at 4095).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kInf = 1 << 24;
constexpr int kNone = 1 << 30;  // identity of min: above every value
constexpr int kWarps = 4;       // pairs (warps) per block, k <= 511
constexpr int kChunk = 32;      // rows of chars loaded at a time
constexpr int kSmemLanes = 32768;  // k > 511: row in shared memory up to here
// The warp kernel's lanes a thread, fewest first (k <= 511)
constexpr int kWarpL[] = {1, 2, 4, 8, 12, 16, 24, 32};
constexpr int kWarpN = 8;
// K9's P-warp instances (P, L), fewest lanes first: W <= 32 P L lanes,
// so k_max = 32 * 16 * 33 / 2 - 1 = 8447
constexpr int kWarpsP[] = {4, 8, 8, 16, 16};
constexpr int kWarpsL[] = {9, 9, 17, 17, 33};
constexpr int kWarpsN = 5;

// The kernel a band k takes (launch and otter_edit_banded_ends_free_shape
// both read it): kind 0 is the warp
// kernel with kWarpL[x] lanes a thread, 1 K9's P-warp kernel with
// kWarpsP[x] warps of kWarpsL[x] lanes (only with ends_free), 2 the block
// kernel with x threads.
struct Choice {
  int kind, x;
};

Choice choose(int k, bool ends_free) {
  const int W = 2 * (k + 1);
  for (int x = 0; x < kWarpN; ++x) {
    if (W <= 32 * kWarpL[x]) return {0, x};
  }
  for (int x = 0; ends_free && x < kWarpsN; ++x) {
    if (W <= 32 * kWarpsP[x] * kWarpsL[x]) return {1, x};
  }
  return {2, min(1024, (W / 8 + 31) / 32 * 32)};
}

__device__ __forceinline__ int load_or0(const int32_t* p, int len, int idx) {
  return idx < len ? p[idx] : 0;
}

// One warp per pair; thread `lane` keeps lanes [lane L, lane L + L).
// kEndsFree: K9 (meta rows of 6), else K7 (mn rows of 2). Lb: a text row's
// length; K9's window starts one column on.
template <int L, bool kEndsFree>
__global__ void __launch_bounds__(32 * kWarps)
edit_banded_warp_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ bpad,
                        const int32_t* __restrict__ mn, int La, int Lb, int k,
                        int32_t* __restrict__ out, int n_pairs) {
  constexpr int kMeta = kEndsFree ? 6 : 2;
  constexpr int kOff = kEndsFree ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_pairs) return;  // the whole warp
  const int k1 = k + 1;
  const int W = 2 * k1;
  if (!kEndsFree) Lb = La + W + 2;  // K7's layout fixes its text rows
  const int32_t* job = mn + static_cast<size_t>(b) * kMeta;
  const int m = min(job[0], La);
  const int n = job[1];
  const int pb = kEndsFree ? job[2] : 0;
  const int pe = kEndsFree ? job[3] : 0;
  const int tb = kEndsFree ? job[4] : 0;
  const int32_t* arow = a + static_cast<size_t>(b) * La;
  const int32_t* brow = bpad + static_cast<size_t>(b) * Lb + kOff;
  const int Lt = Lb - kOff;
  const int w0 = lane * L;

  int H[L], txt[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j0 = w0 + l - k1;
    H[l] = (w0 + l < W && j0 >= 0 && j0 <= n)
               ? (kEndsFree ? max(0, j0 - tb) : j0)
               : kInf;
    txt[l] = load_or0(brow, Lt, w0 + l);  // row 1's window
  }
  // K9: this thread's least end cell so far, row 0's last column first
  int best = kInf;
  if (kEndsFree && pe >= m && n + k1 < W) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (w0 + l == n + k1) best = H[l];
    }
  }
  int aw = 0, nw = 0;
#pragma unroll 1
  for (int i = 1; i <= m; ++i) {
    const int r = (i - 1) % kChunk;
    if (r == 0) {  // rows i .. i + 31: one char of each per lane
      aw = load_or0(arow, La, i - 1 + lane);
      nw = load_or0(brow, Lt, i - 2 + 32 * L + lane);
    }
    const int ac = __shfl_sync(kAll, aw, r);
    const int nc = __shfl_sync(kAll, nw, r);
    if (i > 1) {  // the window moves one lane: bpad[i - 1 + w]
      int next = __shfl_down_sync(kAll, txt[0], 1);
      if (lane == 31) next = nc;
#pragma unroll
      for (int l = 0; l + 1 < L; ++l) txt[l] = txt[l + 1];
      txt[L - 1] = next;
    }
    // the "up" operand of the thread's last lane, before it is replaced
    int up_next = __shfl_down_sync(kAll, H[0], 1);
    if (lane == 31) up_next = kInf;
    const int jhi = min(n, i + k);  // j <= n and w <= W - 1
    const int j0 = i + w0 - k1;     // column of the thread's first lane

    // pass 1: v of every lane, kept as the running minimum of v[l] - l over
    // the thread's lanes
    int run = kNone;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int j = j0 + l;
      const int up = l + 1 < L ? H[l + 1] : up_next;
      int v = min(up + 1, H[l] + (txt[l] != ac ? 1 : 0));
      if (j == 0) v = kEndsFree ? max(0, i - pb) : i;
      if (j < 0 || j > jhi) v = kInf;
      run = min(run, v - l);
      H[l] = run;
    }

    // inclusive prefix-min of the thread minima (as v - w) across the warp,
    // then shifted to be exclusive
    int incl = run - w0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl = min(incl, y);
    }
    int pre = __shfl_up_sync(kAll, incl, 1);
    pre = lane == 0 ? kNone : pre + w0;  // as v - l of this thread's lanes

    // pass 2: the row
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int j = j0 + l;
      H[l] = (j < 0 || j > jhi) ? kInf : min(pre, H[l]) + l;
    }
    // K9: the last column (j = n) is lane n - i + k + 1 of row i
    if (kEndsFree && m - i <= pe) {
      const int wcol = n - i + k1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (w0 + l == wcol && wcol < W) best = min(best, H[l]);
      }
    }
  }

  if (kEndsFree) {
    // the last row over j in [max(0, n - te), n], then the warp's minimum
    const int jlo = max(0, n - job[5]);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int j = m + w0 + l - k1;
      if (j >= jlo && j <= n) best = min(best, H[l]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      best = min(best, __shfl_xor_sync(kAll, best, d));
    }
    if (lane == 0) out[b] = best;
    return;
  }
  // the lane of column n after row m
  const int wt = n - m + k1;
  const bool valid = m - n <= k && n - m <= k;
  const int src = valid ? wt / L : 0;
  const int sl = valid ? wt % L : 0;
  int hv = H[0];
#pragma unroll
  for (int l = 1; l < L; ++l) {
    if (l == sl) hv = H[l];
  }
  hv = __shfl_sync(kAll, hv, src);
  if (lane == 0) out[b] = valid ? hv : kInf;
}

// One block per pair; thread t keeps lanes [t R, min(t R + R, W)) with
// R = ceil(W / blockDim.x) of the row in `row` (shared memory, or the pair's
// W int32 of device-memory scratch), and the warp totals of a row's scan in
// shared memory after it. kEndsFree, Lb: as the warp kernel's.
template <bool kEndsFree>
__global__ void __launch_bounds__(1024)
edit_banded_block_kernel(const int32_t* __restrict__ a,
                         const int32_t* __restrict__ bpad,
                         const int32_t* __restrict__ mn, int La, int Lb,
                         int k, int32_t* __restrict__ out,
                         int32_t* __restrict__ scratch) {
  constexpr int kMeta = kEndsFree ? 6 : 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = blockIdx.x;
  const int k1 = k + 1;
  const int W = 2 * k1;
  if (!kEndsFree) Lb = La + W + 2;  // K7's layout fixes its text rows
  const bool in_smem = W <= kSmemLanes;
  int32_t* row = in_smem ? reinterpret_cast<int32_t*>(smem_raw)
                         : scratch + static_cast<size_t>(b) * W;
  int32_t* wtot = reinterpret_cast<int32_t*>(smem_raw) + (in_smem ? W : 0);
  const int32_t* job = mn + static_cast<size_t>(b) * kMeta;
  const int m = min(job[0], La);
  const int n = job[1];
  const int pb = kEndsFree ? job[2] : 0;
  const int pe = kEndsFree ? job[3] : 0;
  const int tb = kEndsFree ? job[4] : 0;
  const int32_t* arow = a + static_cast<size_t>(b) * La;
  const int32_t* brow = bpad + static_cast<size_t>(b) * Lb +
                        (kEndsFree ? 1 : 0);
  const int Lt = Lb - (kEndsFree ? 1 : 0);
  const int R = (W + blockDim.x - 1) / blockDim.x;
  const int w0 = min(t * R, W);
  const int w1 = min(w0 + R, W);
  for (int w = w0; w < w1; ++w) {
    const int j = w - k1;
    row[w] = (j >= 0 && j <= n) ? (kEndsFree ? max(0, j - tb) : j) : kInf;
  }
  // K9: this thread's least end cell so far (its own lanes only)
  int best = kInf;
  if (kEndsFree && pe >= m && n + k1 >= w0 && n + k1 < w1) {
    best = row[n + k1];
  }
  __syncthreads();
#pragma unroll 1
  for (int i = 1; i <= m; ++i) {
    const int ac = arow[i - 1];
    const int up_next = w1 < W ? row[w1] : kInf;  // before it is replaced
    __syncthreads();
    const int32_t* btxt = brow + (i - 1);
    int run = kNone;
    for (int w = w0; w < w1; ++w) {
      const int j = i + w - k1;
      const int up = w + 1 < w1 ? row[w + 1] : up_next;
      // K7's rows end inside its text row; K9's past m + k may not
      const int bc = !kEndsFree || i - 1 + w < Lt ? btxt[w] : 0;
      int v = min(up + 1, row[w] + (bc != ac ? 1 : 0));
      if (j == 0) v = kEndsFree ? max(0, i - pb) : i;
      if (j < 0 || j > n) v = kInf;
      run = min(run, v - w);
      row[w] = run;
    }
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl = min(incl, y);
    }
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    int pre = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) pre = kNone;
    for (int q = 0; q < warp; ++q) pre = min(pre, wtot[q]);
    for (int w = w0; w < w1; ++w) {
      const int j = i + w - k1;
      row[w] = (j < 0 || j > n) ? kInf : min(pre, row[w]) + w;
    }
    // K9: the last column is lane n - i + k + 1 of row i
    const int wcol = n - i + k1;
    if (kEndsFree && m - i <= pe && wcol >= w0 && wcol < w1) {
      best = min(best, row[wcol]);
    }
    __syncthreads();
  }
  if (kEndsFree) {
    // the last row over j in [max(0, n - te), n], then the block's minimum
    const int jlo = max(0, n - job[5]);
    for (int w = w0; w < w1; ++w) {
      const int j = m + w - k1;
      if (j >= jlo && j <= n) best = min(best, row[w]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      best = min(best, __shfl_xor_sync(kAll, best, d));
    }
    if (lane == 0) wtot[warp] = best;
    __syncthreads();
    if (t == 0) {
      for (int q = 1; q < static_cast<int>(blockDim.x + 31) / 32; ++q) {
        best = min(best, wtot[q]);
      }
      out[b] = best;
    }
    return;
  }
  if (t == 0) {
    const bool valid = m - n <= k && n - m <= k;
    out[b] = valid ? row[n - m + k1] : kInf;
  }
}

// The least of x[0 .. N), as a tree of log2 N levels.
template <int N>
__device__ __forceinline__ int min_tree(const int (&x)[N]) {
  int y[N];
#pragma unroll
  for (int l = 0; l < N; ++l) y[l] = x[l];
#pragma unroll
  for (int s = 1; s < N; s <<= 1) {
#pragma unroll
    for (int l = 0; l + s < N; l += 2 * s) y[l] = min(y[l], y[l + s]);
  }
  return y[0];
}

// K9, one block of P warps per job; thread t = 32 p + lane keeps lanes
// [t L, t L + L). The slots: [row parity][warp totals, warps' first lanes]
// [P], then the warps' end cells [P].
template <int P, int L>
__global__ void __launch_bounds__(32 * P, 1)
edit_banded_warps_kernel(const int32_t* __restrict__ a,
                         const int32_t* __restrict__ bxp,
                         const int32_t* __restrict__ meta, int La, int Lb,
                         int k, int32_t* __restrict__ out) {
  static_assert(P >= 2, "a job on several warps");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int32_t* slots = reinterpret_cast<int32_t*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int k1 = k + 1;
  const int W = 2 * k1;
  const int32_t* job = meta + static_cast<size_t>(b) * 6;
  const int m = min(job[0], La);
  const int n = job[1];
  const int pb = job[2];
  const int pe = job[3];
  const int tb = job[4];
  const int32_t* arow = a + static_cast<size_t>(b) * La;
  const int32_t* brow = bxp + static_cast<size_t>(b) * Lb + 1;
  const int Lt = Lb - 1;
  const int w0 = (32 * warp + lane) * L;
  const int wn = 32 * L * (warp + 1);  // the next warp's first lane

  int H[L], txt[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j0 = w0 + l - k1;
    H[l] = (w0 + l < W && j0 >= 0 && j0 <= n) ? max(0, j0 - tb) : kInf;
    txt[l] = load_or0(brow, Lt, w0 + l);  // row 1's window
  }
  // the "up" operand of the warp's last lane: lane wn of the row before
  int up_wn = kInf;
  if (warp + 1 < P && wn < W && wn - k1 >= 0 && wn - k1 <= n) {
    up_wn = max(0, wn - k1 - tb);
  }
  int best = kInf;  // this thread's least end cell so far
  if (pe >= m && n + k1 < W) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (w0 + l == n + k1) best = H[l];
    }
  }
  // rows 32 c + 1 .. 32 c + 32: the pattern chars and the chars entering
  // lane wn - 1, one of each per lane; the next chunk is loaded a chunk
  // ahead, and a row's two chars are shuffled out during the row before
  int aw = load_or0(arow, La, lane);
  int nw = load_or0(brow, Lt, wn - 1 + lane);
  int aw_next = load_or0(arow, La, 32 + lane);
  int nw_next = load_or0(brow, Lt, wn + 31 + lane);
  int ac = __shfl_sync(kAll, aw, 0);
#pragma unroll 1
  for (int i = 1; i <= m; ++i) {
    int up_next = __shfl_down_sync(kAll, H[0], 1);
    if (lane == 31) up_next = up_wn;
    // a lane is in the band iff its column j = j0 + l is in [0, jhi]
    const unsigned jhi = min(n, i + k);  // j <= n and w <= W - 1
    const int j0 = i + w0 - k1;
    const int c0 = max(0, i - pb);       // the column j = 0

    // pass 1: v - l of every lane
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int up = l + 1 < L ? H[l + 1] : up_next;
      int v = min(up + 1, H[l] + (txt[l] != ac ? 1 : 0));
      if (j0 + l == 0) v = c0;
      if (static_cast<unsigned>(j0 + l) > jhi) v = kInf;
      H[l] = v - l;
    }
    // the warp's inclusive prefix-min of v - w, from the thread minima (a
    // tree); a lane below d gets its own value from __shfl_up_sync
    int incl = min_tree<L>(H) - w0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      incl = min(incl, __shfl_up_sync(kAll, incl, d));
    }
    const int excl = __shfl_up_sync(kAll, incl, 1);
    // the running minimum of v - l over the thread's lanes
#pragma unroll
    for (int l = 1; l < L; ++l) H[l] = min(H[l], H[l - 1]);
    // the warp's total and its first lane's v - w go to this row's slots
    int32_t* tot = slots + (i & 1) * 2 * P;
    if (lane == 31) tot[warp] = incl;
    if (lane == 0) tot[P + warp] = H[0] - w0;
    // row i + 1's chars, and its window (one lane on: bxp[i + 1 + w])
    if ((i & 31) == 0) {
      aw = aw_next;
      nw = nw_next;
      aw_next = load_or0(arow, La, i + 32 + lane);
      nw_next = load_or0(brow, Lt, i + 31 + wn + lane);
    }
    ac = __shfl_sync(kAll, aw, i & 31);
    const int nc = __shfl_sync(kAll, nw, i & 31);
    int enter = __shfl_down_sync(kAll, txt[0], 1);
    if (lane == 31) enter = nc;
#pragma unroll
    for (int l = 0; l + 1 < L; ++l) txt[l] = txt[l + 1];
    txt[L - 1] = enter;
    __syncthreads();

    // the least v - w of the warps before this one, and the next warp's
    // first lane
    int prev[P - 1];
#pragma unroll
    for (int q = 0; q + 1 < P; ++q) prev[q] = q < warp ? tot[q] : kNone;
    const int before = min_tree<P - 1>(prev);
    const int first_next = warp + 1 < P ? tot[P + warp + 1] : kInf;
    const int pre = (lane == 0 ? before : min(before, excl)) + w0;

    // pass 2: the row
#pragma unroll
    for (int l = 0; l < L; ++l) {
      H[l] = static_cast<unsigned>(j0 + l) > jhi ? kInf : min(pre, H[l]) + l;
    }
    // lane 31: the next warp's first lane after this row, the next row's
    // "up" of its last lane (incl is the warp's total there)
    const int jn = i + wn - k1;
    up_wn = warp + 1 < P && static_cast<unsigned>(jn) <= jhi
                ? min(min(before, incl), first_next) + wn
                : kInf;
    // the last column (j = n) is lane n - i + k + 1 of row i
    if (m - i <= pe) {
      const int lc = n - i + k1 < W ? n - i + k1 - w0 : -1;
      int c[L];
#pragma unroll
      for (int l = 0; l < L; ++l) c[l] = l == lc ? H[l] : kInf;
      best = min(best, min_tree<L>(c));
    }
  }

  // the last row over j in [max(0, n - te), n], then the block's minimum
  const int jlo = max(0, n - job[5]);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int j = m + w0 + l - k1;
    if (j >= jlo && j <= n) best = min(best, H[l]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    best = min(best, __shfl_xor_sync(kAll, best, d));
  }
  int32_t* ends = slots + 4 * P;
  if (lane == 0) ends[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 1; q < P; ++q) best = min(best, ends[q]);
    out[b] = best;
  }
}

template <int P, int L>
cudaError_t launch_warps(const int32_t* a, const int32_t* bxp,
                         const int32_t* meta, int La, int Lb, int k,
                         int32_t* out, int n_jobs, cudaStream_t stream) {
  edit_banded_warps_kernel<P, L><<<n_jobs, 32 * P, 4 * 5 * P, stream>>>(
      a, bxp, meta, La, Lb, k, out);
  return cudaGetLastError();
}

template <int L, bool kEndsFree>
cudaError_t launch_warp(const int32_t* a, const int32_t* bpad,
                        const int32_t* mn, int La, int Lb, int k,
                        int32_t* out, int n_pairs, cudaStream_t stream) {
  const int blocks = (n_pairs + kWarps - 1) / kWarps;
  edit_banded_warp_kernel<L, kEndsFree><<<blocks, 32 * kWarps, 0, stream>>>(
      a, bpad, mn, La, Lb, k, out, n_pairs);
  return cudaGetLastError();
}

template <bool kEndsFree>
cudaError_t launch_block(const int32_t* a, const int32_t* bpad,
                         const int32_t* mn, int La, int Lb, int k,
                         int32_t* out, int n_pairs, int threads,
                         int32_t* scratch, cudaStream_t stream) {
  const int W = 2 * (k + 1);
  const int smem = (W <= kSmemLanes ? 4 * W : 0) + 4 * 32;
  if (W > kSmemLanes && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edit_banded_block_kernel<kEndsFree>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  edit_banded_block_kernel<kEndsFree><<<n_pairs, threads, smem, stream>>>(
      a, bpad, mn, La, Lb, k, out, scratch);
  return cudaGetLastError();
}

// K7 and K9 at the kernel choose() picks: the warp kernel at the fewest
// lanes a thread that hold the band, K9's P warps of the fewest lanes to
// k_max, the block kernel beyond.
template <bool kEndsFree>
int launch(const int32_t* a, const int32_t* bpad, const int32_t* mn, int La,
           int Lb, int k, int32_t* out, int n_pairs, void* scratch,
           void* stream) {
  if (k < 0 || La < 0 || Lb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool E = kEndsFree;
  const Choice c = choose(k, kEndsFree);
  if (c.kind == 0) {
    switch (c.x) {
      case 0: return launch_warp<kWarpL[0], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 1: return launch_warp<kWarpL[1], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 2: return launch_warp<kWarpL[2], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 3: return launch_warp<kWarpL[3], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 4: return launch_warp<kWarpL[4], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 5: return launch_warp<kWarpL[5], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      case 6: return launch_warp<kWarpL[6], E>(a, bpad, mn, La, Lb, k, out,
                                               n_pairs, s);
      default: return launch_warp<kWarpL[7], E>(a, bpad, mn, La, Lb, k, out,
                                                n_pairs, s);
    }
  }
  if (c.kind == 1) {
    switch (c.x) {
      case 0: return launch_warps<kWarpsP[0], kWarpsL[0]>(a, bpad, mn, La, Lb,
                                                          k, out, n_pairs, s);
      case 1: return launch_warps<kWarpsP[1], kWarpsL[1]>(a, bpad, mn, La, Lb,
                                                          k, out, n_pairs, s);
      case 2: return launch_warps<kWarpsP[2], kWarpsL[2]>(a, bpad, mn, La, Lb,
                                                          k, out, n_pairs, s);
      case 3: return launch_warps<kWarpsP[3], kWarpsL[3]>(a, bpad, mn, La, Lb,
                                                          k, out, n_pairs, s);
      default: return launch_warps<kWarpsP[4], kWarpsL[4]>(
          a, bpad, mn, La, Lb, k, out, n_pairs, s);
    }
  }
  return launch_block<E>(a, bpad, mn, La, Lb, k, out, n_pairs, c.x,
                         static_cast<int32_t*>(scratch), s);
}

}  // namespace

// K7. k >= 0. scratch holds 2 (k + 1) * n_pairs int32 when
// 2 (k + 1) > 32768 (allocated by the caller); it is not read otherwise and
// may be null.
extern "C" int otter_edit_banded(const int32_t* a, const int32_t* bpad,
                                 const int32_t* mn, int L, int k, int32_t* out,
                                 int n_pairs, void* scratch, void* stream) {
  return launch<false>(a, bpad, mn, L, L + 2 * (k + 1) + 2, k, out, n_pairs,
                       scratch, stream);
}

// K9: ax (n_jobs, Lp), bxp (n_jobs, Lb), meta (n_jobs, 6); every read of
// bxp is bounded by Lb (the jnp layout's Lb = k + 2 + Np + W + 2 holds every
// window of a row i <= min(m, n + k + 1)); scratch as K7's.
extern "C" int otter_edit_banded_ends_free(const int32_t* ax,
                                           const int32_t* bxp,
                                           const int32_t* meta, int Lp,
                                           int Lb, int k, int32_t* out,
                                           int n_jobs, void* scratch,
                                           void* stream) {
  return launch<true>(ax, bxp, meta, Lp, Lb, k, out, n_jobs, scratch,
                      stream);
}

// K9's kernel and instance at band k, as choose() picks them: shape gets
// {0, 1, L} (a warp of L lanes a thread), {1, P, L} (P warps of L) or
// {2, threads, lanes a thread} (the block kernel). 0, or
// cudaErrorInvalidValue for k < 0.
extern "C" int otter_edit_banded_ends_free_shape(int k, int32_t* shape) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Choice c = choose(k, true);
  shape[0] = c.kind;
  if (c.kind == 0) {
    shape[1] = 1, shape[2] = kWarpL[c.x];
  } else if (c.kind == 1) {
    shape[1] = kWarpsP[c.x], shape[2] = kWarpsL[c.x];
  } else {
    shape[1] = c.x, shape[2] = (2 * (k + 1) + c.x - 1) / c.x;
  }
  return static_cast<int>(cudaSuccess);
}
