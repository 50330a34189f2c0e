// otter-tpu native runtime helpers.
//
// Host-side C++ components complementing the TPU compute path:
//   * banded unit-cost edit distance (the CPU analog of the Pallas kernel;
//     used as the bench baseline and as a host fast path for stragglers)
//   * batch entry point with OpenMP-style threading via std::thread
//
// Built as a shared library and bound via ctypes (see otter_tpu/native.py).
// Implements the same Ukkonen-banded recurrence as
// otter_tpu/kernels/edit_pallas.py: band of diagonals |j - i| <= k; a result
// <= k is the exact Levenshtein distance.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>
#include <thread>

namespace {

constexpr int32_t kInf = 1 << 24;

// Banded Levenshtein on raw byte strings. Returns a value <= k iff the true
// distance is <= k (then exact); otherwise a value > k.
int32_t banded_edit(const uint8_t* a, int32_t m, const uint8_t* b, int32_t n,
                    int32_t k, int32_t* work) {
  if (m < n) {  // pattern = longer sequence
    std::swap(a, b);
    std::swap(m, n);
  }
  if (m - n > k) return kInf;
  const int32_t W = 2 * k + 2;
  int32_t* prev = work;
  int32_t* cur = work + W;
  // row 0: D[0][j] = j at band coord w = j + (k+1)
  for (int32_t w = 0; w < W; ++w) {
    const int32_t j = w - (k + 1);
    prev[w] = (j >= 0 && j <= n) ? j : kInf;
  }
  for (int32_t i = 1; i <= m; ++i) {
    const uint8_t ac = a[i - 1];
    const int32_t j_lo = std::max(0, i - k - 1);
    const int32_t j_hi = std::min(n, i + k);
    int32_t left = kInf;  // D[i][j-1]
    for (int32_t w = 0; w < W; ++w) {
      const int32_t j = i + w - (k + 1);
      if (j < j_lo || j > j_hi) {
        cur[w] = kInf;
        if (j == j_lo - 1) left = kInf;
        continue;
      }
      int32_t best;
      if (j == 0) {
        best = i;
      } else {
        const int32_t up = (w + 1 < W) ? prev[w + 1] + 1 : kInf;
        const int32_t diag = prev[w] + (b[j - 1] == ac ? 0 : 1);
        best = std::min(up, diag);
        if (left < kInf && left + 1 < best) best = left + 1;
      }
      cur[w] = best;
      left = best;
    }
    std::swap(prev, cur);
  }
  const int32_t w_final = n - m + (k + 1);
  if (w_final < 0 || w_final >= W) return kInf;
  return prev[w_final];
}

}  // namespace

extern "C" {

// Single pair, adaptive band doubling until exact.
int32_t otter_edit_distance(const uint8_t* a, int32_t m, const uint8_t* b,
                            int32_t n, int64_t* cells) {
  if (m == n && std::memcmp(a, b, m) == 0) return 0;
  int32_t k = 63;
  const int32_t maxlen = std::max(m, n);
  std::vector<int32_t> work;
  for (;;) {
    if (k >= std::abs(m - n)) {
      work.resize(2 * (2 * k + 2));
      const int32_t d = banded_edit(a, m, b, n, k, work.data());
      if (cells) *cells += int64_t(std::max(m, n)) * (2 * k + 2);
      if (d <= k) return d;
    }
    if (k >= maxlen) return std::max(m, n);  // degenerate (empty string)
    k = std::min(maxlen, 2 * k + 1);
  }
}

// Batch of packed pairs. offsets has nb+1 entries into seqs for each of the
// 2*nb sequences laid out pairwise: [a0, b0, a1, b1, ...].
void otter_edit_distance_batch(const uint8_t* seqs, const int64_t* offsets,
                               int32_t n_pairs, int32_t n_threads,
                               int32_t* out, int64_t* cells) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> cell_acc(n_threads, 0);
  auto worker = [&](int32_t t) {
    for (int32_t p = t; p < n_pairs; p += n_threads) {
      const uint8_t* a = seqs + offsets[2 * p];
      const int32_t m = int32_t(offsets[2 * p + 1] - offsets[2 * p]);
      const uint8_t* b = seqs + offsets[2 * p + 1];
      const int32_t n = int32_t(offsets[2 * p + 2] - offsets[2 * p + 1]);
      out[p] = otter_edit_distance(a, m, b, n, &cell_acc[t]);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  if (cells) {
    int64_t total = 0;
    for (const auto c : cell_acc) total += c;
    *cells += total;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAM feeder: decode raw (already-BGZF-inflated) BAM record streams into
// struct-of-arrays so Python avoids per-record parsing. The nibble sequence
// is expanded to ASCII here ("=ACMGRSVTWYHKDBN", SAM spec).
// ---------------------------------------------------------------------------

namespace {
const char kNt16[] = "=ACMGRSVTWYHKDBN";

struct BamBatch {
  std::vector<int32_t> ref_id, pos, flag, mapq, l_qseq;
  std::vector<int64_t> name_off, cigar_off, seq_off, aux_off;
  std::vector<char> names;
  std::vector<uint32_t> cigars;
  std::vector<char> seqs;
  std::vector<uint8_t> auxs;
};

// Size of one aux value of the given type char at p (p points past the type
// byte); returns -1 on unknown type. B arrays: elem type + int32 count.
int64_t aux_value_size(const uint8_t* p, const uint8_t* end, char type) {
  switch (type) {
    case 'A': case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    case 'Z': case 'H': {
      const uint8_t* q = p;
      while (q < end && *q) ++q;
      return (q - p) + 1;
    }
    case 'B': {
      if (p + 5 > end) return -1;
      int64_t esize = aux_value_size(p + 5, end, char(p[0]));
      if (esize <= 0) return -1;
      uint32_t count;
      std::memcpy(&count, p + 1, 4);
      return 5 + esize * int64_t(count);
    }
    default: return -1;
  }
}

// CG:B,I long-cigar tag (SAM spec 4.2.2) located inside an aux block.
struct CgTag {
  const uint8_t* ops = nullptr;  // packed cigar words
  uint32_t count = 0;
  const uint8_t* tag_begin = nullptr;  // tag bytes [tag_begin, tag_end)
  const uint8_t* tag_end = nullptr;
};

CgTag find_cg_tag(const uint8_t* p, const uint8_t* end) {
  while (p + 3 <= end) {
    const char t0 = char(p[0]), t1 = char(p[1]), type = char(p[2]);
    if (t0 == 'C' && t1 == 'G' && type == 'B' && p + 8 <= end &&
        char(p[3]) == 'I') {
      uint32_t count;
      std::memcpy(&count, p + 4, 4);
      if (p + 8 + 4 * int64_t(count) <= end)
        return {p + 8, count, p, p + 8 + 4 * int64_t(count)};
      return {};
    }
    int64_t vsize = aux_value_size(p + 3, end, type);
    if (vsize < 0) return {};
    p += 3 + vsize;
  }
  return {};
}
}  // namespace

extern "C" {

// Parse records from a raw BAM record stream (concatenated
// block_size+record blobs, i.e. everything after the header section).
// Returns an opaque handle; query with the accessors below; free when done.
void* otter_bam_parse(const uint8_t* buf, int64_t size) {
  auto* b = new BamBatch();
  int64_t off = 0;
  b->name_off.push_back(0);
  b->cigar_off.push_back(0);
  b->seq_off.push_back(0);
  b->aux_off.push_back(0);
  while (off + 4 <= size) {
    uint32_t block_size;
    std::memcpy(&block_size, buf + off, 4);
    off += 4;
    if (off + block_size > size || block_size < 32) break;
    const uint8_t* r = buf + off;
    int32_t v32;
    std::memcpy(&v32, r, 4);
    b->ref_id.push_back(v32);
    std::memcpy(&v32, r + 4, 4);
    b->pos.push_back(v32);
    const uint8_t l_read_name = r[8];
    b->mapq.push_back(r[9]);
    uint16_t n_cigar_op, flag16;
    std::memcpy(&n_cigar_op, r + 12, 2);
    std::memcpy(&flag16, r + 14, 2);
    b->flag.push_back(flag16);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 16, 4);
    b->l_qseq.push_back(l_seq);
    const uint8_t* p = r + 32;
    b->names.insert(b->names.end(), p, p + l_read_name - 1);
    b->name_off.push_back(int64_t(b->names.size()));
    p += l_read_name;
    const uint32_t* cig = reinterpret_cast<const uint32_t*>(p);
    // long-cigar convention (SAM spec 4.2.2, like htslib's sam.c): a kSmN
    // placeholder cigar means the real cigar lives in the CG:B,I aux tag
    bool placeholder =
        n_cigar_op == 2 && (cig[0] & 0xF) == 4 /*S*/ &&
        int32_t(cig[0] >> 4) == *reinterpret_cast<const int32_t*>(r + 16) &&
        (cig[1] & 0xF) == 3 /*N*/;
    const uint8_t* aux_probe =
        p + 4 * n_cigar_op +
        (*reinterpret_cast<const int32_t*>(r + 16) + 1) / 2 +
        *reinterpret_cast<const int32_t*>(r + 16);
    CgTag cg;
    if (placeholder && aux_probe <= r + block_size)
      cg = find_cg_tag(aux_probe, r + block_size);
    if (cg.ops) {
      const size_t c0 = b->cigars.size();
      b->cigars.resize(c0 + cg.count);
      std::memcpy(b->cigars.data() + c0, cg.ops, 4 * size_t(cg.count));
    } else {
      b->cigars.insert(b->cigars.end(), cig, cig + n_cigar_op);
    }
    b->cigar_off.push_back(int64_t(b->cigars.size()));
    p += 4 * n_cigar_op;
    const int32_t n_nyb = (l_seq + 1) / 2;
    size_t s0 = b->seqs.size();
    b->seqs.resize(s0 + l_seq);
    for (int32_t i = 0; i < l_seq; ++i) {
      const uint8_t byte = p[i >> 1];
      b->seqs[s0 + i] = kNt16[(i & 1) ? (byte & 0xF) : (byte >> 4)];
    }
    b->seq_off.push_back(int64_t(b->seqs.size()));
    p += n_nyb + l_seq;  // skip qual
    const uint8_t* aux_end = r + block_size;
    if (cg.ops) {
      // drop the consumed CG tag so a write round-trip never duplicates it
      b->auxs.insert(b->auxs.end(), p, cg.tag_begin);
      b->auxs.insert(b->auxs.end(), cg.tag_end, aux_end);
    } else {
      b->auxs.insert(b->auxs.end(), p, aux_end);
    }
    b->aux_off.push_back(int64_t(b->auxs.size()));
    off += block_size;
  }
  return b;
}

int64_t otter_bam_count(void* h) {
  return int64_t(static_cast<BamBatch*>(h)->ref_id.size());
}

// Copy fixed-size columns into caller buffers (each sized n records).
void otter_bam_columns(void* h, int32_t* ref_id, int32_t* pos, int32_t* flag,
                       int32_t* mapq, int32_t* l_qseq, int64_t* name_off,
                       int64_t* cigar_off, int64_t* seq_off,
                       int64_t* aux_off) {
  auto* b = static_cast<BamBatch*>(h);
  const size_t n = b->ref_id.size();
  std::memcpy(ref_id, b->ref_id.data(), n * 4);
  std::memcpy(pos, b->pos.data(), n * 4);
  std::memcpy(flag, b->flag.data(), n * 4);
  std::memcpy(mapq, b->mapq.data(), n * 4);
  std::memcpy(l_qseq, b->l_qseq.data(), n * 4);
  std::memcpy(name_off, b->name_off.data(), (n + 1) * 8);
  std::memcpy(cigar_off, b->cigar_off.data(), (n + 1) * 8);
  std::memcpy(seq_off, b->seq_off.data(), (n + 1) * 8);
  std::memcpy(aux_off, b->aux_off.data(), (n + 1) * 8);
}

int64_t otter_bam_blob_sizes(void* h, int64_t* names, int64_t* cigars,
                             int64_t* seqs, int64_t* auxs) {
  auto* b = static_cast<BamBatch*>(h);
  *names = int64_t(b->names.size());
  *cigars = int64_t(b->cigars.size());
  *seqs = int64_t(b->seqs.size());
  *auxs = int64_t(b->auxs.size());
  return 0;
}

void otter_bam_blobs(void* h, char* names, uint32_t* cigars, char* seqs,
                     uint8_t* auxs) {
  auto* b = static_cast<BamBatch*>(h);
  std::memcpy(names, b->names.data(), b->names.size());
  std::memcpy(cigars, b->cigars.data(), b->cigars.size() * 4);
  std::memcpy(seqs, b->seqs.data(), b->seqs.size());
  std::memcpy(auxs, b->auxs.data(), b->auxs.size());
}

void otter_bam_free(void* h) { delete static_cast<BamBatch*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded gap-affine aligner with traceback: the native engine behind
// ops/align_batch.py::affine_cigars_multi. Exact same recurrences, boundary
// conditions, end-cell preference, and traceback tie-breaking as the numpy
// reference (_banded_batch_multi / _end_cell / _traceback_banded), which in
// turn reproduce WFA2 alignEndsFree cigars (gap-affine penalties 0/4/6+2L,
// right-aligned edits). Band coords: w = j - i + (k+1), W = 2(k+1); a band
// of k >= max(m, n) covers the full matrix, making the result
// unconditionally exact.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kBigAffine = 1 << 28;  // matches align_np._BIG
constexpr int32_t kMismatch = 4;
constexpr int32_t kGapOpen = 6;
constexpr int32_t kGapExt = 2;

// One member: fill H/E/F (history kept for traceback), pick the end cell,
// emit the cigar. Returns the end-cell score; cigar written to `cig`
// (capacity >= m + n + 1), length to *cig_len.
int32_t affine_banded_member(const uint8_t* a, int32_t m, const uint8_t* b,
                             int32_t n, int32_t k, int32_t pb, int32_t pe,
                             int32_t tb, int32_t te,
                             std::vector<int32_t>& Hbuf,
                             std::vector<int32_t>& Ebuf,
                             std::vector<int32_t>& Fbuf, char* cig,
                             int32_t* cig_len) {
  const int32_t W = 2 * (k + 1);
  Hbuf.resize(size_t(m + 1) * W);
  Ebuf.resize(size_t(m + 1) * W);
  Fbuf.resize(size_t(m + 1) * W);
  int32_t* H = Hbuf.data();
  int32_t* E = Ebuf.data();
  int32_t* F = Fbuf.data();
  for (int32_t w = 0; w < W; ++w) {
    const int32_t j0 = w - (k + 1);
    H[w] = (j0 >= 0 && j0 <= n)
               ? (j0 <= tb ? 0 : kGapOpen + kGapExt * (j0 - tb))
               : kBigAffine;
    E[w] = kBigAffine;
    F[w] = kBigAffine;
  }
  for (int32_t i = 1; i <= m; ++i) {
    const int32_t* Hp = H + size_t(i - 1) * W;
    const int32_t* Fp = F + size_t(i - 1) * W;
    int32_t* Hc = H + size_t(i) * W;
    int32_t* Ec = E + size_t(i) * W;
    int32_t* Fc = F + size_t(i) * W;
    const uint8_t ac = a[i - 1];
    const int32_t hb =
        (i <= pb) ? 0 : kGapOpen + kGapExt * (i - pb);
    int32_t runmin = kBigAffine * 2;  // min over w'<w of Bv[w'] - ext*w'
    for (int32_t w = 0; w < W; ++w) {
      const int32_t j = i + w - (k + 1);
      const int32_t up_h = (w + 1 < W) ? Hp[w + 1] : kBigAffine;
      const int32_t up_f = (w + 1 < W) ? Fp[w + 1] : kBigAffine;
      const int32_t f = std::min(up_h + kGapOpen + kGapExt, up_f + kGapExt);
      int32_t bv;
      const bool invalid = (j < 0) | (j > n);
      if (j >= 1 && j <= n) {
        const int32_t diag = Hp[w] + (b[j - 1] == ac ? 0 : kMismatch);
        bv = std::min(diag, f);
      } else {
        bv = kBigAffine;
      }
      if (j == 0) bv = hb;
      if (invalid) bv = kBigAffine;
      int32_t e = (w == 0) ? kBigAffine : runmin + kGapExt * w + kGapOpen;
      if (invalid) e = kBigAffine;
      int32_t h = std::min(bv, e);
      if (j == 0) h = hb;
      if (invalid) h = kBigAffine;
      Hc[w] = h;
      Ec[w] = e;
      Fc[w] = invalid ? kBigAffine : f;
      runmin = std::min(runmin, bv - kGapExt * w);
    }
  }
  // end cell: best over the free trailing windows, preferring max j then
  // max i on ties (align_batch.py::_end_cell)
  const int32_t kp1 = k + 1;
  auto hat = [&](int32_t i, int32_t j) -> int32_t {
    const int32_t w = j - i + kp1;
    return (w >= 0 && w < W) ? H[size_t(i) * W + w] : kBigAffine;
  };
  int32_t best = hat(m, n), ei = m, ej = n;
  for (int32_t j = n - 1; j >= std::max(0, n - te); --j) {
    const int32_t s = hat(m, j);
    if (s < best) { best = s; ei = m; ej = j; }
  }
  for (int32_t i = m - 1; i >= std::max(0, m - pe); --i) {
    const int32_t s = hat(i, n);
    if (s < best) { best = s; ei = i; ej = n; }
  }
  // traceback (align_batch.py::_traceback_banded): prefer F then E over the
  // diagonal on ties -> WFA-compatible right-aligned edits
  auto eat = [&](int32_t i, int32_t j) -> int32_t {
    const int32_t w = j - i + kp1;
    return (w >= 0 && w < W) ? E[size_t(i) * W + w] : kBigAffine;
  };
  auto fat = [&](int32_t i, int32_t j) -> int32_t {
    const int32_t w = j - i + kp1;
    return (w >= 0 && w < W) ? F[size_t(i) * W + w] : kBigAffine;
  };
  char* out = cig;
  for (int32_t t = 0; t < n - ej; ++t) *out++ = 'I';
  for (int32_t t = 0; t < m - ei; ++t) *out++ = 'D';
  int32_t i = ei, j = ej;
  int state = 0;  // 0 = H, 1 = F, 2 = E
  while (i > 0 || j > 0) {
    if (state == 0) {
      if (i == 0) {
        for (int32_t t = 0; t < j; ++t) *out++ = 'I';
        break;
      }
      if (j == 0) {
        for (int32_t t = 0; t < i; ++t) *out++ = 'D';
        break;
      }
      const int32_t h = hat(i, j);
      if (h == fat(i, j)) { state = 1; continue; }
      if (h == eat(i, j)) { state = 2; continue; }
      *out++ = (a[i - 1] == b[j - 1]) ? 'M' : 'X';
      --i;
      --j;
    } else if (state == 1) {
      *out++ = 'D';
      if (fat(i, j) == fat(i - 1, j) + kGapExt && i > 1) {
        --i;
      } else {
        --i;
        state = 0;
      }
    } else {
      *out++ = 'I';
      if (eat(i, j) == eat(i, j - 1) + kGapExt && j > 1) {
        --j;
      } else {
        --j;
        state = 0;
      }
    }
  }
  const int32_t len = int32_t(out - cig);
  std::reverse(cig, out);
  *cig_len = len;
  return best;
}

}  // namespace

extern "C" {

// Batch entry point. seqs/offsets lay out 2*B sequences pairwise (a_i, b_i);
// per-member cigar buffers at cig_off[i] (capacity m_i + n_i + 1). Each
// member uses band half-width kv[i]. Outputs: cigar lengths, end-cell
// scores. Threaded round-robin over members.
void otter_affine_banded_batch(const uint8_t* seqs, const int64_t* offsets,
                               const int32_t* pb, const int32_t* pe,
                               const int32_t* tb, const int32_t* te,
                               const int32_t* kv, int32_t n_members,
                               int32_t n_threads, char* cigars,
                               const int64_t* cig_off, int32_t* cig_len,
                               int32_t* score) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int32_t t) {
    std::vector<int32_t> Hbuf, Ebuf, Fbuf;
    for (int32_t p = t; p < n_members; p += n_threads) {
      const uint8_t* a = seqs + offsets[2 * p];
      const int32_t m = int32_t(offsets[2 * p + 1] - offsets[2 * p]);
      const uint8_t* b = seqs + offsets[2 * p + 1];
      const int32_t n = int32_t(offsets[2 * p + 2] - offsets[2 * p + 1]);
      score[p] = affine_banded_member(a, m, b, n, kv[p], pb[p], pe[p], tb[p],
                                      te[p], Hbuf, Ebuf, Fbuf,
                                      cigars + cig_off[p], &cig_len[p]);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PPOA: backbone-anchored partial-order-alignment consensus. Exact semantics
// port of the reference header-only engine (src/anppoa.hpp) and of the
// python oracle (otter_tpu/ops/poa.py): float32 weights, identical edge
// insertion order and tie-breaking, w -= max(c, t*w) pruning, heaviest-path
// consensus ending in one of the last-10-backbone-anchored ending nodes.
// ---------------------------------------------------------------------------

namespace {

struct Poa {
  int32_t backbone_len = 0;
  std::vector<char> nodes;                                  // 1 char per node
  std::vector<std::vector<std::pair<int32_t, float>>> edges;
  std::vector<int32_t> starting_nodes;
  std::vector<char> ending;                                 // flag per node

  void init(const uint8_t* bb, int32_t n) {
    backbone_len = n;
    nodes.assign(bb, bb + n);
    edges.assign(n, {});
    ending.assign(n, 0);
    if (n > 0) starting_nodes.push_back(0);
    for (int32_t i = 1; i < n; ++i) {
      insert_edge(i - 1, i);
      if (n - i <= 10) ending[i] = 1;
    }
  }

  int32_t new_node(char c) {
    nodes.push_back(c);
    edges.emplace_back();
    ending.push_back(0);
    return int32_t(nodes.size()) - 1;
  }

  void insert_edge(int32_t src, int32_t sink) {
    auto& local = edges[src];
    for (auto& e : local) {
      if (e.first == sink) {
        e.second += 1.0f;
        return;
      }
    }
    local.emplace_back(sink, 1.0f);
  }

  // anppoa.hpp:112-241 / poa.py insert_alignment (generic per-column loop)
  void insert_alignment(const uint8_t* seq, int64_t seq_len,
                        const uint8_t* cig, int64_t cig_len,
                        bool span_l, bool span_r) {
    int32_t previous_node = 0;
    int64_t ref_i = 0, target_i = 0, cigar_i = 0;
    bool is_first_node = true;
    if (!span_l) {
      is_first_node = false;
      while (cigar_i < cig_len) {
        const char c = char(cig[cigar_i]);
        if (c != 'D' && c != 'I') break;
        if (c == 'D') {
          ++ref_i;
          previous_node = int32_t(ref_i);
        } else {
          ++target_i;
        }
        ++cigar_i;
      }
    }
    while (cigar_i < cig_len) {
      const char c = char(cig[cigar_i]);
      const char target_seq = target_i < seq_len ? char(seq[target_i]) : 0;
      if (c == 'M' || c == 'X') {
        if (c == 'M') {
          if (is_first_node || previous_node == ref_i) {
            is_first_node = false;
          } else {
            insert_edge(previous_node, int32_t(ref_i));
          }
          previous_node = int32_t(ref_i);
        } else {
          if (is_first_node) {
            bool need_new = true;
            for (int32_t node : starting_nodes) {
              if (nodes[node] == target_seq) {
                need_new = false;
                break;
              }
            }
            if (need_new) {
              previous_node = new_node(target_seq);
              starting_nodes.push_back(previous_node);
            }
            is_first_node = false;
          } else {
            auto& outgoing = edges[previous_node];
            int32_t match_i = -1;
            for (size_t ei = 0; ei < outgoing.size(); ++ei) {
              const int32_t sink = outgoing[ei].first;
              if (nodes[sink] == target_seq && sink >= backbone_len) {
                match_i = int32_t(ei);
                break;
              }
            }
            if (match_i >= 0) {
              outgoing[match_i].second += 1.0f;
              previous_node = outgoing[match_i].first;
            } else {
              const int32_t nn = new_node(target_seq);
              insert_edge(previous_node, nn);
              previous_node = nn;
            }
          }
        }
        ++ref_i;
        ++target_i;
      }
      if (c == 'D') {
        if (!is_first_node) {
          ++ref_i;
        } else {
          ++ref_i;
          previous_node = int32_t(ref_i);
        }
      } else if (c == 'I') {
        if (is_first_node) {
          previous_node = new_node(target_seq);
          starting_nodes.push_back(previous_node);
          is_first_node = false;
        } else {
          auto& outgoing = edges[previous_node];
          int32_t match_i = -1;
          for (size_t ei = 0; ei < outgoing.size(); ++ei) {
            const int32_t sink = outgoing[ei].first;
            if (sink >= backbone_len && nodes[sink] == target_seq) {
              match_i = int32_t(ei);
              break;
            }
          }
          if (match_i >= 0) {
            outgoing[match_i].second += 1.0f;
            previous_node = outgoing[match_i].first;
          } else {
            const int32_t nn = new_node(target_seq);
            insert_edge(previous_node, nn);
            previous_node = nn;
          }
        }
        ++target_i;
      }
      if (backbone_len - ref_i <= 10 && span_r) {
        if (previous_node >= 0 && previous_node < int32_t(ending.size()))
          ending[previous_node] = 1;
      }
      ++cigar_i;
    }
  }

  void adjust_weights(float c, float t) {
    for (auto& local : edges)
      for (auto& e : local) e.second -= std::max(c, t * e.second);
  }

  // anppoa.hpp:254-379 / poa.py consensus: heaviest path in float32, Kahn
  // topological order, first strictly-greater wins everywhere
  int64_t consensus(uint8_t* out) {
    const int32_t n_nodes = int32_t(nodes.size());
    std::vector<std::vector<std::pair<int32_t, float>>> incoming(n_nodes);
    for (int32_t src = 0; src < n_nodes; ++src)
      for (auto& e : edges[src]) incoming[e.first].emplace_back(src, e.second);
    std::vector<int32_t> indeg(n_nodes), topo;
    topo.reserve(n_nodes);
    for (int32_t n = 0; n < n_nodes; ++n)
      indeg[n] = int32_t(incoming[n].size());
    for (int32_t n = 0; n < n_nodes; ++n)
      if (indeg[n] == 0) topo.push_back(n);
    for (size_t qi = 0; qi < topo.size(); ++qi)
      for (auto& e : edges[topo[qi]])
        if (--indeg[e.first] == 0) topo.push_back(e.first);
    if (int32_t(topo.size()) < n_nodes) {
      // cycle (impossible for valid cigars): fall back to id order
      topo.clear();
      for (int32_t n = 0; n < n_nodes; ++n) topo.push_back(n);
    }
    std::vector<float> hw(n_nodes, 0.0f);
    std::vector<int32_t> hp(n_nodes, -1);
    for (int32_t node : topo) {
      const auto& inc = incoming[node];
      if (inc.empty()) continue;
      bool not_defined = true;
      float best_w = 0.0f;
      int32_t best_p = -1;
      for (auto& e : inc) {
        const float cand = hw[e.first] + e.second;
        if (not_defined || cand > best_w) {
          not_defined = false;
          best_w = cand;
          best_p = e.first;
        }
      }
      hw[node] = best_w;
      hp[node] = best_p;
    }
    int32_t h_node = 0;
    float h_weight = 0.0f;
    bool not_init = true;
    for (int32_t node = 0; node < n_nodes; ++node) {
      if (!ending[node]) continue;
      if (not_init || hw[node] > h_weight) {
        not_init = false;
        h_node = node;
        h_weight = hw[node];
      }
    }
    std::vector<int32_t> path;
    for (int32_t node = h_node; node != -1; node = hp[node])
      path.push_back(node);
    int64_t len = 0;
    for (auto it = path.rbegin(); it != path.rend(); ++it)
      if (nodes[*it] != 0) out[len++] = uint8_t(nodes[*it]);
    return len;
  }
};

}  // namespace

extern "C" {

// Batched PPOA consensus. Members are flat across tasks; task_off[t] ..
// task_off[t+1] index the member arrays. Each consensus is written at
// out + out_off[t] (caller-provided capacity = backbone + sum member seq
// lens per task) with its length in out_len[t].
void otter_poa_consensus_batch(
    const uint8_t* bbs, const int64_t* bb_off, const uint8_t* seqs,
    const int64_t* seq_off, const uint8_t* cigs, const int64_t* cig_off,
    const uint8_t* span_l, const uint8_t* span_r, const int64_t* task_off,
    const float* cvals, float tval, int64_t n_tasks, int32_t n_threads,
    uint8_t* out, const int64_t* out_off, int32_t* out_len) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int32_t t) {
    for (int64_t p = t; p < n_tasks; p += n_threads) {
      Poa poa;
      poa.init(bbs + bb_off[p], int32_t(bb_off[p + 1] - bb_off[p]));
      for (int64_t mi = task_off[p]; mi < task_off[p + 1]; ++mi) {
        poa.insert_alignment(seqs + seq_off[mi],
                             seq_off[mi + 1] - seq_off[mi],
                             cigs + cig_off[mi],
                             cig_off[mi + 1] - cig_off[mi],
                             span_l[mi] != 0, span_r[mi] != 0);
      }
      poa.adjust_weights(cvals[p], tval);
      out_len[p] = int32_t(poa.consensus(out + out_off[p]));
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Region read extraction: BAM record stream -> filtered AnRead columns.
// Ports src/anseqs.cpp get_breakpoints (:286-408) + parse_alignment
// (:412-435) + parse_anreads filters (:439-460) exactly as the python
// oracle (otter_tpu/seqs/breakpoints.py, seqs/extract.py). The nibble
// sequence is expanded ONLY for the extracted window.
// ---------------------------------------------------------------------------

namespace {

struct AnreadBatch {
  std::vector<char> names, seqs;
  std::vector<int64_t> name_off{0}, seq_off{0};
  std::vector<uint8_t> span_l, span_r;
  std::vector<int32_t> cc0, cc1, hp, ps;
  std::vector<double> rq;
  int32_t error = 0;  // 1 = inconsistent query coords (python raises)
};

constexpr int32_t kAuxAbsent = INT32_MIN;

// first numeric value of a 2-char tag, or fallback
bool aux_numeric(const uint8_t* p, const uint8_t* end, char t0, char t1,
                 double* out) {
  while (p + 3 <= end) {
    const char a = char(p[0]), b = char(p[1]), type = char(p[2]);
    const uint8_t* v = p + 3;
    int64_t vsize = aux_value_size(v, end, type);
    if (vsize < 0) return false;
    if (a == t0 && b == t1) {
      switch (type) {
        case 'c': { int8_t x; std::memcpy(&x, v, 1); *out = x; return true; }
        case 'C': { *out = v[0]; return true; }
        case 's': { int16_t x; std::memcpy(&x, v, 2); *out = x; return true; }
        case 'S': { uint16_t x; std::memcpy(&x, v, 2); *out = x; return true; }
        case 'i': { int32_t x; std::memcpy(&x, v, 4); *out = x; return true; }
        case 'I': { uint32_t x; std::memcpy(&x, v, 4); *out = x; return true; }
        case 'f': { float x; std::memcpy(&x, v, 4); *out = x; return true; }
        default: return false;  // non-numeric type: python returns None
      }
    }
    p = v + vsize;
  }
  return false;
}

struct BpMsg {
  bool successful = true;
  bool spanning_l = true;
  bool spanning_r = true;
  int64_t cc0 = -1, cc1 = -1;
};

// exact port of breakpoints.py::get_breakpoints; cigar = packed uint32 ops
bool get_breakpoints_c(int64_t start, int64_t end, int64_t pos,
                       int64_t l_qseq, const uint32_t* cigar, int64_t n_cigar,
                       BpMsg* msg, int64_t* qlo_out, int64_t* qhi_out) {
  bool clipped_l = false, clipped_r = false;
  int64_t qstart_dist = -1, qend_dist = -1;
  int64_t leftmost_q = -1, rightmost_q = -1;
  int64_t leftmost_r = -1, rightmost_r = -1;
  int64_t qstart_q = -1, qend_q = -1;
  int64_t qstart_cigar_i = 0, qend_cigar_i = 0;
  int64_t rpos = pos, qpos = 0;
  for (int64_t i = 0; i < n_cigar; ++i) {
    const int64_t ol = cigar[i] >> 4;
    const uint32_t op = cigar[i] & 0xF;
    if (op == 5 /*H*/ || op == 4 /*S*/) {
      if (i == 0) clipped_l = true;
      if (i == n_cigar - 1) clipped_r = true;
      if (op == 4) qpos += ol;
    } else if (op == 0 /*M*/ || op == 7 /*=*/ || op == 8 /*X*/) {
      if (leftmost_q == -1) {
        leftmost_q = qpos;
        leftmost_r = rpos;
      }
      const int64_t last_r = rpos + ol - 1;
      if (rightmost_q == -1 || last_r > rightmost_r) {
        rightmost_q = qpos + (last_r - rpos);
        rightmost_r = last_r;
      }
      if (last_r >= start) {
        const int64_t cand_r = rpos >= start ? rpos : start;
        const int64_t cstart_dist = cand_r - start;
        if (cstart_dist >= 0 && (qstart_dist < 0 || cstart_dist < qstart_dist)) {
          qstart_dist = cstart_dist;
          qstart_q = qpos + (cand_r - rpos);
          qstart_cigar_i = i;
        }
      }
      if (rpos <= end) {
        const int64_t cand_r = last_r <= end ? last_r : end;
        const int64_t cend_dist = end - cand_r;
        if (cend_dist >= 0 && (qend_dist < 0 || cend_dist < qend_dist)) {
          qend_dist = cend_dist;
          qend_q = qpos + (cand_r - rpos);
          qend_cigar_i = i;
        }
      }
      rpos += ol;
      qpos += ol;
    } else if (op == 1 /*I*/) {
      qpos += ol;
    } else if (op == 2 /*D*/) {
      rpos += ol;
    }
  }
  if (rightmost_r < start || leftmost_r > end) {
    msg->successful = false;
    msg->spanning_l = false;
    msg->spanning_r = false;
    return false;
  }
  if (qstart_q > -1 && qend_q > -1 && qstart_q > qend_q) {
    qstart_q = -1;
    qend_q = -1;
    msg->successful = true;
    msg->spanning_l = true;
    msg->spanning_r = true;
  } else {
    msg->cc0 = qstart_q;
    msg->cc1 = qend_q;
    if (leftmost_r > start && clipped_l && qstart_cigar_i == 1) {
      while (qstart_q > 0 && qstart_cigar_i > 0) {
        const int64_t ol = cigar[qstart_cigar_i - 1] >> 4;
        const uint32_t op = cigar[qstart_cigar_i - 1] & 0xF;
        if (op == 2) {
          --qstart_cigar_i;
        } else if (op == 5 || op == 4 || op == 1) {
          qstart_q -= ol;
          --qstart_cigar_i;
        } else {
          break;
        }
      }
    }
    // NOTE: the reference reads cigar[qend_cigar_i - 1] here (as written)
    if (rightmost_r < end && clipped_r && qend_cigar_i == n_cigar - 1) {
      while (qend_q < l_qseq - 1 && qend_cigar_i < n_cigar) {
        const int64_t ol = cigar[qend_cigar_i - 1] >> 4;
        const uint32_t op = cigar[qend_cigar_i - 1] & 0xF;
        if (op == 2) {
          ++qend_cigar_i;
        } else if (op == 5 || op == 4 || op == 1) {
          qend_q += ol;
          ++qend_cigar_i;
        } else {
          break;
        }
      }
    }
    msg->spanning_l = leftmost_q >= 0 && leftmost_r <= start;
    msg->spanning_r = rightmost_q >= 0 && rightmost_r >= end;
    msg->successful = true;
  }
  if (msg->spanning_l && msg->spanning_r) {
    *qlo_out = qstart_q;
    *qhi_out = qend_q;
  } else if (msg->spanning_l) {
    *qlo_out = qstart_q;
    *qhi_out = l_qseq;
  } else if (msg->spanning_r) {
    *qlo_out = 0;
    *qhi_out = qend_q;
  } else {
    *qlo_out = 0;
    *qhi_out = l_qseq;
  }
  return true;
}

}  // namespace

extern "C" {

// Parse + filter + extract AnReads for one region from a raw record stream.
// Returns an opaque handle (query/free with the accessors below).
void* otter_anreads_parse(const uint8_t* buf, int64_t size, int32_t tid,
                          int64_t qstart, int64_t qend, int64_t bstart,
                          int64_t bend, int32_t mapq_min, int32_t nonprimary,
                          int32_t omitnonspanning, double read_quality) {
  auto* out = new AnreadBatch();
  std::vector<uint32_t> cig_exp;
  std::vector<char> seqbuf;
  int64_t off = 0;
  while (off + 4 <= size) {
    uint32_t block_size;
    std::memcpy(&block_size, buf + off, 4);
    off += 4;
    if (off + block_size > size || block_size < 32) break;
    const uint8_t* r = buf + off;
    off += block_size;
    int32_t ref_id, pos, l_seq;
    std::memcpy(&ref_id, r, 4);
    std::memcpy(&pos, r + 4, 4);
    const uint8_t l_read_name = r[8];
    const int32_t mapq = r[9];
    uint16_t n_cigar_op, flag16;
    std::memcpy(&n_cigar_op, r + 12, 2);
    std::memcpy(&flag16, r + 14, 2);
    std::memcpy(&l_seq, r + 16, 4);
    if (ref_id != tid) continue;
    if (flag16 & 0x4 /*unmapped*/) continue;
    if (mapq < mapq_min) continue;
    if (!nonprimary && (flag16 & 0x900)) continue;
    const uint8_t* p = r + 32;
    const char* name = reinterpret_cast<const char*>(p);
    const int64_t name_len = l_read_name - 1;
    p += l_read_name;
    const uint32_t* cig = reinterpret_cast<const uint32_t*>(p);
    int64_t n_cig = n_cigar_op;
    p += 4 * n_cigar_op;
    const uint8_t* nyb = p;
    p += (l_seq + 1) / 2 + l_seq;  // + qual
    const uint8_t* aux_end = r + block_size;
    // CG long-cigar expansion (same rule as the feeder)
    bool placeholder = n_cig == 2 && (cig[0] & 0xF) == 4 &&
                       int32_t(cig[0] >> 4) == l_seq && (cig[1] & 0xF) == 3;
    if (placeholder) {
      CgTag cg = find_cg_tag(p, aux_end);
      if (cg.ops) {
        cig_exp.assign(reinterpret_cast<const uint32_t*>(cg.ops),
                       reinterpret_cast<const uint32_t*>(cg.ops) + cg.count);
        cig = cig_exp.data();
        n_cig = cg.count;
      }
    }
    // region overlap on ref span (the fetch filter, io/bam.py)
    int64_t refspan = 0;
    for (int64_t i = 0; i < n_cig; ++i) {
      const uint32_t op = cig[i] & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        refspan += cig[i] >> 4;
    }
    if (!(pos < qend && pos + refspan > qstart)) continue;
    // breakpoints + extraction (parse_alignment semantics)
    BpMsg msg;
    int64_t qlo = 0, qhi = 0;
    get_breakpoints_c(bstart, bend, pos, l_seq, cig, n_cig, &msg, &qlo, &qhi);
    if (!msg.successful) continue;
    if ((qlo == -1) != (qhi == -1)) {
      out->error = 1;
      // record the offending name for the python-side error message
      out->names.assign(name, name + name_len);
      return out;
    }
    const bool spanning = msg.spanning_l && msg.spanning_r;
    if (omitnonspanning && !spanning) continue;
    double rqv = 0.0;
    const bool has_rq = aux_numeric(p, aux_end, 'r', 'q', &rqv);
    if ((has_rq ? rqv : 0.0) < read_quality) continue;
    // transfer_status (breakpoints.py): final flags equal (sl, sr)
    // coords adjustment (parse_alignment)
    int64_t cc0 = msg.cc0, cc1 = msg.cc1;
    if (qlo == -1 || l_seq < (qhi - qlo)) {
      out->seqs.push_back('N');
    } else {
      const int64_t l_og = cc1 - cc0;
      cc0 = cc0 - qlo;
      cc1 = cc0 + l_og;
      if (qhi > qlo) {
        const size_t s0 = out->seqs.size();
        out->seqs.resize(s0 + (qhi - qlo));
        for (int64_t i = qlo; i < qhi; ++i) {
          const uint8_t byte = nyb[i >> 1];
          out->seqs[s0 + (i - qlo)] =
              kNt16[(i & 1) ? (byte & 0xF) : (byte >> 4)];
        }
      } else {
        out->seqs.push_back('N');
      }
    }
    out->seq_off.push_back(int64_t(out->seqs.size()));
    out->names.insert(out->names.end(), name, name + name_len);
    out->name_off.push_back(int64_t(out->names.size()));
    out->span_l.push_back(msg.spanning_l ? 1 : 0);
    out->span_r.push_back(msg.spanning_r ? 1 : 0);
    out->cc0.push_back(int32_t(cc0));
    out->cc1.push_back(int32_t(cc1));
    out->rq.push_back(has_rq ? rqv : -1e300);  // sentinel: tag absent
    double v;
    out->hp.push_back(aux_numeric(p, aux_end, 'H', 'P', &v) ? int32_t(v)
                                                            : kAuxAbsent);
    out->ps.push_back(aux_numeric(p, aux_end, 'P', 'S', &v) ? int32_t(v)
                                                            : kAuxAbsent);
  }
  return out;
}

int64_t otter_anreads_count(void* h) {
  auto* b = static_cast<AnreadBatch*>(h);
  if (b->error) return -1;
  return int64_t(b->span_l.size());
}

int64_t otter_anreads_blob_sizes(void* h, int64_t* names, int64_t* seqs) {
  auto* b = static_cast<AnreadBatch*>(h);
  *names = int64_t(b->names.size());
  *seqs = int64_t(b->seqs.size());
  return 0;
}

void otter_anreads_export(void* h, char* names, int64_t* name_off, char* seqs,
                          int64_t* seq_off, uint8_t* span_l, uint8_t* span_r,
                          int32_t* cc0, int32_t* cc1, double* rq, int32_t* hp,
                          int32_t* ps) {
  auto* b = static_cast<AnreadBatch*>(h);
  const size_t n = b->span_l.size();
  std::memcpy(names, b->names.data(), b->names.size());
  std::memcpy(name_off, b->name_off.data(), (n + 1) * 8);
  std::memcpy(seqs, b->seqs.data(), b->seqs.size());
  std::memcpy(seq_off, b->seq_off.data(), (n + 1) * 8);
  std::memcpy(span_l, b->span_l.data(), n);
  std::memcpy(span_r, b->span_r.data(), n);
  std::memcpy(cc0, b->cc0.data(), n * 4);
  std::memcpy(cc1, b->cc1.data(), n * 4);
  std::memcpy(rq, b->rq.data(), n * 8);
  std::memcpy(hp, b->hp.data(), n * 4);
  std::memcpy(ps, b->ps.data(), n * 4);
}

void otter_anreads_error_name(void* h, char* name, int64_t cap) {
  auto* b = static_cast<AnreadBatch*>(h);
  const int64_t n = std::min<int64_t>(cap - 1, int64_t(b->names.size()));
  std::memcpy(name, b->names.data(), n);
  name[n] = 0;
}

void otter_anreads_free(void* h) { delete static_cast<AnreadBatch*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Average-linkage NN-chain hierarchical clustering (hclust-cpp semantics).
//
// Exact float64 parity with otter_tpu/ops/hclust.py::nn_chain_average_ref +
// to_r_dendrogram (itself a port of include/hclust-cpp NN_chain_core +
// generate_R_dendrogram<false> as used by src/otterclust.cpp:182,336): same
// linked-list scan order (lowest-index nearest neighbour wins ties), same
// Lance-Williams average update written as two explicit products plus an
// add (the build uses -ffp-contract=off so no FMA contraction can change
// the rounding vs numpy), same stable sort by height and union-find
// R-convention relabeling. Threaded batch variant for the cohort genotype
// path (one matrix per region, n = 2*samples+1).
// ---------------------------------------------------------------------------

namespace hclust_nn {

static void hclust_one(const double* cond, int32_t n,
                       int64_t* merge, double* height) {
  if (n < 2) return;
  const size_t ncond = size_t(n) * (n - 1) / 2;
  std::vector<double> D(cond, cond + ncond);
  std::vector<double> members(n, 1.0);
  std::vector<int32_t> succ(n), pred(n);
  for (int32_t i = 0; i < n; ++i) { succ[i] = i + 1; pred[i] = i - 1; }
  int32_t start = 0;
  auto didx = [n](int32_t a, int32_t b) -> size_t {
    if (a > b) std::swap(a, b);
    return ((size_t(2 * n - 3 - a) * a) >> 1) + b - 1;
  };
  std::vector<int32_t> m1v, m2v;
  std::vector<double> mh;
  m1v.reserve(n - 1); m2v.reserve(n - 1); mh.reserve(n - 1);
  std::vector<int32_t> chain(n);
  int32_t tip = 0, idx1 = 0, idx2 = 0;
  double mind = 0.0;
  for (int32_t it = 0; it < n - 1; ++it) {
    if (tip <= 3) {
      idx1 = start;
      chain[0] = idx1;
      tip = 1;
      idx2 = succ[idx1];
      mind = D[didx(idx1, idx2)];
      for (int32_t i = succ[idx2]; i < n; i = succ[i]) {
        const double d = D[didx(idx1, i)];
        if (d < mind) { mind = d; idx2 = i; }
      }
    } else {
      tip -= 3;
      idx1 = chain[tip - 1];
      idx2 = chain[tip];
      mind = D[didx(idx1, idx2)];
    }
    for (;;) {
      chain[tip] = idx2;
      for (int32_t i = start; i < idx2; i = succ[i]) {
        const double d = D[didx(i, idx2)];
        if (d < mind) { mind = d; idx1 = i; }
      }
      for (int32_t i = succ[idx2]; i < n; i = succ[i]) {
        const double d = D[didx(idx2, i)];
        if (d < mind) { mind = d; idx1 = i; }
      }
      idx2 = idx1;
      idx1 = chain[tip];
      tip += 1;
      if (idx2 == chain[tip - 2]) break;
    }
    m1v.push_back(idx1); m2v.push_back(idx2); mh.push_back(mind);
    if (idx1 > idx2) std::swap(idx1, idx2);
    const double size1 = members[idx1], size2 = members[idx2];
    members[idx2] += members[idx1];
    {  // unlink idx1 from the active list
      const int32_t p = pred[idx1], s = succ[idx1];
      if (p < 0) start = s; else succ[p] = s;
      if (s < n) pred[s] = p;
    }
    const double s = size1 / (size1 + size2);
    const double t = size2 / (size1 + size2);
    int32_t i = start;
    for (; i < idx1; i = succ[i]) {
      const size_t kk = didx(i, idx2);
      const double x = s * D[didx(i, idx1)];
      const double y = t * D[kk];
      D[kk] = x + y;
    }
    for (; i < idx2; i = succ[i]) {
      const size_t kk = didx(i, idx2);
      const double x = s * D[didx(idx1, i)];
      const double y = t * D[kk];
      D[kk] = x + y;
    }
    for (i = succ[idx2]; i < n; i = succ[i]) {
      const size_t kk = didx(idx2, i);
      const double x = s * D[didx(idx1, i)];
      const double y = t * D[kk];
      D[kk] = x + y;
    }
  }
  // R-convention output: stable sort by height, union-find relabel
  const int32_t nm = n - 1;
  std::vector<int32_t> order(nm);
  for (int32_t i = 0; i < nm; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return mh[a] < mh[b]; });
  std::vector<int32_t> parent(2 * n - 1);
  for (int32_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
  auto findroot = [&](int32_t x) -> int32_t {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) { const int32_t nx = parent[x]; parent[x] = root; x = nx; }
    return root;
  };
  int32_t next_cluster = n;
  for (int32_t oi = 0; oi < nm; ++oi) {
    const int32_t mi = order[oi];
    int32_t node1 = findroot(m1v[mi]);
    int32_t node2 = findroot(m2v[mi]);
    parent[node1] = next_cluster;
    parent[node2] = next_cluster;
    ++next_cluster;
    if (node1 > node2) std::swap(node1, node2);
    merge[size_t(oi) * 2 + 0] =
        node1 < n ? -int64_t(node1 + 1) : int64_t(node1 - n + 1);
    merge[size_t(oi) * 2 + 1] =
        node2 < n ? -int64_t(node2 + 1) : int64_t(node2 - n + 1);
    height[oi] = mh[mi];
  }
}

// Square-layout variant for cohort-scale matrices (n >= ~256): identical
// arithmetic, scan order and tie behavior to hclust_one — every D access
// reads the symmetric full matrix via the CURRENT row, so the condensed
// layout's strided column walks (the wall at n = 1001, ~6 cache misses per
// active index) become contiguous row streams. Lance-Williams writes keep
// both mirrors in sync; each written value is the same x + y double, so
// all comparisons (and hence merges/heights) are bit-identical.
static void hclust_one_sq(const double* cond, int32_t n,
                          int64_t* merge, double* height) {
  if (n < 2) return;
  std::vector<double> D(size_t(n) * n, 0.0);
  {
    size_t p = 0;
    for (int32_t a = 0; a < n; ++a) {
      double* row = D.data() + size_t(a) * n;
      for (int32_t b = a + 1; b < n; ++b, ++p) {
        row[b] = cond[p];
        D[size_t(b) * n + a] = cond[p];
      }
    }
  }
  std::vector<double> members(n, 1.0);
  std::vector<int32_t> succ(n), pred(n);
  for (int32_t i = 0; i < n; ++i) { succ[i] = i + 1; pred[i] = i - 1; }
  int32_t start = 0;
  std::vector<int32_t> m1v, m2v;
  std::vector<double> mh;
  m1v.reserve(n - 1); m2v.reserve(n - 1); mh.reserve(n - 1);
  std::vector<int32_t> chain(n);
  int32_t tip = 0, idx1 = 0, idx2 = 0;
  double mind = 0.0;
  for (int32_t it = 0; it < n - 1; ++it) {
    if (tip <= 3) {
      idx1 = start;
      chain[0] = idx1;
      tip = 1;
      idx2 = succ[idx1];
      const double* r1 = D.data() + size_t(idx1) * n;
      mind = r1[idx2];
      for (int32_t i = succ[idx2]; i < n; i = succ[i]) {
        const double d = r1[i];
        if (d < mind) { mind = d; idx2 = i; }
      }
    } else {
      tip -= 3;
      idx1 = chain[tip - 1];
      idx2 = chain[tip];
      mind = D[size_t(idx1) * n + idx2];
    }
    for (;;) {
      chain[tip] = idx2;
      const double* r2 = D.data() + size_t(idx2) * n;
      for (int32_t i = start; i < idx2; i = succ[i]) {
        const double d = r2[i];
        if (d < mind) { mind = d; idx1 = i; }
      }
      for (int32_t i = succ[idx2]; i < n; i = succ[i]) {
        const double d = r2[i];
        if (d < mind) { mind = d; idx1 = i; }
      }
      idx2 = idx1;
      idx1 = chain[tip];
      tip += 1;
      if (idx2 == chain[tip - 2]) break;
    }
    m1v.push_back(idx1); m2v.push_back(idx2); mh.push_back(mind);
    if (idx1 > idx2) std::swap(idx1, idx2);
    const double size1 = members[idx1], size2 = members[idx2];
    members[idx2] += members[idx1];
    {
      const int32_t p = pred[idx1], s = succ[idx1];
      if (p < 0) start = s; else succ[p] = s;
      if (s < n) pred[s] = p;
    }
    const double s = size1 / (size1 + size2);
    const double t = size2 / (size1 + size2);
    const double* r1 = D.data() + size_t(idx1) * n;
    double* r2 = D.data() + size_t(idx2) * n;
    for (int32_t i = start; i < n; i = succ[i]) {
      if (i == idx2) continue;
      const double x = s * r1[i];
      const double y = t * r2[i];
      const double v = x + y;
      r2[i] = v;
      D[size_t(i) * n + idx2] = v;
    }
  }
  const int32_t nm = n - 1;
  std::vector<int32_t> order(nm);
  for (int32_t i = 0; i < nm; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return mh[a] < mh[b]; });
  std::vector<int32_t> parent(2 * n - 1);
  for (int32_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
  auto findroot = [&](int32_t x) -> int32_t {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) { const int32_t nx = parent[x]; parent[x] = root; x = nx; }
    return root;
  };
  int32_t next_cluster = n;
  for (int32_t oi = 0; oi < nm; ++oi) {
    const int32_t mi = order[oi];
    int32_t node1 = findroot(m1v[mi]);
    int32_t node2 = findroot(m2v[mi]);
    parent[node1] = next_cluster;
    parent[node2] = next_cluster;
    ++next_cluster;
    if (node1 > node2) std::swap(node1, node2);
    merge[size_t(oi) * 2 + 0] =
        node1 < n ? -int64_t(node1 + 1) : int64_t(node1 - n + 1);
    merge[size_t(oi) * 2 + 1] =
        node2 < n ? -int64_t(node2 + 1) : int64_t(node2 - n + 1);
    height[oi] = mh[mi];
  }
}

static void hclust_dispatch(const double* cond, int32_t n,
                            int64_t* merge, double* height) {
  if (n >= 256) {
    hclust_one_sq(cond, n, merge, height);
  } else {
    hclust_one(cond, n, merge, height);
  }
}

}  // namespace hclust_nn

extern "C" {

void otter_hclust_average(const double* condensed, int32_t n,
                          int64_t* merge, double* height) {
  hclust_nn::hclust_dispatch(condensed, n, merge, height);
}

// Batch over matrices: condensed_all holds each matrix's condensed values
// back to back (offsets[i]..offsets[i+1]); merge/height outputs are likewise
// concatenated ((ns[i]-1)*2 and ns[i]-1 entries per matrix).
void otter_hclust_average_batch(const double* condensed_all,
                                const int64_t* cond_off, const int32_t* ns,
                                int32_t n_mats, int64_t* merge_all,
                                const int64_t* merge_off, double* height_all,
                                const int64_t* height_off,
                                int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int32_t t) {
    for (int32_t b = t; b < n_mats; b += n_threads) {
      hclust_nn::hclust_dispatch(condensed_all + cond_off[b], ns[b],
                                 merge_all + merge_off[b],
                                 height_all + height_off[b]);
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

// cutree_k (fastcluster.cpp cutree_k semantics, the exact port of
// ops/hclust.py::cutree_k): labels 0..nclust-1 from the R-convention merge
// matrix; all-zero when nclust > n or nclust < 2.
void otter_cutree_k(int32_t n, const int64_t* merge, int32_t nclust,
                    int64_t* labels) {
  for (int32_t i = 0; i < n; ++i) labels[i] = 0;
  if (nclust > n || nclust < 2) return;
  std::vector<int64_t> last_merge(n, 0);
  for (int32_t k = 1; k <= n - nclust; ++k) {
    int64_t m1 = merge[(k - 1) * 2];
    int64_t m2 = merge[(k - 1) * 2 + 1];
    if (m1 < 0 && m2 < 0) {
      last_merge[-m1 - 1] = k;
      last_merge[-m2 - 1] = k;
    } else if (m1 < 0 || m2 < 0) {
      int64_t j;
      if (m1 < 0) { j = -m1; m1 = m2; } else { j = -m2; }
      for (int32_t i = 0; i < n; ++i)
        if (last_merge[i] == m1) last_merge[i] = k;
      last_merge[j - 1] = k;
    } else {
      for (int32_t i = 0; i < n; ++i)
        if (last_merge[i] == m1 || last_merge[i] == m2) last_merge[i] = k;
    }
  }
  int64_t label = 0;
  std::vector<int64_t> z(n, -1);
  for (int32_t j = 0; j < n; ++j) {
    int64_t lm = last_merge[j];
    if (lm == 0) {
      labels[j] = label++;
    } else {
      if (z[lm] < 0) z[lm] = label++;
      labels[j] = z[lm];
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Genotype allele feeder: raw BAM record stream -> per-record seq + RG +
// the ta/tc/ac/sc/PS/HP/se/ic tags (seqs/extract.py::parse_anallele,
// reference anseqs.cpp:462-511). Region overlap matches io/bam.py::fetch
// (pos < qend, ref_end > qstart, mapped); records whose ta tag differs
// from the target region string are dropped here, exactly like the python
// walk. Record order is stream order (== fetch order).
// ---------------------------------------------------------------------------

namespace {

struct AnalleleBatch {
  std::vector<char> seqs, rgs;
  std::vector<int64_t> seq_off{0}, rg_off{0};
  std::vector<int32_t> tc, ac, sc, ps, hp, ic;
  std::vector<double> se;
  std::vector<uint8_t> has_se;
};

// first string value of a 2-char tag (types Z and A), python's
// isinstance(v, str) gate
bool aux_string(const uint8_t* p, const uint8_t* end, char t0, char t1,
                const char** sp, int64_t* slen) {
  while (p + 3 <= end) {
    const char a = char(p[0]), b = char(p[1]), type = char(p[2]);
    const uint8_t* v = p + 3;
    int64_t vsize = aux_value_size(v, end, type);
    if (vsize < 0) return false;
    if (a == t0 && b == t1) {
      if (type == 'Z') {
        *sp = reinterpret_cast<const char*>(v);
        *slen = vsize - 1;  // strip NUL
        return true;
      }
      if (type == 'A') {
        *sp = reinterpret_cast<const char*>(v);
        *slen = 1;
        return true;
      }
      return false;  // numeric type: python's isinstance(str) is False
    }
    p = v + vsize;
  }
  return false;
}

}  // namespace

extern "C" {

void* otter_analleles_parse(const uint8_t* buf, int64_t size, int32_t tid,
                            int64_t qstart, int64_t qend,
                            const char* target, int64_t target_len) {
  auto* out = new AnalleleBatch();
  std::vector<uint32_t> cig_exp;
  int64_t off = 0;
  while (off + 4 <= size) {
    uint32_t block_size;
    std::memcpy(&block_size, buf + off, 4);
    off += 4;
    if (off + block_size > size || block_size < 32) break;
    const uint8_t* r = buf + off;
    off += block_size;
    int32_t ref_id, pos, l_seq;
    std::memcpy(&ref_id, r, 4);
    std::memcpy(&pos, r + 4, 4);
    const uint8_t l_read_name = r[8];
    uint16_t n_cigar_op, flag16;
    std::memcpy(&n_cigar_op, r + 12, 2);
    std::memcpy(&flag16, r + 14, 2);
    std::memcpy(&l_seq, r + 16, 4);
    if (ref_id != tid) continue;
    if (flag16 & 0x4) continue;
    const uint8_t* p = r + 32;
    p += l_read_name;
    const uint32_t* cig = reinterpret_cast<const uint32_t*>(p);
    int64_t n_cig = n_cigar_op;
    p += 4 * n_cigar_op;
    const uint8_t* nyb = p;
    p += (l_seq + 1) / 2 + l_seq;  // + qual
    const uint8_t* aux_end = r + block_size;
    bool placeholder = n_cig == 2 && (cig[0] & 0xF) == 4 &&
                       int32_t(cig[0] >> 4) == l_seq && (cig[1] & 0xF) == 3;
    if (placeholder) {
      CgTag cg = find_cg_tag(p, aux_end);
      if (cg.ops) {
        cig_exp.assign(reinterpret_cast<const uint32_t*>(cg.ops),
                       reinterpret_cast<const uint32_t*>(cg.ops) + cg.count);
        cig = cig_exp.data();
        n_cig = cg.count;
      }
    }
    int64_t refspan = 0;
    for (int64_t i = 0; i < n_cig; ++i) {
      const uint32_t op = cig[i] & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        refspan += cig[i] >> 4;
    }
    if (!(pos < qend && pos + refspan > qstart)) continue;
    // ta tag must equal the target region string
    const char* ta = nullptr;
    int64_t ta_len = 0;
    if (!aux_string(p, aux_end, 't', 'a', &ta, &ta_len)) {
      if (target_len != 0) continue;  // parsed_region "" != target
    } else if (ta_len != target_len ||
               std::memcmp(ta, target, size_t(target_len)) != 0) {
      continue;
    }
    // RG sample name ("" when absent, python errors upstream on unknown)
    const char* rg = nullptr;
    int64_t rg_len = 0;
    aux_string(p, aux_end, 'R', 'G', &rg, &rg_len);
    if (rg_len) out->rgs.insert(out->rgs.end(), rg, rg + rg_len);
    out->rg_off.push_back(int64_t(out->rgs.size()));
    // seq ("N" when empty)
    if (l_seq == 0) {
      out->seqs.push_back('N');
    } else {
      const size_t s0 = out->seqs.size();
      out->seqs.resize(s0 + size_t(l_seq));
      for (int32_t i = 0; i < l_seq; ++i) {
        const uint8_t code = (i & 1) ? (nyb[i >> 1] & 0xF) : (nyb[i >> 1] >> 4);
        out->seqs[s0 + i] = kNt16[code];
      }
    }
    out->seq_off.push_back(int64_t(out->seqs.size()));
    double v = 0.0;
    out->tc.push_back(aux_numeric(p, aux_end, 't', 'c', &v) ? int32_t(v) : 1);
    out->ac.push_back(aux_numeric(p, aux_end, 'a', 'c', &v) ? int32_t(v) : 1);
    out->sc.push_back(aux_numeric(p, aux_end, 's', 'c', &v) ? int32_t(v) : 1);
    out->ps.push_back(aux_numeric(p, aux_end, 'P', 'S', &v) ? int32_t(v)
                                                            : -1);
    out->hp.push_back(aux_numeric(p, aux_end, 'H', 'P', &v) ? int32_t(v)
                                                            : -1);
    out->ic.push_back(aux_numeric(p, aux_end, 'i', 'c', &v) ? int32_t(v) : 1);
    const bool hs = aux_numeric(p, aux_end, 's', 'e', &v);
    out->se.push_back(hs ? v : 0.0);
    out->has_se.push_back(hs ? 1 : 0);
  }
  return out;
}

int64_t otter_analleles_count(void* h) {
  return int64_t(static_cast<AnalleleBatch*>(h)->tc.size());
}

void otter_analleles_blob_sizes(void* h, int64_t* seq_total,
                                int64_t* rg_total) {
  auto* b = static_cast<AnalleleBatch*>(h);
  *seq_total = int64_t(b->seqs.size());
  *rg_total = int64_t(b->rgs.size());
}

void otter_analleles_columns(void* h, int32_t* tc, int32_t* ac, int32_t* sc,
                             int32_t* ps, int32_t* hp, int32_t* ic,
                             double* se, int64_t* seq_off, int64_t* rg_off,
                             char* seqs, char* rgs) {
  auto* b = static_cast<AnalleleBatch*>(h);
  const size_t n = b->tc.size();
  std::memcpy(tc, b->tc.data(), n * 4);
  std::memcpy(ac, b->ac.data(), n * 4);
  std::memcpy(sc, b->sc.data(), n * 4);
  std::memcpy(ps, b->ps.data(), n * 4);
  std::memcpy(hp, b->hp.data(), n * 4);
  std::memcpy(ic, b->ic.data(), n * 4);
  std::memcpy(se, b->se.data(), n * 8);
  std::memcpy(seq_off, b->seq_off.data(), (n + 1) * 8);
  std::memcpy(rg_off, b->rg_off.data(), (n + 1) * 8);
  if (!b->seqs.empty()) std::memcpy(seqs, b->seqs.data(), b->seqs.size());
  if (!b->rgs.empty()) std::memcpy(rgs, b->rgs.data(), b->rgs.size());
}

void otter_analleles_free(void* h) { delete static_cast<AnalleleBatch*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// K-mer counting (seqs/kmer.py::seq2kcounts_np oracle; reference scalar loop
// anseqs.cpp:149-166): per sequence, base-4 big-endian k-mer indices with
// any invalid base routing the window to the 4^k bucket. Counts are small
// integers in float64 -> bit-identical to the python/numpy path.
// ---------------------------------------------------------------------------

extern "C" {

void otter_kcounts(const uint8_t* blob, const int64_t* offs, int32_t n_seqs,
                   int32_t k, int32_t n_threads, double* out) {
  if (n_threads < 1) n_threads = 1;
  int64_t width = 1;
  for (int32_t i = 0; i < k; ++i) width *= 4;
  const int64_t max_index = width;
  width += 1;
  uint8_t code_of[256];
  std::memset(code_of, 4, sizeof(code_of));
  code_of['A'] = 0; code_of['a'] = 0; code_of['C'] = 1; code_of['c'] = 1;
  code_of['G'] = 2; code_of['g'] = 2; code_of['T'] = 3; code_of['t'] = 3;
  auto worker = [&](int32_t t) {
    for (int32_t s = t; s < n_seqs; s += n_threads) {
      const uint8_t* p = blob + offs[s];
      const int64_t n = offs[s + 1] - offs[s];
      double* row = out + int64_t(s) * width;
      std::memset(row, 0, sizeof(double) * width);
      if (n < k) continue;
      for (int64_t j = 0; j + k <= n; ++j) {
        int64_t idx = 0;
        bool bad = false;
        for (int32_t q = 0; q < k; ++q) {
          const uint8_t c = code_of[p[j + q]];
          if (c >= 4) { bad = true; }
          idx = idx * 4 + (c >= 4 ? 0 : c);
        }
        row[bad ? max_index : idx] += 1.0;
      }
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sequence-pool 2-bit packer (myers_pallas.py::pack_pool_2bit oracle): each
// unique sequence becomes one (n_words_pool,) row, char j -> bits
// 2(j%16)..+1 of word j/16, padding packs as 'A' = 0. Used by the pool
// Myers dispatch (dedup H2D for all-vs-all pair sets).
// ---------------------------------------------------------------------------

extern "C" {

void otter_pack_pool_2bit(const uint8_t* buf, const int64_t* offs,
                          int32_t n_seqs, int32_t n_words_pool,
                          int32_t n_threads, uint32_t* out) {
  if (n_threads < 1) n_threads = 1;
  uint8_t code_of[256];
  std::memset(code_of, 0, sizeof(code_of));
  code_of['A'] = 0; code_of['C'] = 1; code_of['G'] = 2; code_of['T'] = 3;
  auto worker = [&](int32_t t) {
    for (int32_t s = t; s < n_seqs; s += n_threads) {
      const uint8_t* p = buf + offs[s];
      const int32_t n = int32_t(offs[s + 1] - offs[s]);
      uint32_t* row = out + int64_t(s) * n_words_pool;
      // fail safe like the numpy oracle: a sequence longer than
      // n_words_pool*16 is truncated instead of overflowing the next row
      const int32_t n_words = std::min((n + 15) / 16, n_words_pool);
      for (int32_t w = 0; w < n_words; ++w) {
        uint32_t acc = 0;
        const int32_t hi = std::min(n, (w + 1) * 16);
        for (int32_t j = w * 16; j < hi; ++j)
          acc |= uint32_t(code_of[p[j]]) << (2 * (j % 16));
        row[w] = acc;
      }
    }
  };
  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Condensed-space medoid row sums (reference andistmat.cpp:36-50; python
// oracle ops/distmat.py::DistMatrix.get_medoid). Computes, for every member
// of a cluster, the f64 row sum over the cluster's other members DIRECTLY
// from the condensed upper-triangle vector — no (n, n) square is ever
// materialized (the old to_square dominated the 1001-allele cohort medoid
// remap, VERDICT r4 #5). Accumulation starts at 0.0 and adds in the given
// member order, the exact addition order of the scalar reference loop and
// of the numpy cumsum path; the argmin (incl. numpy's NaN propagation)
// stays in python over the returned sums.
// ---------------------------------------------------------------------------

extern "C" {

void otter_medoid_sums(const double* vals, int64_t n, const int64_t* idx,
                       int64_t m, int32_t n_threads, double* out_sums) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int32_t t) {
    for (int64_t a = t; a < m; a += n_threads) {
      const int64_t i = idx[a];
      double s = 0.0;
      for (int64_t b = 0; b < m; ++b) {
        const int64_t j = idx[b];
        if (i == j) continue;  // exact +0.0 in the numpy path: same sum
        const int64_t lo = i < j ? i : j;
        const int64_t hi = i < j ? j : i;
        s += vals[((2 * n - 3 - lo) * lo >> 1) + hi - 1];
      }
      out_sums[a] = s;
    }
  };
  // thread spawn costs ~100 us each — only worth it when the O(m^2)
  // gather-sum dwarfs it (m >= 512 ~ 260k+ condensed reads). n_threads
  // MUST drop to 1 before the single call: worker strides by it
  if (n_threads == 1 || m < 512) {
    n_threads = 1;
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Condensed cosine-dissimilarity gather+round (ops/cluster.py::
// kusage_cosine_condensed oracle; reference otterclust.cpp:402-420): from a
// pre-round scaled (n, n) similarity matrix and allele norms, produce the
// condensed 1 - round3(cos) matrix in one threaded pass. Entries within
// ``guard`` of a .5 rounding boundary are NOT resolved here — their
// condensed positions are returned so python can recompute them with the
// np.dot oracle (bit-exactness of that dot is numpy's, not ours). Per-entry
// arithmetic (floor(sv+0.5) / ceil(sv-0.5), /1000.0, NaN-norm -> sim 0.0,
// 1.0 - sim) matches the numpy expressions bit for bit.
// ---------------------------------------------------------------------------

extern "C" {

int64_t otter_cosine_condensed(const double* scaled, const double* norms,
                               int64_t n, double guard, int32_t n_threads,
                               double* out, int64_t* near_pos,
                               int64_t near_cap, int32_t prescaled) {
  if (n_threads < 1) n_threads = 1;
  const int64_t total = n * (n - 1) / 2;
  std::atomic<int64_t> near_count(0);
  auto worker = [&](int32_t t) {
    // contiguous condensed ranges per thread; (i, j) recovered by walking
    int64_t lo = total * t / n_threads;
    int64_t hi = total * (t + 1) / n_threads;
    if (lo >= hi) return;
    // find row i of condensed position lo
    int64_t i = 0, row_start = 0;
    while (row_start + (n - 1 - i) <= lo) {
      row_start += n - 1 - i;
      ++i;
    }
    int64_t j = i + 1 + (lo - row_start);
    for (int64_t p = lo; p < hi; ++p) {
      // prescaled = 0: the raw GEMM dot is divided/scaled here, the same
      // elementwise f64 ops ( /(ni*nj), *1000.0 ) the python path applies
      // to the whole matrix — skipping two full-matrix numpy passes
      const double sv = prescaled
          ? scaled[i * n + j]
          : scaled[i * n + j] / (norms[i] * norms[j]) * 1000.0;
      if (std::isfinite(sv)
          && std::fabs(std::fabs(sv - std::floor(sv)) - 0.5) < guard) {
        const int64_t slot = near_count.fetch_add(1);
        if (slot < near_cap) near_pos[slot] = p;
      }
      double sim = (sv >= 0 ? std::floor(sv + 0.5) : std::ceil(sv - 0.5))
                   / 1000.0;
      if (std::isnan(norms[i] * norms[j])) sim = 0.0;
      out[p] = 1.0 - sim;
      if (++j == n) {
        ++i;
        j = i + 1;
      }
    }
  };
  if (n_threads == 1 || total < 4096) {
    n_threads = 1;
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  return near_count.load();
}

}  // extern "C"
