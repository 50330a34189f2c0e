// Device helpers shared by the Myers kernels (myers.cu, myers_striped.cu,
// myers_banded.cu): the pattern's bit planes from the 2-bit pool, and one
// 64-bit word of Myers/Hyyro's column step with its carries.

#pragma once

#include <cstdint>

namespace otter {

// 64 pattern chars (pool words 4w..4w+3, 16 chars each) as two bit planes:
// bit i of lo (hi) is bit 0 (1) of the 2-bit code of char 64 w + i.
__device__ __forceinline__ void pattern_word(const uint32_t* prow, int w,
                                             uint64_t& lo, uint64_t& hi) {
  lo = 0;
  hi = 0;
  for (int q = 0; q < 4; ++q) {
    const uint32_t pw = prow[4 * w + q];
    for (int i = 0; i < 16; ++i) {
      lo |= static_cast<uint64_t>((pw >> (2 * i)) & 1u) << (16 * q + i);
      hi |= static_cast<uint64_t>((pw >> (2 * i + 1)) & 1u) << (16 * q + i);
    }
  }
}

// Match mask of text char ch against a pattern word's planes: all-ones
// flips select the bits where the code bit is 0.
struct CharFlip {
  uint64_t lo, hi;
  CharFlip() = default;
  __device__ __forceinline__ explicit CharFlip(uint32_t ch)
      : lo((ch & 1u) ? 0ull : ~0ull), hi((ch & 2u) ? 0ull : ~0ull) {}
  __device__ __forceinline__ uint64_t eq(uint64_t plo, uint64_t phi) const {
    return (plo ^ lo) & (phi ^ hi);
  }
};

// The half of a word step that needs no carry: s0 = (eq & pv) + pv and
// its carry out c1.
__device__ __forceinline__ void myers_add(uint64_t eq, uint64_t pv,
                                          uint64_t& s0, uint64_t& c1) {
  const uint64_t t = eq & pv;
  s0 = t + pv;
  c1 = s0 < t;
}

// The other half, from the carries of the word above: ca is the adder
// carry, cp/cm the Ph/Mh shift carries, all rippled from the word above
// (rows before this word); the word above the top row gives ca = 0, cm = 0
// and cp = the top boundary's horizontal delta (1, or 0 for a free text
// char). ph/mh come back before the shift: the score row reads them.
__device__ __forceinline__ void myers_carry(uint64_t eq, uint64_t s0,
                                            uint64_t c1, uint64_t& pv,
                                            uint64_t& mv, uint64_t& ca,
                                            uint64_t& cp, uint64_t& cm,
                                            uint64_t& ph, uint64_t& mh) {
  const uint64_t xv = eq | mv;
  const uint64_t s = s0 + ca;
  ca = c1 | (s < ca);
  const uint64_t xh = (s ^ pv) | eq;
  ph = mv | ~(xh | pv);
  mh = pv & xh;
  const uint64_t phs = (ph << 1) | cp;
  const uint64_t mhs = (mh << 1) | cm;
  cp = ph >> 63;
  cm = mh >> 63;
  pv = mhs | ~(xv | phs);
  mv = phs & xv;
}

// One pattern word of one text column: both halves.
__device__ __forceinline__ void myers_step(uint64_t eq, uint64_t& pv,
                                           uint64_t& mv, uint64_t& ca,
                                           uint64_t& cp, uint64_t& cm,
                                           uint64_t& ph, uint64_t& mh) {
  uint64_t s0, c1;
  myers_add(eq, pv, s0, c1);
  myers_carry(eq, s0, c1, pv, mv, ca, cp, cm, ph, mh);
}

}  // namespace otter
