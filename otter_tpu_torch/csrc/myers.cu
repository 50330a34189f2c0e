// Kernel K1: bit-parallel Myers/Hyyro global Levenshtein distance of ACGT
// pairs whose sequences are rows of a 2-bit sequence pool.
//
// Replaces the TPU kernel otter_tpu/kernels/myers_pallas.py::
// _myers_kernel_packed (with its _strip_phase text loop; launched by
// myers_pallas_packed through myers_pool_pallas). The plane-input and
// fused-input variants (_myers_kernel, _myers_kernel_fused) compute the same
// values from other input layouts and need no kernel of their own here.
//
// Inputs, as the TPU launch takes them: pool (S, w_pool) int32, each row a
// sequence packed 16 chars per word (char j in bits 2(j%16).. of word j/16,
// padding packs as 'A'); per pair idx_pat/idx_txt (pool rows of the pattern
// and the text), nlen (text length) and minit (pattern length m). The result
// is the score D[m][nlen], or minit where the TPU kernel never captures one
// (nlen == 0, nlen > text_len, m == 0, m > 32 * n_words).
//
// What bounds it: integer ALU. One text character advances one 64-bit
// pattern word, 64 DP cells, with ~20 64-bit logic/add/shift operations that
// the compiler emits as ~35-40 32-bit integer instructions: ~0.6 int32
// instructions per DP cell, against the H100's 64 int32 lanes per SM per
// clock. Memory traffic is small: a pair reads its pattern once (2 bits per
// char) and its text once, and the DP state never leaves the SM.
//
// Design: one thread per pair, so every carry (the adder carry and the Ph/Mh
// shift carries) ripples through the pattern words inside one thread. The
// word count is a template parameter, so Pv/Mv live in registers. A pair runs
// only its own ceil(m/64) words (rows past m-1 never reach the scored row:
// every dataflow of the recurrence moves from lower rows to higher ones) and
// only its own n text characters (the TPU kernel captures the score at
// j == nlen, so later columns never matter). The pattern's match masks are
// kept as two bit planes (low and high bit of each 2-bit code) in shared
// memory, 16 bytes per word per thread; Eq for a text character is two
// xor-and operations. The caller launches a whole n_words bucket at once, so
// a large bucket fills all 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>

#include "myers_common.cuh"

namespace {

constexpr int kThreads = 128;

template <int NW>
__global__ void __launch_bounds__(kThreads)
myers_pool_kernel(const uint32_t* __restrict__ pool, int w_pool,
                  const int32_t* __restrict__ idx_pat,
                  const int32_t* __restrict__ idx_txt,
                  const int32_t* __restrict__ nlen,
                  const int32_t* __restrict__ minit,
                  int32_t* __restrict__ out, int n_pairs, int text_len) {
  extern __shared__ uint64_t planes[];  // [2][NW][kThreads]
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= n_pairs) return;
  const int m = minit[b];
  const int n = nlen[b];
  if (m <= 0 || m > 64 * NW || n <= 0 || n > text_len) {
    out[b] = m;
    return;
  }
  const int nwp = (m + 63) >> 6;
  uint64_t* lo_s = planes + tid;
  uint64_t* hi_s = planes + NW * kThreads + tid;
  const uint32_t* prow = pool + static_cast<size_t>(idx_pat[b]) * w_pool;
  for (int w = 0; w < nwp; ++w) {
    uint64_t lo, hi;
    otter::pattern_word(prow, w, lo, hi);
    lo_s[w * kThreads] = lo;
    hi_s[w * kThreads] = hi;
  }

  uint64_t Pv[NW], Mv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    Pv[w] = ~0ull;
    Mv[w] = 0ull;
  }
  const int sw = nwp - 1;
  const uint64_t sb = 1ull << ((m - 1) & 63);
  int score = m;
  const uint32_t* trow = pool + static_cast<size_t>(idx_txt[b]) * w_pool;
  for (int j0 = 0; j0 < n; j0 += 16) {
    const uint32_t tw = trow[j0 >> 4];
    const int jn = min(16, n - j0);
    for (int c = 0; c < jn; ++c) {
      const otter::CharFlip f((tw >> (2 * c)) & 3u);
      uint64_t ca = 0, cp = 1, cm = 0;  // top boundary row: Ph carry-in 1
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < nwp) {
          uint64_t ph, mh;
          otter::myers_step(f.eq(lo_s[w * kThreads], hi_s[w * kThreads]),
                            Pv[w], Mv[w], ca, cp, cm, ph, mh);
          if (w == sw) {
            score += static_cast<int>((ph & sb) != 0) -
                     static_cast<int>((mh & sb) != 0);
          }
        }
      }
    }
  }
  out[b] = score;
}

template <int NW>
cudaError_t launch_pool(const uint32_t* pool, int w_pool,
                        const int32_t* idx_pat, const int32_t* idx_txt,
                        const int32_t* nlen, const int32_t* minit,
                        int32_t* out, int n_pairs, int text_len,
                        cudaStream_t stream) {
  const int smem = 2 * NW * kThreads * static_cast<int>(sizeof(uint64_t));
  cudaError_t err = cudaFuncSetAttribute(
      myers_pool_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  myers_pool_kernel<NW><<<blocks, kThreads, smem, stream>>>(
      pool, w_pool, idx_pat, idx_txt, nlen, minit, out, n_pairs, text_len);
  return cudaGetLastError();
}

}  // namespace

// n_words counts 32-bit pattern words, as the TPU kernel's buckets do
// (4, 8, 16, 32 or 64); the kernel runs them as n_words / 2 64-bit words.
extern "C" int otter_myers_pool(const int32_t* pool, int w_pool,
                                const int32_t* idx_pat,
                                const int32_t* idx_txt, const int32_t* nlen,
                                const int32_t* minit, int32_t* out,
                                int n_pairs, int n_words, int text_len,
                                void* stream) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(pool);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 4:
      return launch_pool<2>(p, w_pool, idx_pat, idx_txt, nlen, minit, out,
                            n_pairs, text_len, s);
    case 8:
      return launch_pool<4>(p, w_pool, idx_pat, idx_txt, nlen, minit, out,
                            n_pairs, text_len, s);
    case 16:
      return launch_pool<8>(p, w_pool, idx_pat, idx_txt, nlen, minit, out,
                            n_pairs, text_len, s);
    case 32:
      return launch_pool<16>(p, w_pool, idx_pat, idx_txt, nlen, minit, out,
                             n_pairs, text_len, s);
    case 64:
      return launch_pool<32>(p, w_pool, idx_pat, idx_txt, nlen, minit, out,
                             n_pairs, text_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* otter_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
