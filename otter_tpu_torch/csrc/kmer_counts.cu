// Kernel K10: per-allele histograms of base-4 k-mer indices.
//
// Replaces otter_tpu/seqs/kmer.py::kcounts_device (jnp: padded code windows,
// a one-hot (n, W, 4^k + 1) einsum), which OTTER_TPU_KMER_DEVICE=1 sends
// genotype's k-mer usage pass to. For allele a with bytes s[0 .. len) and
// each window start p <= len - k, the window's index is
// sum_j code(s[p + j]) 4^(k - 1 - j) (A/a 0, C/c 1, G/g 2, T/t 3), or 4^k
// when any of its k codes is another byte; counts[a][index] counts the
// windows. An allele shorter than k counts nothing. Counts are integers, so
// the order of the atomic adds changes nothing.
//
// What bounds it: the bytes. Each allele's bytes are read once and its
// 4^k + 1 counts written once; genotype's batches (k = 3, 4,128 or 8,008
// alleles of 120-207 bp) are ~1-2 MB in all, so a launch is a few
// microseconds of work and is bound by its launch and its one wave.
//
// Design: one warp an allele, kWarps alleles a block, so a batch is one wave
// of blocks that each retire several alleles. The warp reads its allele as
// aligned 4-byte words, a word a lane, and decodes each byte once: four bytes'
// codes and not-ACGT flags in a few integer operations. A window that starts
// in lane l's word ends at most M = (k + 2) / 4 words on, so each lane takes
// the next M lanes' codes by M shuffles and cuts its four windows' indices
// from the joined bits; a tile of 32 words yields the windows of its first
// 32 - M, and the next tile starts there; each tile's words are loaded while
// the tile before is counted. Each window is one atomicAdd: combining a warp's
// equal indices first (__match_any_sync, then one add by the first lane)
// measured 1.6x slower on genotype's batches. While 4^k + 1 <= kSmemBins
// (k <= 7) each warp's histogram lives in shared memory: zeroed, filled, then
// written out whole (zeros included, coalesced), so the output needs no
// clearing. Past that (the JAX function takes any k) the warp adds into the
// allele's row of device memory, which the wrapper clears first.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // alleles a block, at most
constexpr int kSmemBins = 16385;   // 4^7 + 1
constexpr int kSmemBlock = 48 * 1024;  // a block's histograms, bytes, unless
                                       // one alone is larger

// a word's four bytes, the first (lowest address) most significant: bits
// 4-11 their 2-bit codes, bits 0-3 their not-ACGT flags. The code is
// ((c >> 1) ^ (c >> 2)) & 3 of each byte: A/a 0, C/c 1, G/g 2, T/t 3.
__device__ __forceinline__ unsigned decode4(unsigned w) {
  const unsigned x = w | 0x20202020u;
  const unsigned ok = __vcmpeq4(x, 0x61616161u) | __vcmpeq4(x, 0x63636363u) |
                      __vcmpeq4(x, 0x67676767u) | __vcmpeq4(x, 0x74747474u);
  const unsigned code = ((w >> 1) ^ (w >> 2)) & 0x03030303u;
  const unsigned bad = ~ok & 0x01010101u;
  const unsigned codes = ((code & 3u) << 6) | ((code >> 4) & 0x30u) |
                         ((code >> 14) & 0xcu) | (code >> 24);
  const unsigned flags = ((bad & 1u) << 3) | ((bad >> 6) & 4u) |
                         ((bad >> 15) & 2u) | (bad >> 24);
  return codes << 4 | flags;
}

// grid: ceil(n / warps) blocks of `warps` warps (blockDim.x = 32 warps);
// shared memory warps x width ints where width <= kSmemBins, else none.
__global__ void __launch_bounds__(kWarps * 32, 2048 / (kWarps * 32))
kmer_counts_kernel(const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ offsets, int n_alleles, int k,
                   int width, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * (blockDim.x >> 5) + warp;
  if (a >= n_alleles) return;
  const bool in_smem = width <= kSmemBins;
  int32_t* row = counts + static_cast<size_t>(a) * width;
  int32_t* hist =
      in_smem ? reinterpret_cast<int32_t*>(smem_raw) + warp * width : row;
  if (in_smem) {
    for (int v = lane; v < width; v += 32) hist[v] = 0;
    __syncwarp();
  }
  const int lo = offsets[a], hi = offsets[a + 1];
  if (hi - lo >= k) {
    const unsigned* words = reinterpret_cast<const unsigned*>(seqs);
    const int ahead = (k + 2) / 4;          // M
    const int bases = 4 * (ahead + 1);      // in the joined bits
    const int last_word = (hi - 1) >> 2;    // holds the allele's last byte
    const int last_start = (hi - k) >> 2;   // holds its last window's start
    const uint64_t index_mask = (uint64_t(1) << (2 * k)) - 1;
    const unsigned flag_mask = (1u << k) - 1;
    int w0 = lo >> 2;
    unsigned word = w0 + lane <= last_word ? words[w0 + lane] : 0u;
    for (; w0 <= last_start; w0 += 32 - ahead) {
      const int w = w0 + lane;
      const int w_next = w + 32 - ahead;
      const unsigned next = w_next <= last_word ? words[w_next] : 0u;
      const unsigned v = decode4(word);
      word = next;
      uint64_t joined = v >> 4;
      unsigned flags = v & 15u;
      for (int q = 1; q <= ahead; ++q) {
        const unsigned u = __shfl_down_sync(0xffffffffu, v, q);
        joined = joined << 8 | (u >> 4);
        flags = flags << 4 | (u & 15u);
      }
      const bool owner = lane < 32 - ahead;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * w + j;  // the window's first byte
        const int shift = bases - j - k;
        int key = -1;
        if (owner && p >= lo && p <= hi - k) {
          key = (flags >> shift) & flag_mask
                    ? width - 1
                    : static_cast<int>((joined >> (2 * shift)) & index_mask);
        }
        if (key >= 0) atomicAdd(hist + key, 1);
      }
    }
  }
  if (in_smem) {
    __syncwarp();
    for (int v = lane; v < width; v += 32) row[v] = hist[v];
  }
}

}  // namespace

// seqs: the alleles' bytes back to back, 4-byte aligned (the last word read
// may pass the last byte by up to 3 bytes, inside that word); offsets:
// n_alleles + 1 int32 (allele a is seqs[offsets[a] .. offsets[a + 1]));
// counts: n_alleles x (4^k + 1) int32, cleared by the caller when 4^k + 1 >
// kSmemBins. Returns the CUDA error of the launch (0 on success).
extern "C" int otter_kmer_counts(const uint8_t* seqs, const int32_t* offsets,
                                 int n_alleles, int k, int32_t* counts,
                                 cudaStream_t stream) {
  if (n_alleles <= 0) return 0;
  if (k < 1 || k > 15 || reinterpret_cast<uintptr_t>(seqs) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = (1 << (2 * k)) + 1;
  const int bytes = width * 4;
  int warps = kWarps, smem = 0;
  if (width <= kSmemBins) {
    warps = bytes > kSmemBlock ? 1 : kSmemBlock / bytes;
    if (warps > kWarps) warps = kWarps;
    smem = warps * bytes;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmer_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_alleles + warps - 1) / warps;
  kmer_counts_kernel<<<blocks, warps * 32, smem, stream>>>(
      seqs, offsets, n_alleles, k, width, counts);
  return static_cast<int>(cudaGetLastError());
}
