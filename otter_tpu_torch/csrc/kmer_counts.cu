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
// What bounds it: the bytes. Each allele's bytes are read (k times from L1,
// once from device memory) and its 4^k + 1 counts written once; a window
// costs ~3 k + 4 integer operations. genotype's batches (k = 3, 4,128 or
// 8,008 alleles of 120-207 bp) are ~1-2 MB in all, so a launch is a few
// microseconds of work and is bound by its launch and its one wave.
//
// Design: one block per allele. While 4^k + 1 <= kSmemBins (k <= 7) the
// block's histogram lives in shared memory: zeroed, filled with shared
// atomicAdd, then written out whole (zeros included), so the output needs
// no clearing. Past that (the JAX function takes any k) the block adds into
// the allele's row of device memory with global atomicAdd; the wrapper
// clears the output first. Thread t takes window starts t, t + B, ... so
// neighbouring threads read neighbouring bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemBins = 16385;  // 4^7 + 1

__device__ __forceinline__ int base_code(uint8_t c) {
  switch (c | 0x20) {  // A/a, C/c, G/g, T/t; no other byte maps onto them
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return 4;
  }
}

__global__ void __launch_bounds__(kThreads)
kmer_counts_kernel(const uint8_t* __restrict__ seqs,
                   const int32_t* __restrict__ offsets, int k, int width,
                   int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int a = blockIdx.x;
  const int t = threadIdx.x;
  const bool in_smem = width <= kSmemBins;
  int32_t* row = counts + static_cast<size_t>(a) * width;
  int32_t* hist = in_smem ? reinterpret_cast<int32_t*>(smem_raw) : row;
  if (in_smem) {
    for (int v = t; v < width; v += blockDim.x) hist[v] = 0;
    __syncthreads();
  }
  const int lo = offsets[a];
  const int windows = offsets[a + 1] - lo - k + 1;
  const uint8_t* s = seqs + lo;
  const int bad = width - 1;  // 4^k
  for (int p = t; p < windows; p += blockDim.x) {
    int idx = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const int c = base_code(s[p + j]);
      ok = ok && c < 4;
      idx = idx * 4 + (c & 3);
    }
    atomicAdd(hist + (ok ? idx : bad), 1);
  }
  if (in_smem) {
    __syncthreads();
    for (int v = t; v < width; v += blockDim.x) row[v] = hist[v];
  }
}

}  // namespace

// seqs: the alleles' bytes back to back; offsets: n_alleles + 1 int32 (allele
// a is seqs[offsets[a] .. offsets[a + 1])); counts: n_alleles x (4^k + 1)
// int32, cleared by the caller when 4^k + 1 > kSmemBins. Returns the CUDA
// error of the launch (0 on success).
extern "C" int otter_kmer_counts(const uint8_t* seqs, const int32_t* offsets,
                                 int n_alleles, int k, int32_t* counts,
                                 cudaStream_t stream) {
  if (n_alleles <= 0) return 0;
  if (k < 1 || k > 15) return static_cast<int>(cudaErrorInvalidValue);
  const int width = (1 << (2 * k)) + 1;
  const int smem = width <= kSmemBins ? width * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmer_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kmer_counts_kernel<<<n_alleles, kThreads, smem, stream>>>(
      seqs, offsets, k, width, counts);
  return static_cast<int>(cudaGetLastError());
}
