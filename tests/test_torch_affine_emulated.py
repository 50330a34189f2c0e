"""The CUDA source of K5 and K6 (otter_tpu_torch/csrc/affine_tb.cu) run on
the CPU: g++ compiles it against a small emulation of the CUDA surface it
uses (each block a set of std::threads, one per CUDA thread; a warp meets
at every shuffle, vote and __syncwarp, a block at every
__syncthreads; atomicAdd is an atomic add of the host, __threadfence its
fence; the emulation also serves the
other CUDA sources' emulated tests), and the
kernels' results are held
against the plain PyTorch version, exactly. This checks the warp-level
design (the shuffle scan, the reductions, the staging, the nibble codes)
where there is no card; the card runs the same source in
tests/test_torch_cuda.py and chip_smoke.py."""

import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from otter_tpu_torch.kernels import affine_tb as K

from test_torch_cuda import last_column_tie_jobs

SOURCE = K.__file__.rsplit("/", 2)[0] + "/csrc/affine_tb.cu"

# The CUDA names affine_tb.cu uses, for the host.
CUDA_RUNTIME_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <semaphore>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 12
};
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
namespace emu {
// the calling thread's current device, and the SM count of each of two
// devices: an H100's 132 and a smaller card's 66
inline thread_local int device = 0;
inline const int device_sms[2] = {132, 66};
}  // namespace emu
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = emu::device;
  return 0;
}
inline cudaError_t cudaSetDevice(int dev) {
  if (dev < 0 || dev > 1) return cudaErrorInvalidValue;
  emu::device = dev;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr,
                                          int dev) {
  if (dev < 0 || dev > 1) return cudaErrorInvalidValue;
  *value = emu::device_sms[dev];
  return 0;
}
// the host's handle on the calling thread's device
extern "C" int emu_set_device(int dev) { return cudaSetDevice(dev); }

struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx, blockDim;

namespace emu {
struct Warp;
// a block's or a cluster's barrier; with the warps it releases, for the
// turn that was parked on it (see stagger below)
struct Group;
struct OnPhase {
  Group* g;
  void operator()() noexcept;
};
struct Group {
  std::barrier<OnPhase> bar;
  std::vector<Warp*> warps;
  std::atomic<bool> stash{false};
  explicit Group(int n) : bar(n, OnPhase{this}) {}
};
struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[2][32];
  std::counting_semaphore<32> go{0};  // the warp's turn, when staggered
  Warp* next = nullptr;               // the warp whose turn comes next
  std::atomic<bool> parked{false};    // waiting at a block or cluster barrier
  std::atomic<bool> done{false};      // returned from the kernel
};
struct Cluster;
struct Block {
  Group group;
  uint8_t* smem;
  Cluster* cluster = nullptr;
  int rank = 0;
  explicit Block(int n) : group(n) {}
};
struct Cluster {
  Group group;
  std::vector<Block*> blocks;
  explicit Cluster(int n) : group(n) {}
};
inline thread_local Warp* warp;
inline thread_local Block* block;
inline thread_local int lane;
inline thread_local int parity;
// the shared memory of blocks that run one after another
alignas(64) inline uint8_t smem_serial[1 << 18];
// stagger: 0, the warps of a block (of a cluster) run together; 1 (-1),
// they run one at a time, from the first warp (the last), so a warp runs on
// to its next barrier, writing the shared memory it writes there, before
// the warps after it read what they read after the last one. A warp hands
// its turn on at every block or cluster barrier (and parks there), where it
// waits on an mbarrier (and takes a turn again later), and when it returns;
// the turn skips parked and returned warps, and when none is left it waits
// with the barrier, which gives it to the first (last) warp it releases.
inline int stagger = 0;
inline void OnPhase::operator()() noexcept {
  for (Warp* w : g->warps) w->parked = false;
  if (g->stash.exchange(false)) {
    (stagger > 0 ? g->warps.front() : g->warps.back())->go.release(32);
  }
}
inline void wait_turn() {
  if (stagger) warp->go.acquire();
}
// hand the turn on: parking at barrier g, returning (g null, done), or
// yielding while an mbarrier is pending (g null)
inline void end_turn(Group* g, bool done = false) {
  if (!stagger) return;
  warp->bar.arrive_and_wait();  // the warp's 32 lanes are done
  if (lane != 0) return;
  if (done) warp->done = true;
  if (g) warp->parked = true;
  Warp* w = warp->next;
  while (w != warp && (w->parked || w->done)) w = w->next;
  if (w == warp && (warp->parked || warp->done)) {
    if (g) g->stash = true;
    return;
  }
  w->go.release(32);
}
// every lane posts its value, then reads the source lane's (or its own);
// posts alternate between two slot sets, so one barrier a call suffices (a
// lane posts to a set again only after every lane has passed the barrier
// that follows its read of it)
template <class T>
T exchange(T v, int src, bool keep) {
  uint64_t x = 0;
  std::memcpy(&x, &v, sizeof(T));
  uint64_t* slot = warp->slot[parity];
  parity ^= 1;
  slot[lane] = x;
  warp->bar.arrive_and_wait();
  const uint64_t y = slot[keep ? lane : src];
  T r;
  std::memcpy(&r, &y, sizeof(T));
  return r;
}
// grid blocks of `block` threads, `cluster` blocks at a time: a cluster's
// blocks run together, each with its own shared memory; clusters (and
// blocks without one) one after another, sharing smem_serial. A block's
// warps run together, or one after another with EMU_WARPS_IN_TURN (fewer
// threads contend at each barrier; only for a source whose warps share
// nothing)
template <class F, class... A>
void run(F f, int grid, int block, int cluster, A... args) {
  for (int g0 = 0; g0 < grid; g0 += cluster) {
    const int nb = cluster;
    const int nw = (block + 31) / 32;
    std::vector<std::unique_ptr<Warp>> warps;
    for (int q = 0; q < nb * nw; ++q) warps.emplace_back(new Warp);
    std::vector<std::unique_ptr<Block>> blocks;
    std::vector<std::unique_ptr<uint8_t[]>> smem;
    Cluster cl(nb * block);
    for (int b = 0; b < nb; ++b) {
      blocks.emplace_back(new Block(block));
      if (nb > 1) smem.emplace_back(new uint8_t[1 << 18]);
      blocks[b]->smem = nb > 1 ? smem[b].get() : smem_serial;
      blocks[b]->cluster = &cl;
      blocks[b]->rank = b;
      cl.blocks.push_back(blocks[b].get());
      for (int q = 0; q < nw; ++q) {
        blocks[b]->group.warps.push_back(warps[b * nw + q].get());
      }
    }
    for (auto& w : warps) cl.group.warps.push_back(w.get());
    const int total = nb * nw;
    for (int q = 0; q < total && stagger; ++q) {
      warps[q]->next = warps[(q + total + stagger) % total].get();
    }
    if (stagger) warps[stagger > 0 ? 0 : total - 1]->go.release(32);
#ifdef EMU_WARPS_IN_TURN
    const int turn = 32;
#else
    const int turn = block;
#endif
    for (int t0 = 0; t0 < block; t0 += turn) {
      std::vector<std::thread> threads;
      for (int b = 0; b < nb; ++b) {
        for (int t = t0; t < t0 + turn && t < block; ++t) {
          threads.emplace_back([&, t, b]() {
            threadIdx.x = t;
            blockIdx.x = g0 + b;
            blockDim.x = block;
            warp = warps[b * nw + t / 32].get();
            emu::block = blocks[b].get();
            lane = t % 32;
            parity = 0;
            wait_turn();
            f(args...);
            end_turn(nullptr, true);
          });
        }
      }
      for (auto& th : threads) th.join();
    }
  }
}
// kernel<<<grid, block, smem, stream>>>(args)
template <class F>
auto launch(F f, int grid, int block, int, void*) {
  return [=](auto... args) { run(f, grid, block, 1, args...); };
}
}  // namespace emu

// cudaLaunchKernelEx with a cluster dimension: the cluster's blocks together
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*f)(E...), A&&... args) {
  int cluster = 1;
  for (unsigned q = 0; q < cfg->numAttrs; ++q) {
    if (cfg->attrs[q].id == cudaLaunchAttributeClusterDimension) {
      cluster = cfg->attrs[q].val.clusterDim.x;
    }
  }
  if (cluster < 1 || cfg->gridDim.x % cluster) return cudaErrorInvalidValue;
  emu::run(f, cfg->gridDim.x, cfg->blockDim.x, cluster, E(args)...);
  return 0;
}
namespace emu {
// the most blocks a cluster the emulated card places (a card, or a slice
// of one, with fewer SMs a GPC places smaller clusters)
inline int max_cluster = 16;
}  // namespace emu
extern "C" void emu_set_max_cluster(int c) { emu::max_cluster = c; }
// as many clusters as the card's 132 SMs hold, or 0 past max_cluster
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F,
                                           const cudaLaunchConfig_t* cfg) {
  int cluster = 1;
  for (unsigned q = 0; q < cfg->numAttrs; ++q) {
    if (cfg->attrs[q].id == cudaLaunchAttributeClusterDimension) {
      cluster = cfg->attrs[q].val.clusterDim.x;
    }
  }
  *n = cluster <= emu::max_cluster ? 132 / cluster : 0;
  return 0;
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::block->rank; }
  unsigned num_blocks() const { return emu::block->cluster->blocks.size(); }
  void sync() const {
    emu::Group* g = &emu::block->cluster->group;
    emu::end_turn(g);
    g->bar.arrive_and_wait();
    emu::wait_turn();
  }
  // the same offset in block r's shared memory
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    const auto off = reinterpret_cast<uint8_t*>(p) - emu::block->smem;
    return reinterpret_cast<T*>(emu::block->cluster->blocks[r]->smem + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// width: the warp splits into groups of that many lanes (a power of two)
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu::exchange(v, (emu::lane & ~(width - 1)) + (src & (width - 1)),
                       false);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d, int width = 32) {
  const int pos = emu::lane & (width - 1);
  return emu::exchange(v, emu::lane - d, pos < d);
}
template <class T> T __shfl_down_sync(unsigned, T v, int d, int width = 32) {
  const int pos = emu::lane & (width - 1);
  return emu::exchange(v, emu::lane + d, pos + d >= width);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int d) {
  return emu::exchange(v, emu::lane ^ d, false);
}
inline int __any_sync(unsigned, int p) {
  uint64_t* slot = emu::warp->slot[emu::parity];
  emu::parity ^= 1;
  slot[emu::lane] = p != 0;
  emu::warp->bar.arrive_and_wait();
  int any = 0;
  for (int q = 0; q < 32; ++q) any |= slot[q] != 0;
  return any;
}
inline void __syncwarp() { emu::warp->bar.arrive_and_wait(); }
inline void __syncthreads() {
  emu::end_turn(&emu::block->group);
  emu::block->group.bar.arrive_and_wait();
  emu::wait_turn();
}
extern "C" void emu_set_stagger(int s) { emu::stagger = s; }
// an mbarrier in its 8 bytes: the pending transaction bytes (bits 0-31),
// pending arrivals (32-47), the arrival count (48-62) and the parity of the
// current phase (63); a phase completes when both pendings reach 0
namespace emu {
inline void mbar_update(uint64_t* bar, int arrivals, int64_t tx) {
  std::atomic_ref<uint64_t> a(*bar);
  uint64_t old = a.load();
  for (;;) {
    const int32_t t = static_cast<int32_t>(old & 0xffffffffu) +
                      static_cast<int32_t>(tx);
    int pend = static_cast<int>((old >> 32) & 0xffff) - arrivals;
    const uint64_t count = (old >> 48) & 0x7fff;
    uint64_t phase = old >> 63;
    if (pend == 0 && t == 0) pend = static_cast<int>(count), phase ^= 1;
    const uint64_t nw = (phase << 63) | (count << 48) |
                        (static_cast<uint64_t>(pend) << 32) |
                        static_cast<uint32_t>(t);
    if (a.compare_exchange_weak(old, nw)) return;
  }
}
}  // namespace emu
inline void mbar_init(uint64_t* bar, unsigned count) {
  *bar = (uint64_t(count) << 48) | (uint64_t(count) << 32);
}
inline void mbar_arrive(uint64_t* bar) { emu::mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu::mbar_update(bar, 1, bytes);
}
// every lane of the warp waits (the warp decides together, so it can hand
// its turn on while the phase is pending)
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  for (;;) {
    const uint64_t st = std::atomic_ref<uint64_t>(*bar).load();
    if (!__any_sync(~0u, (st >> 63) == parity)) return;
    if (emu::stagger) {
      emu::end_turn(nullptr);
      emu::wait_turn();
    } else {
      std::this_thread::yield();
    }
  }
}
// a bulk copy: the copy, then its bytes' completion on the mbarrier
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                          uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu::mbar_update(bar, 0, -static_cast<int64_t>(bytes));
}
// atomicAdd on a shared or device-memory int or float: the block's threads
// are host threads, so a std::atomic_ref add
template <class T> T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
// a fence of the host; a load past the L1: a plain load
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T> T __ldcg(const T* p) { return *p; }
inline unsigned __vcmpeq4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int c = 0; c < 4; ++c) {
    if (((a ^ b) >> (8 * c) & 0xffu) == 0) r |= 0xffu << (8 * c);
  }
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return unsigned(((uint64_t(hi) << 32) | lo) >> (s & 31));
}
"""


def build_emulated(tmp_path_factory, source: str,
                   warps_in_turn: bool = False) -> ctypes.CDLL:
    """A CUDA source of the port built for the host against the emulated
    CUDA names (skips without g++). ``warps_in_turn`` runs a block's warps
    one after another instead of together: faster, but blind to warps that
    overwrite each other's shared memory, so only for a source whose warps
    share nothing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    name = source.rsplit("/", 1)[1][:-3]
    d = tmp_path_factory.mktemp(f"{name}_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cooperative_groups.h").write_text("#include <cuda_runtime.h>\n")
    with open(source) as fh:
        src = fh.read()
    # the package's headers inline, so their launches are rewritten too
    src_dir = SOURCE.rsplit("/", 1)[0]

    def header(match):
        with open(f"{src_dir}/{match.group(1)}") as fh:
            return fh.read()

    src = re.sub(r'#include "(\w+\.cuh)"', header, src)
    # a block's dynamic shared memory is its own (a cluster's blocks run
    # together)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::block->smem);", src)
    # kernel<L, E><<<grid, block, smem, stream>>>(args) -> emu::launch(...)(args)
    src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(",
                 r"emu::launch(\1, \2)(", src, flags=re.S)
    (d / f"{name}.cpp").write_text("#include <cuda_runtime.h>\n" + src)
    lib = d / f"lib{name}_emu.so"
    turns = ["-DEMU_WARPS_IN_TURN"] if warps_in_turn else []
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-w", *turns, f"-I{d}", f"-I{source.rsplit('/', 1)[0]}",
                    "-o", str(lib), str(d / f"{name}.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """affine_tb.cu built for the host against the emulated CUDA names."""
    so = build_emulated(tmp_path_factory, SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (so.otter_affine_tb, so.otter_affine_tb_ckpt):
        fn.restype = I
        fn.argtypes = [P, I, P, I, P, I, I, P, P, I, P, P, I, P]
    return so


def _emulated_run(so, jobs, rows, k, ckpt):
    """(ops, end, cigars) of the emulated kernel and of the plain version,
    the cigars every member's, read from the cigar bytes."""
    a, bpad, mn = K.pack_affine_jobs(jobs, rows, k)
    tw = K._t_words(rows, k)
    B, La = a.shape
    ops = np.full((B, tw), -7, dtype=np.int32)   # every word must be written
    end = np.full((B, 4), -7, dtype=np.int32)
    scratch = np.zeros(B * K.scratch_bytes_per_member(La, k, ckpt),
                       dtype=np.uint8)
    stride = K.cigar_stride(jobs)
    cig = np.full((B, stride), ord("?"), dtype=np.uint8)
    fn = so.otter_affine_tb_ckpt if ckpt else so.otter_affine_tb
    head = (a.ctypes.data, La, bpad.ctypes.data, bpad.shape[1],
            mn.ctypes.data, k, tw, ops.ctypes.data, end.ctypes.data, B,
            scratch.ctypes.data)
    assert fn(*head, None, stride, None) != 0  # no cigar buffer: refused
    assert fn(*head, cig.ctypes.data, stride, None) == 0
    cig_p = torch.empty((B, stride), dtype=torch.uint8)
    ops_p, end_p = K.affine_tb_torch(
        *(torch.from_numpy(x) for x in (a, bpad, mn)), k, tw, cig_p)
    every = np.arange(B)
    return ((ops, end, K.read_cigars(cig, mn, every)),
            (ops_p.numpy(), end_p.numpy(),
             K.read_cigars(cig_p.numpy(), mn, every)))


def _members(rng, n, lo, hi):
    """Members against their representative: End2End, text-side frees,
    pattern-side frees, long gaps in the text and in the pattern (E and F
    runs across many lanes), and unrelated ones (not walked at narrow
    bands)."""
    jobs = []
    for i in range(n):
        rep = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        mem = "".join(c if rng.random() > 0.03 else rng.choice("ACGT")
                      for c in rep)
        x, g = rng.randint(10, len(mem) - 40), rng.randint(12, 30)
        cut = rng.randint(0, len(mem) // 3)
        jobs.append([(mem, rep, 0, 0, 0, 0), (mem[cut:], rep, 0, 0, cut, 0),
                     (rep, mem[cut:], cut, 0, 0, 0),
                     (mem + "ACG", rep, 0, 3, 0, 0),
                     (mem[:x] + mem[x + g:], rep, 0, 0, 0, 0),
                     (mem[:x] + rep[:g] + mem[x:], rep, 0, 0, 0, 0),
                     ("".join(rng.choice("ACGT") for _ in range(len(rep))),
                      rep, 0, 0, 0, 0)][i % 7])
    return jobs


@pytest.mark.parametrize("k", K.BANDS)
def test_cuda_source_k5_k6_emulated_match_plain(emulated, k):
    """K5 and K6 as written for the card, run on the emulated warps: every
    end cell and walk word equal to the plain version's (exact), for
    members of one to two 256-row blocks and last-column ties, and every
    member's cigar bytes equal to the plain version's."""
    rng = random.Random(40 + k)
    jobs = _members(rng, 7, 120, 460) + last_column_tie_jobs(rng, 2)
    for ckpt in (False, True):
        got, want = _emulated_run(emulated, jobs, 512, k, ckpt)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])
        assert got[2] == want[2]
    assert want[1][:, 3].sum() >= len(jobs) // 2
