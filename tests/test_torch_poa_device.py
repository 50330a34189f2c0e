"""K12, the port's POA heaviest-path DP (otter_tpu_torch/kernels/
poa_heaviest.py, csrc/poa_heaviest.cu, ops/poa_device.py), on the CPU
against ``otter_tpu``'s ``_heaviest_step`` and
``poa_consensus_device_batch`` (jnp) and the python ``Ppoa`` oracle: h bit
for bit, min_eid and consensus strings equal, on one device and over a
CPU mesh of 2; the CUDA source on the g++ warp emulation against the plain
version."""

import ctypes
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from otter_tpu.ops.align_np import affine_align_cigar
from otter_tpu.ops.poa import Ppoa as ReferencePpoa
from otter_tpu.ops.poa_device import _heaviest_step
from otter_tpu.ops.poa_device import (
    poa_consensus_device_batch as reference_device_batch)
from otter_tpu_torch.kernels import poa_heaviest as K12
from otter_tpu_torch.ops.poa import Ppoa
from otter_tpu_torch.ops.poa_device import (graph_arrays,
                                            poa_consensus_device_batch)

from test_poa_device import GOLDEN, _mutate
from test_torch_affine_emulated import build_emulated

SOURCE = K12.__file__.rsplit("/", 2)[0] + "/csrc/poa_heaviest.cu"


def _build(cls, sequences, spans=None):
    """tests/test_poa_device.py's build_poa with either package's Ppoa."""
    poa = cls(sequences[0])
    for mi, seq in enumerate(sequences):
        sl, sr = (True, True) if spans is None else spans[mi]
        poa.insert_alignment(seq, affine_align_cigar(sequences[0], seq),
                             sl, sr)
    poa.adjust_weights(
        float(np.float32(len(sequences) * np.float32(0.4))), 0.3)
    return poa


def _seeded(seed, count):
    """(sequences, spans) sets of test_poa_device.py's random and tie
    kinds: mutated random backbones with some non-spanning members, and
    tandem-repeat unit counts with exactly equal path weights."""
    rng = random.Random(seed)
    sets = []
    for trial in range(count):
        if trial % 3 == 2:
            unit = rng.choice(["CAG", "AT", "TTTA"])
            n_units = rng.randrange(4, 10)
            seqs = [unit * n_units] + [
                unit * (n_units + rng.choice([-1, 0, 1])) for _ in range(4)]
            sets.append((seqs, None))
            continue
        base = "".join(rng.choice("ACGT") for _ in range(rng.randrange(20,
                                                                       200)))
        seqs = [base] + [_mutate(rng, base, rng.choice([0.01, 0.05, 0.15]))
                         for _ in range(rng.randrange(2, 8))]
        sets.append((seqs, [(rng.random() < 0.9, rng.random() < 0.9)
                            for _ in seqs]))
    return sets


CASES = {"golden": [(s, None) for s in GOLDEN], "random": _seeded(5, 18),
         "more": _seeded(9, 12)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_heaviest_matches_reference_step(case):
    """K12's plain version: h bit for bit and min_eid equal to the JAX
    function's on every node with an in-edge (JAX pads a source's min_eid
    to its padded edge width, K12 writes the graph's edge count)."""
    arrs = [graph_arrays(_build(Ppoa, s, sp)) for s, sp in CASES[case]]
    batch = K12.pack_graphs([(a[0], a[1], a[2], a[5]) for a in arrs])
    h, min_eid = K12.poa_heaviest(batch)
    for a, (hv, mv) in zip(arrs, K12.split_by_graph(batch, h.numpy(),
                                                    min_eid.numpy())):
        src, sink, w, has_in, _ending, depth = a
        e, n = len(src), len(has_in)
        ep, np_, ip = (1 << max(3, (e - 1).bit_length()),
                       1 << max(3, (n - 1).bit_length()),
                       1 << max(0, (int(depth.max()) - 1).bit_length()))
        S = np.zeros((1, ep), np.int32)
        T = np.zeros((1, ep), np.int32)
        W = np.full((1, ep), -np.inf, np.float32)
        H = np.zeros((1, np_), bool)
        S[0, :e], T[0, :e], W[0, :e], H[0, :n] = src, sink, w, has_in
        hj, mj = _heaviest_step(*map(jnp.asarray, (S, T, W, H)),
                                n_iters=ip, n_pad=np_)
        hj, mj = np.asarray(hj)[0, :n], np.asarray(mj)[0, :n]
        assert np.array_equal(hv.view(np.int32), hj.view(np.int32))
        assert np.array_equal(mv[has_in], mj[has_in])
        assert (mv[~has_in] == e).all()


@pytest.mark.parametrize("mesh", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_matches_reference(case, mesh):
    """Consensus strings equal the JAX package's device batch and the
    python oracle's, on one CPU device and over a CPU mesh of 2 (the graph
    axis split in two shards)."""
    sets = CASES[case]
    poas = [_build(Ppoa, s, sp) for s, sp in sets]
    want = [p.consensus() for p in poas]
    assert want == reference_device_batch(
        [_build(ReferencePpoa, s, sp) for s, sp in sets])
    devices = ("cpu",) * mesh if mesh > 1 else "cpu"
    assert poa_consensus_device_batch(poas, devices) == want


def test_degenerate_single_node():
    poa = Ppoa("A")
    assert poa_consensus_device_batch([poa], "cpu") == [poa.consensus()]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """poa_heaviest.cu built for the host against the emulated CUDA
    names."""
    so = build_emulated(tmp_path_factory, SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.otter_poa_heaviest.restype = I
    so.otter_poa_heaviest.argtypes = [P] * 5 + [I, I, P, P, P, P]
    so.otter_poa_heaviest_stream.restype = I
    so.otter_poa_heaviest_stream.argtypes = [P] * 4 + [I] * 7 + [P, P, P]
    so.emu_set_stagger.argtypes = [I]
    return so


@pytest.mark.parametrize("in_smem", [True, False])
def test_cuda_source_emulated_matches_plain(emulated, in_smem):
    """The CUDA source equals the plain version bit for bit on graphs
    whose level counts exceed the warp (up to ~200 levels), h in shared
    memory and (a claimed max_nodes past the shared-memory limit) in
    device memory."""
    sets = _seeded(13, 9)
    arrs = [graph_arrays(_build(Ppoa, s, sp)) for s, sp in sets]
    batch = K12.pack_graphs([(a[0], a[1], a[2], a[5]) for a in arrs])
    assert batch.max_depth > 32
    want_h, want_m = K12.poa_heaviest_torch(batch)
    h = torch.empty_like(want_h)
    min_eid = torch.empty_like(want_m)
    max_nodes = batch.max_nodes if in_smem else 1 << 20
    h_pos = torch.empty_like(want_h)
    assert emulated.otter_poa_heaviest(
        *[t.data_ptr() for t in batch[:5]], batch.meta.shape[0], max_nodes,
        h_pos.data_ptr(), h.data_ptr(), min_eid.data_ptr(), None) == 0
    assert np.array_equal(h.numpy().view(np.int32),
                          want_h.numpy().view(np.int32))
    assert torch.equal(min_eid, want_m)


@pytest.mark.parametrize("ring,stagger", [
    (K12.RING, 0), ((1, 2, 3), 0), ((1, 2, 3), 1), ((1, 2, 3), -1),
    ((2, 3, 2), 1), ((2, 3, 2), -1)])
def test_cuda_source_stream_emulated_matches_plain(emulated, ring, stagger):
    """The streamed kernel equals the plain version bit for bit on graphs
    of up to ~140 nodes: with the default rings, and with rings of two
    chunks of 4-8 elements and of four of 4-8, far shorter than a graph
    (both streams wrap their rings many times); the blocks' three warps run
    together, or one at a time (``emu_set_stagger``; a warp hands its turn
    on where it waits on an mbarrier), from the walker or from the last
    producer. Every output word is written (the buffers start poisoned)."""
    sets = _seeded(13, 9)
    arrs = [graph_arrays(_build(Ppoa, s, sp)) for s, sp in sets]
    batch = K12.pack_graphs([(a[0], a[1], a[2], a[5]) for a in arrs])
    assert K12.stream_fits(batch, ring)
    lg_slots, lg_pos, lg_edge = ring
    largest = int(batch.meta[:, 1].max())
    assert ring == K12.RING or largest > 4 << lg_slots + max(lg_pos,
                                                             lg_edge)
    want_h, want_m = K12.poa_heaviest_torch(batch)
    h = torch.full_like(want_h, float("nan"))
    min_eid = torch.full_like(want_m, -7)
    emulated.emu_set_stagger(stagger)
    try:
        assert emulated.otter_poa_heaviest_stream(
            batch.in_ptr.data_ptr(), batch.e_rec.data_ptr(),
            batch.node_of.data_ptr(), batch.meta.data_ptr(),
            batch.meta.shape[0], batch.max_nodes, batch.in_ptr.shape[0],
            batch.e_rec.shape[0], *ring, h.data_ptr(), min_eid.data_ptr(),
            None) == 0
    finally:
        emulated.emu_set_stagger(0)
    assert np.array_equal(h.numpy().view(np.int32),
                          want_h.numpy().view(np.int32))
    assert torch.equal(min_eid, want_m)


def test_stream_route_by_size():
    """K12's route: the streamed kernel while every graph has at most
    STREAM_NODES nodes and every node's in-edges fit the edge ring (at
    most 2^lg_slots chunks), else the device-memory kernel; pack_graphs
    records each position's in-edges, in ascending edge id, as (graph-local
    source position, weight bits, edge id)."""
    sets = _seeded(13, 3)
    arrs = [graph_arrays(_build(Ppoa, s, sp)) for s, sp in sets]
    batch = K12.pack_graphs([(a[0], a[1], a[2], a[5]) for a in arrs])
    assert batch.max_in_edges == max(
        int(np.bincount(a[1]).max()) for a in arrs)
    assert K12.stream_fits(batch)
    assert not K12.stream_fits(batch._replace(
        max_nodes=K12.STREAM_NODES + 1))
    wide = batch._replace(max_in_edges=9)
    assert K12.stream_fits(wide, (1, 2, 3))
    assert not K12.stream_fits(wide, (1, 3, 2))
    in_ptr = batch.in_ptr.numpy()
    rec = batch.e_rec.numpy()
    assert in_ptr[-1] == len(rec) == sum(len(a[0]) for a in arrs)
    for (src, sink, w, *_r), (off, n, *_m) in zip(arrs,
                                                  batch.meta.numpy()):
        node = batch.node_of.numpy()[off : off + n] - off  # by position
        for p in range(n):
            r = rec[in_ptr[off + p] : in_ptr[off + p + 1]]
            assert (np.diff(r[:, 2]) > 0).all()
            assert (sink[r[:, 2]] == node[p]).all()
            assert (src[r[:, 2]] == node[r[:, 0]]).all()
            assert np.array_equal(r[:, 1], w[r[:, 2]].view(np.int32))
