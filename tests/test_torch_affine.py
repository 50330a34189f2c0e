"""The port's affine traceback kernel K5 on the CPU (its plain PyTorch
version, otter_tpu_torch/kernels/affine_tb.py) against the JAX package's
Pallas kernel in interpret mode and the host cigar ladder.

Every comparison is exact: end cells and scores are integers, walks and
cigars are compared code for code and byte for byte."""

import random

import numpy as np
import pytest
import torch

from otter_tpu.kernels.affine_pallas import _t_words as jax_t_words
from otter_tpu.kernels.affine_pallas import affine_tb_pallas
from otter_tpu.kernels.affine_pallas import \
    pack_affine_jobs as jax_pack_affine_jobs
from otter_tpu.ops.align_batch import affine_cigars_multi
from otter_tpu_torch.kernels.affine_tb import (BANDS, _t_words,
                                               _unpack_codes,
                                               affine_cigars_tb, affine_tb,
                                               affine_tb_ckpt_cuda,
                                               affine_tb_cuda,
                                               affine_tb_torch,
                                               pack_affine_jobs,
                                               scratch_bytes_per_member)
from test_torch_cuda import last_column_tie_jobs

CPU = torch.device("cpu")


def _acgt(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _mutate(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.4:
            out.append(rng.choice("ACGT"))
        elif r < rate * 0.7:
            out.append(ch)
            out.append(rng.choice("ACGT"))
        elif r >= rate:
            out.append(ch)
    return "".join(out) or "A"


def _jobs(rng, n, lo=60, hi=220):
    """Consensus-shaped jobs: a member against its representative, frees
    on one side or none, a few unrelated members."""
    jobs = []
    for i in range(n):
        rep = _acgt(rng, rng.randint(lo, hi))
        mem = _mutate(rng, rep, rng.choice([0.0, 0.01, 0.05, 0.12]))
        if i % 7 == 6:
            mem = _acgt(rng, len(rep))
        cut = rng.randint(0, len(mem) // 3)
        jobs.append([(mem, rep, 0, 0, 0, 0),
                     (mem[cut:], rep, 0, 0, cut + 3, 0),
                     (mem[: len(mem) - cut], rep, 0, 0, 0, cut + 3),
                     (rep, mem[cut:], cut + 2, 0, 0, 0)][i % 4])
    return jobs


@pytest.mark.parametrize("k", [63, 127])
def test_k5_matches_tpu_kernel_interpret(k):
    """The arrays the TPU launch takes through the Pallas kernel
    (interpret mode) and the port's plain version: the same end cells,
    scores and walked flags, and the same walk codes (exact)."""
    rng = random.Random(5 + k)
    jobs = _jobs(rng, 32)
    max_rows = 256
    tw = jax_t_words(max_rows, k)
    assert tw == _t_words(max_rows, k)
    a, bpad, mn = jax_pack_affine_jobs(jobs, max_rows, k)
    o_jax, e_jax = affine_tb_pallas(a, bpad, mn, k, max_rows, tw,
                                    interpret=True)
    o_jax, e_jax = np.asarray(o_jax), np.asarray(e_jax)
    ops, end = affine_tb_torch(torch.from_numpy(a), torch.from_numpy(bpad),
                               torch.from_numpy(mn), k, tw)
    end = end.numpy()
    assert np.array_equal(end, e_jax[:, :4])
    assert end[: len(jobs), 3].sum() > len(jobs) // 2
    c_jax = _unpack_codes(o_jax, tw)
    c_port = _unpack_codes(ops.numpy(), tw)
    for b in range(len(jobs)):
        assert np.array_equal(c_port[b][c_port[b] != 0],
                              c_jax[b][c_jax[b] != 0])


def test_k5_cigars_equal_host_ladder():
    """affine_cigars_tb on CPU tensors (the plain version) gives the host
    ladder's cigars for every member it walks, and reports the rest failed
    (exact)."""
    rng = random.Random(55)
    jobs = _jobs(rng, 40, lo=80, hi=400)
    cigs, failed = affine_cigars_tb(jobs, CPU)
    want = affine_cigars_multi(jobs)
    walked = [i for i in range(len(jobs)) if i not in set(failed)]
    assert len(walked) > len(jobs) // 2
    for i in walked:
        assert cigs[i] == want[i], i


def test_k5_port_packing_matches_tpu_packing():
    """The port's packer writes the TPU packer's arrays (exact)."""
    rng = random.Random(57)
    jobs = _jobs(rng, 9)
    a, bpad, mn = pack_affine_jobs(jobs, 256, 63)
    a2, bpad2, mn2 = jax_pack_affine_jobs(jobs, 256, 63)
    n = len(jobs)
    assert np.array_equal(a, a2[:n])
    assert np.array_equal(bpad, bpad2[:n, : bpad.shape[1]])
    assert np.array_equal(mn, mn2[:n])


def test_k5_dispatch_and_checks():
    """CPU tensors take the plain version; bad dtypes raise."""
    rng = random.Random(59)
    jobs = _jobs(rng, 4)
    a, bpad, mn = pack_affine_jobs(jobs, 256, 63)
    t = [torch.from_numpy(x) for x in (a, bpad, mn)]
    o1, e1 = affine_tb(*t, 63, 128)
    o2, e2 = affine_tb_torch(*t, 63, 128)
    assert torch.equal(o1, o2) and torch.equal(e1, e2)
    with pytest.raises(ValueError):
        affine_tb_torch(t[0].to(torch.int32), t[1], t[2], 63, 128)


def test_k6_matches_tpu_ckpt_kernel_interpret():
    """The TPU's checkpointed kernel (interpret mode) and the port's K6 on
    CPU tensors (K5's plain version: K6's results are K5's) agree on end
    cells, walked flags and walk codes over members of several 256-row
    blocks (exact)."""
    from otter_tpu.kernels.affine_pallas import affine_tb_ckpt_pallas
    from otter_tpu_torch.kernels.affine_tb import affine_tb_ckpt

    rng = random.Random(61)
    jobs = _jobs(rng, 8, lo=300, hi=480)
    k, max_rows = 63, 512
    tw = jax_t_words(max_rows, k)
    a, bpad, mn = jax_pack_affine_jobs(jobs, max_rows, k)
    o_jax, e_jax = affine_tb_ckpt_pallas(a, bpad, mn, k, max_rows, tw,
                                         interpret=True)
    ops, end = affine_tb_ckpt(torch.from_numpy(a), torch.from_numpy(bpad),
                              torch.from_numpy(mn), k, tw)
    assert np.array_equal(end.numpy(), np.asarray(e_jax)[:, :4])
    c_jax = _unpack_codes(np.asarray(o_jax), tw)
    c_port = _unpack_codes(ops.numpy(), tw)
    for b in range(len(jobs)):
        assert np.array_equal(c_port[b][c_port[b] != 0],
                              c_jax[b][c_jax[b] != 0])


def _codes_equal(o_jax, ops, tw, n):
    c_jax = _unpack_codes(np.asarray(o_jax), tw)
    c_port = _unpack_codes(ops.numpy(), tw)
    return all(np.array_equal(c_port[b][c_port[b] != 0],
                              c_jax[b][c_jax[b] != 0]) for b in range(n))


def test_k6_matches_tpu_ckpt_kernel_interpret_k255():
    """At k = 255 (W = 512 lanes) the TPU's checkpointed kernel
    (interpret mode) and the port's plain version agree on end cells,
    walked flags and walk codes over members of two 256-row blocks
    (exact)."""
    from otter_tpu.kernels.affine_pallas import affine_tb_ckpt_pallas

    rng = random.Random(255)
    jobs = _jobs(rng, 6, lo=280, hi=480)
    k, max_rows = 255, 512
    tw = jax_t_words(max_rows, k)
    a, bpad, mn = jax_pack_affine_jobs(jobs, max_rows, k)
    o_jax, e_jax = affine_tb_ckpt_pallas(a, bpad, mn, k, max_rows, tw,
                                         interpret=True)
    ops, end = affine_tb_torch(torch.from_numpy(a), torch.from_numpy(bpad),
                               torch.from_numpy(mn), k, tw)
    assert np.array_equal(end.numpy(), np.asarray(e_jax)[:, :4])
    assert end[: len(jobs), 3].sum() >= len(jobs) - 1
    assert _codes_equal(o_jax, ops, tw, len(jobs))


def test_k5_last_column_ties_match_tpu_kernel_interpret():
    """Members whose end cell lies on the last column, with the smallest
    score reached at two or more rows: the TPU kernel (interpret mode) and
    the plain version pick the same (largest) row and walk alike (exact)."""
    jobs = last_column_tie_jobs(random.Random(9), 6)
    k, max_rows = 63, 256
    tw = jax_t_words(max_rows, k)
    a, bpad, mn = jax_pack_affine_jobs(jobs, max_rows, k)
    o_jax, e_jax = affine_tb_pallas(a, bpad, mn, k, max_rows, tw,
                                    interpret=True)
    ops, end = affine_tb_torch(torch.from_numpy(a), torch.from_numpy(bpad),
                               torch.from_numpy(mn), k, tw)
    end = end.numpy()[: len(jobs)]
    assert np.array_equal(end, np.asarray(e_jax)[: len(jobs), :4])
    assert np.all(end[:, 1] < [len(j[0]) for j in jobs])   # i < m
    assert np.all(end[:, 2] == [len(j[1]) for j in jobs])  # j == n
    assert _codes_equal(o_jax, ops, tw, len(jobs))


@pytest.mark.parametrize("k", BANDS)
def test_scratch_bytes_per_member_hand_count(k):
    """K5 keeps 4 bits per cell: rows * W / 2 bytes; K6 keeps H and F
    (2 W int32) for each started 256-row block (hand counts)."""
    hand = {63: (128, 1024), 127: (256, 2048), 255: (512, 4096),
            511: (1024, 8192)}
    W, ckpt_bytes = hand[k]
    assert W == 2 * (k + 1)
    assert scratch_bytes_per_member(2048, k, False) == 2048 * W // 2
    assert scratch_bytes_per_member(4096, k, False) == 4096 * (k + 1)
    assert scratch_bytes_per_member(4096, k, True) == 16 * ckpt_bytes
    assert scratch_bytes_per_member(257, k, True) == 2 * ckpt_bytes
    assert scratch_bytes_per_member(256, k, True) == ckpt_bytes


def test_cuda_wrappers_refuse_bands_without_instance():
    """A band the kernels have no template instance for raises before any
    launch; so does a CPU tensor."""
    jobs = _jobs(random.Random(63), 2)
    t = [torch.from_numpy(x) for x in pack_affine_jobs(jobs, 256, 95)]
    for fn in (affine_tb_cuda, affine_tb_ckpt_cuda):
        with pytest.raises(ValueError, match="k must be one of"):
            fn(*t, 95, 128)
    t = [torch.from_numpy(x) for x in pack_affine_jobs(jobs, 256, 63)]
    for fn in (affine_tb_cuda, affine_tb_ckpt_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*t, 63, 128)
