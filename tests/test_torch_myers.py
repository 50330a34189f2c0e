"""Kernel K1 of the PyTorch port (otter_tpu_torch/kernels/myers_pallas.py)
against the JAX package's Pallas kernel and the numpy oracles.

Every comparison is exact: the results are integer edit distances and
packed words, so the tolerance is zero."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from otter_tpu.kernels import myers_pallas as jax_k1
from otter_tpu.ops.align_np import edit_distance
from otter_tpu_torch.kernels import myers_pallas as K1


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _pool_case(seed, n_words, text_len, n_pairs):
    """Pool arrays in the JAX launch layout: B = one TPU program of pairs,
    padding pairs at idx 0 with nlen = minit = 0."""
    rng = random.Random(seed)
    pats = [_acgt(rng, rng.randint(1, 32 * n_words)) for _ in range(24)]
    txts = [_mutate(rng, p, 0.1) + _acgt(rng, rng.randint(0, 40))
            for p in pats[:12]]
    txts += [_acgt(rng, rng.randint(32 * n_words, text_len))
             for _ in range(12)]
    seqs = pats + txts
    pool = jax_k1.pack_pool_2bit(seqs, K1.pool_width(n_words, text_len))
    B = jax_k1.PAIRS_PER_PROG
    ip = np.zeros(B, np.int32)
    it = np.zeros(B, np.int32)
    nlen = np.zeros(B, np.int32)
    minit = np.zeros(B, np.int32)
    for b in range(n_pairs):
        p = rng.randrange(24)
        t = 24 + rng.randrange(24)
        if len(seqs[p]) > len(seqs[t]):
            p, t = t, p
        ip[b], it[b] = p, t
        minit[b], nlen[b] = len(seqs[p]), len(seqs[t])
    return seqs, pool, ip, it, nlen, minit


def test_pack_pool_bit_identical():
    """The port's native packer gives the JAX package's pool words bit for
    bit (exact)."""
    rng = random.Random(5)
    seqs = [_acgt(rng, n) for n in (0, 1, 15, 16, 17, 100, 513)]
    assert np.array_equal(K1.pack_pool(seqs, 40),
                          jax_k1.pack_pool_2bit(seqs, 40))


@pytest.mark.parametrize("n_words,text_len", [(4, 256), (8, 512)])
def test_myers_pool_torch_matches_pallas_interpret(n_words, text_len):
    """One set of numpy arrays through myers_pool_pallas (interpret mode)
    and myers_pool_torch: every output slot, padding included, is equal
    (exact), and the live pairs equal the numpy DP oracle."""
    seqs, pool, ip, it, nlen, minit = _pool_case(11 + n_words, n_words,
                                                 text_len, 900)
    want = np.asarray(jax_k1.myers_pool_pallas(
        jnp.asarray(pool), jnp.asarray(ip), jnp.asarray(it),
        jnp.asarray(nlen), jnp.asarray(minit), n_words, text_len,
        interpret=True)).reshape(-1)
    got = K1.myers_pool_torch(_t(pool), _t(ip), _t(it), _t(nlen), _t(minit),
                              n_words, text_len).numpy()
    assert np.array_equal(got, want)
    oracle = [edit_distance(seqs[ip[b]], seqs[it[b]]) for b in range(900)]
    assert got[:900].tolist() == oracle


def test_myers_pool_edge_lengths():
    """Pattern lengths at the 32/64-bit word edges, equal strings and
    texts of 0-30% error equal the numpy DP oracle (exact)."""
    rng = random.Random(7)
    pairs = []
    for m in (1, 2, 31, 32, 33, 63, 64, 65, 127, 128):
        s = _acgt(rng, m)
        pairs += [(s, s), (s, _mutate(rng, s, 0.3)),
                  (s, _acgt(rng, m + rng.randint(0, 200)))]
    seqs = []
    ip, it, ml, nl = [], [], [], []
    for a, b in pairs:
        p, t = (a, b) if len(a) <= len(b) else (b, a)
        ip.append(len(seqs))
        seqs.append(p)
        it.append(len(seqs))
        seqs.append(t)
        ml.append(len(p))
        nl.append(len(t))
    pool = K1.pack_pool(seqs, K1.pool_width(4, 512))
    got = K1.myers_pool(_t(pool), _t(ip), _t(it), _t(nl), _t(ml), 4, 512)
    assert got.tolist() == [edit_distance(a, b) for a, b in pairs]


def test_myers_pool_uncaptured_slots_keep_minit():
    """Where the TPU kernel captures no score (nlen 0, nlen > text_len,
    m > 32 * n_words) the result is minit, as on the TPU (exact)."""
    seqs = ["ACGT" * 40, "ACGA" * 40]
    pool = _t(K1.pack_pool(seqs, K1.pool_width(4, 160)))
    ip, it = _t([0, 0, 0]), _t([1, 1, 1])
    nlen, minit = _t([0, 161, 160]), _t([5, 7, 129])
    got = K1.myers_pool_torch(pool, ip, it, nlen, minit, 4, 160)
    assert got.tolist() == [5, 7, 129]


def test_myers_pool_cuda_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU tensors raise."""
    pool = _t(K1.pack_pool(["ACGT"], 8))
    one = _t([0])
    before = K1.myers_pool_cuda.launches
    with pytest.raises(ValueError):
        K1.myers_pool_cuda(pool, one, one, _t([4]), _t([4]), 4, 16)
    assert K1.myers_pool_cuda.launches == before
