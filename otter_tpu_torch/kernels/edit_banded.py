"""Kernel K7: banded Levenshtein row DP over any byte alphabet.

Counterpart of ``edit_banded_pallas`` / ``_edit_kernel`` in
``otter_tpu/kernels/edit_pallas.py``, with the inputs that launch takes:
``a`` (B, L) int32 codes of each pair's longer side, ``bpad``
(B, L + 2 (k + 1) + 2) int32 codes of the shorter side shifted right by
k + 1, and ``mn`` (B, 2) int32 lengths, as ``pack_banded`` (the JAX
package's ``_pack_bucket``) builds them. The result is (B,) int32: the
exact distance when it is <= k, INF = 2^24 when |m - n| > k, and the
banded DP's value otherwise (see ``csrc/edit_banded.cu``).

``edit_banded_cuda`` launches the hand-written kernel, ``edit_banded_torch``
is the plain PyTorch version of the same recurrence (the JAX package's
``edit_banded_numpy``), and ``edit_banded`` picks one by device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .myers_pallas import data_ptr

INF = 1 << 24
SMEM_LANES = 1 << 15   # k > 511: the row in shared memory up to W lanes


def pack_banded(pairs: Sequence[Tuple[str, str]], k: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(a, bpad, mn) of ``pairs`` at band k: rows = the longer side, band
    columns = the shorter (latin-1 byte codes; padding 0 never meets a
    valid cell)."""
    pats: List[bytes] = []
    txts: List[bytes] = []
    for p, t in pairs:
        x, y = (p, t) if len(p) >= len(t) else (t, p)
        pats.append(x.encode("latin-1"))
        txts.append(y.encode("latin-1"))
    W = 2 * (k + 1)
    L = max([len(p) for p in pats] + [1])
    a = np.zeros((len(pairs), L), dtype=np.int32)
    bp = np.zeros((len(pairs), L + W + 2), dtype=np.int32)
    mn = np.zeros((len(pairs), 2), dtype=np.int32)
    for i, (pc, tc) in enumerate(zip(pats, txts)):
        a[i, : len(pc)] = np.frombuffer(pc, dtype=np.uint8)
        bp[i, k + 1 : k + 1 + len(tc)] = np.frombuffer(tc, dtype=np.uint8)
        mn[i] = (len(pc), len(tc))
    return a, bp, mn


def _check(a, bpad, mn, k: int) -> None:
    B, L = a.shape
    if a.dtype != torch.int32 or bpad.dtype != torch.int32 \
            or mn.dtype != torch.int32:
        raise ValueError("a, bpad and mn must be int32")
    if bpad.shape != (B, L + 2 * (k + 1) + 2) or mn.shape != (B, 2):
        raise ValueError("bpad must be (B, L + 2 (k + 1) + 2), mn (B, 2)")
    if not (a.device == bpad.device == mn.device):
        raise ValueError("all inputs must be on one device")


def edit_banded_torch(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Plain PyTorch K7, vectorised over pairs: one row update per pattern
    row, the left term as a running minimum (cummin). Returns (B,) int32."""
    _check(a, bpad, mn, k)
    B, L = a.shape
    W = 2 * (k + 1)
    dev = a.device
    w_idx = torch.arange(W, device=dev, dtype=torch.int64).unsqueeze(0)
    m = mn[:, 0].to(torch.int64).clamp(max=L).unsqueeze(1)
    n = mn[:, 1].to(torch.int64).unsqueeze(1)
    j0 = w_idx - (k + 1)
    prev = torch.where((j0 >= 0) & (j0 <= n), j0, INF).expand(B, W).clone()
    inf_col = torch.full((B, 1), INF, device=dev, dtype=torch.int64)
    rows = int(m.max()) if B else 0
    for i in range(1, rows + 1):
        a_col = a[:, i - 1 : i]
        window = bpad[:, i - 1 : i - 1 + W]
        j = i + j0
        sub = (window != a_col).to(torch.int64)
        up = torch.cat([prev[:, 1:], inf_col], dim=1) + 1
        v = torch.minimum(up, prev + sub)
        v = torch.where(j == 0, i, v)
        invalid = (j < 0) | (j > n)
        v = torch.where(invalid, INF, v)
        cur = torch.cummin(v - w_idx, dim=1).values + w_idx
        cur = torch.where(invalid, INF, cur)
        prev = torch.where(i <= m, cur, prev)
    target = (n - m + (k + 1)).clamp(0, W - 1)
    res = prev.gather(1, target).squeeze(1)
    valid = (n - m).abs().squeeze(1) <= k
    return torch.where(valid, res, INF).to(torch.int32)


def edit_banded_cuda(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                     k: int) -> torch.Tensor:
    """K7 on the card (``csrc/edit_banded.cu``): one launch on the current
    stream, no synchronisation; a warp per pair for k <= 511, a block per
    pair above, with the row in device-memory scratch (allocated here) once
    it outgrows shared memory. Raises on bad inputs or a refused launch."""
    from . import _build

    _check(a, bpad, mn, k)
    if not a.is_cuda:
        raise ValueError("edit_banded_cuda takes CUDA tensors")
    B, L = a.shape
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    W = 2 * (k + 1)
    scratch = torch.empty(W * B if W > SMEM_LANES else 0, dtype=torch.int32,
                          device=a.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.otter_edit_banded(data_ptr(a), data_ptr(bpad), data_ptr(mn),
                                    L, k, data_ptr(out), B, data_ptr(scratch),
                                    stream)
    _build.check(lib, err, "edit_banded_cuda")
    edit_banded_cuda.launches += 1
    return out


edit_banded_cuda.launches = 0


def edit_banded(a: torch.Tensor, bpad: torch.Tensor, mn: torch.Tensor,
                k: int) -> torch.Tensor:
    """K7 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if a.is_cuda:
        return edit_banded_cuda(a, bpad, mn, k)
    if a.device.type == "cpu":
        return edit_banded_torch(a, bpad, mn, k)
    raise ValueError(f"no K7 version for device {a.device}")
