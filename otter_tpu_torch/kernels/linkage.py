"""Kernel K11: global-minimum average linkage in float32.

Counterpart of ``average_linkage_device`` in
``otter_tpu/ops/hclust_device.py`` (jnp, not Pallas). Input: ``D`` (B, n,
n) float32, B symmetric distance matrices (diagonals ignored). The result
is ``(recs, heights)``: (B, n - 1, 2) int32 slot pairs (i, j), i < j, and
(B, n - 1) float32 merge heights. Step k takes the least active D[i][j]
(i < j; the lowest (i, j) in row-major order on ties), then folds j into
i: D[i][c] = D[c][i] = fl(fma(si, D[i][c], fl(sj D[j][c])) / max(si + sj,
1)), the fused multiply-add that XLA on the CPU compiles the JAX
function's ``si * D[i, :] + sj * D[j, :]`` into.

``linkage_cuda`` launches the hand-written kernel (``csrc/linkage.cu``) on
one of three routes chosen by n and the card (``linkage_plan``): one
block with D in shared memory, a thread block cluster with D's upper
triangle in its distributed shared memory where the card can place it, or
one block with D in device memory;
``linkage_torch`` is the plain PyTorch version (the JAX function's full
scan a step), and ``linkage`` picks one by device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .myers_pallas import data_ptr

# the JAX function's mask value
_INF = 3.0e38
# matrices larger than this do not fit the kernel's per-row state
N_MAX = 12288
# the kernel's routes, by the numbers csrc/linkage.cu gives them
ROUTES = ("shared", "cluster", "l2")


def _check(D) -> None:
    if D.dtype != torch.float32 or D.dim() != 3 \
            or D.shape[1] != D.shape[2]:
        raise ValueError("D must be (B, n, n) float32")
    if D.shape[1] > N_MAX:
        raise ValueError(f"n must be at most {N_MAX}, not {D.shape[1]}")


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """fl32(a b + c) with one rounding, for float32 tensors (PyTorch has no
    fused multiply-add). a b is exact in float64 (two 24-bit mantissas),
    and TwoSum gives the float64 sum s and its exact error e. Rounding s
    to float32 would round twice where s falls on a float32 midpoint and e
    is not 0, so s is first rounded to odd: where e != 0 and s's last bit
    is even, s steps one float64 ulp towards e. A float64 value rounded to
    odd then rounds to float32 as the exact sum would (53 >= 24 + 2 bits).
    Exact for finite a b + c within float32's range."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def linkage_torch(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K11: the JAX function's steps, each a full scan of the
    active upper triangle (O(n^3) in all)."""
    _check(D)
    B, n, _ = D.shape
    dev = D.device
    recs = torch.empty((B, max(n - 1, 0), 2), dtype=torch.int32, device=dev)
    hs = torch.empty((B, max(n - 1, 0)), dtype=torch.float32, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    triu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), 1)
    flat_ids = torch.arange(n * n, device=dev)
    for b in range(B):
        M = torch.where(eye, _INF, D[b])
        sizes = torch.ones(n, dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        for k in range(n - 1):
            valid = active[:, None] & active[None, :] & triu
            Dt = torch.where(valid, M, _INF).reshape(-1)
            h = Dt.min()
            flat = int(torch.where(Dt == h, flat_ids, n * n).min())
            i, j = divmod(flat, n)
            si, sj = sizes[i], sizes[j]
            row = fma_f32(si, M[i], sj * M[j]) / torch.clamp(si + sj,
                                                             min=1.0)
            M[i] = row
            M[:, i] = row
            M[i, i] = _INF
            sizes[i] = si + sj
            sizes[j] = 0.0
            active[j] = False
            recs[b, k, 0] = i
            recs[b, k, 1] = j
            hs[b, k] = h
    return recs, hs


def linkage_plan(n: int, lib=None) -> Tuple[str, int, int]:
    """(route, cluster size, shared memory bytes a block) of K11's launch
    for n x n matrices on the current card: the kernel library's own rule
    (``lib``: the built library by default); the L2 route where the card
    cannot place the cluster the triangle needs."""
    if lib is None:
        from . import _build

        lib = _build.load()
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.otter_linkage_plan(n, *(ctypes.byref(x) for x in out))
    if err:
        raise ValueError(f"no K11 route for n = {n}")
    return ROUTES[out[0].value], out[1].value, out[2].value


def linkage_cuda(D: torch.Tensor, route: Optional[str] = None,
                 cluster: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 on the card (``csrc/linkage.cu``): one launch on the current
    stream on ``linkage_plan``'s route (``route`` forces one: "cluster"
    with ``cluster`` blocks, "l2", or "shared" where D fits), counted in
    ``linkage_cuda.routes``. The cluster route holds D's upper triangle
    only, so there D must be symmetric: the check waits for D, and a D
    that is not raises (the other routes read D whole, as the plain
    version does, and need no check). Raises on bad inputs or a refused
    launch, a forced cluster the card cannot place included."""
    from . import _build

    _check(D)
    if not D.is_cuda:
        raise ValueError("linkage_cuda takes CUDA tensors")
    B, n, _ = D.shape
    recs = torch.empty((B, max(n - 1, 0), 2), dtype=torch.int32,
                       device=D.device)
    hs = torch.empty((B, max(n - 1, 0)), dtype=torch.float32,
                     device=D.device)
    if B == 0 or n < 2:
        return recs, hs
    lib = _build.load()
    stream = torch.cuda.current_stream(D.device).cuda_stream
    with torch.cuda.device(D.device):
        name = route or linkage_plan(n, lib)[0]
        if name == "cluster" and not torch.equal(D, D.transpose(1, 2)):
            raise ValueError("D must be symmetric on K11's cluster route")
        # the working copy of matrices on the L2 route
        scratch = torch.empty_like(D) if name == "l2" else D
        if route is None:
            err = lib.otter_linkage(data_ptr(D), n, B, data_ptr(scratch),
                                    data_ptr(recs), data_ptr(hs), stream)
        else:
            err = lib.otter_linkage_route(
                data_ptr(D), n, B, data_ptr(scratch), data_ptr(recs),
                data_ptr(hs), ROUTES.index(route), cluster, stream)
    _build.check(lib, err, f"linkage_cuda ({name} route)")
    linkage_cuda.launches += 1
    linkage_cuda.routes[name] += 1
    return recs, hs


linkage_cuda.launches = 0
linkage_cuda.routes = dict.fromkeys(ROUTES, 0)


def linkage(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 by device: the CUDA kernel for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if D.is_cuda:
        return linkage_cuda(D)
    if D.device.type == "cpu":
        return linkage_torch(D)
    raise ValueError(f"no K11 version for device {D.device}")
