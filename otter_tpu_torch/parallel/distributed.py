"""Multi-process execution: region sharding over ``torch.distributed``.

Counterpart of ``otter_tpu/parallel/distributed.py``. The reference's
single-node thread pool over regions (BS_thread_pool, src/assemble.cpp:43)
becomes, across processes:

  process p handles the p-th contiguous block of BED regions (regions are
  independent, so the recovery unit is a region, SURVEY.md §5), on its own
  card (``bind_device``) or on a card it shares;
  outputs, two modes:
    per-process streams (default): each process writes its block in order
      to its own stream; concatenating them in process order gives the
      one-process byte stream;
    writer gather (OTTER_TPU_GATHER=1): every block is gathered to process
      0 and written there as one stream, the analog of the reference's
      mutex-serialized stdout (src/assemble.cpp:42,143-149).

The environment is the JAX package's: ``JAX_COORDINATOR_ADDRESS`` (or
``COORDINATOR_ADDRESS``) as host:port, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID`` and ``OTTER_TPU_COORD_TIMEOUT_S``; with an address but no
``JAX_NUM_PROCESSES``, torchrun's ``WORLD_SIZE`` and ``RANK`` give the
topology (where jax would detect the cluster). Process 0 serves the
rendezvous at the address. Collectives run over gloo on CPU tensors: what
is gathered is host text, and NCCL refuses two ranks on one card. Without
an address, or with an invalid topology or an unreachable coordinator,
everything runs in one process, with a warning for the last two.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.timestamp import antimestamp

# the rendezvous wait without OTTER_TPU_COORD_TIMEOUT_S: jax.distributed's
# default initialization_timeout
DEFAULT_COORD_TIMEOUT_S = 300.0
# a collective waits for the slowest process's shard, which may take hours
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=24)


def _warn(msg: str) -> None:
    sys.stderr.write(f"({antimestamp()}): [WARNING] {msg}\n")


def _validated_topology() -> Optional[dict]:
    """Parse and validate the coordinator environment: (host, port,
    world_size, rank, timeout_s), or None for 'run single-process' (an
    invalid configuration degrades with a warning instead of hanging;
    region independence makes one process a correct, if slow, fallback)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    if not addr:
        return None
    host, _, port_s = addr.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = 0
    if not host or not 0 < port < 65536:
        _warn(f"coordinator address {addr!r} is not host:port; "
              "running single-process")
        return None
    if os.environ.get("JAX_NUM_PROCESSES"):
        count_name, index_name = "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"
    elif os.environ.get("WORLD_SIZE"):
        count_name, index_name = "WORLD_SIZE", "RANK"
    else:
        _warn(f"coordinator {addr} but no process count (JAX_NUM_PROCESSES, "
              "or torchrun's WORLD_SIZE and RANK); running single-process")
        return None
    nproc_s = os.environ[count_name]
    try:
        nproc = int(nproc_s)
    except ValueError:
        _warn(f"{count_name}={nproc_s!r} is not an integer; "
              "running single-process")
        return None
    if nproc <= 0:
        _warn(f"{count_name}={nproc} must be >= 1; running single-process")
        return None
    pid_s = os.environ.get(index_name, "0")
    try:
        pid = int(pid_s)
    except ValueError:
        _warn(f"{index_name}={pid_s!r} is not an integer; "
              "running single-process")
        return None
    if not 0 <= pid < nproc:
        _warn(f"{index_name}={pid} out of range for {count_name}={nproc}; "
              "running single-process")
        return None
    timeout_s = DEFAULT_COORD_TIMEOUT_S
    env_timeout = os.environ.get("OTTER_TPU_COORD_TIMEOUT_S")
    if env_timeout:
        try:
            timeout_s = max(1.0, float(env_timeout))
        except ValueError:
            _warn(f"OTTER_TPU_COORD_TIMEOUT_S={env_timeout!r} ignored "
                  "(not a number)")
    return dict(host=host, port=port, world_size=nproc, rank=pid,
                timeout_s=timeout_s)


def maybe_initialize() -> Tuple[int, int]:
    """Set up the gloo process group when a coordinator is configured;
    returns (process_index, process_count), (0, 1) without one.

    The rendezvous is bounded by OTTER_TPU_COORD_TIMEOUT_S (300 s by
    default): process 0 waits that long for the others to join, the others
    that long for process 0 to listen. A rendezvous that fails or times out
    raises inside ``torch.distributed``, and the process then runs alone
    with a warning, as the JAX package degrades. A group already set up by
    the caller is used as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    topo = _validated_topology()
    if topo is None:
        return 0, 1
    where = f"{topo['host']}:{topo['port']}"
    try:
        store = dist.TCPStore(
            topo["host"], topo["port"], topo["world_size"],
            is_master=topo["rank"] == 0,
            timeout=datetime.timedelta(seconds=topo["timeout_s"]),
            wait_for_workers=True)
        dist.init_process_group("gloo", store=store, rank=topo["rank"],
                                world_size=topo["world_size"],
                                timeout=COLLECTIVE_TIMEOUT)
    except (RuntimeError, OSError) as e:
        _warn(f"rendezvous at {where} failed with a "
              f"{topo['timeout_s']:.0f} s timeout ({e}); "
              "running single-process")
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@contextlib.contextmanager
def process_group():
    """``maybe_initialize``'s (process_index, process_count) for a block of
    work; a group this call set up is destroyed at the end of the block,
    once the output is written (a group left open can hang the interpreter
    at exit). No barrier: a process whose shard is done leaves at once."""
    import torch.distributed as dist

    owned = not dist.is_initialized()
    pidx, pcount = maybe_initialize()
    try:
        yield pidx, pcount
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def bind_device(device: str, process_index: int) -> str:
    """The device this process runs on. For ``cuda``: card ``LOCAL_RANK``
    (else the process index) modulo the card count, made the process's
    current device, since the kernels' launchers launch on the current
    device; every process shares the card where there is one. For
    ``mesh``: the process's mesh is its visible cards, capped by
    ``OTTER_TPU_MESH_DEVICES`` (``parallel/mesh.py::make_mesh``), and its
    current device the mesh's first card; processes on one host split the
    cards with ``CUDA_VISIBLE_DEVICES``. Raises for ``cuda`` and ``mesh``
    without a card. Other devices come back unchanged."""
    if device not in ("cuda", "mesh"):
        return device
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is false")
    if device == "mesh":
        from .mesh import make_mesh

        torch.cuda.set_device(make_mesh()[0])
        return device
    local = int(os.environ.get("LOCAL_RANK", process_index))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def shard_regions(regions: Sequence, process_index: int,
                  process_count: int) -> List:
    """Contiguous block partition of regions across processes (output order
    is rebuilt by concatenation in process order). A process whose index is
    past the region count gets an EMPTY shard (it still joins the
    collectives, emitting nothing)."""
    n = len(regions)
    base = n // process_count
    extra = n % process_count
    start = process_index * base + min(process_index, extra)
    size = base + (1 if process_index < extra else 0)
    return list(regions[start : start + size])


def gather_enabled(process_count: int) -> bool:
    """Writer gather mode (OTTER_TPU_GATHER=1): the whole stream comes out
    of process 0 instead of one stream per process."""
    return process_count > 1 and os.environ.get("OTTER_TPU_GATHER") == "1"


def gather_text_to_writer(text: str, process_index: int,
                          process_count: int) -> Optional[str]:
    """Collective gather of per-process output blocks to process 0.

    Every process gives its block (SAM/FASTA/VCF text, ASCII); process 0
    gets the blocks concatenated in process order, byte-equal to the
    one-process stream, and every other process gets None. Blocks differ in
    length, so two all-gathers run over gloo: the lengths, then the blocks
    padded to the longest as uint8. A failed collective raises."""
    if process_count <= 1:
        return text
    import torch
    import torch.distributed as dist

    data = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64))
    sizes = [int(t.item()) for t in lens]
    mx = max(sizes)
    if mx == 0:
        return "" if process_index == 0 else None
    buf = torch.zeros(mx, dtype=torch.uint8)
    buf[: len(data)] = torch.from_numpy(data.copy())
    blocks = [torch.zeros(mx, dtype=torch.uint8)
              for _ in range(process_count)]
    dist.all_gather(blocks, buf)
    if process_index != 0:
        return None
    return b"".join(blocks[p][: sizes[p]].numpy().tobytes()
                    for p in range(process_count)).decode("ascii")
