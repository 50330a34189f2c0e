"""Share of the distance kernels' bound: the least time of the all-vs-all
work the window's inputs need (``roofline.py``) over the device time of
the kernels below in the profiler trace, in percent.

The kernels: K1 (``myers_pool_kernel``, ``csrc/myers.cu``), K3 (the
``myers_banded_kernel`` instances without free ends, ``myers_banded.cu``)
and K7 (``edit_banded_warp_kernel`` / ``edit_banded_block_kernel`` without
free ends, ``edit_banded.cu``, pairs with N bases). K2, K4 and K9, the
ends-free kernels, serve reassignment and the consensus hints and are not
this work. A new distance kernel is named in a new metric file."""

import re

from benchmark.roofline import bound_seconds

KERNELS = re.compile(
    r"(^|::)(myers_pool_kernel<|myers_banded_kernel<\d+, false>"
    r"|edit_banded_warp_kernel<\d+, false>|edit_banded_block_kernel<false>)")


def read(ctx):
    if not ctx.needed_cells:
        return None
    kernel_s = ctx.kernel_seconds(lambda name: bool(KERNELS.search(name)))
    if kernel_s <= 0:
        return None
    bound_s, _by = bound_seconds(ctx.needed_cells, ctx.needed_bytes,
                                 ctx.sm_hz)
    return 100.0 * bound_s / kernel_s
