"""The consensus (``ops.consensus.consensus_apply_batched``: the band
hints, K5 / K6 in ``kernels.affine_tb`` with their host packing, the
native band ladder, the native partial-order graphs), from the program's
``consensus_batch`` phase, in ms a region of the traced window."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("consensus_batch"):
        return None
    return 1e3 * ctx.phase("consensus_batch") / ctx.regions
