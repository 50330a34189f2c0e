"""The distance engine's ladders (``kernels.edit_engine``: the K3 rungs
with K2 for what they leave, the K7 rungs, the K4 rungs of the ends-free
jobs), each rung's launch and read of its results, from the program's
``ladder`` span, in ms a region of the traced window."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("ladder"):
        return None
    return 1e3 * ctx.phase("ladder") / ctx.regions
