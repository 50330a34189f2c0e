"""Local realignment in region preparation
(``ops.consensus.local_realignment``: one native gap-affine ladder call a
region), from the program's ``realign`` span, in ms a region of the traced
window; part of ``host_io``."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("realign"):
        return None
    return 1e3 * ctx.phase("realign") / ctx.regions
