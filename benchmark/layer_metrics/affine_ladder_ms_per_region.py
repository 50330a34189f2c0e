"""The native band ladder of the consensus
(``ops.align_batch.affine_cigars_multi`` on the members K5 / K6 could not
prove optimal), from the program's ``affine_ladder`` span, in ms a region
of the traced window; part of ``consensus_batch``."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("affine_ladder"):
        return None
    return 1e3 * ctx.phase("affine_ladder") / ctx.regions
