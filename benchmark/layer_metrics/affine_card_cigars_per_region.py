"""Consensus members a region whose cigar came finished from K5 / K6's
cigar bytes (``kernels/affine_tb.py::affine_cigars_tb``), from the
program's ``affine_card_cigars`` counter over the traced window; nothing
where the program has no such counter."""


def read(ctx):
    if not ctx.regions or "count.affine_card_cigars" not in ctx.snapshot:
        return None
    return ctx.snapshot["count.affine_card_cigars"] / ctx.regions
