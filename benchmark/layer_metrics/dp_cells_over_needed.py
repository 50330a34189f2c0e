"""DP cells the distance engine computed (``counters()["cells"]`` of every
engine the window's passes built: all-vs-all pairs, reassignment pairs and
jobs, consensus hints, ladder rungs) over the cells the window's
all-vs-all pairs need (``roofline.needed_cells``)."""


def read(ctx):
    if ctx.engine_cells is None or not ctx.needed_cells:
        return None
    return ctx.engine_cells / ctx.needed_cells
