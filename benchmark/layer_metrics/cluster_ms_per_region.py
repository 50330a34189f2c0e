"""Clustering (``ops.cluster``: average linkage and the cut, then the
reassignment of reads that do not span and the consensus preparation),
from the program's ``cluster_labels`` and ``cluster_finish`` phases, in ms
a region of the traced window."""

PHASES = ("cluster_labels", "cluster_finish")


def read(ctx):
    if not ctx.regions or not any(ctx.has_phase(p) for p in PHASES):
        return None
    return 1e3 * sum(ctx.phase(p) for p in PHASES) / ctx.regions
