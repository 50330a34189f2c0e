"""Blocking device-to-host reads a region (``utils.metrics.to_host``),
from the program's ``device_syncs`` counter over the traced window."""


def read(ctx):
    if not ctx.regions or "count.device_syncs" not in ctx.snapshot:
        return None
    return ctx.snapshot["count.device_syncs"] / ctx.regions
