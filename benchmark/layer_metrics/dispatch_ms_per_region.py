"""The distance engine's host side (``kernels.edit_engine``: routing, pool
packing, copies to the card, ladders, the waits for results), from the
program's ``device_dispatch`` phase less the K8 launch it holds
(``kde_device``), in ms a region of the traced window."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("device_dispatch"):
        return None
    return 1e3 * (ctx.phase("device_dispatch")
                  - ctx.phase("kde_device")) / ctx.regions
