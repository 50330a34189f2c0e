"""Share of the traced window in which no operation ran on the card
(kernels, copies, fills: the union of their intervals in the
``torch.profiler`` trace), in percent."""


def read(ctx):
    if not ctx.window_s or ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
