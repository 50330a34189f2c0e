"""Time the host waits on the card: every blocking device-to-host read of
results (``utils.metrics.to_host``: the engine, K5 / K6, K8, K12), from
the program's ``device_wait`` span, in ms a region of the traced window."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("device_wait"):
        return None
    return 1e3 * ctx.phase("device_wait") / ctx.regions
