"""Region preparation on the host (``models.assemble.prepare_region``:
BAM decode by the native extractor, local realignment, filters), from the
program's ``host_io`` phase, in ms a region of the traced window."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("host_io"):
        return None
    return 1e3 * ctx.phase("host_io") / ctx.regions
