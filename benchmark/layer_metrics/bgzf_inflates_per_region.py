"""BGZF blocks inflated a region (``io/bgzf.py``), from the program's
``bgzf_inflates`` counter over the traced window."""


def read(ctx):
    if not ctx.regions or "count.bgzf_inflates" not in ctx.snapshot:
        return None
    return ctx.snapshot["count.bgzf_inflates"] / ctx.regions
