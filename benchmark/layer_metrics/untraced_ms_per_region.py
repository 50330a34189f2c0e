"""The part of each ``models.assemble.assemble`` call that no span under
it covers: the self time of the program's root span ``assemble``, in ms a
region of the traced window."""


def read(ctx):
    if not ctx.regions or "self.assemble" not in ctx.snapshot:
        return None
    return 1e3 * ctx.snapshot["self.assemble"] / ctx.regions
