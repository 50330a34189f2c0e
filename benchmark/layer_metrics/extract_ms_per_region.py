"""BAM decode in region preparation (``seqs.extract.parse_anreads``: the
BAI query, BGZF inflate and record decode of the native extractor), from
the program's ``extract`` span, in ms a region of the traced window; part
of ``host_io``."""


def read(ctx):
    if not ctx.regions or not ctx.has_phase("extract"):
        return None
    return 1e3 * ctx.phase("extract") / ctx.regions
