"""Share of the consensus members given to K5 / K6
(``kernels/affine_tb.py::affine_cigars_tb``) whose cigar came finished
from the card's cigar bytes, in %: the program's ``affine_card_cigars``
counter over its ``affine_cigar_members`` counter in the traced window;
nothing where the program has no such counters or gave no member."""


def read(ctx):
    members = ctx.snapshot.get("count.affine_cigar_members")
    cigars = ctx.snapshot.get("count.affine_card_cigars")
    if not members or cigars is None:
        return None
    return 100.0 * cigars / members
