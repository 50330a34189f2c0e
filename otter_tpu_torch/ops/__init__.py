from .align_np import (
    edit_distance,
    edit_distance_ends_free,
    affine_align_cigar,
    affine_align_ends_free_cigar,
)
