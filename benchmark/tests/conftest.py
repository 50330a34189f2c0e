"""Small deployments for the benchmark's CPU tests: the cells' own files
with fewer, shorter loci and reads."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

_PANEL_LOCI = [
    {"gene": "HTT", "motif": "CAG", "normal": [10, 26]},
    {"gene": "DMPK", "motif": "CTG", "normal": [5, 34]},
    {"gene": "C9orf72", "motif": "GGGGCC", "normal": [2, 23]},
]

TINY = {
    "hifi30x.catalog": {
        "config": {"loci": 6, "coverage": 8, "read_len_mean": 3000,
                   "read_len_sd": 800},
        "traffic": {"spacing": 1500, "check_regions": 6,
                    "ref_len": [40, 400], "alt_units": [1, 8]}},
    "panel200x.expansions": {
        "config": {"samples": 2, "coverage": [20, 30], "flank": [150, 400]},
        "traffic": {"check_regions": 6, "loci": _PANEL_LOCI, "samples": [
            {"name": "NORMAL", "expanded": {}},
            {"name": "DM1", "expanded": {"DMPK": [200, None]}}]}},
}
