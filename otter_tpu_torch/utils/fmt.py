"""C++ iostream-compatible numeric formatting.

The reference emits floats with default std::ostream formatting (6 significant
digits, %g-style switching between fixed and scientific), e.g. the ``se:f:``
tag (src/anseqs.cpp:50) and the HSD INFO field (src/genotype.cpp:49-53).
Python's ``%g`` implements the same C printf semantics, so we use it directly;
``float`` (C++ 32-bit) values are rounded through float32 first because the
reference stores them as float before streaming.
"""

import math

import numpy as np


def fmt_double(x) -> str:
    """Format a C++ ``double`` the way ``std::cout << x`` would."""
    x = float(x)
    if x != x:
        return "nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    return "%g" % x


_FMT_FLOAT_CACHE: dict = {}


def fmt_float(x) -> str:
    """Format a C++ ``float`` the way ``std::cout << x`` would. Memoized:
    tag values (se etc.) repeat heavily across cohort VCF rows."""
    x = float(x)
    # key on (value, sign) — 0.0 and -0.0 are ==/hash-equal as dict keys
    # but C++ iostream prints "-0" for negative zero, so a value-only key
    # would let whichever sign was cached first win
    key = (x, math.copysign(1.0, x))
    got = _FMT_FLOAT_CACHE.get(key)
    if got is None:
        if len(_FMT_FLOAT_CACHE) > 65536:
            _FMT_FLOAT_CACHE.clear()
        got = _FMT_FLOAT_CACHE[key] = fmt_double(float(np.float32(x)))
    return got
