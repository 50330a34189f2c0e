"""Timestamped stderr logging.

The reference logs every diagnostic line to stderr prefixed with a ctime
string (src/antimestamp.hpp:11-19); all informational output goes to stderr
so that stdout stays a clean SAM/FASTA/VCF stream.
"""

import sys
import time


def antimestamp() -> str:
    """Current time as a ctime-style string, e.g. 'Mon Aug 17 12:00:00 2026'."""
    return time.ctime()


def log(msg: str) -> None:
    sys.stderr.write(f"({antimestamp()}): {msg}\n")


def warn(msg: str) -> None:
    sys.stderr.write(f"({antimestamp()}): [WARNING] {msg}\n")
