#!/usr/bin/env python3
"""Count the SASS instructions of one plain step of the K3 / K4 kernels.

    cuobjdump -sass build/otter_tpu_torch/libotter_kernels.*.so \\
        | python3 tools/sass_steps.py

reads a ``cuobjdump -sass`` dump of the kernels' library on standard input
and prints, for each ``myers_banded_kernel<Q, ends-free>`` instance, the
instructions of its text loop and of the loop's plain step: the step that
no group ends a segment in (the first ``__any_sync`` is false) and where
every lane runs all its columns with no block entering (the second is
false), which is the path of ~15 of each 16 steps. The plain step is
counted as the spans it runs through (loop head to the first vote's
branch, that branch's target to the second vote's branch, the fall-through
to the jump past the other path, and the jump's target to the loop's back
branch), so small branches inside a span (a text word's load, lane 0's
carries) count as run. Prints one line per instance and the per-slot and
per-column figures, with ``(span(Q) - span(1)) / (Q - 1)`` as the
instructions a window slot adds to a step of four columns.
"""

from __future__ import annotations

import re
import sys

FUNC = re.compile(r"Function : (\S*myers_banded_kernelILi(\d+)ELb([01])E\S*)")
INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                 r"\s*([^;]*);")


def parse(lines):
    """{(Q, ends_free): [(addr, pred, op, args)]} of the banded kernels."""
    out, cur = {}, None
    for line in lines:
        f = FUNC.search(line)
        if f:
            cur = out.setdefault((int(f.group(2)), f.group(3) == "1"), [])
            continue
        if "Function :" in line:
            cur = None
            continue
        m = INS.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4).strip()))
    return out


def target(args: str) -> int:
    return int(args.split()[0].rstrip(" ;"), 16)


def plain_step(ins) -> tuple:
    """(instructions of the text loop, of its plain step)."""
    back = [(target(a), at) for at, p, op, a in ins
            if op == "BRA" and p and target(a) < at]
    head, tail = max(back, key=lambda b: b[1] - b[0])
    body = [x for x in ins if head <= x[0] <= tail]
    votes = [i for i, x in enumerate(body) if x[2] == "VOTE.ANY"]
    if len(votes) != 2:
        raise ValueError(f"expected two votes in the loop, found {len(votes)}")

    def branch_after(i):
        for x in body[i + 1:]:
            if x[2] == "BRA":
                return x
        raise ValueError("no branch after a vote")

    b1 = branch_after(votes[0])  # @!P: no group ends its segment -> target
    b2 = branch_after(votes[1])  # @P: some step is not plain -> target
    if not b1[1].startswith("@!") or b2[1].startswith("@!"):
        raise ValueError("unexpected branch senses after the votes")
    x1 = target(b1[3])
    jump = next(x for x in body if x[0] > b2[0] and x[2] == "BRA"
                and not x[1])
    z = target(jump[3])
    spans = ((head, b1[0]), (x1, b2[0]), (b2[0] + 16, jump[0]), (z, tail))
    return (tail - head) // 16 + 1, sum((b - a) // 16 + 1 for a, b in spans)


def main() -> int:
    found = parse(sys.stdin)
    if not found:
        raise SystemExit("no myers_banded_kernel instance in the dump")
    for ef in (False, True):
        rows = {q: plain_step(ins) for (q, e), ins in found.items() if e == ef}
        for q in sorted(rows):
            loop, step = rows[q]
            print(f"K{4 if ef else 3} Q {q}: loop {loop}, plain step {step} "
                  f"({step / 4:.1f} a column a lane)")
        qs = sorted(rows)
        if len(qs) > 1:
            slot = (rows[qs[-1]][1] - rows[qs[0]][1]) / (qs[-1] - qs[0])
            fixed = rows[qs[0]][1] - slot * qs[0]
            print(f"K{4 if ef else 3}: a slot adds {slot:.1f} to a plain step "
                  f"({slot / 4:.1f} a block column); the rest of a step "
                  f"{fixed:.1f} ({fixed / 4:.1f} a column)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
