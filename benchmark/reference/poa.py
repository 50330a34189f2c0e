"""Backbone-anchored partial-order-alignment graph ("PPOA").

Exact semantics port of the reference header-only engine (src/anppoa.hpp):
backbone nodes with homopolymer flags and ending_nodes = last 10 backbone
nodes (:64-84), cigar-driven graph extension with alt nodes appended past the
backbone (:112-241, ending-node rule :237), weight pruning
``w -= max(c, t*w)`` (:243-252), and heaviest-path consensus over the
topologically-drained node list (:254-344, best ending node :356-367).

The graph build is inherently sequential per allele; it runs on the host
(it is O(members * len), far off the hot path — the hot path is the O(n^2)
distance matrix, which runs on TPU).

Frozen copy of ``otter_tpu_torch/ops/poa.py`` at commit eda140f.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple


class Ppoa:
    def __init__(self, backbone: str = ""):
        self.backbone = ""
        self.hps: List[bool] = []
        self.nodes: List[str] = []
        self.edges: List[List[List]] = []  # per-source [sink, weight] pairs
        self.starting_nodes: List[int] = []
        self.ending_nodes: Set[int] = set()
        self.last_id = 0
        if backbone:
            self.init(backbone)

    def init(self, backbone: str) -> None:
        self.backbone = backbone
        n = len(backbone)
        self.hps = [False] * n
        self.nodes = [""] * n
        self.edges = [[] for _ in range(n)]
        self.last_id = n
        for i in range(1, n):
            if i == 1:
                self.insert_node(0, backbone[0])
                self.starting_nodes.append(0)
            self.insert_node(i, backbone[i])
            self.insert_edge(i - 1, i)
            if backbone[i] == backbone[i - 1]:
                self.hps[i] = True
                if not self.hps[i - 1]:
                    self.hps[i - 1] = True
            if n - i <= 10:
                self.ending_nodes.add(i)

    def insert_node(self, node_id: int, seq: str) -> None:
        if node_id < self.last_id:
            self.nodes[node_id] = seq
        else:
            self.nodes.append(seq)
            self.edges.append([])
            self.last_id = node_id + 1

    def insert_edge(self, source: int, sink: int) -> None:
        local = self.edges[source]
        if not local:
            local.append([sink, 1.0])
            return
        for e in local:
            if e[0] == sink:
                e[1] += 1.0
                return
        local.append([sink, 1.0])

    def insert_alignment(self, sequence: str, cigar: str,
                         is_spanning_l: bool = True,
                         is_spanning_r: bool = True) -> None:
        """Extend the graph along a per-column cigar (anppoa.hpp:112-241)."""
        previous_node = 0
        ref_i = 0
        target_i = 0
        cigar_i = 0
        is_first_node = True
        backbone_len = len(self.backbone)

        if not is_spanning_l:
            # skip leading D/I ops (free begin gaps) (:116-127)
            is_first_node = False
            while cigar_i < len(cigar):
                c = cigar[cigar_i]
                if c != "D" and c != "I":
                    break
                if c == "D":
                    ref_i += 1
                    previous_node = ref_i
                else:
                    target_i += 1
                cigar_i += 1

        while cigar_i < len(cigar):
            c = cigar[cigar_i]
            # fast path: an interior run of M's over consecutive backbone
            # nodes is a bulk weight increment on backbone edges (t -> t+1),
            # which sit at position 0 of each backbone node's edge list by
            # construction (init). The first M of a run is handled by the
            # generic step (its incoming edge may come from an alt node).
            if (c == "M" and not is_first_node and previous_node == ref_i - 1
                    and ref_i < backbone_len):
                run = 1
                while (cigar_i + run < len(cigar)
                       and cigar[cigar_i + run] == "M"
                       and ref_i + run < backbone_len):
                    run += 1
                # generic semantics per M step t = ref_i..ref_i+run-1:
                #   insert_edge(t-1, t); previous_node = t; ref_i/target_i++
                #   then maybe ending_nodes.add(t) when bl - (t+1) <= 10
                for t in range(ref_i, ref_i + run):
                    self.edges[t - 1][0][1] += 1.0
                if is_spanning_r:
                    lo = max(ref_i, backbone_len - 11)
                    for t in range(lo, ref_i + run):
                        self.ending_nodes.add(t)
                previous_node = ref_i + run - 1
                ref_i += run
                target_i += run
                cigar_i += run
                continue
            target_seq = sequence[target_i] if target_i < len(sequence) else ""
            if c == "M" or c == "X":
                if c == "M":
                    if is_first_node or previous_node == ref_i:
                        is_first_node = False
                    else:
                        self.insert_edge(previous_node, ref_i)
                    previous_node = ref_i
                else:  # X: mismatch -> alternate node
                    if is_first_node:
                        need_new = True
                        for node in self.starting_nodes:
                            if self.nodes[node] == target_seq:
                                need_new = False
                                break
                        if need_new:
                            self.insert_node(self.last_id, target_seq)
                            previous_node = self.last_id - 1
                            self.starting_nodes.append(previous_node)
                        is_first_node = False
                    else:
                        outgoing = self.edges[previous_node]
                        match_i = -1
                        for ei, e in enumerate(outgoing):
                            if self.nodes[e[0]] == target_seq and e[0] >= backbone_len:
                                match_i = ei
                                break
                        if match_i >= 0:
                            outgoing[match_i][1] += 1
                            previous_node = outgoing[match_i][0]
                        else:
                            new_node = self.last_id
                            self.insert_node(new_node, target_seq)
                            self.insert_edge(previous_node, new_node)
                            previous_node = new_node
                ref_i += 1
                target_i += 1
            if c == "D":
                if not is_first_node:
                    ref_i += 1
                else:
                    ref_i += 1
                    previous_node = ref_i
            elif c == "I":
                if is_first_node:
                    self.insert_node(self.last_id, target_seq)
                    previous_node = self.last_id - 1
                    self.starting_nodes.append(previous_node)
                    is_first_node = False
                else:
                    outgoing = self.edges[previous_node]
                    match_i = -1
                    for ei, e in enumerate(outgoing):
                        if e[0] >= backbone_len and self.nodes[e[0]] == target_seq:
                            match_i = ei
                            break
                    if match_i >= 0:
                        outgoing[match_i][1] += 1
                        previous_node = outgoing[match_i][0]
                    else:
                        new_node = self.last_id
                        self.insert_node(new_node, target_seq)
                        self.insert_edge(previous_node, new_node)
                        previous_node = new_node
                target_i += 1
            if backbone_len - ref_i <= 10 and is_spanning_r:
                self.ending_nodes.add(previous_node)
            cigar_i += 1

    def adjust_weights(self, c: float, t: float) -> None:
        """w -= max(c, t*w), float32 arithmetic like the C++ floats
        (:243-252), vectorized elementwise (same per-edge float32 ops)."""
        import numpy as np
        flat = [e for local in self.edges for e in local]
        if not flat:
            return
        w = np.array([e[1] for e in flat], dtype=np.float32)
        t_applied = np.float32(t) * w
        final = np.maximum(np.float32(c), t_applied)
        new_w = (w - final).astype(np.float32)
        for e, nw in zip(flat, new_w.tolist()):
            e[1] = nw

    def consensus(self) -> str:
        """Heaviest path ending in an ending node (:254-344,356-379)."""
        n_nodes = len(self.nodes)
        incoming: List[List[Tuple[int, float]]] = [[] for _ in range(n_nodes)]
        for src, local in enumerate(self.edges):
            for sink, w in local:
                incoming[sink].append((src, w))

        # topologically drain the node list, computing heaviest paths.
        # Path weights are C++ floats in the reference (ppoa_path.weight),
        # so sums go through float32 to keep tie behavior identical.
        # Backpointers replace the reference's per-node path copies (O(V^2));
        # selection order/tie-breaking is unchanged, so the reconstructed
        # path is identical.
        import numpy as np
        f32 = np.float32
        heaviest: Dict[int, Tuple[float, int]] = {}  # node -> (weight, prev)

        def set_heaviest(node: int) -> None:
            if node in heaviest:
                return
            inc = incoming[node]
            if not inc:
                heaviest[node] = (f32(0.0), -1)
                return
            not_defined = True
            h_weight = f32(0.0)
            h_prev = -1
            for src, w in inc:
                if src not in heaviest:
                    set_heaviest(src)
                sw = heaviest[src][0]
                cand = f32(sw + f32(w))
                if not_defined or cand > h_weight:
                    not_defined = False
                    h_weight = cand
                    h_prev = src
            heaviest[node] = (h_weight, h_prev)

        # Kahn topological order (replaces the reference's O(V^2) list
        # rotation, anppoa.hpp:327-344 — heaviest values are memoized and
        # order-independent, so results are identical)
        from collections import deque

        indeg = [len(incoming[n]) for n in range(n_nodes)]
        queue = deque(n for n in range(n_nodes) if indeg[n] == 0)
        processed = 0
        while queue:
            nxt = queue.popleft()
            set_heaviest(nxt)
            processed += 1
            for sink, _w in self.edges[nxt]:
                indeg[sink] -= 1
                if indeg[sink] == 0:
                    queue.append(sink)
        if processed < n_nodes:
            # graph cycle (cannot happen for valid cigars); bail out
            for node in range(n_nodes):
                set_heaviest(node)

        h_node = 0
        h_weight = f32(0.0)
        not_init = True
        for node in sorted(heaviest.keys()):
            if node in self.ending_nodes:
                if not_init or heaviest[node][0] > h_weight:
                    not_init = False
                    h_node = node
                    h_weight = heaviest[node][0]
        # reconstruct via backpointers (the reference's path vector would
        # contain exactly this chain, anppoa.hpp:278-283,373)
        path = []
        node = h_node
        while node != -1:
            path.append(node)
            node = heaviest[node][1] if node in heaviest else -1
        path.reverse()
        return "".join(self.nodes[p] for p in path)

    def print_dot(self) -> str:
        out = ["digraph ansparc {", "  graph [rankdir = LR]"]
        for node_id in range(self.last_id):
            out.append(f'  {node_id}[label = "{node_id}-{self.nodes[node_id]}"]')
        for src, local in enumerate(self.edges):
            for sink, w in local:
                out.append(f'  {src} -> {sink} [label = "{w}"]')
        out.append("}")
        return "\n".join(out)
