"""De Bruijn graph local assembly (amplicon realignment support).

The port's copy of ``megapath_tpu/amplicon/debruijn.py``, held equal to it
by ``tests/test_torch_amplicon.py``. It runs on the host, as the JAX
package's does.

Re-implementation of the DeepVariant-style consensus assembly used by
the reference's amplicon realigner
(MegaPath: scripts/realignment/realign/debruijn_graph.cpp: k-mer
graph over the reference window + reads, edges weighted by read
support, candidate haplotypes = source->sink paths). The reference
builds a boost::adjacency_list; here the graph is plain dicts — windows
are a few hundred bp, reads tens — and the hot realignment (SSW of
reads vs haplotypes) runs on the batched DP kernel instead.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass
class DeBruijnGraph:
    k: int
    edges: Dict[str, Dict[str, int]] = field(default_factory=dict)  # kmer -> {next_kmer: weight}
    ref_edges: Set[Tuple[str, str]] = field(default_factory=set)
    source: Optional[str] = None
    sink: Optional[str] = None

    def add_seq(self, seq: str, weight: int = 1, is_ref: bool = False) -> None:
        k = self.k
        if len(seq) < k + 1:
            return
        for i in range(len(seq) - k):
            a = seq[i : i + k]
            b = seq[i + 1 : i + 1 + k]
            if "N" in a or "N" in b:
                continue
            self.edges.setdefault(a, {})
            self.edges[a][b] = self.edges[a].get(b, 0) + weight
            if is_ref:
                self.ref_edges.add((a, b))
        if is_ref:
            self.source = seq[:k]
            self.sink = seq[-k:]

    def prune(self, min_weight: int = 2) -> None:
        """Drop non-reference edges with weight < min_weight (the
        reference's min edge support)."""
        for a in list(self.edges):
            kept = {
                b: w
                for b, w in self.edges[a].items()
                if w >= min_weight or (a, b) in self.ref_edges
            }
            if kept:
                self.edges[a] = kept
            else:
                del self.edges[a]

    def haplotypes(self, max_paths: int = 128, max_len: int = 1000) -> List[str]:
        """All source->sink paths (bounded DFS), ref-window haplotypes."""
        if self.source is None or self.sink is None:
            return []
        out: List[str] = []
        k = self.k
        stack: List[Tuple[str, List[str], Set[Tuple[str, str]]]] = [
            (self.source, [self.source], set())
        ]
        while stack and len(out) < max_paths:
            node, path, used = stack.pop()
            if node == self.sink and len(path) > 1:
                out.append(path[0] + "".join(p[-1] for p in path[1:]))
                continue
            if len(path) > max_len:
                continue
            # explore strongest edges FIRST (stack pops last-pushed, so
            # push weakest first): with bounded max_paths the true
            # haplotypes must be emitted before weak error branches
            # exhaust the budget — at amplicon depths a few spurious
            # >=2-weight error edges otherwise explode the path count
            # combinatorially past the cap ahead of the real alleles
            for nxt, _w in sorted(
                self.edges.get(node, {}).items(), key=lambda kv: (kv[1], kv[0])
            ):
                e = (node, nxt)
                if e in used:  # disallow repeating an edge (cycles)
                    continue
                stack.append((nxt, path + [nxt], used | {e}))
        # also emit sink-reached-at-start case (source == sink)
        return out


def candidate_haplotypes(
    ref_window: str,
    reads: Sequence[str],
    k: int = 21,
    min_edge_weight: int = 2,
    max_paths: int = 128,
) -> List[str]:
    """Reference-window haplotype candidates from read evidence.

    The reference tries several k values until the graph is acyclic
    enough (realign_illumina_reads.py); callers can loop k themselves.
    Always includes the reference haplotype itself.
    """
    g = DeBruijnGraph(k=k)
    g.add_seq(ref_window, weight=1, is_ref=True)
    for r in reads:
        g.add_seq(r, weight=1)
    # depth-scaled pruning: at amplicon depths, recurrent sequencing
    # errors clear an absolute >=2 support gate (120x * 0.5% error ->
    # several spurious branches per window); scale the edge floor to
    # ~4% of the window's read depth so sub-allele-fraction noise is
    # pruned while real >=5%-AF alleles always survive
    depth_est = sum(len(r) for r in reads) / max(len(ref_window), 1)
    mw = max(min_edge_weight, int(0.04 * depth_est))
    g.prune(mw)
    haps = g.haplotypes(max_paths=max_paths, max_len=4 * len(ref_window))
    if ref_window not in haps:
        haps.insert(0, ref_window)
    return haps
