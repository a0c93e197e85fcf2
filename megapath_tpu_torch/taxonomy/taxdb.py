"""NCBI taxonomy database: nodes.dmp / names.dmp / accession->taxid.

The port's copy of ``megapath_tpu/taxonomy/taxdb.py``, held equal to it
by ``tests/test_torch_host.py``. Host numpy, as in the reference package.

Array-backed equivalent of TaxDB in the reference's cc/taxonomy.h. The
parent/rank tables are dense numpy arrays indexed by taxid so that LCA and
lineage walks can be vectorized over whole read batches (the reference
walks std::unordered_map per read). Missing taxids behave like the
reference's value-initialized vector entries: parent 0, empty rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from megapath_tpu_torch.io.fastq import open_maybe_gz

# Rank codes for Kraken-style reports (genKrakenReport.cpp:41-48):
# superkingdom->D, and the first letter (uppercased) for these ranks;
# every other rank maps to '-'.
_LETTER_RANKS = (
    "domain",
    "kingdom",
    "phylum",
    "class",
    "order",
    "family",
    "genus",
    "species",
)


def remove_version(acc: str) -> str:
    """Strip a trailing ``.NN`` version (taxonomy.h:14-23)."""
    for i in range(len(acc) - 1, -1, -1):
        c = acc[i]
        if c == ".":
            return acc[:i]
        if not c.isdigit():
            return acc
    return acc


def get_accession(header: str) -> str:
    """Extract the accession from an NT FASTA header (taxonomy.h:25-39).

    Handles both modern plain-accession headers and legacy
    ``gi|123|db|ACC|...`` headers.
    """
    bar = header.find("|")
    if bar == -1:
        return remove_version(header)
    if header[:bar] == "gi":
        p = header.find("|", bar + 1)
        p = header.find("|", p + 1)
        p2 = header.find("|", p + 1)
        if p2 == -1:
            p2 = len(header)
        return remove_version(header[p + 1 : p2])
    return remove_version(header)


def get_correct_acc(header: str) -> str:
    """Like get_accession but WITHOUT version stripping (misc.h:28-43)."""
    bar = header.find("|")
    if bar == -1:
        return header
    if header[:bar] == "gi":
        p = header.find("|", bar + 1)
        p = header.find("|", p + 1)
        p2 = header.find("|", p + 1)
        if p2 == -1:
            p2 = len(header)
        return header[p + 1 : p2]
    return header


class TaxDB:
    """Dense-array taxonomy with vectorized lineage ops.

    Attributes
    ----------
    parent : np.ndarray[int32]   parent[tid] (0 for absent tids)
    rank_code : np.ndarray[uint8]  kraken rank letter per tid (ord value)
    is_species / is_superkingdom : np.ndarray[bool]
    names : dict tid -> scientific name
    acc2tid : dict accession(no version) -> tid
    """

    def __init__(self, size: int = 2_000_000):
        self.parent = np.zeros(size, dtype=np.int32)
        self.rank_code = np.full(size, ord("-"), dtype=np.uint8)
        self.is_species = np.zeros(size, dtype=bool)
        self.is_superkingdom = np.zeros(size, dtype=bool)
        self.rank: Dict[int, str] = {}
        self.names: Dict[int, str] = {}
        self.acc2tid: Dict[str, int] = {}
        # depth (distance to root, computed lazily after read_nodes)
        self._depth: Optional[np.ndarray] = None
        self._species_of: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def _grow(self, tid: int) -> None:
        if tid >= len(self.parent):
            n = int((tid + 1) * 1.5)
            for attr, fill in (
                ("parent", 0),
                ("rank_code", ord("-")),
                ("is_species", False),
                ("is_superkingdom", False),
            ):
                old = getattr(self, attr)
                new = np.full(n, fill, dtype=old.dtype)
                new[: len(old)] = old
                setattr(self, attr, new)

    def read_nodes(self, path) -> None:
        """Parse nodes.dmp: ``tid | parent | rank | ...``."""
        fp = open_maybe_gz(path, "rt")
        for line in fp:
            cols = line.split("\t|\t")
            if len(cols) < 3:
                cols = [c.strip() for c in line.split("|")]
            tid = int(cols[0])
            parent = int(cols[1])
            rank = cols[2].strip()
            self._grow(tid)
            self.parent[tid] = parent
            self.rank[tid] = rank
            if rank == "superkingdom":
                self.rank_code[tid] = ord("D")
                self.is_superkingdom[tid] = True
            elif rank in _LETTER_RANKS:
                self.rank_code[tid] = ord(rank[0].upper())
            if rank == "species":
                self.is_species[tid] = True
        self._depth = None
        self._species_of = None

    def read_names(self, path) -> None:
        """Parse names.dmp keeping scientific names (taxonomy.h:97-127)."""
        fp = open_maybe_gz(path, "rt")
        for line in fp:
            if "scientific name" not in line:
                continue
            cols = [c.strip() for c in line.split("|")]
            tid = int(cols[0])
            # The reference re-joins whitespace-split tokens with single
            # spaces (taxonomy.h:110-121); mirror that normalization.
            self.names[tid] = " ".join(cols[1].split())

    def read_acc2tid(self, path) -> None:
        """Parse an accession2taxid table: ``acc acc.version taxid ...``.

        First whitespace-separated column is ignored header-style like the
        reference (taxonomy.h:58-70 reads col2=acc col3=tid).
        """
        fp = open_maybe_gz(path, "rt")
        for line in fp:
            cols = line.split()
            if len(cols) < 3:
                continue
            try:
                tid = int(cols[2])
            except ValueError:
                continue
            self.acc2tid[remove_version(cols[1])] = tid

    # ------------------------------------------------------------------
    def name_of(self, tid: int) -> str:
        return self.names.get(tid, "")

    def rank_of(self, tid: int) -> str:
        return self.rank.get(tid, "")

    def lineage(self, tid: int) -> List[int]:
        """Root-exclusive lineage [tid, parent, ..., 1-or-0] like the
        reference's LCA walk (taxonomy.h:156-163)."""
        out = []
        seen = set()
        while tid != 0 and tid != 1:
            if tid in seen:  # corrupt cycles: bail like hitting root
                break
            seen.add(tid)
            out.append(tid)
            tid = int(self.parent[tid]) if tid < len(self.parent) else 0
        out.append(tid)
        return out

    def lca(self, tids: Sequence[int]) -> int:
        """Lowest common ancestor with reference semantics
        (taxonomy.h:152-177): single tid returns itself *without* a
        lineage check; disjoint lineages return 0."""
        if len(tids) == 1:
            return int(tids[0])
        lineages = [self.lineage(t) for t in tids]
        lca = 0
        for k in range(len(lineages[0])):
            cand = lineages[0][-1 - k]
            for ln in lineages[1:]:
                if len(ln) < k + 1 or ln[-1 - k] != cand:
                    return lca
            lca = cand
        return lca

    def pop_to_species(self, tid: int) -> int:
        """Walk up until rank=='species' (or root), taxonomy.h:129-134."""
        seen = set()
        while tid != 1 and tid != 0 and not (
            tid < len(self.is_species) and self.is_species[tid]
        ):
            if tid in seen:
                return tid
            seen.add(tid)
            tid = int(self.parent[tid]) if tid < len(self.parent) else 0
        return tid

    def superkingdom_of(self, tid: int) -> int:
        """Walk up to the superkingdom rank; 0 if none."""
        while tid != 1 and tid != 0:
            if tid < len(self.is_superkingdom) and self.is_superkingdom[tid]:
                return tid
            tid = int(self.parent[tid]) if tid < len(self.parent) else 0
        return 0

    # ------------------------------------------------------------------
    # Vectorized (batch) operations for the device-adjacent path
    # ------------------------------------------------------------------
    def depth_table(self) -> np.ndarray:
        """depth[tid] = #steps to reach 1/0; absent tids get depth 1."""
        if self._depth is not None:
            return self._depth
        n = len(self.parent)
        parent = self.parent
        cur = np.arange(n, dtype=np.int64)
        steps = np.zeros(n, dtype=np.int32)
        for _ in range(64):
            at_root = (cur == 0) | (cur == 1)
            if at_root.all():
                break
            nxt = parent[cur]
            steps = steps + (~at_root)
            cur = np.where(at_root, cur, nxt)
        depth = steps
        self._depth = depth
        return depth

    def species_table(self) -> np.ndarray:
        """species_of[tid]: popUpToSpecies for every tid, vectorized."""
        if self._species_of is not None:
            return self._species_of
        n = len(self.parent)
        parent = self.parent
        done = self.is_species.copy()
        done[0] = True
        if n > 1:
            done[1] = True
        cur = np.arange(n, dtype=np.int64)
        for _ in range(64):
            active = ~done[cur]
            if not active.any():
                break
            cur = np.where(active, parent[cur], cur)
        self._species_of = cur.astype(np.int32)
        return self._species_of

    def lca_pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized LCA of two equal-length taxid arrays.

        Classic lift-to-equal-depth then walk-up-together, as dense numpy
        passes. Used by the batched classification path; per-read exact
        LCA-of-list folds with this.
        """
        depth = self.depth_table()
        parent = self.parent
        a = a.astype(np.int64).copy()
        b = b.astype(np.int64).copy()
        n_tab = len(parent)
        a = np.where((a >= 0) & (a < n_tab), a, 0)
        b = np.where((b >= 0) & (b < n_tab), b, 0)
        for _ in range(64):
            da, db = depth[a], depth[b]
            if (da == db).all():
                break
            a = np.where(da > db, parent[a], a)
            b = np.where(db > da, parent[b], b)
        for _ in range(64):
            neq = (a != b)
            if not neq.any():
                break
            a = np.where(neq, parent[a], a)
            b = np.where(neq, parent[b], b)
        # Disjoint lineages (one chain bottoms out at 0, the other at 1)
        # never meet; the reference LCA returns 0 for those.
        return np.where(a == b, a, 0).astype(np.int32)

    def lca_grouped(self, tids: np.ndarray, gid: np.ndarray) -> np.ndarray:
        """Per-group LCA over rows sorted by group id.

        Shift-doubling fold of lca_pairwise: after round k, row i holds
        the LCA of its group's rows in (i-2^k, i], so each group's last
        row ends with the full-group LCA after ceil(log2(max group))
        rounds. Single-row groups keep their own tid, matching the
        reference's no-lineage-check single-element case
        (taxonomy.h:152-159). Returns one LCA per group, in group order.
        """
        M = len(tids)
        if M == 0:
            return np.zeros(0, np.int32)
        gid = np.asarray(gid)
        first = np.r_[True, gid[1:] != gid[:-1]]
        starts = np.flatnonzero(first)
        sizes = np.diff(np.r_[starts, M])
        cur = np.asarray(tids, dtype=np.int64).copy()
        idx = np.arange(M)
        stride = 1
        maxk = int(sizes.max())
        while stride < maxk:
            prev = idx - stride
            same = prev >= 0
            same[same] = gid[prev[same]] == gid[same]
            comb = self.lca_pairwise(
                cur, np.where(same, cur[np.maximum(prev, 0)], cur)
            )
            cur = np.where(same, comb, cur)
            stride *= 2
        ends = np.r_[starts[1:], M] - 1
        return cur[ends].astype(np.int32)
