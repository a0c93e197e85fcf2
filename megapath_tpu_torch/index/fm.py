"""FM-index: BWT + occ checkpoints + sampled SA + k-mer lookup table.

The port's copy of ``megapath_tpu/index/fm.py``, the index the host
seeding walks: the occurrence table is a flat checkpoint array every
OCC_BLOCK BWT symbols plus the 2-bit packed BWT, so a rank query is one
checkpoint gather and a count over at most OCC_BLOCK chars. All queries
are numpy and batch-first. The build runs on a torch device (the suffix
array by prefix doubling, ``index/suffix.py``, and every table after
it); the arrays it returns are numpy, equal to the reference's
(``tests/test_torch_index.py``). ``save``/``load`` read and write the
reference's ``.fm.npz`` (``tests/test_torch_cli.py``).

Interval convention: half-open [lo, hi) over the n+1 rows of the full
BWT matrix (row 0 = sentinel suffix). ``count = hi - lo``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from megapath_tpu_torch.index.pack import save_npz
from megapath_tpu_torch.index.suffix import bwt_from_sa_t, suffix_array_t

OCC_BLOCK = 128  # bwt symbols per occ checkpoint
WORD_CHARS = 16  # 2-bit chars per uint32 word
LOOKUP_K = 13  # reference LT k-mer size (2bwt-flex/LT.h:44-49)


@dataclass
class FMIndex:
    """Arrays of one index shard."""

    n: int  # text length (chars, no sentinel)
    primary: int  # full-BWT row holding the sentinel cell
    bwt_words: np.ndarray  # uint32 [ceil(n/16)] packed BWT (sentinel cell removed)
    occ: np.ndarray  # uint32 [n_blocks+1, 4] counts of c in bwt[:block*128]
    counts: np.ndarray  # int64 [5]: C[c] = first full-row of suffixes starting with c
    sa_sampled: np.ndarray  # int64 [n_marked] SA values at marked rows
    mark_rank: np.ndarray  # int64 [n+2] prefix count of marked rows <= r
    sa_interval: int  # text-position sampling stride (1 = full SA)
    lut_lo: Optional[np.ndarray] = None  # uint32 [4^k] full-row interval lo
    lut_hi: Optional[np.ndarray] = None
    lut_k: int = 0

    # ------------------------------------------------------------------
    # rank / backward search (numpy, batch-first: all args may be arrays)
    # ------------------------------------------------------------------
    def _occ_arr(self, idx: np.ndarray, c: np.ndarray) -> np.ndarray:
        """#occurrences of c in bwt[0:idx) (sentinel-free bwt coords)."""
        idx = np.asarray(idx, dtype=np.int64)
        c = np.asarray(c)
        block = idx // OCC_BLOCK
        base = self.occ[block, c].astype(np.int64)
        rel = idx - block * OCC_BLOCK  # 0..127 chars of the block to count
        wpb = OCC_BLOCK // WORD_CHARS
        # clamp: when idx lands exactly on the final checkpoint, rel==0
        # masks out every gathered char, so any in-range words do
        word0 = np.minimum(block * wpb, max(0, len(self.bwt_words) - wpb))
        w = self.bwt_words[word0[..., None] + np.arange(wpb)]
        shifts = (2 * np.arange(WORD_CHARS, dtype=np.uint32))[None, :]
        chars = ((w[..., :, None] >> shifts) & 3).reshape(*idx.shape, OCC_BLOCK)
        pos = np.arange(OCC_BLOCK)
        inblk = ((chars == c[..., None]) & (pos < rel[..., None])).sum(axis=-1)
        return base + inblk

    def occ_full(self, row: np.ndarray, c: np.ndarray) -> np.ndarray:
        """#occurrences of c among full-BWT rows [0, row)."""
        row = np.asarray(row, dtype=np.int64)
        return self._occ_arr(row - (row > self.primary), c)

    def extend_backward(
        self, lo: np.ndarray, hi: np.ndarray, c: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prepend char c to the pattern: [lo,hi) -> new interval."""
        C = self.counts[np.asarray(c)]
        return C + self.occ_full(lo, c), C + self.occ_full(hi, c)

    def bwt_char_full(self, row: np.ndarray) -> np.ndarray:
        """BWT char of full rows (undefined at row==primary)."""
        row = np.asarray(row, dtype=np.int64)
        adj = row - (row > self.primary)
        w = self.bwt_words[adj // WORD_CHARS]
        return ((w >> (2 * (adj % WORD_CHARS).astype(np.uint32))) & 3).astype(np.uint8)

    def lf(self, row: np.ndarray) -> np.ndarray:
        """LF-mapping of full rows; primary row maps to 0."""
        row = np.asarray(row, dtype=np.int64)
        c = self.bwt_char_full(np.where(row == self.primary, 0, row))
        out = self.counts[c] + self.occ_full(row, c)
        return np.where(row == self.primary, 0, out)

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """Text positions of full rows (vectorized LF walk to samples)."""
        rows = np.asarray(rows, dtype=np.int64)
        pos = np.full(rows.shape, -1, dtype=np.int64)
        steps = np.zeros(rows.shape, dtype=np.int64)
        cur = rows.copy()
        for _ in range(self.sa_interval + 1):
            at_sent = cur == 0
            marked = self._is_marked(cur) & ~at_sent
            hit = (pos < 0) & marked
            if hit.any():
                pos[hit] = self._sample_value(cur[hit]) + steps[hit]
            hit0 = (pos < 0) & at_sent
            pos[hit0] = self.n + steps[hit0]  # sentinel row = position n
            todo = pos < 0
            if not todo.any():
                break
            cur = np.where(todo, self.lf(cur), cur)
            steps = steps + todo
        return pos

    def _is_marked(self, row: np.ndarray) -> np.ndarray:
        return (self.mark_rank[row + 1] - self.mark_rank[row]) > 0

    def _sample_value(self, row: np.ndarray) -> np.ndarray:
        return self.sa_sampled[self.mark_rank[row]].astype(np.int64)

    def lut_interval(self, kmer: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Packed k-mer codes (base-4, first char most significant) ->
        full-row interval [lo, hi)."""
        return self.lut_lo[kmer].astype(np.int64), self.lut_hi[kmer].astype(np.int64)

    def save(self, path: str) -> None:
        """The reference's ``.fm.npz`` (``pack.save_npz``): the same keys
        and dtypes (``sa_sampled`` and ``mark_rank`` int64), an absent
        k-mer table stored as empty uint32 arrays."""
        empty = np.zeros(0, np.uint32)
        save_npz(
            path,
            n=self.n,
            primary=self.primary,
            bwt_words=self.bwt_words,
            occ=self.occ,
            counts=self.counts,
            sa_sampled=self.sa_sampled,
            mark_rank=self.mark_rank,
            sa_interval=self.sa_interval,
            lut_lo=self.lut_lo if self.lut_lo is not None else empty,
            lut_hi=self.lut_hi if self.lut_hi is not None else empty,
            lut_k=self.lut_k,
        )

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        with np.load(path) as z:
            lut_k = int(z["lut_k"])
            return cls(
                n=int(z["n"]),
                primary=int(z["primary"]),
                bwt_words=z["bwt_words"],
                occ=z["occ"],
                counts=z["counts"],
                sa_sampled=z["sa_sampled"],
                mark_rank=z["mark_rank"],
                sa_interval=int(z["sa_interval"]),
                lut_lo=z["lut_lo"] if lut_k else None,
                lut_hi=z["lut_hi"] if lut_k else None,
                lut_k=lut_k,
            )


def build_fm_index(
    codes: np.ndarray,
    sa_interval: int = 8,
    lut_k: int = LOOKUP_K,
    *,
    device: torch.device,
) -> FMIndex:
    """Build the FM-index of a packed reference text on ``device``: the
    suffix array, the BWT, the occ checkpoints, the sampled SA and the
    k-mer table are all computed there (a 512 Mbp shard builds in
    seconds on a card); the arrays returned are numpy."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    dev = torch.device(device)
    text = torch.from_numpy(codes).to(dev)
    sa = suffix_array_t(text)
    bwt, primary = bwt_from_sa_t(text, sa)

    # counts: C[c] = 1 + #chars < c (sentinel occupies row 0)
    counts = np.zeros(5, dtype=np.int64)
    counts[1:] = np.cumsum(np.bincount(codes, minlength=4))
    counts += 1

    # occ checkpoints over the sentinel-free bwt; pad cells (code 4)
    # count as no char
    n_blocks = (n + OCC_BLOCK - 1) // OCC_BLOCK
    pad = n_blocks * OCC_BLOCK
    padded = torch.full((pad,), 4, dtype=torch.uint8, device=dev)
    padded[:n] = bwt
    blocks = padded.view(n_blocks, OCC_BLOCK)
    occ = torch.zeros((n_blocks + 1, 4), dtype=torch.int64, device=dev)
    for c in range(4):
        occ[1:, c] = torch.cumsum((blocks == c).sum(dim=1), 0)
    padded[n:] = 0  # the packed words hold A past the text, as the reference's
    shifts = 2 * torch.arange(WORD_CHARS, dtype=torch.int64, device=dev)
    words = (padded.view(-1, WORD_CHARS).to(torch.int64) << shifts).sum(dim=1)
    del padded, blocks

    # sampled SA: mark full rows whose text position % sa_interval == 0;
    # full row r>0 holds position sa[r-1], row 0 (sentinel) is never marked
    full_pos = torch.empty(n + 1, dtype=torch.int64, device=dev)
    full_pos[0] = n
    full_pos[1:] = sa
    marked = (full_pos % sa_interval) == 0
    marked[0] = False
    mark_rank = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    mark_rank[1:] = torch.cumsum(marked, 0)

    fm = FMIndex(
        n=n,
        primary=primary,
        bwt_words=words.cpu().numpy().astype(np.uint32),
        occ=occ.cpu().numpy().astype(np.uint32),
        counts=counts,
        sa_sampled=full_pos[marked].cpu().numpy(),
        mark_rank=mark_rank.cpu().numpy(),
        sa_interval=sa_interval,
    )
    del full_pos, marked, mark_rank
    if lut_k:
        fm.lut_lo, fm.lut_hi = _build_lut(text, sa, lut_k)
        fm.lut_k = lut_k
    return fm


def _build_lut(text: torch.Tensor, sa: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """k-mer -> full-row interval [lo, hi), replacing 2bwt-flex LT.

    Keys are computed per suffix from its first k chars (A-padded);
    suffixes shorter than k (at most k-1 of them) are then excised from
    their padded bucket since they cannot contain a full k-mer.
    """
    n = len(text)
    # key[r] for suffix sa[r]: base-4 big-endian of codes[sa[r] : sa[r]+k]
    key = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in range(k):
        idx = sa + j
        ch = text[idx.clamp_max(n - 1)].to(torch.int64)
        key = key * 4 + torch.where(idx < n, ch, 0)
    # bucket boundaries among the n suffix rows (full rows 1..n)
    starts = np.zeros(4**k + 1, dtype=np.int64)
    starts[1:] = np.cumsum(torch.bincount(key, minlength=4**k).cpu().numpy())
    lo = starts[:-1] + 1  # +1: full rows are suffix rows shifted by sentinel
    hi = starts[1:] + 1
    # excise short suffixes (positions n-1 .. n-k+1) from their buckets
    for p in range(max(0, n - k + 1), n):
        r = int(torch.nonzero(sa == p)[0, 0])  # suffix row; full row = r+1
        b = int(key[r])
        # short suffixes sort before all full-length members (A-pad
        # ties break by the implicit sentinel); bump lo past them
        if lo[b] <= r + 1 < hi[b]:
            lo[b] = r + 2
    return lo.astype(np.uint32), hi.astype(np.uint32)
