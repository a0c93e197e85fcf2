"""Reference packing: FASTA -> 2-bit codes + annotation/ambiguity tables.

The port's copy of ``megapath_tpu/index/pack.py``: the shard text as a
numpy uint8 code array (A=0 C=1 G=2 T=3, every non-ACGT byte maps to G
like the reference's charMap), the sequences concatenated with their
start offsets so a position maps back to (sequence, offset), and the
read packer. ``tests/test_torch_index.py`` holds it equal to the
reference module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx

# Byte -> 2-bit code; non-ACGT maps to G(2) like the reference charMap.
_CODE = np.full(256, 2, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i

COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G


def encode_seq(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes 0..3 (non-ACGT -> 2)."""
    return _CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


@dataclass
class PackedReference:
    """One index shard's packed text + per-sequence annotation."""

    codes: np.ndarray  # uint8 [total_len] values 0..3
    names: List[str]  # per-sequence FASTA name (first token)
    annotations: List[str]  # full header text (the cfq hit annotation)
    offsets: np.ndarray  # int64 [n_seq + 1] start offsets; [-1]=total_len
    ambiguous: np.ndarray  # int64 [n_amb, 2] start,end of non-ACGT runs

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

    def seq_of_pos(self, pos: np.ndarray) -> np.ndarray:
        """Global position(s) -> sequence index via searchsorted."""
        return np.searchsorted(self.offsets, np.asarray(pos), side="right") - 1


def pack_fasta(records: Iterable[FastqRecord]) -> PackedReference:
    """Concatenate sequences into one packed text with annotations."""
    chunks: List[np.ndarray] = []
    names: List[str] = []
    annotations: List[str] = []
    offsets = [0]
    amb: List[Tuple[int, int]] = []
    total = 0
    for rec in records:
        codes = encode_seq(rec.seq)
        b = np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)
        is_amb = (_CODE[b] == 2) & (b != ord("G")) & (b != ord("g"))
        if is_amb.any():
            # record [start,end) runs of ambiguity
            d = np.diff(np.r_[0, is_amb.astype(np.int8), 0])
            starts = np.flatnonzero(d == 1) + total
            ends = np.flatnonzero(d == -1) + total
            amb.extend(zip(starts.tolist(), ends.tolist()))
        chunks.append(codes)
        # the first header token is the sequence name (the reference's
        # .ann); the rest of the header goes to the annotation only
        name = rec.name.split()[0] if rec.name.split() else rec.name
        desc = rec.name[len(name):].strip()
        if rec.comment:
            desc = f"{desc} {rec.comment}".strip()
        names.append(name)
        annotations.append(name if not desc else f"{name} {desc}")
        total += len(codes)
        offsets.append(total)
    return PackedReference(
        codes=np.concatenate(chunks) if chunks else np.zeros(0, np.uint8),
        names=names,
        annotations=annotations,
        offsets=np.asarray(offsets, dtype=np.int64),
        ambiguous=np.asarray(amb, dtype=np.int64).reshape(-1, 2),
    )


def pack_fasta_file(path) -> PackedReference:
    return pack_fasta(read_fastx(path))


def pack_reads(seqs: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reads -> fixed-shape [N, max_len] code batch + length vector.
    Padding code is 0 (A); the lengths mask all compute."""
    n = len(seqs)
    out = np.zeros((n, max_len), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s[:max_len])
        out[i, : len(c)] = c
        lens[i] = len(c)
    return out, lens
