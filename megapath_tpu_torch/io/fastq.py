"""FASTQ / FASTA / annotated-FASTQ ("cfq") host-side input.

The port's copy of the part of ``megapath_tpu/io/fastq.py`` that the
aligner's main path reads with: the record model and the streaming
reader. Plain Python on the host; the hot path works on the packed numpy
arrays that ``megapath_tpu_torch.index.pack`` makes from these records.
``tests/test_torch_index.py`` holds it equal to the reference module.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional


def open_maybe_gz(path, mode: str = "rt"):
    """Open ``path`` whether or not it is gzip-compressed."""
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def trim_readno(name: str) -> str:
    """Strip a trailing ``/1`` or ``/2`` (any digit) pair-end suffix."""
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


@dataclass
class FastqRecord:
    """One FASTQ/FASTA record. ``comment`` is the post-name header text."""

    name: str
    seq: str
    qual: str = ""  # empty => FASTA
    comment: str = ""


def read_fastx(path) -> Iterator[FastqRecord]:
    """Stream FASTQ or FASTA records (gz transparent, multiline FASTA ok)."""
    fp = open_maybe_gz(path, "rt")
    it = iter(fp)
    pushback: Optional[str] = None

    def nextline() -> Optional[str]:
        nonlocal pushback
        if pushback is not None:
            line, pushback = pushback, None
            return line
        return next(it, None)

    def header(line: str):
        head = line[1:]
        name, _, comment = head.partition("\t")
        if "\t" not in head:
            name, _, comment = head.partition(" ")
        return name, comment

    while True:
        line = nextline()
        if line is None:
            return
        line = line.rstrip("\n")
        if not line:
            continue
        if line[0] == "@":  # FASTQ
            name, comment = header(line)
            seq = (nextline() or "").rstrip("\n")
            nextline()  # the '+' line
            qual = (nextline() or "").rstrip("\n")
            yield FastqRecord(name=name, seq=seq, qual=qual, comment=comment)
        elif line[0] == ">":  # FASTA (possibly multiline)
            name, comment = header(line)
            chunks: List[str] = []
            while True:
                nl = nextline()
                if nl is None:
                    break
                if nl and nl[0] in ">@":
                    pushback = nl
                    break
                chunks.append(nl.rstrip("\n"))
            yield FastqRecord(name=name, seq="".join(chunks), comment=comment)
        else:
            raise ValueError(f"malformed FASTX line: {line[:80]!r}")
