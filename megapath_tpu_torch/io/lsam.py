"""LSAM / LSAM.id text format.

The port's copy of the record model and the reader and writer of
``megapath_tpu/io/lsam.py``, held equal to it by
``tests/test_torch_host.py``. The LSAM format is the reference pipeline's
inter-stage contract (the reference's README_LSAM.md):

    name \t flag(0x40|0x80|0) \t score \t seq \t qual \t hits \t [opts...]

where ``hits`` is ``score,target;score,target;...`` or ``*``. Targets are
accessions (LSAM) or taxids (LSAM.id).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Sequence, Tuple

from megapath_tpu_torch.io.fastq import open_maybe_gz

Hit = Tuple[float, str]  # (score, target)


@dataclass
class LsamRecord:
    name: str
    flag: int  # 0x40 first-of-pair, 0x80 second, 0 single
    score: int
    seq: str = "*"
    qual: str = "*"
    hits: List[Hit] = field(default_factory=list)
    opts: List[str] = field(default_factory=list)

    def hits_str(self) -> str:
        return format_hits(self.hits)

    def to_line(self) -> str:
        cols = [
            self.name,
            str(self.flag),
            str(self.score),
            self.seq,
            self.qual,
            self.hits_str(),
        ]
        cols.extend(self.opts)
        return "\t".join(cols)


def _fmt_score(s: float) -> str:
    """Format a hit score the way C++ ``cout << double`` does (%.6g)."""
    if float(s).is_integer() and abs(s) < 1e15:
        return str(int(s))
    return f"{s:.6g}"


def parse_hits(hits: str) -> List[Hit]:
    """``score,target;...`` or ``*`` -> [(score, target)].

    Mirrors splitAcc (the reference's cc/misc.h:46-58): empty segments are
    skipped; a segment with several targets keeps only the first two fields.
    """
    if not hits or hits == "*":
        return []
    out: List[Hit] = []
    for seg in hits.split(";"):
        if not seg:
            continue
        sub = seg.split(",")
        out.append((float(sub[0]), sub[1]))
    return out


def format_hits(hits: Sequence[Hit]) -> str:
    if not hits:
        return "*"
    return ";".join(f"{_fmt_score(s)},{t}" for s, t in hits)


def parse_lsam_line(line: str) -> LsamRecord:
    cols = line.rstrip("\n").split("\t")
    return LsamRecord(
        name=cols[0],
        flag=int(cols[1]),
        score=int(cols[2]),
        seq=cols[3],
        qual=cols[4],
        hits=parse_hits(cols[5]),
        opts=cols[6:],
    )


def read_lsam(path) -> Iterator[LsamRecord]:
    with open_maybe_gz(path, "rt") as fp:
        for line in fp:
            if line.strip():
                yield parse_lsam_line(line)


def write_lsam(records: Iterable[LsamRecord], path) -> None:
    with open_maybe_gz(path, "wt") as fp:
        for r in records:
            fp.write(r.to_line() + "\n")
