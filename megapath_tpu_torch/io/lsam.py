"""LSAM / LSAM.id text format.

The port's copy of ``megapath_tpu/io/lsam.py``: the record model, the
reader and writer, and the cfq -> LSAM, deinterleave and lsamReadFilter
transforms of the stream tools (the reference's cc/fastq2lsam.cpp,
deinterleave.cpp and lsamReadFilter.cpp), held equal to it by
``tests/test_torch_host.py`` and ``tests/test_torch_cli.py``. The LSAM format is the reference pipeline's
inter-stage contract (the reference's README_LSAM.md):

    name \t flag(0x40|0x80|0) \t score \t seq \t qual \t hits \t [opts...]

where ``hits`` is ``score,target;score,target;...`` or ``*``. Targets are
accessions (LSAM) or taxids (LSAM.id).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from megapath_tpu_torch.io.fastq import FastqRecord, open_maybe_gz, trim_readno

SCORE_IGNORE = -1

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


# ---------------------------------------------------------------------------
# cfq -> LSAM (fastq2lsam equivalent)
# ---------------------------------------------------------------------------


def _cfq_record_to_lsam(rec: FastqRecord, which_end: int, output_seq: bool) -> str:
    """One cfq read -> one LSAM text line.

    Byte-parity port of print_lsam_line (the reference's
    cc/fastq2lsam.cpp:28-78): the hit list is re-shaped from
    ``score,refA,refB;`` to ``score,refA;score,refB`` and the original
    score text is passed through verbatim.
    """
    flag = {1: 0x40, 2: 0x80}.get(which_end, 0)
    comm = rec.comment
    if comm == "IGNORE":
        score = SCORE_IGNORE
    else:
        # atoi(comm + 6): parse leading int after "SCORE:" (0 on garbage)
        score = _atoi(comm[6:]) if len(comm) > 6 else 0

    cols = [rec.name, str(flag), str(score)]
    if output_seq:
        cols += [rec.seq, rec.qual]
    else:
        cols += ["*", "*"]

    if score <= 0:
        hits_txt = "*"
    else:
        parts: List[str] = []
        for seg in comm.split(";")[1:]:
            sub = seg.split(",")
            for tgt in sub[1:]:
                parts.append(f"{sub[0]},{tgt}")
        hits_txt = ";".join(parts)
    cols.append(hits_txt)
    line = "\t".join(cols)
    if score == SCORE_IGNORE:
        line += "\tIGNORE"
    return line


def _atoi(s: str) -> int:
    """C atoi: leading whitespace + optional sign + digits, 0 otherwise."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


def fastq_to_lsam(records: Iterable[FastqRecord], out, output_seq: bool = True) -> None:
    """Interleaved cfq stream -> LSAM, pairing consecutive same-name reads
    (main() of the reference's cc/fastq2lsam.cpp:90-113)."""
    fp = open_maybe_gz(out, "wt")
    last: Optional[FastqRecord] = None
    for rec in records:
        rec.name = trim_readno(rec.name)
        if last is not None:
            if last.name == rec.name:
                fp.write(_cfq_record_to_lsam(last, 1, output_seq) + "\n")
                fp.write(_cfq_record_to_lsam(rec, 2, output_seq) + "\n")
                last = None
            else:
                fp.write(_cfq_record_to_lsam(last, 0, output_seq) + "\n")
                last = rec
        else:
            last = rec
    if last is not None:
        fp.write(_cfq_record_to_lsam(last, 0, output_seq) + "\n")


# ---------------------------------------------------------------------------
# deinterleave (cfq -> pe_1/pe_2/se fastq files)
# ---------------------------------------------------------------------------


def deinterleave(records: Iterable[FastqRecord], prefix: str) -> Tuple[str, str, str]:
    """Split an interleaved cfq stream into .pe_1.fq/.pe_2.fq/.se.fq (the
    reference's cc/deinterleave.cpp): pairs are consecutive same-name
    records; names get ``/1`` ``/2`` suffixes; comments are kept
    (space-separated in the header)."""
    se_path = prefix + ".se.fq"
    pe1_path = prefix + ".pe_1.fq"
    pe2_path = prefix + ".pe_2.fq"

    def _fmt(rec: FastqRecord, which: int) -> str:
        lead = "@" if rec.qual else ">"
        head = rec.name + (f"/{which}" if which > 0 else "")
        if rec.comment:
            head += " " + rec.comment
        s = f"{lead}{head}\n{rec.seq}\n"
        if rec.qual:
            s += f"+\n{rec.qual}\n"
        return s

    with open(se_path, "w") as se, open(pe1_path, "w") as p1, open(pe2_path, "w") as p2:
        last: Optional[FastqRecord] = None
        for rec in records:
            rec.name = trim_readno(rec.name)
            if last is not None:
                if last.name == rec.name:
                    p1.write(_fmt(last, 1))
                    p2.write(_fmt(rec, 2))
                    last = None
                else:
                    se.write(_fmt(last, 0))
                    last = rec
            else:
                last = rec
        if last is not None:
            se.write(_fmt(last, 0))
    return pe1_path, pe2_path, se_path


# ---------------------------------------------------------------------------
# lsamReadFilter (drop reads named in a filter list)
# ---------------------------------------------------------------------------


def lsam_read_filter(filter_ids: Iterable[str], lines: Iterable[str]) -> Iterator[str]:
    """Drop LSAM lines whose read id is in ``filter_ids`` (the reference's
    cc/lsamReadFilter.cpp:38-63): ids carrying a ``/1``-style suffix also
    ban the bare name."""
    banned = set()
    for rid in filter_ids:
        rid = rid.strip()
        if not rid:
            continue
        banned.add(rid)
        if len(rid) >= 2 and rid[-2] == "/":
            banned.add(rid[:-2])
    for line in lines:
        name = line.split("\t", 1)[0].split(" ", 1)[0]
        if name not in banned:
            yield line
