"""BWA SAM -> cfq/LSAM converter (sam2cfq equivalent).

The port's copy of ``megapath_tpu/io/sam2cfq.py``, held equal to it by
``tests/test_torch_extras.py`` and ``tests/test_torch_cli_tools.py``.

Port of the reference's cc/sam2cfq.cpp: the alignment score is
recomputed from CIGAR + NM (matches*1 + mismatches*(-2) + gap
open -3/extend -1 per the [DP] scheme, :17-34), XA:Z alternate hits
join the hit list when within the dropout ratio of the best, and
``kraken:taxid|NNN|`` headers resolve to the taxid annotation.
"""

from __future__ import annotations

import re
from typing import Iterable, Iterator, List, Tuple

from megapath_tpu_torch.io.fastq import FastqRecord

_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


def score_from_cigar_nm(cigar: str, nm: int) -> int:
    """AS recomputed from CIGAR + NM (sam2cfq.cpp:17-34): matches score
    +1, mismatches -2, gaps -3 open / -1 extend; NM counts mismatches
    plus gap bases."""
    aligned = 0
    gap_bases = 0
    gap_opens = 0
    for ln, op in _CIG.findall(cigar):
        ln = int(ln)
        if op in "M=X":
            aligned += ln
        elif op in "ID":
            gap_bases += ln
            gap_opens += 1
    mismatches = max(0, nm - gap_bases)
    matches = aligned - mismatches
    return (
        matches * 1
        + mismatches * -2
        + gap_opens * -3
        + max(0, gap_bases - gap_opens) * -1
    )


def _target_name(rname: str) -> str:
    if rname.startswith("kraken:taxid|"):
        parts = rname.split("|", 2)
        if len(parts) >= 2:
            return parts[1]
    return rname


def sam_to_cfq(
    lines: Iterable[str], dropout: float = 0.95
) -> Iterator[FastqRecord]:
    """SAM stream -> cfq records, one per read with merged hits."""
    for line in lines:
        if not line.strip() or line.startswith("@"):
            continue
        cols = line.rstrip("\n").split("\t")
        name, flag, rname, cigar, seq, qual = (
            cols[0], int(cols[1]), cols[2], cols[5], cols[9], cols[10]
        )
        if flag & 0x100 or flag & 0x800:
            continue  # secondary/supplementary merged via XA
        opts = {c.split(":", 1)[0]: c for c in cols[11:]}
        hits: List[Tuple[int, str]] = []
        if not (flag & 0x4) and rname != "*":
            nm = int(opts.get("NM", "NM:i:0").rsplit(":", 1)[1])
            if "AS" in opts:
                score = int(opts["AS"].rsplit(":", 1)[1])
            else:
                score = score_from_cigar_nm(cigar, nm)
            hits.append((score, _target_name(rname)))
            xa = opts.get("XA") or opts.get("XC")
            if xa:
                for alt in xa.split(":", 2)[2].rstrip(";").split(";"):
                    f = alt.split(",")
                    if len(f) >= 4:
                        alt_score = score_from_cigar_nm(f[2], int(f[3]))
                        hits.append((alt_score, _target_name(f[0])))
        best = max((s for s, _ in hits), default=0)
        kept = [(s, t) for s, t in hits if s >= best * dropout]
        comment = f"SCORE:{best};" + "".join(f"{s},{t};" for s, t in kept)
        if flag & 0x10:
            comp = str.maketrans("ACGTacgt", "TGCAtgca")
            seq = seq.translate(comp)[::-1]
            qual = qual[::-1]
        yield FastqRecord(name=name, seq=seq, qual=qual, comment=comment)
