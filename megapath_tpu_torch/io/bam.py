"""BAM output/input (BGZF + BAM binary records), pure Python + zlib.

The port's copy of ``megapath_tpu/io/bam.py``. The reference writes BAM
through its vendored samtools-0.1.18 (soap4/SOAP4.cpp:346-354 when
``-b``; runMegaPath.sh:211-216 then merges and sorts them).
Here BAM is a serialization of the same SAM lines the text writer emits
(``io/sam.py``); the files interoperate with samtools/pysam. The BGZF
bytes depend on the zlib build, so two BAMs compare by their
decompressed content (``read_bam``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NYBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


class BgzfWriter:
    """Blocked-gzip writer (64 KB members with the BC subfield)."""

    def __init__(self, fileobj):
        self._fp = fileobj
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(chunk)) + co.flush()
        # BSIZE = total block length MINUS 1 (SAM spec 4.1): 18-byte
        # header + comp + 8-byte footer = len(comp)+26 total bytes.
        bsize = len(comp) + 25
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HBBHH", 6, 66, 67, 2, bsize)
        )
        self._fp.write(header + comp)
        self._fp.write(struct.pack("<II", zlib.crc32(bytes(chunk)), len(chunk)))

    def close(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf.clear()
        self._fp.write(BGZF_EOF)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a full BGZF byte string (any gzip-member stream)."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(31)
        out += d.decompress(data[pos:])
        consumed = len(data) - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cigar: str) -> List[Tuple[int, int]]:
    if cigar == "*":
        return []
    out = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, _CIGAR_OPS.index(ch)))
            num = 0
    return out


def _encode_record(cols: List[str], ref_ids: dict) -> bytes:
    name, flag, rname, pos, mapq, cigar = cols[:6]
    seq, qual = cols[9], cols[10]
    flag_i, pos_i, mapq_i = int(flag), int(pos) - 1, int(mapq)
    ref_id = ref_ids.get(rname, -1)
    cig = _parse_cigar(cigar)
    ref_span = sum(n for n, op in cig if op in (0, 2, 3, 7, 8)) or 1
    bin_ = _reg2bin(max(pos_i, 0), max(pos_i, 0) + ref_span)
    l_seq = 0 if seq == "*" else len(seq)
    nseq = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq if seq != "*" else ""):
        nyb = _SEQ_NYBBLE.get(ch.upper(), 15)
        nseq[i // 2] |= nyb << (4 if i % 2 == 0 else 0)
    if qual == "*" or l_seq == 0:
        quals = b"\xff" * l_seq
    else:
        quals = bytes((min(ord(q) - 33, 93) for q in qual))
    tags = b""
    for col in cols[11:]:
        tag, typ, val = col.split(":", 2)
        if typ == "i":
            tags += tag.encode() + b"i" + struct.pack("<i", int(val))
        elif typ == "A":
            tags += tag.encode() + b"A" + val[:1].encode()
        elif typ == "f":
            tags += tag.encode() + b"f" + struct.pack("<f", float(val))
        else:  # Z and the rest as string
            tags += tag.encode() + b"Z" + val.encode() + b"\x00"
    body = struct.pack(
        "<iiBBHHHiii",
        ref_id,
        pos_i,
        len(name) + 1,
        mapq_i,
        bin_,
        len(cig),
        flag_i,
        l_seq,
        ref_ids.get(cols[6], -1) if cols[6] not in ("*", "=") else (ref_id if cols[6] == "=" else -1),
        int(cols[7]) - 1,
    )
    body += struct.pack("<i", int(cols[8]))
    body += name.encode() + b"\x00"
    for n, op in cig:
        body += struct.pack("<I", (n << 4) | op)
    body += bytes(nseq) + quals + tags
    return struct.pack("<i", len(body)) + body


def write_bam(fileobj, header_text: str, sam_lines: Iterable[str]) -> None:
    """Serialize a SAM header + alignment lines to BGZF BAM."""
    refs: List[Tuple[str, int]] = []
    for line in header_text.splitlines():
        if line.startswith("@SQ"):
            d = dict(
                f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
            )
            refs.append((d["SN"], int(d["LN"])))
    ref_ids = {n: i for i, (n, _) in enumerate(refs)}

    w = BgzfWriter(fileobj)
    htext = header_text.encode()
    blob = b"BAM\x01" + struct.pack("<i", len(htext)) + htext
    blob += struct.pack("<i", len(refs))
    for n, ln in refs:
        nm = n.encode() + b"\x00"
        blob += struct.pack("<i", len(nm)) + nm + struct.pack("<i", ln)
    w.write(blob)
    for line in sam_lines:
        if not line or line.startswith("@"):
            continue
        w.write(_encode_record(line.rstrip("\n").split("\t"), ref_ids))
    w.close()


def read_bam(fileobj) -> Tuple[str, List[str]]:
    """BAM -> (header text, SAM alignment lines). Whole-file reader for
    tests/tools (streaming is unnecessary at fixture scale)."""
    data = bgzf_decompress(fileobj.read())
    assert data[:4] == b"BAM\x01", "not a BAM file"
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    header_text = data[off : off + l_text].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    names: List[str] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        names.append(data[off : off + l_name - 1].decode())
        off += l_name + 4  # skip l_ref
    lines: List[str] = []
    nyb2c = "=ACMGRSVTWYHKDBN"
    while off < len(data):
        (block,) = struct.unpack_from("<i", data, off)
        off += 4
        rec = data[off : off + block]
        off += block
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, nref, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        p = 32
        name = rec[p : p + l_rn - 1].decode()
        p += l_rn
        cig = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", rec, p)
            p += 4
            cig.append(f"{v >> 4}{_CIGAR_OPS[v & 0xF]}")
        seq = "".join(
            nyb2c[(rec[p + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
            for i in range(l_seq)
        )
        p += (l_seq + 1) // 2
        qual = rec[p : p + l_seq]
        p += l_seq
        qual_s = (
            "*"
            if l_seq == 0 or (qual and qual[0] == 0xFF)
            else "".join(chr(q + 33) for q in qual)
        )
        tags = []
        while p < len(rec):
            tag = rec[p : p + 2].decode()
            typ = chr(rec[p + 2])
            p += 3
            if typ == "i":
                (v,) = struct.unpack_from("<i", rec, p)
                p += 4
                tags.append(f"{tag}:i:{v}")
            elif typ in "cCsSI":
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "I": 4}[typ]
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "I": "<I"}[typ]
                (v,) = struct.unpack_from(fmt, rec, p)
                p += size
                tags.append(f"{tag}:i:{v}")
            elif typ == "A":
                tags.append(f"{tag}:A:{chr(rec[p])}")
                p += 1
            elif typ == "f":
                (v,) = struct.unpack_from("<f", rec, p)
                p += 4
                tags.append(f"{tag}:f:{v}")
            elif typ == "Z":
                end = rec.index(b"\x00", p)
                tags.append(f"{tag}:Z:{rec[p:end].decode()}")
                p = end + 1
            else:  # B arrays and rest unsupported: stop tag parse
                break
        rname = names[ref_id] if ref_id >= 0 else "*"
        rnext = (
            "=" if nref == ref_id and nref >= 0
            else (names[nref] if nref >= 0 else "*")
        )
        lines.append(
            "\t".join(
                [
                    name,
                    str(flag),
                    rname,
                    str(pos + 1),
                    str(mapq),
                    "".join(cig) or "*",
                    rnext,
                    str(npos + 1),
                    str(tlen),
                    seq or "*",
                    qual_s,
                ]
                + tags
            )
        )
    return header_text, lines


def sort_sam_lines(header_text: str, sam_lines: List[str]) -> List[str]:
    """Coordinate sort (samtools sort order: reference index from the
    @SQ order, then POS; unmapped '*' records last, input-stable)."""
    order = {}
    for line in header_text.splitlines():
        if line.startswith("@SQ"):
            d = dict(
                f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
            )
            order[d["SN"]] = len(order)
    unmapped = len(order)

    def key(item):
        i, line = item
        c = line.split("\t", 5)
        rid = order.get(c[2], unmapped)
        pos = int(c[3]) if c[3].isdigit() else 0
        return (rid, pos, i)

    return [l for _, l in sorted(enumerate(sam_lines), key=lambda x: key(x))]


def merge_shard_bams(fileobjs, out_fileobj) -> None:
    """samtools-merge equivalent for PER-SHARD BAMs with DIFFERENT
    reference sets (the cascade's nt.bam.* files cover disjoint shard
    sequences, runMegaPath.sh:211-216): the output header is the @SQ
    concatenation in input order (first wins on duplicate SN) and the
    records re-sort by coordinate under the union ordering."""
    sq_lines: List[str] = []
    seen: dict = {}
    other: List[str] = []
    all_lines: List[str] = []
    for f in fileobjs:
        h, lines = read_bam(f)
        for l in h.splitlines():
            if l.startswith("@SQ"):
                d = dict(
                    x.split(":", 1) for x in l.split("\t")[1:] if ":" in x
                )
                sn, ln = d.get("SN"), d.get("LN")
                if sn not in seen:
                    seen[sn] = ln
                    sq_lines.append(l)
                elif seen[sn] != ln:
                    # samtools merge refuses inconsistent headers; a
                    # silent first-wins here would emit records under a
                    # wrong-length @SQ (coordinate-inconsistent BAM).
                    raise ValueError(
                        f"duplicate @SQ SN:{sn} with conflicting LN "
                        f"({seen[sn]} vs {ln}) across shard BAMs"
                    )
            elif not other or l not in other:
                other.append(l)
        all_lines.extend(lines)
    hd = [l for l in other if l.startswith("@HD")]
    rest = [l for l in other if not l.startswith("@HD")]
    header = "\n".join(hd + sq_lines + rest) + "\n"
    write_bam(out_fileobj, header, sort_sam_lines(header, all_lines))


def merge_bams(fileobjs, out_fileobj) -> None:
    """samtools merge equivalent for the per-shard ``-b`` BAMs
    (runMegaPath.sh shard outputs): headers must agree on @SQ lines;
    records re-sort by coordinate across inputs."""
    header = None
    all_lines: List[str] = []
    sq = None
    for f in fileobjs:
        h, lines = read_bam(f)
        h_sq = [l for l in h.splitlines() if l.startswith("@SQ")]
        if header is None:
            header, sq = h, h_sq
        elif h_sq != sq:
            raise ValueError("merge_bams: @SQ headers differ between inputs")
        all_lines.extend(lines)
    if header is None:
        raise ValueError("merge_bams: no inputs")
    write_bam(out_fileobj, header, sort_sam_lines(header, all_lines))
