"""Reference sharding: split a large FASTA into index shards and build
each shard's ``.ref.npz``/``.fm.npz``.

The port's copy of ``megapath_tpu/index/shard.py``, a functional
replacement for the reference's splitFasta.pl (which cuts NT at 3.9 Gbp
because the 2bwt index uses 32-bit offsets). The index of each shard is
built on an explicit torch device (``index/fm.build_fm_index``) and
written in the JAX package's format, so either package loads it.

**Shard-size design decision (pinned):** the device seeding path is
int32 end to end (the device FM's occ rows, SA values, seed positions),
so the shard cap is 2.0 Gbp, roughly half the reference's 3.9 Gbp, i.e.
~2x the shard count for the same NT build. int32 keeps every hot array
at half the device footprint and bandwidth of an int64 layout. A shard
of 2^31 characters or more fails loudly in ``index/suffix.py``.

**The card's own limit:** the build on a card peaks while it sorts: two
int64 key buffers, two int32 position buffers and the text
(``index/suffix.py``), ``BUILD_BYTES_PER_CHAR`` in all, so an 80 GB card
builds the 2.0 Gbp default shard. Whatever the card's memory, a shard
stays below ``MAX_SHARD_BP`` (~2.1 Gbp), which int32 coordinates set.
``build_shard_indexes`` refuses a shard the card cannot hold before it
allocates anything there, every shard checked before the first is built,
and names ``--device cpu``, which builds it in host memory.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import torch

from megapath_tpu_torch.io.fastq import FastqRecord, read_fastx, write_fastq

# splitFasta.pl:19 uses 3.9e9 (2bwt 32-bit *offsets*); the device FM
# uses int32 *signed* coordinates everywhere, so cap at 2.0 Gbp and
# run twice the shards instead
DEFAULT_SHARD_BP = int(2.0e9)

# card bytes a text character costs at the build's peak, rounded up:
# torch.cuda.max_memory_allocated over build_fm_index of the 2.0 Gbp
# default shard is 25.27 bytes a character, in its sort rounds
# (chip_smoke.py, the default-shard phase, NVIDIA H100 80GB HBM3), so an
# 80 GB card's memory would admit ~3.27 Gbp, past the 2.0 Gbp default
BUILD_BYTES_PER_CHAR = 26
# the largest shard int32 coordinates take: full BWT rows 0..n and the
# sentinel-free n + 1 must stay below 2^31 - 1 (seeding_dev.DeviceFM)
MAX_SHARD_BP = 2**31 - 2


def check_shard_fits(n_bp: int, device: torch.device) -> None:
    """Raise before anything is allocated when a shard of ``n_bp``
    characters cannot be built on ``device``: on a card the limit is its
    memory over ``BUILD_BYTES_PER_CHAR``, at most ``MAX_SHARD_BP``; the CPU
    takes any shard."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    memory = torch.cuda.get_device_properties(device).total_memory
    limit = min(memory // BUILD_BYTES_PER_CHAR, MAX_SHARD_BP)
    if n_bp > limit:
        raise ValueError(
            f"a shard of {n_bp} bp does not fit the index build on "
            f"{torch.cuda.get_device_name(device)}: the build takes "
            f"{BUILD_BYTES_PER_CHAR} bytes a character at its peak and int32 "
            f"coordinates stop at {MAX_SHARD_BP} bp, so this card holds shards "
            f"up to {limit} bp; pass --shard-bp {limit} or smaller, or build "
            f"the index on the host with --device cpu"
        )


def fasta_bp(path) -> int:
    """The characters a FASTA file's sequences hold, as ``pack_fasta_file``
    counts them (``total_len``), without packing it."""
    n = 0
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                n += len(line.rstrip(b"\n"))
    return n


def split_fasta(path, out_prefix: str, max_bp: int = DEFAULT_SHARD_BP) -> List[str]:
    """Write ``{out_prefix}.{i}.fa`` shards each <= max_bp bases.

    A single sequence longer than max_bp gets its own shard (like the
    reference, which never splits within a sequence).
    """
    shard_paths: List[str] = []
    cur: List[FastqRecord] = []
    cur_bp = 0

    def flush():
        nonlocal cur, cur_bp
        if not cur:
            return
        p = f"{out_prefix}.{len(shard_paths)}.fa"
        write_fastq(cur, p, sep=" ")
        shard_paths.append(p)
        cur, cur_bp = [], 0

    for rec in read_fastx(path):
        if cur_bp and cur_bp + len(rec.seq) > max_bp:
            flush()
        cur.append(FastqRecord(rec.name, rec.seq, "", rec.comment))
        cur_bp += len(rec.seq)
    flush()
    return shard_paths


def build_shard_indexes(
    shard_paths: List[str],
    out_dir: str,
    sa_interval: int = 8,
    # lut_k=8 (not the 2bwt LOOKUP_SIZE=13), the reference's default here:
    # the walk gains nothing from empty-bucket exits and a 4^13 table is
    # 512 MB of cold rows
    lut_k: int = 8,
    *,
    device: torch.device,
) -> List[Tuple[str, str]]:
    """Build (packed-ref, fm-index) npz pairs for every shard, each index
    built on ``device``. On a card every shard is checked first, so one
    the card cannot hold raises (``check_shard_fits``) before any shard is
    built or written."""
    from megapath_tpu_torch.index.fm import build_fm_index
    from megapath_tpu_torch.index.pack import pack_fasta_file

    if torch.device(device).type == "cuda":
        for p in shard_paths:
            check_shard_fits(fasta_bp(p), device)
    os.makedirs(out_dir, exist_ok=True)
    out: List[Tuple[str, str]] = []
    for i, p in enumerate(shard_paths):
        ref = pack_fasta_file(p)
        fm = build_fm_index(ref.codes, sa_interval=sa_interval, lut_k=lut_k, device=device)
        ref_path = os.path.join(out_dir, f"shard{i}.ref.npz")
        fm_path = os.path.join(out_dir, f"shard{i}.fm.npz")
        ref.save(ref_path)
        fm.save(fm_path)
        out.append((ref_path, fm_path))
    return out
