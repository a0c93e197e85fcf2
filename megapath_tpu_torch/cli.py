"""Command-line interface of the PyTorch port (the runMegaPath.sh equivalent).

The port of ``megapath_tpu/cli.py``, with the same subcommands and flags,
plus ``--device`` on ``build-index``, ``build-db``, ``run`` and ``amplicon`` (default
``cuda``; without a card the command raises unless ``--device cpu`` is
given, it never runs on the CPU by itself):

  build-index   FASTA -> shards -> suffix array and FM tables built on the
                device -> ``shardN.ref.npz``/``shardN.fm.npz`` in the JAX
                package's format (either package loads the other's)
  build-db      raw NT + taxdump -> createDB curation (drop artificial and
                unmapped sequences, append UniVec and human) -> filterDB
                (``--exclude-taxa``) -> ``PREFIX.curated.fa`` -> the
                shards and indexes of ``build-index``
  run           gzip FASTQ (C++ reader) -> bbduk -> human filter ->
                (ribosome filter) -> NT shards -> SPIKE -> reassign ->
                Kraken reports; ``--devices N`` places the NT shards over
                N devices (``cuda:0`` .. ``cuda:N-1``, or N places on the
                one CPU) and, with more shards than N, rotates them
                through those devices in waves, so ``--devices 1``
                streams any number of shards through one card; ``-b``
                adds the per-shard BAMs and the
                merged, sorted PREFIX.nt.bam; ``-A`` adds the assembly
                stage: the viral and unmapped pairs through bbnorm and the
                multi-k assembler (or ``--megahit-bin``) on the host, the
                contigs indexed and the reads aligned back on the device
                -> PREFIX.contigs.fa, PREFIX.r2c.lsam; ``-A --protein-db``
                adds the protein remap (blastx of the contigs and the
                still-unmapped reads, its DP on the device) ->
                PREFIX.nr.lsam.id, PREFIX.nt.unmap.r2g.lsam.id,
                PREFIX.nr.report
  report        LSAM.id -> Kraken-style report (genKrakenReport)
  amplicon      FASTQ pair -> bbduk -> decoy filters -> (taxon filter) ->
                target alignment -> pileup -> windows realigned against
                de Bruijn haplotypes (the DNA DP on the device) ->
                PREFIX.vcf, PREFIX.done

Stream tools (the reference's cc/ toolchain and its Perl glue):
fastq2lsam, taxlookup, reassign, deinterleave, sam2cfq, extract,
genomecov-filter, lsam-read-filter, m8-to-lsam, r2c-to-r2g, cleanup,
bbduk. Evaluation tools: count-table, m8-cov, maplen-hist. All run on
the host.

``run --spmd`` aligns the NT shards in the one-program step
(``parallel.spmd_full``) over a (data x shard) grid of the ``--devices N``
devices (0: every visible card, or the one CPU under ``--device cpu``);
it needs at least as many devices as shards and says so before any index
is read.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _device(name: str):
    """The torch device of ``--device``; a CUDA device without a card
    raises instead of running on the CPU."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to run on the host"
        )
    return dev


def _devices(n: int, dev):
    """The placement of ``run --devices N`` on ``--device``'s type: None
    for 0, ``cuda:0`` .. ``cuda:N-1`` on a card (refused when fewer are
    visible: the reference takes as many as there are), N places on the
    one CPU."""
    import torch

    if n < 0:
        raise ValueError(f"--devices {n}: the count cannot be negative")
    if not n:
        return None
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(
            f"--devices {n}: only {have} CUDA device(s) visible; pass --devices {have} "
            "or fewer (--devices 1 rotates every shard through one card)"
        )
    return [torch.device(dev.type, i) for i in range(n)]


def _taxdb(args, acc2tid: bool = True):
    from megapath_tpu_torch.taxonomy.taxdb import TaxDB

    db = TaxDB()
    db.read_nodes(args.nodes)
    db.read_names(args.names)
    if acc2tid:
        db.read_acc2tid(args.acc2tid)
    return db


def load_shard(prefix: str):
    """(PackedReference, FMIndex) of ``prefix.ref.npz``/``prefix.fm.npz``."""
    from megapath_tpu_torch.index.fm import FMIndex
    from megapath_tpu_torch.index.pack import PackedReference

    return PackedReference.load(prefix + ".ref.npz"), FMIndex.load(prefix + ".fm.npz")


def _cmd_build_index(args) -> int:
    from megapath_tpu_torch.index.shard import build_shard_indexes, split_fasta

    dev = _device(args.device)
    t0 = time.time()
    shards = split_fasta(args.fasta, args.out_prefix, max_bp=args.shard_bp)
    print(f"[build-index] {len(shards)} shard(s)", file=sys.stderr)
    out = build_shard_indexes(
        shards, os.path.dirname(args.out_prefix) or ".",
        sa_interval=args.sa_interval, lut_k=args.lut_k, device=dev,
    )
    for rp, fp in out:
        print(f"{rp}\t{fp}")
    print(f"[build-index] done in {time.time()-t0:.1f}s", file=sys.stderr)
    return 0


def _cmd_build_db(args) -> int:
    """Raw NT + taxdump -> curated, sharded, indexed database in one
    command: createDB curation (drop artificial/unmapped sequences,
    append UniVec + human, accession headers) -> filterDB named-taxon
    exclusion -> splitFasta sharding -> the index build of
    ``build-index`` on ``--device``. Mirrors the reference's offline
    chain: cc/createDB.cpp, cc/filterDB.cpp, splitFasta.pl and the 2bwt
    index build."""
    from megapath_tpu_torch.index.dbtools import create_db, filter_db
    from megapath_tpu_torch.index.shard import build_shard_indexes, split_fasta
    from megapath_tpu_torch.io.fastq import read_fastx

    dev = _device(args.device)
    t0 = time.time()
    db = _taxdb(args)

    def recs(path):
        return read_fastx(path) if path else iter(())

    curated = create_db(recs(args.nt), recs(args.univec), recs(args.human), db)
    if args.exclude_taxa:
        curated = filter_db(curated, db, args.exclude_taxa)
    curated_fa = args.out_prefix + ".curated.fa"
    n_seq = 0
    with open(curated_fa, "w") as f:
        for rec in curated:
            f.write(f">{rec.name}\n{rec.seq}\n")
            n_seq += 1
    print(f"[build-db] curated {n_seq} sequences", file=sys.stderr)
    if not n_seq:
        print("[build-db] ABORT: no sequences survived curation", file=sys.stderr)
        return 1
    shards = split_fasta(curated_fa, args.out_prefix, max_bp=args.shard_bp)
    print(f"[build-db] {len(shards)} shard(s)", file=sys.stderr)
    out = build_shard_indexes(
        shards, os.path.dirname(args.out_prefix) or ".",
        sa_interval=args.sa_interval, lut_k=args.lut_k, device=dev,
    )
    for rp, fp in out:
        print(f"{rp}\t{fp}")
    print(f"[build-db] done in {time.time()-t0:.1f}s", file=sys.stderr)
    return 0


def _cmd_run(args) -> int:
    from megapath_tpu_torch.filters.bbduk import build_kmer_ref, load_adapters
    from megapath_tpu_torch.parallel.spmd_full import grid_devices, make_mesh
    from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig

    dev = _device(args.device)
    devices = _devices(args.devices, dev)
    if args.spmd:
        # the grid's refusal, before any index is read
        make_mesh(grid_devices(dev, devices), len(args.nt_index))
    db = _taxdb(args)
    nt_shards = [load_shard(p) for p in args.nt_index]
    hg = load_shard(args.hg_index) if args.hg_index else None
    ribo = load_shard(args.ribo_index) if args.ribo_index else None
    adapters = (
        build_kmer_ref(load_adapters(args.adapters)) if args.adapters else None
    )
    cfg = PipelineConfig(
        read_len=args.read_len,
        nt_cutoff=args.cutoff,
        spike_stdev=args.spike_stdev,
        spike_overlap=args.spike_overlap,
        skip_human=args.hg_index is None,
        skip_preprocess=args.adapters is None and args.skip_preprocess,
        device_seeding=not args.no_device_seeding,
        batch_size=args.batch_size,
        bam=args.bam,
        spmd=args.spmd,
    )
    prot_db = None
    if args.protein_db:
        from megapath_tpu_torch.classify.protein import ProteinDB
        from megapath_tpu_torch.io.fastq import read_fastx

        prot_db = ProteinDB.build(
            [(r.name, r.seq) for r in read_fastx(args.protein_db)]
        )
    pipe = MegaPathPipeline(
        nt_shards, db, hg_shard=hg, adapters=adapters, config=cfg,
        ribo_shard=ribo, devices=devices, device=dev,
    )
    try:
        res = pipe.run_files(args.r1, args.r2, args.prefix,
                             assembly=args.assembly, megahit_bin=args.megahit_bin,
                             protein_db=prot_db)
    finally:
        pipe.close()
    print(
        f"[run] pairs in={res.n_input_pairs} preprocessed={res.n_after_preprocess} "
        f"non-human={res.n_after_human} non-ribo={res.n_after_ribo} "
        f"spike-removed={res.spike_removed}",
        file=sys.stderr,
    )
    print(f"[run] wrote {args.prefix}.nt.report / .nt.ra.report / .nt.lsam.id",
          file=sys.stderr)
    return 0


def _cmd_report(args) -> int:
    from megapath_tpu_torch.io.fastq import open_maybe_gz
    from megapath_tpu_torch.taxonomy.report import gen_kraken_report

    db = _taxdb(args, acc2tid=False)
    fp = open_maybe_gz(args.lsam_id, "rt")
    sys.stdout.write(gen_kraken_report(db, fp, score_threshold=args.threshold))
    return 0


# ---------------------------------------------------------------------------
# stream tools (cc/ toolchain + Perl glue equivalents)
# ---------------------------------------------------------------------------


def _in(path):
    from megapath_tpu_torch.io.fastq import open_maybe_gz

    return open_maybe_gz(path or "-", "rt")


def _write_fastq(rec, out, suffix: str = "", comment: str = "") -> None:
    head = rec.name + suffix + ((" " + comment) if comment else "")
    out.write(f"@{head}\n{rec.seq}\n+\n{rec.qual}\n")


def _cmd_fastq2lsam(args) -> int:
    from megapath_tpu_torch.io.fastq import read_fastx
    from megapath_tpu_torch.io.lsam import fastq_to_lsam

    fastq_to_lsam(read_fastx(_in(args.cfq)), sys.stdout, output_seq=not args.no_seq)
    return 0


def _cmd_taxlookup(args) -> int:
    from megapath_tpu_torch.classify.taxlookup import tax_lookup_acc

    for line in tax_lookup_acc(_taxdb(args), _in(args.lsam)):
        sys.stdout.write(line + "\n")
    return 0


def _cmd_reassign(args) -> int:
    from megapath_tpu_torch.classify.reassign import reassign_lines

    lines = [l.rstrip("\n") for l in _in(args.lsam_id)]
    for line in reassign_lines(
        lines, u=args.u, v=args.v, t=args.threshold, output_seq=args.print_seq
    ):
        sys.stdout.write(line + "\n")
    return 0


def _cmd_deinterleave(args) -> int:
    from megapath_tpu_torch.io.fastq import read_fastx
    from megapath_tpu_torch.io.lsam import deinterleave

    p1, p2, se = deinterleave(read_fastx(_in(args.cfq)), args.prefix)
    print(f"{p1}\n{p2}\n{se}", file=sys.stderr)
    return 0


def _cmd_sam2cfq(args) -> int:
    from megapath_tpu_torch.io.sam2cfq import sam_to_cfq

    for rec in sam_to_cfq(_in(args.sam), dropout=args.dropout):
        _write_fastq(rec, sys.stdout, comment=rec.comment)
    return 0


def _cmd_extract(args) -> int:
    from megapath_tpu_torch.classify.extras import extract_from_lsam
    from megapath_tpu_torch.io.lsam import parse_lsam_line

    recs = (parse_lsam_line(l) for l in _in(args.lsam_id) if l.strip())
    last_name = None  # -n prints each pair's name once (alreadyOutput
    # flag in extractFromLSAM.pl), not once per selected end
    for rec, which, comment in extract_from_lsam(
        recs,
        threshold=args.threshold,
        viral=args.viral,
        se_mode=args.se,
        append_ignore=args.append_ignore,
        skip_ignore_tag=args.skip_ignore,
    ):
        if args.names_only:
            if rec.name != last_name:
                sys.stdout.write(rec.name + "\n")
                last_name = rec.name
        else:
            _write_fastq(rec, sys.stdout, suffix=f"/{which}", comment=comment)
    return 0


def _cmd_genomecov_filter(args) -> int:
    """SPIKE step 1 (cc/genomeCovFilter.cpp): flag depth outliers.

    Inputs are the reference's own formats: a ``.genome`` file
    (``name\\tlength``) and a ``bedtools genomecov -bga`` bed stream.
    """
    import numpy as np

    from megapath_tpu_torch.filters.spike import CoverageRuns, spike_regions

    names: list = []
    with open(args.genome) as f:
        for line in f:
            if line.strip():
                names.append(line.split("\t")[0])
    idx = {n: i for i, n in enumerate(names)}
    seq, start, stop, depth = [], [], [], []
    for line in _in(args.genomecov):
        cols = line.split("\t")
        if len(cols) < 4 or cols[0] not in idx:
            continue
        seq.append(idx[cols[0]])
        start.append(int(cols[1]))
        stop.append(int(cols[2]))
        depth.append(int(cols[3]))
    runs = CoverageRuns(
        np.asarray(seq, np.int32),
        np.asarray(start, np.int64),
        np.asarray(stop, np.int64),
        np.asarray(depth, np.int64),
    )
    s, b, e = spike_regions(runs, len(names), max_depth_stdev=args.stdev)
    for i in range(len(s)):
        sys.stdout.write(f"{names[s[i]]}\t{b[i]}\t{e[i]}\n")
    return 0


def _cmd_lsam_read_filter(args) -> int:
    from megapath_tpu_torch.io.lsam import lsam_read_filter

    with open(args.filter_list) as f:
        ids = [l.strip() for l in f if l.strip()]
    for line in lsam_read_filter(ids, _in(args.lsam)):
        sys.stdout.write(line if line.endswith("\n") else line + "\n")
    return 0


def _cmd_m8_to_lsam(args) -> int:
    from megapath_tpu_torch.classify.extras import m8_to_lsam

    for rec in m8_to_lsam(_in(args.m8)):
        sys.stdout.write(rec.to_line() + "\n")
    return 0


def _cmd_r2c_to_r2g(args) -> int:
    from megapath_tpu_torch.classify.extras import r2c_to_r2g
    from megapath_tpu_torch.io.lsam import read_lsam

    for rec in r2c_to_r2g(read_lsam(args.r2c), read_lsam(args.c2g)):
        sys.stdout.write(rec.to_line() + "\n")
    return 0


def _cmd_cleanup(args) -> int:
    from megapath_tpu_torch.classify.extras import cleanup_contaminants
    from megapath_tpu_torch.io.lsam import parse_lsam_line

    recs = [parse_lsam_line(l) for l in _in(args.lsam_id) if l.strip()]
    out, removed = cleanup_contaminants(
        recs,
        contaminant_tids=set(args.taxid),
        score_tolerance=args.tolerance,
        fraction=args.fraction,
    )
    for rec in out:
        sys.stdout.write(rec.to_line() + "\n")
    print(f"removed species: {sorted(removed)}", file=sys.stderr)
    return 0


def _cmd_bbduk(args) -> int:
    from megapath_tpu_torch.filters.bbduk import bbduk_pair, build_kmer_ref, load_adapters
    from megapath_tpu_torch.io.fastq import read_fastx

    recs1 = list(read_fastx(_in(args.r1)))
    recs2 = list(read_fastx(_in(args.r2)))
    ref = build_kmer_ref(load_adapters(args.ref)) if args.ref else None
    res = bbduk_pair(
        recs1,
        recs2,
        ref,
        min_len=args.minlength,
        trimq=args.trimq,
        entropy_cutoff=args.entropy,
    )
    with open(args.out1, "w") as f:
        for r in res.kept1:
            _write_fastq(r, f)
    with open(args.out2, "w") as f:
        for r in res.kept2:
            _write_fastq(r, f)
    if args.outm:
        with open(args.outm, "w") as f:
            for r in res.low_complexity:
                _write_fastq(r, f)
    print(
        f"kept {len(res.kept1)} pairs, low-complexity "
        f"{len(res.low_complexity)}, short-removed {res.removed_short}",
        file=sys.stderr,
    )
    return 0


def _cmd_amplicon(args) -> int:
    from megapath_tpu_torch.filters.bbduk import build_kmer_ref, load_adapters
    from megapath_tpu_torch.pipeline.amplicon import AmpliconConfig, AmpliconPipeline

    dev = _device(args.device)
    pipe = AmpliconPipeline(
        target=load_shard(args.target_index),
        decoys=[load_shard(p) for p in (args.decoy_index or [])],
        taxon_db=load_shard(args.taxon_index) if args.taxon_index else None,
        adapters=(
            build_kmer_ref(load_adapters(args.adapters)) if args.adapters else None
        ),
        config=AmpliconConfig(final_as=args.final_as, min_depth=args.min_depth),
        device=dev,
    )
    res = pipe.run_files(args.r1, args.r2, args.prefix)
    print(
        f"[amplicon] in={res.n_input} qc={res.n_after_qc} "
        f"decoy={res.n_after_decoy} taxon={res.n_after_taxon} "
        f"final={res.n_final} variants={len(res.variants)}",
        file=sys.stderr,
    )
    return 0


def _cmd_count_table(args) -> int:
    from megapath_tpu_torch.io.lsam import parse_lsam_line
    from megapath_tpu_torch.utils.accuracy import count_table

    db = _taxdb(args, acc2tid=False)
    recs = [parse_lsam_line(l) for l in _in(args.lsam_id) if l.strip()]
    sys.stdout.write(count_table(db, recs))
    return 0


def _cmd_m8_cov(args) -> int:
    from megapath_tpu_torch.utils.accuracy import m8_coverage

    sys.stdout.write(m8_coverage(_in(args.m8)))
    return 0


def _cmd_maplen_hist(args) -> int:
    from megapath_tpu_torch.utils.accuracy import maplen_stats

    sys.stdout.write(maplen_stats(_in(args.m8)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megapath-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-index", help="build shard indexes from FASTA")
    b.add_argument("fasta")
    b.add_argument("out_prefix")
    b.add_argument("--shard-bp", type=int, default=int(2e9))
    b.add_argument("--sa-interval", type=int, default=8)
    b.add_argument("--lut-k", type=int, default=13)
    b.add_argument("--device", default="cuda",
                   help="torch device that builds the index (cuda or cpu)")
    b.set_defaults(fn=_cmd_build_index)

    b = sub.add_parser(
        "build-db",
        help="raw NT + taxdump -> curated sharded indexes (createDB/"
             "filterDB/splitFasta/2bwt index chain in one command)",
    )
    b.add_argument("--nt", required=True, help="raw NT FASTA")
    b.add_argument("--univec", default=None, help="UniVec FASTA")
    b.add_argument("--human", default=None, help="human genome FASTA")
    b.add_argument("--nodes", required=True)
    b.add_argument("--names", required=True)
    b.add_argument("--acc2tid", required=True)
    b.add_argument("--exclude-taxa", nargs="*", default=None,
                   help="taxon names to drop (filterDB)")
    b.add_argument("--out-prefix", required=True)
    b.add_argument("--shard-bp", type=int, default=2_000_000_000)
    b.add_argument("--sa-interval", type=int, default=8)
    b.add_argument("--lut-k", type=int, default=8)
    b.add_argument("--device", default="cuda",
                   help="torch device that builds the indexes (cuda or cpu)")
    b.set_defaults(fn=_cmd_build_db)

    r = sub.add_parser("run", help="run the detection pipeline")
    r.add_argument("-1", dest="r1", required=True)
    r.add_argument("-2", dest="r2", required=True)
    r.add_argument("-p", dest="prefix", default="megapath")
    r.add_argument("--nt-index", nargs="+", required=True,
                   help="shard prefixes (expects .ref.npz/.fm.npz)")
    r.add_argument("--hg-index", default=None)
    r.add_argument("--nodes", required=True)
    r.add_argument("--names", required=True)
    r.add_argument("--acc2tid", required=True)
    r.add_argument("--adapters", default=None)
    r.add_argument("-L", dest="read_len", type=int, default=150)
    r.add_argument("-c", dest="cutoff", type=int, default=40)
    r.add_argument("-s", dest="spike_stdev", type=int, default=60)
    r.add_argument("-o", dest="spike_overlap", type=float, default=0.5)
    r.add_argument("--skip-preprocess", action="store_true")
    r.add_argument("--no-device-seeding", action="store_true")
    r.add_argument("--ribo-index", default=None,
                   help="SILVA-style 16S index prefix (-S stage, "
                        "runMegaPath.sh:155-169)")
    r.add_argument("-A", "--assembly", action="store_true",
                   help="assembly + protein remap stage (runMegaPath.sh:267-330)")
    r.add_argument("--megahit-bin", default=None)
    r.add_argument("--protein-db", default=None,
                   help="protein FASTA (NR-style, accessions 0x1-joined) "
                        "for the stage-4.1 in-process blastx")
    r.add_argument("--devices", type=int, default=0,
                   help="distribute NT shard engines over the first N "
                        "devices of --device's type, rotating them in waves "
                        "when there are more shards (0 = single device)")
    r.add_argument("--batch-size", type=int, default=500_000,
                   help="streaming read-pair batch size (SOAP4.cpp:206)")
    r.add_argument("-b", "--bam", action="store_true",
                   help="emit per-shard BAMs + merged/sorted "
                        "PREFIX.nt.bam (soap4 -b -o + samtools, "
                        "runMegaPath.sh:199-216)")
    r.add_argument("--spmd", action="store_true",
                   help="route NT alignment through the one-program "
                        "backend (parallel.spmd_full) over a (data x shard) "
                        "grid of the --devices devices")
    r.add_argument("--device", default="cuda",
                   help="torch device of every engine (cuda or cpu)")
    r.set_defaults(fn=_cmd_run)

    p = sub.add_parser("report", help="LSAM.id -> Kraken report")
    p.add_argument("nodes")
    p.add_argument("names")
    p.add_argument("lsam_id")
    p.add_argument("--threshold", type=int, default=40)
    p.set_defaults(fn=_cmd_report)

    s = sub.add_parser("fastq2lsam", help="cfq stream -> LSAM")
    s.add_argument("cfq", nargs="?", default="-")
    s.add_argument("--no-seq", action="store_true")
    s.set_defaults(fn=_cmd_fastq2lsam)

    s = sub.add_parser("taxlookup", help="LSAM -> LSAM.id (taxLookupAcc)")
    s.add_argument("acc2tid")
    s.add_argument("nodes")
    s.add_argument("names")
    s.add_argument("lsam", nargs="?", default="-")
    s.set_defaults(fn=_cmd_taxlookup)

    s = sub.add_parser("reassign", help="A-explains-B read reassignment")
    s.add_argument("lsam_id", nargs="?", default="-")
    s.add_argument("-t", dest="threshold", type=float, default=40.0)
    s.add_argument("-u", type=float, default=20.0)
    s.add_argument("-v", type=float, default=0.05)
    s.add_argument("-p", dest="print_seq", action="store_true")
    s.set_defaults(fn=_cmd_reassign)

    s = sub.add_parser("deinterleave", help="cfq -> pe_1/pe_2/se fastq")
    s.add_argument("prefix")
    s.add_argument("cfq", nargs="?", default="-")
    s.set_defaults(fn=_cmd_deinterleave)

    s = sub.add_parser("sam2cfq", help="SAM -> cfq (BWA bridge)")
    s.add_argument("sam", nargs="?", default="-")
    s.add_argument("-d", dest="dropout", type=float, default=0.95)
    s.set_defaults(fn=_cmd_sam2cfq)

    s = sub.add_parser("extract", help="extractFromLSAM: unmapped/viral reads")
    s.add_argument("lsam_id", nargs="?", default="-")
    s.add_argument("-t", dest="threshold", type=float, required=True)
    s.add_argument("-v", dest="viral", action="store_true")
    s.add_argument("-s", dest="se", action="store_true")
    s.add_argument("-i", dest="append_ignore", action="store_true")
    s.add_argument("-g", dest="skip_ignore", action="store_true")
    s.add_argument("-n", dest="names_only", action="store_true")
    s.set_defaults(fn=_cmd_extract)

    s = sub.add_parser("genomecov-filter", help="SPIKE depth-outlier regions")
    s.add_argument("genome")
    s.add_argument("genomecov", nargs="?", default="-")
    s.add_argument("stdev", nargs="?", type=int, default=60)
    s.set_defaults(fn=_cmd_genomecov_filter)

    s = sub.add_parser("lsam-read-filter", help="drop listed reads from LSAM")
    s.add_argument("filter_list")
    s.add_argument("lsam", nargs="?", default="-")
    s.set_defaults(fn=_cmd_lsam_read_filter)

    s = sub.add_parser("m8-to-lsam", help="DIAMOND m8 -> LSAM")
    s.add_argument("m8", nargs="?", default="-")
    s.set_defaults(fn=_cmd_m8_to_lsam)

    s = sub.add_parser("r2c-to-r2g", help="read->contig x contig->genome join")
    s.add_argument("r2c")
    s.add_argument("c2g")
    s.set_defaults(fn=_cmd_r2c_to_r2g)

    s = sub.add_parser("cleanup", help="contaminant homolog species removal")
    s.add_argument("lsam_id", nargs="?", default="-")
    s.add_argument("--taxid", type=int, nargs="+", default=[9606, 32630])
    s.add_argument("--tolerance", type=float, default=10.0)
    s.add_argument("--fraction", type=float, default=0.5)
    s.set_defaults(fn=_cmd_cleanup)

    s = sub.add_parser("bbduk", help="k-mer/quality/entropy preprocessing")
    s.add_argument("--in1", dest="r1", required=True)
    s.add_argument("--in2", dest="r2", required=True)
    s.add_argument("--out1", required=True)
    s.add_argument("--out2", required=True)
    s.add_argument("--outm", default=None)
    s.add_argument("--ref", default=None)
    s.add_argument("--minlength", type=int, default=50)
    s.add_argument("--trimq", type=int, default=10)
    s.add_argument("--entropy", type=float, default=0.75)
    s.set_defaults(fn=_cmd_bbduk)

    s = sub.add_parser("amplicon", help="amplicon (TB) variant pipeline")
    s.add_argument("-1", dest="r1", required=True)
    s.add_argument("-2", dest="r2", required=True)
    s.add_argument("-p", dest="prefix", default="amplicon")
    s.add_argument("--target-index", required=True)
    s.add_argument("--decoy-index", nargs="*", default=None)
    s.add_argument("--taxon-index", default=None)
    s.add_argument("--adapters", default=None)
    s.add_argument("--final-as", type=int, default=150)
    s.add_argument("--min-depth", type=int, default=4)
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=_cmd_amplicon)

    s = sub.add_parser("count-table", help="per-rank uniq/non-uniq counts")
    s.add_argument("nodes")
    s.add_argument("names")
    s.add_argument("lsam_id", nargs="?", default="-")
    s.set_defaults(fn=_cmd_count_table)

    s = sub.add_parser("m8-cov", help="per-subject merged m8 coverage")
    s.add_argument("m8", nargs="?", default="-")
    s.set_defaults(fn=_cmd_m8_cov)

    s = sub.add_parser("maplen-hist", help="per-target mapping-length stats")
    s.add_argument("m8", nargs="?", default="-")
    s.set_defaults(fn=_cmd_maplen_hist)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
