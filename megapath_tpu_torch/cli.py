"""Command-line interface of the PyTorch port (the runMegaPath.sh equivalent).

The port of ``megapath_tpu/cli.py``, with the same flags, plus
``--device`` on ``build-index`` and ``run`` (default ``cuda``; without a
card the command raises unless ``--device cpu`` is given, it never runs
on the CPU by itself):

  build-index   FASTA -> shards -> suffix array and FM tables built on the
                device -> ``shardN.ref.npz``/``shardN.fm.npz`` in the JAX
                package's format (either package loads the other's)
  run           gzip FASTQ (C++ reader) -> bbduk -> human filter ->
                (ribosome filter) -> NT shards -> SPIKE -> reassign ->
                Kraken reports; ``-b`` adds the per-shard BAMs and the
                merged, sorted PREFIX.nt.bam
  report        LSAM.id -> Kraken-style report (genKrakenReport)

Stream tools (the reference's cc/ toolchain): fastq2lsam, taxlookup,
reassign, deinterleave, lsam-read-filter.

``run`` parses and then refuses, with NotImplementedError naming the
ROADMAP item, what the port has not ported: ``-A/--assembly``,
``--megahit-bin`` and ``--protein-db`` (A9), ``--devices`` and ``--spmd``
(A10). The JAX CLI's other subcommands (build-db, sam2cfq, extract,
genomecov-filter, m8-to-lsam, r2c-to-r2g, cleanup, bbduk, amplicon,
count-table, m8-cov, maplen-hist) are still to port (ROADMAP A8).
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


def _cmd_run(args) -> int:
    if args.assembly or args.megahit_bin is not None or args.protein_db is not None:
        raise NotImplementedError(
            "run -A/--assembly, --megahit-bin, --protein-db: assembly and the "
            "protein remap are ROADMAP A9"
        )
    if args.devices:
        raise NotImplementedError(
            "run --devices: multi-device shard placement is ROADMAP A10; the port "
            "runs every engine on --device"
        )
    if args.spmd:
        raise NotImplementedError("run --spmd: the one-program SPMD backend is ROADMAP A10")
    from megapath_tpu_torch.filters.bbduk import build_kmer_ref, load_adapters
    from megapath_tpu_torch.pipeline import MegaPathPipeline, PipelineConfig

    dev = _device(args.device)
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
    )
    pipe = MegaPathPipeline(
        nt_shards, db, hg_shard=hg, adapters=adapters, config=cfg,
        ribo_shard=ribo, device=dev,
    )
    res = pipe.run_files(args.r1, args.r2, args.prefix)
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


def _cmd_lsam_read_filter(args) -> int:
    from megapath_tpu_torch.io.lsam import lsam_read_filter

    with open(args.filter_list) as f:
        ids = [l.strip() for l in f if l.strip()]
    for line in lsam_read_filter(ids, _in(args.lsam)):
        sys.stdout.write(line if line.endswith("\n") else line + "\n")
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
                   help="assembly + protein remap stage (ROADMAP A9: refused)")
    r.add_argument("--megahit-bin", default=None, help="ROADMAP A9: refused")
    r.add_argument("--protein-db", default=None,
                   help="protein FASTA for the stage-4.1 blastx (ROADMAP A9: refused)")
    r.add_argument("--devices", type=int, default=0,
                   help="distribute NT shard engines over N devices "
                        "(ROADMAP A10: refused unless 0)")
    r.add_argument("--batch-size", type=int, default=500_000,
                   help="streaming read-pair batch size (SOAP4.cpp:206)")
    r.add_argument("-b", "--bam", action="store_true",
                   help="emit per-shard BAMs + merged/sorted "
                        "PREFIX.nt.bam (soap4 -b -o + samtools, "
                        "runMegaPath.sh:199-216)")
    r.add_argument("--spmd", action="store_true",
                   help="the one-program SPMD backend (ROADMAP A10: refused)")
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

    s = sub.add_parser("lsam-read-filter", help="drop listed reads from LSAM")
    s.add_argument("filter_list")
    s.add_argument("lsam", nargs="?", default="-")
    s.set_defaults(fn=_cmd_lsam_read_filter)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
