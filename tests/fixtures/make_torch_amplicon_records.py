#!/usr/bin/env python
"""Write the JAX package's record of the amplicon pipeline's larger inputs
(``chip_smoke.py`` phase 16 and the realistic-error truth set).

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_amplicon_records.py

Runs the reference ``megapath_tpu`` on the CPU and writes
``torch_amplicon_records.json``:

- ``error_truth_set``, ``multiallelic`` and ``homopolymer``:
  ``tests/test_amplicon_pipeline.py``'s realistic-error truth set, its
  multiallelic case and its homopolymer case (``test_torch_amplicon_
  pipeline.error_truth_set``, ``multiallelic_rows``, ``homopolymer_case``)
  through ``AmpliconPipeline.run_records``: every counter and variant of
  each result, and the sha256 of its pairs;
- ``world``: the JAX CLI over the files of ``chip_smoke.
  write_amp_world_files``: ``build-index`` of TB, the human decoy and the
  taxon FASTA, then ``amplicon`` with ``--decoy-index`` and
  ``--taxon-index`` (``chip_smoke.amp_world_argv``); the VCF must equal
  ``amplicon_planted.vcf``;
- ``realistic``: the JAX CLI over ``chip_smoke.write_amp_realistic_files``
  (the 4,411,532 bp target with 16 amplicons and 24 planted variants, the
  32 Mbp decoy, 18,000 pairs): ``build-index`` of both, then ``amplicon``
  with the decoy (``chip_smoke.amp_realistic_argv``), with its recall and
  false positives against the planted truth (``chip_smoke.amp_truth_score``);

each CLI run as its VCF text, ``.done`` and ``[amplicon]`` stderr line
(``chip_smoke.amp_record``), beside the sha256 of both parts' pairs.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
FIX = ROOT / "tests" / "fixtures"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from megapath_tpu.cli import main as jax_cli  # noqa: E402
from megapath_tpu.index.fm import build_fm_index  # noqa: E402
from megapath_tpu.index.pack import pack_fasta  # noqa: E402
from megapath_tpu.io.fastq import FastqRecord  # noqa: E402
from megapath_tpu.pipeline.amplicon import AmpliconConfig, AmpliconPipeline  # noqa: E402
from test_torch_amplicon_pipeline import (  # noqa: E402
    error_truth_set,
    homopolymer_case,
    multiallelic_rows,
)

OUT = FIX / "torch_amplicon_records.json"


def run(argv, prefix) -> dict:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = jax_cli([str(a) for a in argv])
    if rc != 0:
        raise SystemExit(f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    return cs.amp_record(str(prefix), err.getvalue())


def main() -> None:
    t = time.time()
    work = cs.amp_realistic_workload()
    rec = {"workload": "error_truth_set, multiallelic, homopolymer: test_torch_amplicon_pipeline"
                       ".error_truth_set, multiallelic_rows, homopolymer_case through "
                       "run_records; world: write_amp_world_files, build-index, amplicon "
                       "(amp_world_argv); realistic: write_amp_realistic_files, build-index, "
                       "amplicon (amp_realistic_argv)",
           **cs.amp_digests(work)}
    tb, _ = cs.amp_world()
    hp_tb, hp_rows = homopolymer_case(tb)
    for key, target, rows in (("error_truth_set", tb, error_truth_set(tb)[0]),
                              ("multiallelic", tb, multiallelic_rows(tb)),
                              ("homopolymer", hp_tb, hp_rows)):
        ref = pack_fasta([FastqRecord("TB", cs._text(target), "", "")])
        pipe = AmpliconPipeline(target=(ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6)),
                                config=AmpliconConfig(final_as=80, min_depth=4))
        res = pipe.run_records([FastqRecord(n, a, "I" * len(a)) for n, a, _ in rows],
                               [FastqRecord(n, b, "I" * len(b)) for n, _, b in rows])
        rec[key] = {"input_sha256": cs.pairs_digest(rows),
                    "result": json.loads(json.dumps(dataclasses.asdict(res)))}
        print(f"{key}: {time.time() - t:.1f} s, {len(res.variants)} variants", file=sys.stderr)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cs.write_amp_world_files(d)
        for argv in cs.amp_world_build_argvs(d):
            if jax_cli(argv) != 0:
                raise SystemExit(f"{argv} exited non-zero")
        rec["world"] = run(cs.amp_world_argv(d, d / "world"), d / "world")
        if rec["world"]["vcf"] != (FIX / "amplicon_planted.vcf").read_text():
            raise SystemExit("world: the VCF differs from amplicon_planted.vcf")
        print(f"world: {time.time() - t:.1f} s {rec['world']['stderr']}", file=sys.stderr)
        cs.write_amp_realistic_files(work, d)
        for argv in cs.amp_realistic_build_argvs(d):
            t1 = time.time()
            if jax_cli(argv) != 0:
                raise SystemExit(f"{argv} exited non-zero")
            print(f"{argv[1]}: {time.time() - t1:.1f} s", file=sys.stderr)
        t1 = time.time()
        rec["realistic"] = run(cs.amp_realistic_argv(d, d / "real"), d / "real")
        rec["realistic"]["truth"] = cs.amp_truth_score(rec["realistic"]["vcf"], work["truth"],
                                                       work["target"])
        print(f"realistic amplicon: {time.time() - t1:.1f} s {rec['realistic']['stderr']} "
              f"{rec['realistic']['truth']}", file=sys.stderr)
    OUT.write_text(json.dumps(rec, indent=1) + "\n")
    print(f"amplicon records: {time.time() - t:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
