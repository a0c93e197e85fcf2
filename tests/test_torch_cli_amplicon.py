"""The port's ``amplicon`` subcommand against the JAX CLI's, on the CPU:
``build-index`` then ``amplicon`` through both command lines (``--device
cpu`` on the port) on files of ``tests/test_amplicon_pipeline.py``'s world,
with a decoy and a taxon index: the VCF, the ``.done`` marker, stdout and
stderr byte-equal, and a second run skipped by its ``.done``; ``chip_smoke.py``
phase 16's world part through the port equal to the JAX CLI's record
(``tests/fixtures/torch_amplicon_records.json``) and to
``amplicon_planted.vcf``; the record's inputs; and ``--device cuda``
without a card refused."""

import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu import cli as jcli
from megapath_tpu_torch import cli
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
MAINS = (("jax", jcli.main, ()), ("port", cli.main, ("--device", "cpu")))


@pytest.fixture(scope="module")
def want():
    return json.loads((FIX / "torch_amplicon_records.json").read_text())


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The world's FASTAs (``chip_smoke.write_amp_world_files``) with 20
    pairs over a SNP at 3,000 and 5 human pairs (seed 9) as plain FASTQ."""
    d = tmp_path_factory.mktemp("amp")
    cs.write_amp_world_files(d)
    tb, human = cs.amp_world()
    rng = np.random.default_rng(9)
    src = tb.copy()
    src[3000] = (src[3000] + 1) % 4
    rows = []
    for i in range(20):
        p = int(rng.integers(3000 - 300 + 110, 3000 - 10))
        rows.append((f"p{i}", src[p: p + 100], cs._COMP[src[p + 200: p + 300][::-1]]))
    for i in range(5):
        p = int(rng.integers(0, 6000 - 300))
        rows.append((f"hum{i}", human[p: p + 100], cs._COMP[human[p + 200: p + 300][::-1]]))
    with open(d / "s1.fq", "w") as f1, open(d / "s2.fq", "w") as f2:
        for name, a, b in rows:
            f1.write(f"@{name}/1\n{cs._text(a)}\n+\n{'I' * 100}\n")
            f2.write(f"@{name}/2\n{cs._text(b)}\n+\n{'I' * 100}\n")
    return d


def _argv(d, prefix, *flags):
    return ["amplicon", "-1", str(d / "s1.fq"), "-2", str(d / "s2.fq"), "-p", str(prefix),
            "--target-index", str(d / "tb" / "shard0"), "--decoy-index",
            str(d / "human" / "shard0"), "--taxon-index", str(d / "taxon" / "shard0"), *flags]


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    out = capsys.readouterr()
    return out.out, out.err


@pytest.mark.parametrize("flags", [("--final-as", "80", "--min-depth", "3"), ()])
def test_amplicon_equals_jax_cli(small, tmp_path, capsys, flags):
    """Each CLI builds its own indexes and runs ``amplicon``; everything
    either writes is equal, byte for byte; a rerun is skipped."""
    outs = {}
    for tag, main, extra in MAINS:
        d = tmp_path / tag
        for k in ("tb", "human", "taxon"):
            (d / k).mkdir(parents=True)
            assert main(["build-index", str(small / f"{k}.fa"), str(d / k / k),
                         *cs.WORLD_INDEX_ARGS, *extra]) == 0
        for k in ("s1.fq", "s2.fq"):
            (d / k).write_bytes((small / k).read_bytes())
        run = _run(main, [*_argv(d, d / "amp", *flags), *extra], capsys)
        rerun = _run(main, [*_argv(d, d / "amp", *flags), *extra], capsys)
        outs[tag] = (run[0], run[1].replace(str(d), "D"), rerun[1].replace(str(d), "D"),
                     (d / "amp.vcf").read_bytes(), (d / "amp.done").read_bytes())
    assert outs["port"] == outs["jax"]
    out, err, again, vcf, done = outs["port"]
    assert done == b"ok\n" and again.startswith("Skipping: D/amp.done exists\n")
    assert "[amplicon] in=25 qc=25 decoy=20 taxon=20 final=" in err
    assert (b"TB\t3001\t" in vcf) == bool(flags), vcf


def test_world_part_equals_record(want, tmp_path, capsys):
    """Phase 16's world part through the port's CLI on the CPU: the VCF,
    ``.done`` and stderr line of the JAX CLI's record, the VCF the golden."""
    cs.write_amp_world_files(tmp_path)
    for argv in cs.amp_world_build_argvs(tmp_path):
        assert cli.main([*argv, "--device", "cpu"]) == 0
    _, err = _run(cli.main, [*cs.amp_world_argv(tmp_path, str(tmp_path / "world")),
                             "--device", "cpu"], capsys)
    got = cs.amp_record(str(tmp_path / "world"), err)
    assert got == want["world"]
    assert got["vcf"] == (FIX / "amplicon_planted.vcf").read_text()


def test_records_inputs_and_truth(want):
    """The record's inputs are what ``chip_smoke`` draws; its realistic
    VCF meets the planted truth as ``amp_truth_score`` counts it."""
    work = cs.amp_realistic_workload()
    assert cs.amp_digests(work) == {k: want[k] for k in ("world_input_sha256",
                                                          "realistic_input_sha256")}
    score = cs.amp_truth_score(want["realistic"]["vcf"], work["truth"], work["target"])
    assert json.loads(json.dumps(score)) == want["realistic"]["truth"]
    assert len(work["pairs"]) == cs.AMP_PAIRS + cs.AMP_DECOY_PAIRS
    assert len(work["truth"]) == cs.AMP_VARIANTS and sum(t[3] for t in work["truth"]) == 12


def test_amplicon_on_cuda_without_a_card_raises(small, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_argv(small, tmp_path / "amp"))
    assert not (tmp_path / "amp.vcf").exists()
