"""The port's amplicon pipeline (``pipeline/amplicon.py``) against the JAX
package's, on the CPU, on ``tests/test_amplicon_pipeline.py``'s world
(6,000 bp TB and human decoy, seed 77): twins of its tests with both
pipelines run in this process on the same reads and their results equal
whole (every counter, every variant with its depth and alt count; VCF
files byte-equal), ``assembly_filter``'s keep mask equal in process (the
unitig assembler's text follows the string hash), the planted-truth VCF
byte-equal to ``tests/fixtures/amplicon_planted.vcf``, and the cases
whose JAX run takes several seconds (the multiallelic and homopolymer
cases and the realistic-error truth set, 23 s on the JAX side) held
against the JAX pipeline's records in
``tests/fixtures/torch_amplicon_records.json``."""

import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.index.fm import build_fm_index as jbuild_fm_index
from megapath_tpu.index.pack import pack_fasta as jpack_fasta
from megapath_tpu.index.pack import pack_reads as jpack_reads
from megapath_tpu.io.fastq import FastqRecord as JRec
from megapath_tpu.pipeline.amplicon import AmpliconConfig as JConfig
from megapath_tpu.pipeline.amplicon import AmpliconPipeline as JPipeline
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, decode_seq, pack_fasta, pack_reads
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.io.vcf import write_vcf
from megapath_tpu_torch.pipeline.amplicon import AmpliconConfig, AmpliconPipeline
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")


def _port_pack(name, codes):
    """The port's (ref, fm) of one sequence, sa_interval 4."""
    ref = pack_fasta([FastqRecord(name, decode_seq(codes), "", "")])
    return ref, build_fm_index(ref.codes, sa_interval=4, lut_k=6, device=CPU)


def _packs(name, codes):
    """(JAX (ref, fm), port (ref, fm)) of one sequence, sa_interval 4."""
    jref = jpack_fasta([JRec(name, decode_seq(codes), "", "")])
    return (jref, jbuild_fm_index(jref.codes, sa_interval=4, lut_k=6)), _port_pack(name, codes)


@pytest.fixture(scope="module")
def world():
    tb, human = cs.amp_world()
    return {"tb": tb, "human": human, "TB": _packs("TB", tb), "chr1": _packs("chr1", human)}


def _pairs(codes, n, rng, read_len=100, ins=300, snp_at=None, tag="p"):
    """``tests/test_amplicon_pipeline.py``'s ``_pairs`` as (name, seq1,
    seq2) rows: the same draws from ``rng``."""
    src = codes.copy()
    if snp_at is not None:
        src[snp_at] = (src[snp_at] + 1) % 4
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(src) - ins))
        if snp_at is not None:
            p = int(rng.integers(max(0, snp_at - ins + read_len + 10),
                                 min(len(src) - ins, snp_at - 10)))
        a = src[p: p + read_len]
        b = COMPLEMENT[src[p + ins - read_len: p + ins][::-1]]
        out.append((f"{tag}{i}", decode_seq(a), decode_seq(b)))
    return out


def _recs(rows, rec):
    q = lambda s: "I" * len(s)  # noqa: E731
    return [rec(n, a, q(a)) for n, a, _ in rows], [rec(n, b, q(b)) for n, _, b in rows]


def _result(res) -> dict:
    return dataclasses.asdict(res)


def _both(world, rows, target="TB", decoys=(), **cfg):
    """``run_records`` of both pipelines on the same pairs; the results
    must be equal. Returns the port's."""
    jpipe = JPipeline(target=world[target][0], decoys=[world[k][0] for k in decoys],
                      config=JConfig(**cfg))
    pipe = AmpliconPipeline(target=world[target][1], decoys=[world[k][1] for k in decoys],
                            config=AmpliconConfig(**cfg), device=CPU)
    want = jpipe.run_records(*_recs(rows, JRec))
    got = pipe.run_records(*_recs(rows, FastqRecord))
    assert _result(got) == _result(want)
    return got


def test_calls_snp_equals_jax(world):
    rng = np.random.default_rng(9)
    tb = world["tb"]
    rows = _pairs(tb, 20, rng, snp_at=3000) + _pairs(world["human"], 5, rng, tag="hum")
    res = _both(world, rows, decoys=("chr1",), final_as=80, min_depth=3)
    assert (res.n_after_qc, res.n_after_decoy, res.n_final) == (25, 20, 20)
    assert any(v.pos == 3000 and v.alt == "ACGT"[(tb[3000] + 1) % 4] for v in res.variants)


def test_no_false_calls_equals_jax(world):
    res = _both(world, _pairs(world["tb"], 15, np.random.default_rng(10)),
                final_as=80, min_depth=3)
    assert res.variants == []


def test_run_files_equals_jax(world, tmp_path):
    rows = _pairs(world["tb"], 16, np.random.default_rng(5), snp_at=2000)
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for name, a, b in rows:
            f1.write(f"@{name}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@{name}\n{b}\n+\n{'I' * len(b)}\n")
    cfg = dict(final_as=80, min_depth=3)
    outs = {}
    for tag, pipe in (("jax", JPipeline(target=world["TB"][0], config=JConfig(**cfg))),
                      ("port", AmpliconPipeline(target=world["TB"][1],
                                                config=AmpliconConfig(**cfg), device=CPU))):
        res = pipe.run_files(str(p1), str(p2), str(tmp_path / tag))
        outs[tag] = (_result(res), (tmp_path / f"{tag}.vcf").read_bytes(),
                     (tmp_path / f"{tag}.done").read_bytes())
        assert pipe.run_files(str(p1), str(p2), str(tmp_path / tag)).n_input == 0
    assert outs["port"] == outs["jax"]
    vcf = outs["port"][1].decode()
    assert vcf.startswith("##fileformat=VCFv4.2\n")
    assert outs["port"][0]["variants"] and "TB\t2001\t" in vcf


def test_assembly_filter_mask_equals_jax(world):
    """Both filters in this process (``assemble_unitigs`` follows the
    string hash): the same keep mask, and the JAX test's bound."""
    tb = world["tb"]
    rng = np.random.default_rng(12)
    rows = []
    for i in range(30):
        p = int(rng.integers(1000, 2500 - 300))
        rows.append((f"p{i}", decode_seq(tb[p: p + 100]),
                     decode_seq(COMPLEMENT[tb[p + 200: p + 300][::-1]])))
    masks = {}
    for tag, pipe, rec, pack in (
            ("jax", JPipeline(target=world["TB"][0], config=JConfig()), JRec, jpack_reads),
            ("port", AmpliconPipeline(target=world["TB"][1], config=AmpliconConfig(),
                                      device=CPU), FastqRecord, pack_reads)):
        r1, r2 = _recs(rows, rec)
        reads1, lens1 = pack([r.seq for r in r1], 512)
        reads2, lens2 = pack([r.seq for r in r2], 512)
        masks[tag] = pipe.assembly_filter(r1, r2, reads1, lens1, reads2, lens2,
                                          regions=[(1000, 2500)])
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    assert masks["port"].sum() >= 25


def test_planted_truth_vcf_equals_golden(world):
    """``test_variant_caller_planted_truth_recall_precision``'s reads
    (``chip_smoke.amp_planted_pairs``) through the port: recall = precision
    = 1 and the VCF byte-equal to the golden the JAX pipeline is pinned to."""
    rows = [(n, a, b) for n, a, _, b, _ in cs.amp_planted_pairs(world["tb"])]
    pipe = AmpliconPipeline(target=world["TB"][1], config=AmpliconConfig(final_as=80,
                                                                         min_depth=4),
                            device=CPU)
    res = pipe.run_records(*_recs(rows, FastqRecord))
    buf = io.StringIO()
    write_vcf(res.variants, buf, contigs=[("TB", 6000)])
    assert buf.getvalue() == (FIX / "amplicon_planted.vcf").read_text()


MA_AT, DEL_AT, NEAR_AT, RUN_AT = 1200, 2000, 2010, 3000


def multiallelic_rows(tb):
    """``test_multiallelic_and_low_af_near_indel``'s pairs: two SNP
    alleles at MA_AT, a 3 bp deletion at DEL_AT with a SNP at NEAR_AT on
    the same allele, and the wild type (seed 31)."""
    rng = np.random.default_rng(31)

    def with_snp(codes, pos, delta):
        out = codes.copy()
        out[pos] = (out[pos] + delta) % 4
        return out

    al3 = np.concatenate([tb[:DEL_AT], tb[DEL_AT + 3:]])
    al3[NEAR_AT - 3] = (al3[NEAR_AT - 3] + 1) % 4
    rows = []
    for tag, src, n in (("m1", with_snp(tb, MA_AT, 1), 300), ("m2", with_snp(tb, MA_AT, 2), 300),
                        ("lo", al3, 250), ("wt", tb, 150)):
        rows += _pairs(src, n, rng, tag=tag)
    return rows


def homopolymer_case(tb):
    """``test_homopolymer_indel``'s target (``tb`` with an 8 bp A run at
    RUN_AT) and pairs: half from the run shortened by one (seed 41)."""
    rng = np.random.default_rng(41)
    tb = tb.copy()
    tb[RUN_AT: RUN_AT + 8] = 0
    hp = np.concatenate([tb[: RUN_AT + 7], tb[RUN_AT + 8:]])
    return tb, _pairs(hp, 450, rng, tag="hp") + _pairs(tb, 450, rng, tag="wt")


def _port_equals_record(key, target, rows, **cfg):
    """``run_records`` of the port on ``rows``; every counter and variant
    equal to the JAX pipeline's record under ``key`` (the JAX run takes
    several seconds, so ``make_torch_amplicon_records.py`` records it).
    Returns the port's result."""
    want = json.loads((FIX / "torch_amplicon_records.json").read_text())[key]
    assert cs.pairs_digest(rows) == want["input_sha256"]
    pipe = AmpliconPipeline(target=target, config=AmpliconConfig(**cfg), device=CPU)
    res = pipe.run_records(*_recs(rows, FastqRecord))
    assert json.loads(json.dumps(_result(res))) == want["result"]
    return res


def test_multiallelic_and_low_af_near_indel_equals_jax(world):
    tb = world["tb"]
    res = _port_equals_record("multiallelic", world["TB"][1], multiallelic_rows(tb),
                              final_as=80, min_depth=4)
    want = {
        (MA_AT, "ACGT"[tb[MA_AT]], "ACGT"[(tb[MA_AT] + 1) % 4]),
        (MA_AT, "ACGT"[tb[MA_AT]], "ACGT"[(tb[MA_AT] + 2) % 4]),
        (DEL_AT - 1, decode_seq(tb[DEL_AT - 1: DEL_AT + 3]), "ACGT"[tb[DEL_AT - 1]]),
        (NEAR_AT, "ACGT"[tb[NEAR_AT]], "ACGT"[(tb[NEAR_AT] + 1) % 4]),
    }
    assert {(v.pos, v.ref, v.alt) for v in res.variants} == want


def test_homopolymer_indel_equals_jax(world):
    tb, rows = homopolymer_case(world["tb"])
    res = _port_equals_record("homopolymer", _port_pack("TB", tb), rows,
                              final_as=80, min_depth=4)
    dels = [v for v in res.variants
            if len(v.ref) == 2 and len(v.alt) == 1 and RUN_AT - 2 <= v.pos <= RUN_AT + 8]
    assert len(dels) == 1 and set(dels[0].ref[1:]) == {"A"}
    assert 0.3 < dels[0].alt_count / dels[0].depth < 0.7


def error_truth_set(tb):
    """``test_variant_caller_realistic_error_truth_set``'s inputs: 900
    pairs of each allele (2 x 100 bp, insert 300, 0.5% substitutions,
    seed 77) and its truth (position, ref, alt): 12 SNPs, deletions and
    insertions of 1-10 bp at 600 + 430 k, hom and het."""
    rng = np.random.default_rng(77)
    vrng = np.random.default_rng(9)
    specs, pos = [], 600
    for k, h in zip(["snp", "snp", "del", "ins"] * 3, [False, True, False, True, True, False] * 2):
        specs.append((pos, k, 1 if k == "snp" else int(vrng.integers(1, 11)), h))
        pos += 430

    def apply(codes, use_het):
        out = list(codes)
        for p, k, size, het in sorted(specs, key=lambda s: -s[0]):
            if het and not use_het:
                continue
            if k == "snp":
                out[p] = (out[p] + 1) % 4
            elif k == "del":
                del out[p: p + size]
            else:
                out[p + 1: p + 1] = [(codes[p] + 1 + j) % 4 for j in range(size)]
        return np.array(out, np.uint8)

    def noisy(src, n, tag):
        rows = []
        for i in range(n):
            p = int(rng.integers(0, len(src) - 300))
            a = src[p: p + 100].copy()
            b = COMPLEMENT[src[p + 200: p + 300][::-1]].copy()
            for arr in (a, b):
                for _ in range(int(rng.binomial(100, 0.005))):
                    q = int(rng.integers(0, 100))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            rows.append((f"{tag}{i}", decode_seq(a), decode_seq(b)))
        return rows

    rows_a = noisy(apply(tb, False), 900, "a")
    rows_b = noisy(apply(tb, True), 900, "b")
    truth = []
    for p, k, size, _ in specs:
        if k == "snp":
            truth.append((p, "ACGT"[tb[p]], "ACGT"[(tb[p] + 1) % 4], False))
        elif k == "del":
            truth.append((p - 1, decode_seq(tb[p - 1: p + size]), "ACGT"[tb[p - 1]], False))
        else:
            ins = "".join("ACGT"[(tb[p] + 1 + j) % 4] for j in range(size))
            truth.append((p, "ACGT"[tb[p]], "ACGT"[tb[p]] + ins, False))
    return rows_a + rows_b, truth


def test_realistic_error_truth_set_equals_record(world):
    """The port on the realistic-error truth set: every counter and variant
    equal to the JAX pipeline's record, and the JAX test's bars (recall >=
    0.9, at most one false positive) on the port's calls."""
    rows, truth = error_truth_set(world["tb"])
    res = _port_equals_record("error_truth_set", world["TB"][1], rows, final_as=80,
                              min_depth=4)
    buf = io.StringIO()
    write_vcf(res.variants, buf, contigs=[("TB", 6000)])
    score = cs.amp_truth_score(buf.getvalue(), truth, world["tb"])
    assert score["recall"] >= 0.9 and score["false_positives"] <= 1, score
