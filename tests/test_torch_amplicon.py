"""The port's amplicon modules against the JAX package's, on the CPU, at
tolerance 0: ``amplicon/debruijn.py`` and ``amplicon/realign.py`` on the
inputs of ``tests/test_amplicon.py`` (haplotypes, ``realign_window``'s
scores, best haplotypes, positions and CIGARs) and of
``tests/test_amplicon_parity.py``'s four planted windows
(``realign_reads_window``: SNP, deletion, insertion, two haplotypes and a
junk read), ``realign_windows_batched``, ``io/vcf.py``; and the DNA DP's
dispatch (``ops.dp.sw_align_dna``): on the CPU it equals the JAX
``sw_align`` at ``SSW_PARAMS`` with spans of 250-300 and windows up to
1,040 rows, and the plain ``sw_align_substmat`` under ``dna_table``, what
the ``sw_subst.cu`` kernel computes on a card, equals the plain
``sw_align`` (the B8 contract)."""

import io

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.amplicon import candidate_haplotypes as jcandidate_haplotypes
from megapath_tpu.amplicon import realign as jrealign
from megapath_tpu.io import vcf as jvcf
from megapath_tpu.ops.dp import sw_align as jsw_align
from megapath_tpu.pipeline.amplicon import Variant as JVariant
from megapath_tpu_torch.amplicon import candidate_haplotypes, realign
from megapath_tpu_torch.amplicon.debruijn import DeBruijnGraph
from megapath_tpu_torch.io import vcf
from megapath_tpu_torch.ops import dp as dp_mod
from megapath_tpu_torch.ops.dp import (
    OFF_TEXT_CODE,
    check_dna_codes,
    dna_table,
    sw_align,
    sw_align_dna,
    sw_align_substmat,
)
from megapath_tpu_torch.pipeline.amplicon import Variant
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
SSW = realign.SSW_PARAMS
FIELDS = ("score", "end_ref", "end_read")


def _rand_seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _window_equal(got, want):
    assert got.haplotypes == want.haplotypes
    for f in ("best_hap", "scores", "read_pos"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
        assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype, f
    assert got.cigars == want.cigars


# ---------------------------------------------------------------------------
# twins of tests/test_amplicon.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["reference", "snp", "deletion", "singleton_error"])
def test_dbg_haplotypes_equal_jax(case):
    """``test_dbg_recovers_reference``, ``test_dbg_recovers_snp_haplotype``,
    ``test_dbg_recovers_deletion_haplotype`` and
    ``test_dbg_prune_drops_singleton_errors``: the same candidate lists,
    in the same order, and the JAX tests' checks."""
    if case == "reference":
        ref = _rand_seq(120, 0)
        alt, reads, kw = ref, [], {}
    elif case == "snp":
        ref = _rand_seq(150, 1)
        alt = ref[:75] + ("A" if ref[75] != "A" else "C") + ref[76:]
        reads, kw = [alt[i: i + 50] for i in range(40, 90, 3)], {"min_edge_weight": 2}
    elif case == "deletion":
        ref = _rand_seq(160, 2)
        alt = ref[:80] + ref[85:]
        reads, kw = [alt[i: i + 50] for i in range(40, 100, 4)], {}
    else:
        ref = _rand_seq(150, 3)
        alt = ref[:60] + "T" + ref[61:]
        reads, kw = [alt[40:90]], {"min_edge_weight": 2}
    haps = candidate_haplotypes(ref, reads, k=15, **kw)
    assert haps == jcandidate_haplotypes(ref, reads, k=15, **kw)
    assert (alt in haps) == (case != "singleton_error")
    assert case == "deletion" or ref in haps


def test_dbg_graph_equals_jax():
    from megapath_tpu.amplicon.debruijn import DeBruijnGraph as JGraph

    ref = _rand_seq(140, 11)
    reads = [ref[i: i + 40] for i in range(0, 100, 7)] + [ref[30:70].replace("A", "C", 2)] * 3
    got, want = DeBruijnGraph(k=13), JGraph(k=13)
    for g in (got, want):
        g.add_seq(ref, is_ref=True)
        for r in reads:
            g.add_seq(r)
        g.prune(2)
    assert (got.edges, got.ref_edges, got.source, got.sink) == (
        want.edges, want.ref_edges, want.source, want.sink)
    assert got.haplotypes(max_paths=16) == want.haplotypes(max_paths=16)


def test_realign_window_prefers_alt_haplotype():
    ref = _rand_seq(200, 4)
    alt = ref[:100] + ref[103:]
    reads = [alt[i: i + 60] for i in range(60, 130, 5)]
    out = realign.realign_window(ref, reads, k=15, device=CPU)
    _window_equal(out, jrealign.realign_window(ref, reads, k=15))
    alt_idx = out.haplotypes.index(alt)
    assert (out.best_hap == alt_idx).mean() > 0.7
    assert (out.read_pos[out.best_hap == alt_idx] >= 0).all()


def test_realign_reads_matching_ref():
    ref = _rand_seq(200, 5)
    reads = [ref[i: i + 60] for i in range(20, 120, 10)]
    out = realign.realign_window(ref, reads, k=15, device=CPU)
    _window_equal(out, jrealign.realign_window(ref, reads, k=15))
    assert (out.best_hap == out.haplotypes.index(ref)).all()
    np.testing.assert_array_equal(out.read_pos, np.arange(20, 120, 10))


def test_realign_window_without_cigars_and_without_reads():
    ref = _rand_seq(180, 6)
    alt = ref[:90] + "G" + ref[90:]
    reads = [alt[i: i + 70] for i in range(0, 110, 9)]
    _window_equal(realign.realign_window(ref, reads, k=15, compute_cigars=False, device=CPU),
                  jrealign.realign_window(ref, reads, k=15, compute_cigars=False))
    _window_equal(realign.realign_window(ref, [], k=15, device=CPU),
                  jrealign.realign_window(ref, [], k=15))


def test_update_vcf_af():
    """``tests/test_amplicon.py::test_update_vcf_af`` on both packages."""
    for a in ((100, {"T": 30}, "A", "T"), (100, {"IAC": 10}, "A", "AAC"),
              (100, {"DGG": 5}, "AGG", "A"), (100, {"C": 3}, "A", "T"), (0, {"T": 3}, "A", "T")):
        assert vcf.find_af(*a) == jvcf.find_af(*a)
    assert vcf.find_af(100, {"T": 30}, "A", "T") == 0.3
    rows = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        "chr1\t10\t.\tA\tT\t30\tPASS\t.\tGT:GQ:DP:AF\t1/1:20:50:0.5000",
        "chr1\t99\t.\tC\tG\t30\tPASS\t.\tGT:GQ:DP:AF\t0/1:20:50:0.2000",
        "chr1\t120\t.\tC\tCTT\t30\tPASS\t.\tGT\t0/1",
        "chr1\t130\t.\tC\tG\t30\tPASS\t.\tGT\t0/1",
        "",
    ]
    table = {("chr1", 10): (80, {"T": 40}), ("chr1", 120): (40, {"ITT": 10}),
             ("chr1", 130): (40, {"A": 10})}
    out = vcf.update_vcf_af(rows, table)
    assert out == jvcf.update_vcf_af(rows, table)
    assert out[2].endswith("1/1:20:80:0.5000") and out[3] == rows[3]
    assert out[4].endswith("\t0/1\t40:0.2500")


def test_vcf_writer_equals_jax():
    """``tests/test_cli.py::test_vcf_writer`` on both packages, with hom,
    het and zero-depth rows and without contigs."""
    fields = [("chr1 desc", 9, "A", "T", 20, 19), ("chr1", 40, "G", "GAC", 30, 12),
              ("chr2", 3, "TTA", "T", 0, 0)]
    for contigs in ([("chr1", 1000), ("chr2", 50)], None):
        got, want = io.StringIO(), io.StringIO()
        vcf.write_vcf([Variant(*f) for f in fields], got, contigs=contigs)
        jvcf.write_vcf([JVariant(*f) for f in fields], want, contigs=contigs)
        assert got.getvalue() == want.getvalue()
    assert "chr1\t10\t.\tA\tT\t95\tPASS\tDP=20;AC=19\tGT:AD\t1/1:1,19" in got.getvalue()


# ---------------------------------------------------------------------------
# realign_reads_window on tests/test_amplicon_parity.py's planted windows
# ---------------------------------------------------------------------------
def _mkseq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _parity_window(case):
    """(reads, positions, cigars, reference, haplotypes, ref_start,
    ref_prefix, ref_suffix) of one of ``tests/test_amplicon_parity.py``'s
    windows."""
    rng = np.random.default_rng({"snp": 31, "deletion": 32, "insertion": 33, "multi": 34}[case])
    n_center = 160 if case == "multi" else 200
    prefix, center, suffix = _mkseq(rng, 20), _mkseq(rng, n_center), _mkseq(rng, 20)
    reference = prefix + center + suffix
    if case == "snp":
        var = list(center)
        var[100] = "ACGT"[("ACGT".index(var[100]) + 1) % 4]
        hap = prefix + "".join(var) + suffix
        offs, n, start = (0, 30, 60, 90, 120, 150), 80, 1000
    elif case == "deletion":
        hap = prefix + center[:100] + center[103:] + suffix
        offs, n, start = (0, 40, 60, 90, 130, 150), 70, 500
    elif case == "insertion":
        hap = prefix + center[:100] + "GTCA" + center[100:] + suffix
        offs, n, start = (0, 50, 80, 120, 160), 70, 0
    else:
        v1 = list(center)
        v1[60] = "ACGT"[("ACGT".index(v1[60]) + 1) % 4]
        hap1 = prefix + "".join(v1) + suffix
        hap2 = prefix + center[:80] + center[82:] + suffix
        reads = [hap1[30:100], hap2[40:110], _mkseq(rng, 70)]
        return (reads, [30, 40, 50], ["70M"] * 3, reference, [hap1, hap2], 0, len(prefix),
                len(suffix))
    reads = [hap[o: o + n] for o in offs]
    return (reads, [start + o for o in offs], [f"{n}M"] * len(offs), reference, [hap], start,
            len(prefix), len(suffix))


@pytest.mark.parametrize("case", ["snp", "deletion", "insertion", "multi"])
def test_realign_reads_window_equals_jax(case):
    args = _parity_window(case)
    got = realign.realign_reads_window(*args, device=CPU)
    assert got == jrealign.realign_reads_window(*args)
    if case == "snp":
        assert got[0][0] == 1000
    if case == "deletion":
        assert got[0][5] == 500 + 150 + 3


def test_realign_windows_batched_equals_jax():
    """Four windows (SNP, deletion, insertion, none) and one without reads
    in one batch: each window's haplotypes, scores and best haplotypes."""
    jobs = []
    for seed, edit in ((40, "snp"), (41, "del"), (42, "ins"), (43, None)):
        ref = _rand_seq(230, seed)
        alt = {"snp": ref[:115] + ("A" if ref[115] != "A" else "T") + ref[116:],
               "del": ref[:100] + ref[106:], "ins": ref[:120] + "TTGCA" + ref[120:],
               None: ref}[edit]
        jobs.append((ref, [alt[i: i + 90] for i in range(0, len(alt) - 90, 8)]
                     + [ref[i: i + 90] for i in range(5, 120, 30)]))
    jobs.append((_rand_seq(150, 44), []))
    got = realign.realign_windows_batched(jobs, k=15, device=CPU)
    want = jrealign.realign_windows_batched(jobs, k=15)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _window_equal(g, w)
    assert sum(len(g.haplotypes) > 1 for g in got) >= 3


# ---------------------------------------------------------------------------
# the DNA DP (B8)
# ---------------------------------------------------------------------------
def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,R,W,seed", [(12, 300, 300, 1), (8, 300, 620, 2), (6, 300, 1040, 3)])
def test_sw_align_dna_equals_jax_sw_align(B, R, W, seed):
    """Spans of 250-300 (best scores past the int16 kernel's 1,023 at
    match 4) and windows across the kernel's 512-row tile."""
    batch = cs.dna_batch(np.random.default_rng(seed), B, R, W)
    got = sw_align_dna(*_t(*batch), SSW)
    want = jsw_align(*batch, params=SSW)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.score.max()) > 1023


@pytest.mark.parametrize("seed,B,R,W,params", [
    (4, 24, 300, 300, SSW), (5, 16, 150, 520, SSW), (6, 40, 64, 96, SSW),
    (7, 16, 120, 200, realign.DPParams(1, -2, -3, -1)),
    (8, 16, 120, 200, realign.DPParams(2, -3, -1, -4)),
])
def test_substmat_under_dna_table_equals_sw_align(seed, B, R, W, params):
    """The B8 contract on the CPU: the plain ``sw_align_substmat`` under
    ``dna_table(params)`` (what ``sw_subst.cu`` computes on a card) equals
    the plain ``sw_align`` on all three outputs, also on OFF_TEXT_CODE
    windows, lengths 0 and 1, ties of repeated text and gap_open above
    gap_extend."""
    rng = np.random.default_rng(seed)
    reads, refs, rl, wl = cs.dna_batch(rng, B, R, W, span=(min(R, 40), R))
    refs[-4:] = np.tile(reads[-4:, :8], W // 8 + 1)[:, :W]  # repeats: equal scores
    t = _t(reads, refs, rl, wl)
    got = sw_align_substmat(*t, dna_table(params), params)
    want = sw_align(*t, params)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0)


def test_dna_table():
    tab = dna_table(SSW)
    assert tab.dtype == torch.int32 and tab.shape == (OFF_TEXT_CODE + 1,) * 2
    assert (tab.diagonal() == 4).all() and int((tab == -6).sum()) == 20
    cached = dp_mod._dna_table_on(SSW, CPU)  # what sw_align_dna uploads once
    assert cached is dp_mod._dna_table_on(SSW, CPU) and torch.equal(cached, tab)


def test_dna_dp_hands_its_host_arrays_largest_code(monkeypatch):
    """``dna_dp`` reads the largest code of its host arrays and passes it to
    ``sw_align_dna`` (whose check on a card then needs no read-back); its
    outputs are the plain ``sw_align``'s."""
    reads, refs, rl, wl = cs.dna_batch(np.random.default_rng(8), 6, 40, 90, span=(30, 40))
    refs[1, 70:] = OFF_TEXT_CODE
    seen = []
    monkeypatch.setattr(realign, "sw_align_dna",
                        lambda *a, **k: seen.append(k) or sw_align_dna(*a, **k))
    got = realign.dna_dp(reads, refs, rl, wl, SSW, device=CPU)
    assert seen == [{"max_code": OFF_TEXT_CODE}]
    want = sw_align(*_t(reads, refs, rl, wl), SSW)
    for g, f in zip(got, FIELDS):
        np.testing.assert_array_equal(g, getattr(want, f).numpy(), err_msg=f)


def test_dna_codes_above_off_text_raise():
    reads, refs, rl, wl = _t(*cs.dna_batch(np.random.default_rng(9), 4, 40, 60, span=(30, 40)))
    check_dna_codes(reads, refs)
    for bad in (reads.clone(), refs.clone()):
        bad[2, 3] = OFF_TEXT_CODE + 1
        with pytest.raises(ValueError, match="code 5"):
            check_dna_codes(*((bad, refs) if bad.shape == reads.shape else (reads, bad)))


def test_sw_align_dna_refuses_other_devices():
    meta = [torch.empty((2, 4), dtype=torch.uint8, device="meta"),
            torch.empty((2, 6), dtype=torch.uint8, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="no DP for tensors on meta"):
        sw_align_dna(*meta, SSW)
