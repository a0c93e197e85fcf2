"""The port's protein path against the JAX package's, on the CPU: the plain
``sw_align_substmat``/``sw_align_protein`` against JAX's at tolerance 0
(score, end_ref, end_read) and against ``tests/test_protein.py:150``'s
numpy oracle; a numpy model of ``csrc/sw_subst.cu``'s arithmetic (its row
tiles, the carried row, each lane's best and the key reduction) equal to
the plain version across tile boundaries; the twins of every test in
``tests/test_protein.py`` through the port's ``blastx``/``blastx_m8`` and
``protein_remap``, their m8 lines and remap outputs byte-equal to the JAX
package's, and both ac-diamond golden checks."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from megapath_tpu.classify import protein as jprot
from megapath_tpu.classify.extras import m8_to_lsam as jm8_to_lsam
from megapath_tpu.io.lsam import LsamRecord as JLsamRecord
from megapath_tpu.ops.dp import DPParams as JDPParams
from megapath_tpu.ops.dp import sw_align_protein as jsw_align_protein
from megapath_tpu.ops.dp import sw_align_substmat as jsw_align_substmat
from megapath_tpu.pipeline.assembly import AssemblyResult as JAssemblyResult
from megapath_tpu.pipeline.assembly import protein_remap as jprotein_remap
from megapath_tpu_torch.classify import protein as prot
from megapath_tpu_torch.classify.extras import m8_to_lsam
from megapath_tpu_torch.io.lsam import LsamRecord
from megapath_tpu_torch.ops.dp import NEG, DPParams, sw_align_protein, sw_align_substmat
from megapath_tpu_torch.pipeline.assembly import AssemblyResult, protein_remap
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIELDS = ("score", "end_ref", "end_read")
PROTEIN = (0, 0, -11, -1)
DNA = {"A": 0, "C": 1, "G": 2, "T": 3}


def enc_dna(s):
    return np.array([DNA[c] for c in s], np.uint8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# inputs, all at one shape so that JAX compiles each program once
# ---------------------------------------------------------------------------
B, R, W = 24, 40, 64


def _batch(seed, n_codes=24, hi=None):
    """Random codes below ``hi`` (default n_codes), planted homologs with
    substitutions and an indel, lengths varied down to 0."""
    rng = np.random.default_rng(seed)
    hi = n_codes if hi is None else hi
    q = rng.integers(0, hi, (B, R)).astype(np.uint8)
    s = rng.integers(0, hi, (B, W)).astype(np.uint8)
    s[0, 10:50] = q[0]
    s[1, 5:45] = q[1]
    s[1, 20] = (s[1, 20] + 1) % n_codes
    s[2, 3:20], s[2, 23:46] = q[2, :17], q[2, 17:40]  # a gap in the query
    s[3, 8:20], s[3, 20:45] = q[3, :12], q[3, 15:40]  # a gap in the subject
    ql = rng.integers(0, R + 1, B).astype(np.int32)
    sl = rng.integers(0, W + 1, B).astype(np.int32)
    ql[:4], sl[:4] = R, W
    ql[4], sl[5] = 0, 0
    ql[6], sl[7] = 1, 1
    return q, s, ql, sl


def _ties(seed):
    """A repeated motif in both: equal scores in many columns and rows."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, R), np.uint8)
    s = np.zeros((B, W), np.uint8)
    for b in range(B):
        motif = rng.integers(0, 20, int(rng.integers(1, 5)))
        q[b] = np.resize(np.roll(motif, -int(rng.integers(0, len(motif)))), R)
        s[b] = np.resize(np.roll(motif, -int(rng.integers(0, len(motif)))), W)
    ql = rng.integers(1, R + 1, B).astype(np.int32)
    sl = rng.integers(1, W + 1, B).astype(np.int32)
    return q, s, ql, sl


def _other_subst(seed, n):
    rng = np.random.default_rng(seed)
    m = rng.integers(-6, 7, (n, n)).astype(np.int32)
    return (m + m.T) // 2


@pytest.mark.parametrize("case", ["random", "ties", "codes_past_n", "byte_codes"])
def test_plain_protein_dp_equals_jax(case):
    """``sw_align_protein`` (BLOSUM62, go -11, ge -1) equals JAX's on
    random batches with planted homologs, zero, one and padded lengths,
    ties of both orders and codes >= n_codes (which score 0)."""
    batch = {"random": lambda: _batch(12),
             "ties": lambda: _ties(13),
             "codes_past_n": lambda: _batch(14, hi=30),
             "byte_codes": lambda: _batch(15, hi=256)}[case]()
    _equal(sw_align_protein(*_t(*batch)), jsw_align_protein(*batch))


@pytest.mark.parametrize("n_codes,params", [(7, (0, 0, -3, -1)), (7, (0, 0, -1, -3)),
                                            (5, (0, 0, -2, -2))])
def test_plain_substmat_equals_jax_on_another_table(n_codes, params):
    """Another substitution table with fewer codes (some of the batch's
    codes past it) and other gap costs, ``gap_open > gap_extend`` among
    them: the plain version computes the JAX prefix-max form."""
    q, s, ql, sl = _batch(16 + n_codes, n_codes=n_codes, hi=n_codes + 3)
    subst = _other_subst(n_codes, n_codes)
    import jax.numpy as jnp

    want = jsw_align_substmat(q, s, ql, sl, jnp.asarray(subst), params=JDPParams(*params),
                              n_codes=n_codes)
    _equal(sw_align_substmat(*_t(q, s, ql, sl, subst), DPParams(*params)), want)


def _oracle(qq, ss):
    """``tests/test_protein.py:166``'s plain numpy SW under BLOSUM62."""
    go, ge = -11, -1
    nq, ns = len(qq), len(ss)
    H = np.zeros((nq + 1, ns + 1), np.int64)
    E = np.full((nq + 1, ns + 1), -(10**6), np.int64)
    F = np.full((nq + 1, ns + 1), -(10**6), np.int64)
    for i in range(1, nq + 1):
        for j in range(1, ns + 1):
            E[i, j] = max(H[i, j - 1] + go, E[i, j - 1] + ge)
            F[i, j] = max(H[i - 1, j] + go, F[i - 1, j] + ge)
            H[i, j] = max(0, H[i - 1, j - 1] + jprot.BLOSUM62[qq[i - 1], ss[j - 1]],
                          E[i, j], F[i, j])
    return int(H.max())


def test_plain_protein_dp_equals_the_numpy_oracle():
    q, s, ql, sl = _batch(17, hi=20)
    got = sw_align_protein(*_t(q, s, ql, sl))
    for b in range(B):
        assert int(got.score[b]) == _oracle(q[b, : ql[b]], s[b, : sl[b]]), b


# ---------------------------------------------------------------------------
# csrc/sw_subst.cu's arithmetic, modelled in numpy
# ---------------------------------------------------------------------------
def _beats(a, b):
    """(score, column, row) ``a`` beats ``b``: the larger score, then the
    lower column, then the lower row (the kernel's ``beats``)."""
    return a[0] > b[0] or (a[0] == b[0] and (a[1], a[2]) < (b[1], b[2]))


def kernel_model(q, s, ql, sl, subst, params, max_rows=16):
    """One candidate as ``sw_subst.cu`` computes it with ``max_rows`` rows a
    lane: equal stripes of 32 lanes a tile, each row's recurrence (F an
    add-max, H without E an add-max-relu, E into the next row the plain
    chain from H without E), a tile's last row (H, outgoing E) carried to
    the next tile's first, each lane's first best cell of a tile (strict >
    in column-then-row order) merged into its best by the full key, and
    the warp's key reduction. Returns (score, end_ref, end_read)."""
    go, ge = params[2], params[3]
    n = subst.shape[0]
    tab = np.zeros((n + 1, n + 1), np.int64)
    tab[:n, :n] = subst
    n_cols = min(max(int(ql), 0), len(q))
    n_rows = min(max(int(sl), 0), len(s))
    lanes = [(0, 0, 0)] * 32
    if n_cols and n_rows:
        tiles0 = -(-n_rows // (32 * max_rows))
        per_lane = -(-n_rows // (32 * tiles0))
        tile_rows = 32 * per_lane
        n_tiles = -(-n_rows // tile_rows)
        carry_h = np.zeros(n_cols, np.int64)
        carry_e = np.full(n_cols, NEG, np.int64)
        for tile in range(n_tiles):
            rows = range(tile * tile_rows, min((tile + 1) * tile_rows, n_rows))
            H = {r: 0 for r in rows}
            F = {r: NEG for r in rows}
            tb = [(0, 0, 0)] * 32
            out_h = np.zeros(n_cols, np.int64)
            out_e = np.zeros(n_cols, np.int64)
            for j in range(n_cols):
                qc = min(int(q[j]), n)
                diag = carry_h[j - 1] if j else 0
                e = carry_e[j]
                for r in rows:
                    hp = H[r]
                    f = max(hp + go, F[r] + ge)
                    hne = max(diag + tab[qc, min(int(s[r]), n)], f, 0)
                    h = max(hne, e)
                    e = max(hne + go, e + ge)
                    diag, H[r], F[r] = hp, h, f
                    lane = (r - tile * tile_rows) // per_lane
                    if h > tb[lane][0]:
                        tb[lane] = (h, j, r)
                out_h[j], out_e[j] = H[rows[-1]], e
            carry_h, carry_e = out_h, out_e
            for k in range(32):
                if tb[k][0] > 0 and _beats(tb[k], lanes[k]):
                    lanes[k] = tb[k]
    best = lanes[0]
    for k in range(1, 32):
        if _beats(lanes[k], best):
            best = lanes[k]
    s_, j_, i_ = best
    return (s_, i_ + 1, j_ + 1) if s_ > 0 else (0, 0, 0)


@pytest.mark.parametrize("max_rows,widths", [
    (1, (1, 31, 32, 33, 65)),  # 32-row tiles: W = tile, tile + 1, 2 tile + 1
    (2, (64, 65, 129)),
    (16, (1, 64, 200)),
])
def test_kernel_model_equals_plain_across_tiles(max_rows, widths):
    """The kernel's tiles, carried row and best keys give the plain
    version's score and end cell at tolerance 0, across every tile
    boundary, with ties, codes >= n_codes and ``gap_open > gap_extend``."""
    rng = np.random.default_rng(40 + max_rows)
    subst = jprot.BLOSUM62
    for w in widths:
        for params in (PROTEIN, (0, 0, -1, -3)):
            q = rng.integers(0, 26, (6, 24)).astype(np.uint8)
            s = rng.integers(0, 26, (6, w)).astype(np.uint8)
            s[0, : min(w, 24)] = q[0, : min(w, 24)]
            s[1] = np.resize(q[1, :3], w)  # a repeated motif: ties
            q[1] = np.resize(q[1, :3], 24)
            ql = np.array([24, 24, 0, 7, 24, 24], np.int32)
            sl = np.array([w, w, w, w, 0, max(w - 3, 1)], np.int32)
            want = sw_align_substmat(*_t(q, s, ql, sl, subst), DPParams(*params))
            for b in range(6):
                got = kernel_model(q[b], s[b], ql[b], sl[b], subst, params, max_rows)
                assert got == tuple(int(getattr(want, f)[b]) for f in FIELDS), (w, params, b)


def test_kernel_tile_matches_the_wrapper():
    """The wrapper allocates the carried rows for windows wider than the
    kernel's tile (``kTile`` = 32 x ``kMaxRows``)."""
    import re

    from megapath_tpu_torch.ops import protein_cuda

    src = (cs.HERE / "megapath_tpu_torch" / "csrc" / "sw_subst.cu").read_text()
    rows = int(re.search(r"constexpr int kMaxRows = (\d+);", src).group(1))
    codes = int(re.search(r"constexpr int kMaxCodes = (\d+);", src).group(1))
    assert 32 * rows == protein_cuda.TILE_ROWS
    assert codes == protein_cuda.MAX_CODES


def test_substmat_kernel_entry_refuses_cpu_tensors():
    from megapath_tpu_torch.ops import protein_cuda

    before = protein_cuda.launches
    q, s, ql, sl = _t(*_batch(18))
    with pytest.raises(ValueError, match="CUDA tensors"):
        protein_cuda.sw_align_substmat_cuda(q, s, ql, sl, torch.from_numpy(jprot.BLOSUM62),
                                            DPParams(*PROTEIN))
    assert protein_cuda.launches == before


# ---------------------------------------------------------------------------
# twins of tests/test_protein.py
# ---------------------------------------------------------------------------
def test_module_tables_equal_jax():
    assert prot.AA == jprot.AA
    np.testing.assert_array_equal(prot.BLOSUM62, jprot.BLOSUM62)
    np.testing.assert_array_equal(prot.CODON_AA, jprot.CODON_AA)
    raw = np.arange(-5, 400, 7)
    np.testing.assert_array_equal(prot.bitscore(raw), jprot.bitscore(raw))
    np.testing.assert_array_equal(prot.evalue(prot.bitscore(raw), 300, 5000),
                                  jprot.evalue(jprot.bitscore(raw), 300, 5000))


def test_translate_equals_jax():
    codes = enc_dna("ATGGCATTTTAA")
    frames = dict(prot.translate_frames(codes))
    assert "".join(prot.AA[c] for c in frames[1]) == "MAF*"
    assert "".join(prot.AA[c] for c in frames[-1]) == "LKCH"
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 100, 101):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        got, want = prot.translate_frames(codes), jprot.translate_frames(codes)
        assert [f for f, _ in got] == [f for f, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _reverse_translate(aa_seq: str, rng) -> str:
    """Any codon that decodes to each aa (``tests/test_protein.py:52``)."""
    out = []
    for c in aa_seq:
        cands = np.flatnonzero(prot.CODON_AA == prot.AA_CODE[c])
        v = int(cands[rng.integers(0, len(cands))])
        out.append("ACGT"[v >> 4] + "ACGT"[(v >> 2) & 3] + "ACGT"[v & 3])
    return "".join(out)


@pytest.fixture(scope="module")
def dbs():
    """``tests/test_protein.py``'s DB (6 random proteins of 120 aa, taxid
    names joined by 0x1), built by both packages."""
    rng = np.random.default_rng(5)
    seqs = [(f"{9000 + i}0x1{500 + i}", "".join(prot.AA[:20][j] for j in
                                                  rng.integers(0, 20, 120)))
            for i in range(6)]
    db, jdb = prot.ProteinDB.build(seqs, k=4), jprot.ProteinDB.build(seqs, k=4)
    for f in ("text", "offsets", "kmer_sorted", "kmer_pos"):
        np.testing.assert_array_equal(getattr(db, f), getattr(jdb, f))
    assert db.names == jdb.names and db.k == jdb.k
    return db, jdb, seqs


def _both(dbs, queries):
    """The port's and the JAX package's blastx on the same queries: the m8
    lines must be equal; returns the port's hits."""
    db, jdb, _ = dbs
    hits = prot.blastx(queries, db, device=CPU)
    assert [h.to_line() for h in hits] == [h.to_line() for h in jprot.blastx(queries, jdb)]
    assert prot.blastx_m8(queries, db, device=CPU) == jprot.blastx_m8(queries, jdb)
    return hits


def test_blastx_recovers_planted_protein(dbs):
    seqs = dbs[2]
    dna = _reverse_translate(seqs[2][1][10:60], np.random.default_rng(7))
    hits = _both(dbs, [("q0", enc_dna(dna))])
    top = hits[0]
    assert top.sseqid == seqs[2][0]
    assert (top.pident, top.length, top.mismatch, top.gapopen) == (100.0, 50, 0, 0)
    assert (top.sstart, top.send, top.qstart, top.qend) == (11, 60, 1, 150)
    assert top.bitscore_ > 40


def test_blastx_reverse_strand(dbs):
    seqs = dbs[2]
    dna = _reverse_translate(seqs[4][1][20:70], np.random.default_rng(8))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(dna))
    hits = _both(dbs, [("q0", enc_dna(rc))])
    assert hits and hits[0].sseqid == seqs[4][0] and hits[0].pident == 100.0
    assert hits[0].qstart > hits[0].qend


def test_blastx_mutations_reported(dbs):
    seqs = dbs[2]
    frag = list(seqs[1][1][0:60])
    for at in (20, 40):
        frag[at] = prot.AA[(prot.AA_CODE[frag[at]] + 1) % 20]
    dna = _reverse_translate("".join(frag), np.random.default_rng(9))
    hits = _both(dbs, [("q0", enc_dna(dna))])
    assert hits and hits[0].sseqid == seqs[1][0]
    assert hits[0].mismatch == 2
    assert hits[0].pident == pytest.approx(100.0 * 58 / 60, abs=0.01)


def test_blastx_no_random_hits(dbs):
    dna = np.random.default_rng(10).integers(0, 4, 120).astype(np.uint8)
    assert _both(dbs, [("junk", dna)]) == []


def test_blastx_many_queries_and_indels(dbs):
    """Several queries in one batch (candidates padded to the longest
    frame): planted fragments with an insertion and a deletion, on both
    strands, beside junk and a query shorter than a k-mer."""
    seqs = dbs[2]
    rng = np.random.default_rng(19)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    queries = []
    for i, (_, s) in enumerate(seqs):
        frag = s[5:50] + "".join(prot.AA[:20][j] for j in rng.integers(0, 20, 2)) + s[50:90]
        if i % 2:
            frag = s[5:40] + s[43:100]
        dna = _reverse_translate(frag, rng)
        if i % 3 == 2:
            dna = "".join(comp[c] for c in reversed(dna))
        queries.append((f"q{i}", enc_dna(dna)))
    queries.append(("junk", rng.integers(0, 4, 300).astype(np.uint8)))
    queries.append(("short", enc_dna("ACGTAC")))
    hits = _both(dbs, queries)
    assert {h.qseqid for h in hits} == {f"q{i}" for i in range(6)}
    assert any(h.gapopen for h in hits)


def test_m8_flows_into_lsam(dbs):
    seqs = dbs[2]
    dna = _reverse_translate(seqs[0][1][5:55], np.random.default_rng(11))
    _both(dbs, [("contig_1", enc_dna(dna))])
    lines = prot.blastx_m8([("contig_1", enc_dna(dna))], dbs[0], device=CPU)
    recs = list(m8_to_lsam(lines))
    assert [r.to_line() for r in recs] == [r.to_line() for r in jm8_to_lsam(lines)]
    assert recs[0].name == "contig_1"
    assert {t for _, t in recs[0].hits} == {"9000", "500"}


def _remap_inputs(seed: int):
    """``tests/test_protein.py:188``'s stage-4.1 inputs (a contig encoding
    a fragment of subject 0, a read of subject 1, a junk read, a read
    mapped to the contig), for both packages."""
    rng = np.random.default_rng(seed)
    real20 = prot.AA[:20]
    prot_seqs = [("NC_045512", "".join(real20[j] for j in rng.integers(0, 20, 150))),
                 ("NC_0009130x1NC_003197",
                  "".join(real20[j] for j in rng.integers(0, 20, 150)))]
    contig0 = _reverse_translate(prot_seqs[0][1][10:110], rng)
    u1_dna = _reverse_translate(prot_seqs[1][1][40:90], rng)

    def dec(codes):
        return "".join("ACGT"[c] for c in codes)

    recs1 = [type("R", (), {"name": n, "seq": s})() for n, s in
             (("u1", u1_dna), ("u2", dec(rng.integers(0, 4, 150))),
              ("mapped", dec(rng.integers(0, 4, 150))))]
    r2c = [("mapped", 120, [(120.0, "0")]), ("u1", 0, []), ("u2", 0, [])]
    port = AssemblyResult([contig0], [LsamRecord(name=n, flag=0, score=sc, seq="*", qual="*",
                                                 hits=h) for n, sc, h in r2c])
    jax_ = JAssemblyResult([contig0], [JLsamRecord(name=n, flag=0, score=sc, seq="*",
                                                   qual="*", hits=h) for n, sc, h in r2c])
    return prot_seqs, recs1, port, jax_


def _remap_both(prot_seqs, recs1, port, jax_, mini_taxdb):
    out = protein_remap(port, recs1, [], prot.ProteinDB.build(prot_seqs, k=4),
                        cs.mini_taxdb(), cutoff=40, device=CPU)
    want = jprotein_remap(jax_, recs1, [], jprot.ProteinDB.build(prot_seqs, k=4), mini_taxdb,
                          cutoff=40)
    for got_recs, want_recs in zip(out[:2], want[:2]):
        assert [r.to_line() for r in got_recs] == [r.to_line() for r in want_recs]
    assert out[2] == want[2]
    return out


def test_protein_remap_stage(mini_taxdb):
    """Stage 4.1 end to end, equal to the JAX package's: the contig hits
    subject 0 (taxid 694009), u1 both of subject 1's species, u2 nothing;
    'mapped' inherits the contig's genome; the report counts it."""
    nr_lsam_id, r2g, report = _remap_both(*_remap_inputs(21), mini_taxdb)
    by_name = {r.name: r for r in nr_lsam_id}
    assert {t for _, t in by_name["contig_0"].hits} == {"694009"}
    assert {t for _, t in by_name["u1"].hits} == {"562", "28901"}
    assert "u2" not in by_name
    r2g_by = {r.name: r for r in r2g}
    assert {t for _, t in r2g_by["mapped"].hits} == {"694009"}
    assert "Severe acute" in report or "694009" in report


def test_protein_remap_with_no_contig_and_an_empty_db(mini_taxdb):
    """No contig (the assembler built none): the reads alone are searched;
    an empty protein DB: no hit, and no r2g record with a genome."""
    prot_seqs, recs1, port, jax_ = _remap_inputs(22)
    port.contigs.clear()
    jax_.contigs.clear()
    nr_lsam_id, _, _ = _remap_both(prot_seqs, recs1, port, jax_, mini_taxdb)
    assert [r.name for r in nr_lsam_id] == ["u1"]
    nr_lsam_id, r2g, _ = _remap_both([], recs1, port, jax_, mini_taxdb)
    assert nr_lsam_id == [] and not [r for r in r2g if r.hits]


# ---------------------------------------------------------------------------
# the ac-diamond goldens (tests/test_protein.py:244-327)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def acd_world():
    prots, queries = cs.acd_inputs()
    lines = prot.blastx_m8(queries, prot.ProteinDB.build(prots), device=CPU)
    assert lines == jprot.blastx_m8(queries, jprot.ProteinDB.build(prots))
    golden = {}
    for line in open(cs.PROT_ACD / "acd.m8"):
        c = line.rstrip("\n").split("\t")
        golden[c[0]] = c
    ours = {}
    for line in lines:
        c = line.split("\t")
        ours.setdefault(c[0], []).append(c)
    return golden, ours


def test_acd_hit_pairs_match(acd_world):
    golden, ours = acd_world
    for q, g in golden.items():
        assert q in ours, f"{q}: ac-diamond hit {g[1]}, the port found nothing"
        top = max(ours[q], key=lambda c: float(c[11]))
        assert top[1] == g[1], f"{q}: want {g[1]}, got {top[1]}"
    assert not [q for q in ours if q.endswith("_junk")]


def test_acd_scores_and_coords_match(acd_world):
    golden, ours = acd_world
    for q, g in golden.items():
        top = max(ours[q], key=lambda c: float(c[11]))
        g_bits, o_bits = float(g[11]), float(top[11])
        assert abs(o_bits - g_bits) <= 0.10 * g_bits, f"{q}: bitscore {o_bits} vs {g_bits}"
        if float(g[2]) == 100.0:
            assert float(top[2]) == 100.0
            assert top[3] == g[3]
            assert top[4] == g[4] == "0"
            assert (top[8], top[9]) == (g[8], g[9])
