"""The port's one-program step (``megapath_tpu_torch.parallel.spmd_full``)
against the JAX package's.

On ``tests/test_spmd_full.py``'s small world (2 shards of random text,
80 bp clean, mutated, single-end/rescue and junk pairs) the JAX step runs
on a 2 x 2 mesh of conftest's virtual CPU devices and the port's on a
2 x 2 grid of places on the one CPU (its plain walk, locate and DP): every
``SpmdHits`` field equal, row for row, invalid rows and overflow flags
included. ``spmd_hits_to_batch`` equals the port's ``AlignEngine`` under
the NT and the hg parameters; caps too small raise; the meta has no
default and refuses mixed build parameters; a shard is put on a device
once however many cells share it. Every check is exact.
"""

import numpy as np
import pytest
import torch

from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align import seeding_dev
from megapath_tpu_torch.index.fm import build_fm_index
from megapath_tpu_torch.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath_tpu_torch.io.fastq import FastqRecord
from megapath_tpu_torch.parallel import spmd_full as sf
from megapath_tpu_torch.pipeline.megapath import HG_PARAMS
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
L, B = 80, 16


def _revcomp(codes):
    return COMPLEMENT[codes[::-1]].astype(np.uint8)


@pytest.fixture(scope="module")
def small_world():
    """test_spmd_full.small_world: the same texts (seed 42), both packages'
    shards."""
    from megapath_tpu.index.fm import build_fm_index as jbuild
    from megapath_tpu.index.pack import pack_fasta as jpack
    from megapath_tpu.io.fastq import FastqRecord as JRecord

    rng = np.random.default_rng(42)
    port, jax_, texts = [], [], []
    for s, sizes in enumerate([(4000, 3000, 2000), (3500, 2500)]):
        seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in sizes]
        names = [f"s{s}m{m}" for m in range(len(sizes))]
        ref = pack_fasta([FastqRecord(nm, decode_seq(c), "") for nm, c in zip(names, seqs)])
        jref = jpack([JRecord(nm, decode_seq(c), "", "") for nm, c in zip(names, seqs)])
        port.append((ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)))
        jax_.append((jref, jbuild(jref.codes, sa_interval=8, lut_k=8)))
        texts.append(seqs)
    return port, jax_, texts


def _planted_reads(texts, B, L=80, insert=220, seed=5):
    """test_spmd_full._planted_reads: clean, mutated, single-end, junk."""
    rng = np.random.default_rng(seed)
    flat = [(s, c) for s, seqs in enumerate(texts) for c in seqs]
    reads1 = np.zeros((B, L), np.uint8)
    reads2 = np.zeros((B, L), np.uint8)
    for b in range(B):
        kind = b % 4
        if kind == 3:
            reads1[b] = rng.integers(0, 4, L)
            reads2[b] = rng.integers(0, 4, L)
            continue
        s, c = flat[b % len(flat)]
        p = int(rng.integers(0, len(c) - insert))
        r1 = c[p : p + L].copy()
        r2 = _revcomp(c[p + insert - L : p + insert]).copy()
        if kind == 1:
            for arr in (r1, r2):
                for _ in range(3):
                    q = int(rng.integers(0, L))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        if kind == 2:
            r2 = rng.integers(0, 4, L).astype(np.uint8)
        reads1[b], reads2[b] = r1, r2
    return reads1, reads2, np.full(B, L, np.int32)


def _port_step(shards, reads1, reads2, lens, params, caps=sf.SpmdCaps(), rows=2,
               timer=None):
    mesh = sf.make_mesh([CPU] * (rows * len(shards)), len(shards))
    meta = sf.fm_meta([fm for _, fm in shards])
    inputs = sf.place_spmd_full_inputs(mesh, meta, shards)
    step = sf.build_spmd_full_engine(mesh, meta, L, params=params, caps=caps)
    return step(inputs, reads1, reads2, lens, lens, timer=timer), inputs


@pytest.fixture(scope="module")
def nt_steps(small_world):
    """Both packages' steps on the same batch, NT parameters, 2 x 2."""
    import jax
    from jax.sharding import Mesh as JMesh

    from megapath_tpu.align.params import AlignParams as JParams
    from megapath_tpu.parallel import spmd_full as jsf

    port, jshards, texts = small_world
    reads1, reads2, lens = _planted_reads(texts, B)
    sfm, meta = jsf.stack_fms_exact([fm for _, fm in jshards])
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), axis_names=("data", "shard"))
    jstep = jsf.build_spmd_full_engine(mesh, meta, L, params=JParams())
    words = jsf.pack_ref_rows(jsf.pad_ref_codes([r.codes for r, _ in jshards]))
    offs = jsf.pad_seq_offsets([r.offsets for r, _ in jshards])
    want = jstep(sfm, words, offs, reads1, reads2, lens, lens)
    timer = sf.StageEvents()
    got, _ = _port_step(port, reads1, reads2, lens, AlignParams(), timer=timer)
    return got, want, (reads1, reads2, lens), timer


@pytest.mark.parametrize("field", sf.SpmdHits._fields)
def test_step_fields_equal_the_jax_step(nt_steps, field):
    """Each [D, S, H] field row for row, the invalid rows too."""
    got, want, _, _ = nt_steps
    w = np.asarray(getattr(want, field))
    g = getattr(got, field)
    assert g.shape == w.shape
    if w.dtype == bool:
        assert g.dtype == bool
    np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_step_has_hits_in_every_cell_and_times_its_stages(nt_steps):
    got, _, _, timer = nt_steps
    assert got.valid.sum(axis=2).min() > 0
    assert (got.overflow == 0).all()
    secs = timer.seconds()
    assert list(secs) == ["walk", "locate", "cluster", "pair", "deep DP",
                          "single-end DP + rescue", "compact"]
    assert all(v >= 0 for v in secs.values())


@pytest.mark.parametrize("params,seed", [(AlignParams(), 5), (HG_PARAMS, 9)], ids=["nt", "hg"])
def test_hits_to_batch_equal_the_engine(small_world, params, seed):
    """Per shard, the step's hits equal ``AlignEngine.align_pairs``'s (as
    a set: the engine orders them by stage)."""
    port, _, texts = small_world
    reads1, reads2, lens = _planted_reads(texts, B, seed=seed)
    out, _ = _port_step(port, reads1, reads2, lens, params, rows=1)
    per_shard = sf.spmd_hits_to_batch(out, B)
    fields = ("read", "end", "seq", "score", "raw_score", "start", "stop", "strand", "paired")
    for (ref, fm), got in zip(port, per_shard):
        eng = AlignEngine(ref, fm, params, device=CPU)
        eng.exact_rescue = False
        want = eng.align_pairs(reads1, lens, reads2, lens)
        rows = lambda h: sorted(zip(*[getattr(h, f).tolist() for f in fields]))  # noqa: E731
        assert len(got) > 0 and rows(got) == rows(want)


def test_caps_too_small_raise():
    """A tandem repeat: every seed stands for sa_size_threshold + 1 SA rows,
    so 16 pairs need more located positions than the default caps' 1,024
    (the cap's floor at this block size): the flag is set and the
    conversion raises."""
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 4, 200).astype(np.uint8)
    text = np.tile(unit, 40)
    ref = pack_fasta([FastqRecord("rep", decode_seq(text), "")])
    shard = (ref, build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU))
    reads1, reads2, lens = _planted_reads([[text]], B)
    out, _ = _port_step([shard], reads1, reads2, lens, AlignParams(), rows=1)
    assert out.overflow.tolist() == [[1]]
    with pytest.raises(RuntimeError, match="spmd_full cap overflow"):
        sf.spmd_hits_to_batch(out, B)


def test_meta_has_no_default_and_mixed_parameters_are_refused(small_world):
    port, _, _ = small_world
    assert sf.FMMetaPad._field_defaults == {}
    with pytest.raises(TypeError):
        sf.FMMetaPad(8)  # noqa
    ref, fm = port[0]
    other = build_fm_index(ref.codes, sa_interval=4, lut_k=8, device=CPU)
    with pytest.raises(ValueError, match="build parameters differ"):
        sf.fm_meta([fm, other])
    # a meta that disagrees with the tables is refused at placement and by the step
    mesh = sf.make_mesh([CPU], 1)
    wrong = sf.FMMetaPad(lut_k=8, sa_interval=4)
    with pytest.raises(ValueError, match="the engine's meta"):
        sf.place_spmd_full_inputs(mesh, wrong, [port[0]])
    inputs = sf.place_spmd_full_inputs(mesh, sf.fm_meta([fm]), [port[0]])
    step = sf.build_spmd_full_engine(mesh, wrong, L)
    r = np.zeros((256, L), np.uint8)
    with pytest.raises(ValueError, match="the engine's meta"):
        step(inputs, r, r, np.zeros(256, np.int32), np.zeros(256, np.int32))


def test_a_shard_goes_to_a_device_once(small_world, monkeypatch):
    """[cpu] * 8 over 2 shards: a 4 x 2 grid whose cells all share one
    place; each shard is uploaded once, and every cell of its column holds
    that one copy."""
    port, _, _ = small_world
    uploads = []
    orig = seeding_dev.HostFM.upload
    monkeypatch.setattr(seeding_dev.HostFM, "upload",
                        lambda self, dev: uploads.append(dev) or orig(self, dev))
    mesh = sf.make_mesh([CPU] * 8, 2)
    assert mesh.shape == {"data": 4, "shard": 2}
    inputs = sf.place_spmd_full_inputs(mesh, sf.fm_meta([fm for _, fm in port]), port)
    assert len(uploads) == 2 and len(inputs.placed) == 2
    for s in range(2):
        assert len({id(row[s]) for row in inputs.cells}) == 1
    with pytest.raises(ValueError, match=r"spmd backend needs >= 3 devices for 3 shards"):
        sf.make_mesh([CPU] * 2, 3)
