"""The port's numpy copies of the host seeding and pairing modules stay
equal to the reference's (``megapath_tpu/align/{seeding,pairing}.py``)
on the soap4 fixture reads, under the default dials and the exact ones."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from megapath_tpu.align import pairing as jpair
from megapath_tpu.align import params as jparams
from megapath_tpu.align import seeding as jseed
from megapath_tpu.index.fm import build_fm_index
from megapath_tpu.index.pack import pack_fasta_file, pack_reads
from megapath_tpu.io.fastq import read_fastx
from megapath_tpu_torch.align import pairing as tpair
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.align import params as tparams
from megapath_tpu_torch.align import seeding as tseed
from megapath_tpu_torch.convert import align_params_from_reference
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def world():
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = build_fm_index(ref.codes, sa_interval=8, lut_k=8)
    r1 = [r.seq for r in read_fastx(FIX / "align_r1.fq")]
    r2 = [r.seq for r in read_fastx(FIX / "align_r2.fq")]
    reads1, lens1 = pack_reads(r1, 80)
    reads2, lens2 = pack_reads(r2, 80)
    allr = np.concatenate([reads1, reads2])
    all_lens = np.concatenate([lens1, lens2]).astype(np.int32)
    # the port walks its own index, built on its own
    port_fm = tfm.build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=torch.device("cpu"))
    return (fm, port_fm), allr, all_lens, lens1, lens2


def _eq(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


EXACT = dict(kill_ratio=0.0, sibling_kill_steps=0)


@pytest.mark.parametrize("dials", ["default", "exact"])
def test_seed_decode_pair_match_reference(world, dials):
    (fm, port_fm), allr, all_lens, lens1, lens2 = world
    jp = jparams.AlignParams()
    if dials == "exact":
        jp = jp.with_(mmp=dataclasses.replace(jp.mmp, **EXACT))
    tp = align_params_from_reference(jp)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)

    jw, jwl = jseed.make_walkers_fast(allr, all_lens)
    tw, twl = tseed.make_walkers_fast(allr, all_lens)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(twl, jwl)

    js = jseed.mmp_seed(jw, jwl, fm, jp.mmp)
    ts = tseed.mmp_seed(tw, twl, port_fm, tp.mmp)
    assert len(ts) == len(js) > 0
    _eq(ts, js, ("walker", "offset", "length", "sa_lo", "sa_count"))

    n = len(all_lens)
    jsp = jseed.decode_seeds(js, fm, all_lens, n, jp.mmp)
    tsp = tseed.decode_seeds(ts, port_fm, all_lens, n, tp.mmp)
    _eq(tsp, jsp, ("read", "strand", "pos", "coverage"))

    half = n // 2
    split = []
    for sp, mod in ((jsp, jseed), (tsp, tseed)):
        m1 = sp.read < half
        split.append([
            mod.SeedPositions(sp.read[m], sp.strand[m], sp.pos[m], sp.coverage[m])
            for m in (m1, ~m1)
        ])
    for sp in split[0][1], split[1][1]:
        sp.read = (sp.read - half).astype(np.int32)
    jc = jpair.pair_candidates(*split[0], lens1, lens2, jp)
    tc = tpair.pair_candidates(*split[1], lens1, lens2, tp)
    assert len(tc) == len(jc) > 0
    _eq(tc, jc, ("pair", "left_pos", "right_pos", "left_is_read2"))


def test_params_copy_has_reference_fields_and_defaults():
    for name in ("MmpParams", "AlignParams"):
        j, t = getattr(jparams, name)(), getattr(tparams, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert dataclasses.asdict(tparams.HUMAN_FILTER) == dataclasses.asdict(
        jparams.HUMAN_FILTER
    )
    assert dataclasses.asdict(tparams.NT_STAGE) == dataclasses.asdict(
        jparams.NT_STAGE
    )
