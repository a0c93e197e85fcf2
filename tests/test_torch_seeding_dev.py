"""The port's device seeding (``megapath_tpu_torch.align.seeding_dev``)
against ``megapath_tpu.align.seeding_jax`` and the host FM index.

The port runs its plain PyTorch walk and locate on the CPU; the JAX walk
runs on the CPU in both of its table layouts (paired rows with the
two-phase walk, classic rows). Twins of tests/test_seeding_jax.py:45, 78,
86 and 222. Every check is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from megapath_tpu.align.params import MmpParams as JMmpParams
from megapath_tpu.align.seeding import make_walkers_fast
from megapath_tpu.align import seeding_jax as js
from megapath_tpu.index.fm import build_fm_index
from megapath_tpu_torch.align import seeding_dev as sd
from megapath_tpu_torch.convert import align_params_from_reference
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.ops import seed_cuda
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PARAMS = JMmpParams(seed_min_length=12, reseed_len=13, good_seed_len=18)
DIALS = {
    "test": PARAMS,
    "default": JMmpParams(),  # kill 2.5/80, sibling cull at 48
    "exact": JMmpParams(kill_ratio=0.0, sibling_kill_steps=0),
}


def _port_fm(fm) -> tfm.FMIndex:
    """The reference's FM index as the port's (arrays shared)."""
    return tfm.FMIndex(**{f.name: getattr(fm, f.name) for f in dataclasses.fields(tfm.FMIndex)})


@pytest.fixture(scope="module")
def world():
    codes = np.random.default_rng(3).integers(0, 4, 20000).astype(np.uint8)
    worlds = {}
    for lut in (6, 0):
        fm = build_fm_index(codes, sa_interval=4, lut_k=lut)
        worlds[lut] = (fm, sd.DeviceFM.from_host(_port_fm(fm), CPU))
    return codes, worlds


def _reads(codes, rng, n, L, junk_every=4, varlen=False):
    reads = np.zeros((n, L), np.uint8)
    lens = np.full(n, L, np.int32)
    for b in range(n):
        ln = int(rng.integers(10, L + 1)) if varlen else L
        lens[b] = ln
        if b % junk_every == junk_every - 1:
            reads[b, :ln] = rng.integers(0, 4, ln)
            continue
        p = int(rng.integers(0, len(codes) - ln))
        r = codes[p : p + ln].copy()
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, ln))
            r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        reads[b, :ln] = r
    return reads, lens


def _jax_walk(fm, walkers, wlens, params, paired, max_seeds, L):
    """The JAX walk as the engine runs it in each layout: the charged
    bound 3L+64, a doubled iteration budget for the two-phase walk."""
    dfm = js.DeviceFM.from_host(fm, paired=paired)
    assert (dfm.blk < 128) == paired
    chg = 3 * L + 64
    out, _ = js.device_mmp_seed(
        dfm, walkers, wlens, params, max_seeds=max_seeds,
        max_steps=2 * chg + 128 if paired else chg, two_phase=paired,
        charge_limit=chg,
    )
    return out


def _assert_seeds_equal(got, want):
    for name in ("n_seeds", "offset", "length", "sa_lo", "sa_count"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), err_msg=name,
        )


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("dial", sorted(DIALS))
@pytest.mark.parametrize("lut", [6, 0])
def test_walk_matches_device_mmp_seed(world, lut, dial, paired):
    codes, worlds = world
    fm, dfm = worlds[lut]
    n, L = 32, 90
    reads, lens = _reads(codes, np.random.default_rng(5), n, L)
    walkers, wlens = make_walkers_fast(reads, lens)
    jp = DIALS[dial]
    want = _jax_walk(fm, walkers, wlens, jp, paired, 8, L)
    chg = 3 * L + 64
    got = sd.mmp_seed_device(
        dfm, torch.from_numpy(walkers), torch.from_numpy(wlens),
        align_params_from_reference(jp), max_seeds=8, max_steps=chg,
        charge_limit=chg,
    )
    _assert_seeds_equal(got, want)
    assert int(got.n_seeds.sum()) > 0


def test_variable_lengths(world):
    """Twin of test_variable_lengths: read lengths 10..100, the default
    walk bound and 16 slots."""
    codes, worlds = world
    fm, dfm = worlds[6]
    reads, lens = _reads(codes, np.random.default_rng(9), 16, 100, junk_every=5,
                         varlen=True)
    walkers, wlens = make_walkers_fast(reads, lens)
    want, _ = js.device_mmp_seed(js.DeviceFM.from_host(fm), walkers, wlens, PARAMS)
    got = sd.mmp_seed_device_plain(
        dfm, torch.from_numpy(walkers), torch.from_numpy(wlens),
        align_params_from_reference(PARAMS),
    )
    _assert_seeds_equal(got, want)


def test_odd_walker_count_runs_without_sibling(world):
    """An odd walker count has no strand pairing: the JAX walk turns the
    sibling cull off, and so does the port."""
    codes, worlds = world
    fm, dfm = worlds[6]
    reads, lens = _reads(codes, np.random.default_rng(13), 15, 64)
    walkers, wlens = make_walkers_fast(reads, lens)
    walkers, wlens = walkers[:-1], wlens[:-1]
    want, _ = js.device_mmp_seed(js.DeviceFM.from_host(fm), walkers, wlens, PARAMS)
    got = sd.mmp_seed_device_plain(
        dfm, torch.from_numpy(walkers), torch.from_numpy(wlens),
        align_params_from_reference(PARAMS),
    )
    _assert_seeds_equal(got, want)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("lut", [6, 0])
def test_locate_matches_device_locate_and_host(world, lut, paired):
    codes, worlds = world
    fm, dfm = worlds[lut]
    rows = np.concatenate([
        np.arange(1, fm.n + 1, 37), [1, fm.primary, fm.primary + 1, fm.n],
    ]).astype(np.int32)
    want = fm.locate(rows.astype(np.int64))
    jw = np.asarray(js.device_locate(js.DeviceFM.from_host(fm, paired=paired),
                                     rows, fm.sa_interval))
    got = sd.locate_device(dfm, torch.from_numpy(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tables_pack_as_reference(world):
    _, worlds = world
    fm, dfm = worlds[6]
    words, chk = js.pack_mark_rank(fm.mark_rank, fm.n)
    np.testing.assert_array_equal(dfm.mark_rows[:, 0].numpy().view(np.uint32), words)
    np.testing.assert_array_equal(dfm.mark_rows[:, 1].numpy(), chk)
    np.testing.assert_array_equal(dfm.sa_sampled.numpy(), fm.sa_sampled)
    np.testing.assert_array_equal(
        dfm.rows[:, :4].numpy().view(np.uint32), fm.occ
    )
    assert dfm.rows.shape == (fm.occ.shape[0], 16)


def test_build_walkers_matches_jax():
    rng = np.random.default_rng(2)
    reads = rng.integers(0, 4, (9, 33)).astype(np.uint8)
    lens = rng.integers(0, 34, 9).astype(np.int32)
    jw, jl = js.build_walkers(reads, lens)
    tw, tl = sd.build_walkers(torch.from_numpy(reads), torch.from_numpy(lens))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tw.dtype == torch.uint8 and tl.dtype == torch.int32


@pytest.mark.parametrize("dial", ["default", "exact"])
def test_pipeline_matches_device_seed_pipeline_loc(world, dial):
    """Walk + flatten + expansion + locate, as one leg, against the JAX
    pipeline's flat seeds and positions (its caps large enough)."""
    codes, worlds = world
    fm, dfm = worlds[6]
    n, L = 48, 100
    reads, lens = _reads(codes, np.random.default_rng(21), n, L, junk_every=3)
    jp = DIALS[dial]
    chg = 3 * L + 64
    out = js.device_seed_pipeline_loc(
        js.DeviceFM.from_host(fm), reads, lens, jp, 8, chg, (), 4 * n, 16 * n,
        charge_limit=chg,
    )
    n_valid, *flat_j, pos_j, tot = (np.asarray(a) for a in out[:8])
    assert not bool(out[8]) and not bool(out[9])
    flat, pos, walkers = sd.device_seed_pipeline_loc(
        dfm, torch.from_numpy(reads), torch.from_numpy(lens),
        align_params_from_reference(jp), 8, chg, chg,
    )
    assert len(flat.walker) == int(n_valid) > 0
    for g, w in zip(flat, flat_j):
        np.testing.assert_array_equal(g.numpy(), w[: int(n_valid)].astype(np.int32))
    assert len(pos) == int(tot)
    np.testing.assert_array_equal(pos.numpy(), pos_j[: int(tot)])
    np.testing.assert_array_equal(walkers.numpy(), np.asarray(out[10]))
    # the positions are the host FM's locate of the expanded rows
    rows = sd.expand_rows(flat.sa_lo, flat.sa_count).numpy()
    np.testing.assert_array_equal(pos.numpy(), fm.locate(rows.astype(np.int64)))


def test_walk_refuses_what_the_jax_walk_refuses(world):
    _, worlds = world
    dfm = worlds[6][1]
    p = align_params_from_reference(PARAMS)
    w = torch.zeros((2, 1024), dtype=torch.uint8)
    with pytest.raises(ValueError, match="1023"):
        sd.mmp_seed_device(dfm, w, torch.zeros(2, dtype=torch.int32), p)
    big = dataclasses.replace(p, sa_size_threshold=1023)
    with pytest.raises(ValueError, match="10-bit"):
        sd.mmp_seed_device(dfm, w[:, :8], torch.zeros(2, dtype=torch.int32), big)


def test_cpu_path_launches_nothing(world):
    codes, worlds = world
    dfm = worlds[6][1]
    before = (seed_cuda.walk_launches, seed_cuda.locate_launches)
    reads, lens = _reads(codes, np.random.default_rng(4), 4, 40)
    sd.device_seed_pipeline_loc(
        dfm, torch.from_numpy(reads), torch.from_numpy(lens),
        align_params_from_reference(PARAMS), 4, 184, 184,
    )
    assert (seed_cuda.walk_launches, seed_cuda.locate_launches) == before


# ----------------------------------------------------------------------
# the occ rows' mark words, and the locate kernel's step on them
# ----------------------------------------------------------------------
def _layout_text(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "homopolymer":
        return np.full(n, 2, np.uint8)
    t = np.resize(rng.integers(0, 4, 7).astype(np.uint8), n)  # 7-mer repeat
    t[rng.integers(0, n, max(1, n // 50))] = 3
    return t


@pytest.fixture(scope="module")
def layouts(world):
    """(reference FM, port DeviceFM) on the world (sa_interval 4) and on
    a repeat and a homopolymer text at sa_intervals 1, 3 and 8."""
    out = {"world": world[1][6]}
    for kind, n in (("repeat", 4000), ("homopolymer", 300)):
        for s in (1, 3, 8):
            fm = build_fm_index(_layout_text(kind, n), sa_interval=s, lut_k=4)
            out[f"{kind} s={s}"] = (fm, sd.DeviceFM.from_host(_port_fm(fm), CPU))
    return out


LAYOUTS = ["world"] + [f"{k} s={s}" for k in ("repeat", "homopolymer") for s in (1, 3, 8)]


@pytest.mark.parametrize("name", LAYOUTS)
def test_mark_words_hold_marked_rows_by_adj(layouts, name):
    """Bit adj & 127 of row adj >> 7's mark words is marked(r) for every
    full row r != primary, adj = r - (r > primary); primary itself holds
    text position 0 and is marked."""
    fm, dfm = layouts[name]
    n, primary = fm.n, fm.primary
    marked = (fm.mark_rank[1:] - fm.mark_rank[:-1]) > 0  # full rows 0..n
    words = dfm.rows[:, sd.MARK_WORD:].numpy().view(np.uint32)
    r = np.arange(n + 1)
    adj = r - (r > primary)
    bits = (words[adj >> 7, (adj & 127) >> 5] >> (adj & 31).astype(np.uint32)) & 1
    other = r != primary
    np.testing.assert_array_equal(bits[other].astype(bool), marked[other])
    assert marked[primary] and fm.sa_sampled[fm.mark_rank[primary]] == 0
    # past the text, and in the last checkpoint row, no bit is set
    tail = np.unpackbits(words.view(np.uint8), bitorder="little")[n:]
    assert not tail.any()


def _count_in_words(words: torch.Tensor, pat: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """locate.cu's ``count_in_words``: chars equal to the pattern's among
    the first max(s, 0) / 2 chars of 4 words (int64 uint32 values [M, 4])."""
    x = ~(words ^ pat[:, None]) & sd.U32
    k = (s[:, None] - 32 * torch.arange(4)[None, :]).clamp(0, 32)  # the funnel shift
    return sd._popcount(x & (x >> 1) & 0x55555555 & sd._low_bits(k)).sum(dim=1)


def _locate_kernel_step(dfm, rows: torch.Tensor) -> torch.Tensor:
    """csrc/locate.cu in plain torch, lane by lane. A step reads one
    64-byte occ row: lane 0 its checkpoint and BWT words 0-3, lane 1 words
    4-7 and the mark bits. The mark bit is lane 1's (row ``primary`` is
    decided by comparison), the char lane rel >> 6's, each lane counts the
    char in its own 4 words and lane 0 adds C[c] and the checkpoint; only
    at a mark does the row read its mark row for the rank, then
    sa_sampled."""
    i64 = torch.int64
    rows_u = sd._u32(dfm.rows)
    marks = sd._u32(dfm.mark_rows)
    counts = dfm.counts.to(i64)
    sampled = dfm.sa_sampled.to(i64)
    r = rows.to(i64)
    pos = torch.full_like(r, -1)
    live = torch.ones_like(r, dtype=torch.bool)
    pick = lambda v, q: torch.gather(v, 1, q[:, None])[:, 0]  # noqa: E731
    for steps in range(dfm.sa_interval + 1):
        adj = r - (r > dfm.primary).to(i64)
        row = rows_u[adj >> 7]  # the step's one row fetch
        occ, words, mk = row[:, :4], (row[:, 4:8], row[:, 8:12]), row[:, 12:]
        rel = adj & 127
        mine = [(pick(w, (rel >> 4) & 3) >> (2 * (rel & 15))) & 3 for w in words]
        bit = (pick(mk, rel >> 5) >> (rel & 31)) & 1
        hit = live & ((r == dfm.primary) | (bit == 1))
        m = marks[(r >> 5)[hit]]  # at the mark only
        rank = m[:, 1] + sd._popcount(m[:, 0] & sd._low_bits((r & 31)[hit]))
        pos[hit] = sampled[rank] + steps
        live = live & ~hit
        c = torch.where((rel >> 6) == 1, mine[1], mine[0])
        pat = c * 0x55555555
        part0 = _count_in_words(words[0], pat, 2 * rel) + counts[c] + pick(occ, c)
        part1 = _count_in_words(words[1], pat, 2 * rel - 128)
        r = torch.where(live, part0 + part1, r)
    return pos.to(torch.int32)


@pytest.mark.parametrize("name", LAYOUTS)
def test_kernel_step_equals_plain_and_jax_locate(layouts, name):
    """The kernel's step, emulated, on every full row: equal to
    locate_device_plain and to the JAX device_locate."""
    fm, dfm = layouts[name]
    rows = np.arange(0, fm.n + 1, dtype=np.int32)
    got = _locate_kernel_step(dfm, torch.from_numpy(rows))
    plain = sd.locate_device_plain(dfm, torch.from_numpy(rows))
    jw = np.asarray(js.device_locate(js.DeviceFM.from_host(fm), rows, fm.sa_interval))
    np.testing.assert_array_equal(plain.numpy(), jw)
    np.testing.assert_array_equal(got.numpy(), jw)
    assert (got.numpy() >= 0).all()  # every row reaches a mark in sa_interval steps


def test_walk_ignores_the_mark_words(world):
    """mmp_seed_device_plain's seeds are the same with the mark words
    cleared: the walk ranks from a row's first 12 words only."""
    codes, worlds = world
    fm, dfm = worlds[6]
    cleared = dataclasses.replace(dfm, rows=dfm.rows.clone())
    cleared.rows[:, sd.MARK_WORD:] = 0
    assert bool(dfm.rows[:, sd.MARK_WORD:].ne(0).any())
    n, L = 32, 90
    reads, lens = _reads(codes, np.random.default_rng(31), n, L)
    walkers, wlens = make_walkers_fast(reads, lens)
    p = align_params_from_reference(DIALS["default"])
    args = (torch.from_numpy(walkers), torch.from_numpy(wlens), p, 8, 334, 334)
    _assert_seeds_equal(sd.mmp_seed_device_plain(dfm, *args),
                        sd.mmp_seed_device_plain(cleared, *args))
