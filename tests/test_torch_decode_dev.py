"""The device decode of the engine's seeds
(``seeding_dev.decode_seeds_device``) against the host decode
(``seeding.decode_seeds``) on the same seeds and positions.

The host side is what the engine's device-seeding path computed before
the decode moved to the device: the flat seeds read back, the padded
walker ids remapped, ``decode_seeds`` over the located positions. Every
check is exact: each field, in order and dtype. This file imports no JAX,
so its ``card`` case also runs on a card:
``python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_dev.py``.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from megapath_tpu_torch.align import seeding_dev as sd
from megapath_tpu_torch.align.params import MmpParams
from megapath_tpu_torch.align.seeding import Seeds, decode_seeds
from megapath_tpu_torch.index import fm as tfm
from megapath_tpu_torch.index.pack import pack_fasta_file, pack_reads
from megapath_tpu_torch.io.fastq import read_fastx
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIX = pathlib.Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")
DEFAULT = MmpParams()
EXACT = dataclasses.replace(DEFAULT, kill_ratio=0.0, sibling_kill_steps=0)
FIELDS = ("read", "strand", "pos", "coverage")


def host_decode(flat: sd.FlatSeeds, pos: torch.Tensor, lens: np.ndarray, n: int,
                nb: int, mmp: MmpParams):
    """The flat seeds read back, walker rows nb.. remapped to n.., and
    ``decode_seeds`` over the located positions."""
    f = [t.cpu().numpy().astype(np.int64) for t in flat]
    ws = np.where(f[0] >= nb, f[0] - (nb - n), f[0])
    seeds = Seeds(walker=ws.astype(np.int32), offset=f[1].astype(np.int32),
                  length=f[2].astype(np.int32), sa_lo=f[3], sa_count=f[4].astype(np.int32))
    return decode_seeds(seeds, None, lens[:n], n, mmp,
                        pre_pos=pos.cpu().numpy().astype(np.int64))


def assert_same(got, want) -> None:
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def synthetic(seeds, n: int, nb: int, L: int = 100, lens=None, device=CPU):
    """FlatSeeds and positions from (walker, offset, length, [positions])
    tuples, one located row a position; sa_count is the positions'
    count. Returns (flat, pos, host lens [n], padded device lens [nb])."""
    cols = [[], [], [], [], []]
    pos = []
    for w, off, ln, ps in seeds:
        for c, v in zip(cols, (w, off, ln, 0, len(ps))):
            c.append(v)
        pos += list(ps)
    flat = sd.FlatSeeds(*[torch.tensor(c, dtype=torch.int32, device=device) for c in cols])
    lens = np.full(n, L, np.int32) if lens is None else np.asarray(lens, np.int32)
    lens_d = torch.zeros(nb, dtype=torch.int32, device=device)
    lens_d[:n] = torch.from_numpy(lens)
    return flat, torch.tensor(pos, dtype=torch.int32, device=device), lens, lens_d


def random_seeds(rng, n: int, nb: int, n_seeds: int, mmp: MmpParams, L: int = 150):
    """Seeds on every walker id the padded walk can give (a tenth on the
    pad walkers [n, nb)), offsets and lengths across the read, sa_count
    up to sa_size_threshold + 1, and positions packed close, so that
    starts tie, fall below 0 and chain within and just past indel_fuzz."""
    real = np.concatenate([np.arange(n), np.arange(nb, nb + n)])
    out = []
    for _ in range(n_seeds):
        w = int(rng.choice(real) if rng.random() < 0.9 else rng.integers(n, nb))
        ln = int(rng.integers(mmp.seed_min_length, L + 1))
        off = int(rng.integers(0, L - ln + 1))
        cnt = int(rng.choice([1, 1, 2, 3, mmp.sa_size_threshold + 1]))
        out.append((w, off, ln, rng.integers(0, 4 * L, cnt).tolist()))
    return out


F = DEFAULT.indel_fuzz
G = DEFAULT.good_seed_len
T = DEFAULT.sa_size_threshold
# (name, seeds, n reads, padded reads, read lengths or None, params)
CASES = {
    "no seeds": ([], 4, 512, None, DEFAULT),
    "one walker": ([(0, 0, 30, [500]), (0, 40, 20, [540, 900]), (0, 70, 17, [571])],
                   1, 512, None, DEFAULT),
    "negative starts": ([(2, 60, 30, [10, 59]), (2, 90, 20, [30]), (6, 10, 40, [3])],
                        4, 512, None, DEFAULT),
    "equal starts": ([(1, 0, 20, [100]), (1, 10, 25, [110]), (1, 30, 17, [130, 130]),
                      (5, 0, 30, [100]), (5, 5, 30, [105])], 4, 512, None, DEFAULT),
    # the second start of walker 0 is indel_fuzz past the anchor, the third
    # indel_fuzz + 1 (one past the second: an anchor chain, not a linkage)
    "fuzz apart": ([(0, 0, 20, [1000]), (0, 20, 20, [1020 + F]), (0, 40, 20, [1040 + F + 1]),
                    (3, 0, 30, [50]), (3, 30, 30, [80 + F + 1])], 2, 512, None, DEFAULT),
    "sa_count threshold + 1": ([(0, 0, 20, list(range(0, 40 * (T + 1), 40))),
                                (1, 0, G, list(range(7, 40 * (T + 1), 40))),
                                (2, 5, 20, [300])], 2, 512, None, DEFAULT),
    # unique only by rlen // 2: length 20 < good_seed_len, reads of 40
    "unique by rlen // 2": ([(0, 0, 20, list(range(0, 8 * 50, 50))),
                             (1, 0, 19, list(range(0, 8 * 50, 50)))],
                            1, 512, [40], DEFAULT),
    # coverage 20 against a best of 40 at ratio 0.5, 34 against 40 at 0.85
    # (in float64 0.85 * 40 == 34.0; the float32 ratio times 40 is above 34)
    "coverage at the ratio": ([(0, 0, 40, [100]), (0, 0, 20, [900]), (0, 0, 19, [2000])],
                              1, 512, None, DEFAULT),
    "coverage at 0.85": ([(0, 0, 40, [100]), (0, 0, 34, [900]), (0, 0, 33, [2000])],
                         1, 512, None, dataclasses.replace(DEFAULT, short_seed_ratio=0.85)),
    "pad walkers": ([(3, 0, 30, [100]), (7, 0, 30, [200]), (512 + 1, 0, 30, [300]),
                     (5, 0, 20, [400]), (600, 10, 25, [500])], 4, 512, None, DEFAULT),
}


@pytest.fixture(scope="module")
def world():
    """The soap4 fixture genome indexed by the port on the CPU, and its
    200 pairs' ends at width 80 (tests/test_torch_seeding.py's world)."""
    ref = pack_fasta_file(FIX / "align_genome.fa")
    fm = tfm.build_fm_index(ref.codes, sa_interval=8, lut_k=8, device=CPU)
    r1 = [r.seq for r in read_fastx(FIX / "align_r1.fq")]
    r2 = [r.seq for r in read_fastx(FIX / "align_r2.fq")]
    reads1, lens1 = pack_reads(r1, 80)
    reads2, lens2 = pack_reads(r2, 80)
    reads = np.concatenate([reads1, reads2])
    lens = np.concatenate([lens1, lens2]).astype(np.int32)
    return fm, reads, lens


def walk(dfm, reads: np.ndarray, lens: np.ndarray, mmp: MmpParams, device):
    """The engine's device-seeding leg on the reads padded to the 512
    bucket: (flat seeds, positions, padded lengths, padded count)."""
    n, L = reads.shape
    nb = 512 if n <= 512 else -(-n // 4096) * 4096
    pr = np.zeros((nb, L), np.uint8)
    pr[:n] = reads
    pl = np.zeros(nb, np.int32)
    pl[:n] = lens
    chg = 3 * L + 64
    max_seeds = int(min(16, max(4, L // 16 + 2)))
    lens_d = torch.from_numpy(pl).to(device)
    flat, pos = sd.device_seed_pipeline_loc(
        dfm, *sd.build_walkers(torch.from_numpy(pr).to(device), lens_d), mmp, max_seeds, chg,
        chg)
    return flat, pos, lens_d, nb


CASE_IDS = ["world default", "world exact"] + sorted(CASES) + [f"random {s}" for s in (1, 2, 3)]


@pytest.mark.parametrize("case", CASE_IDS)
def test_device_decode_equals_host_decode(world, case):
    if case.startswith("world"):
        fm, reads, lens = world
        mmp = EXACT if case.endswith("exact") else DEFAULT
        flat, pos, lens_d, nb = walk(sd.DeviceFM.from_host(fm, CPU), reads, lens, mmp, CPU)
        n = len(reads)
        assert len(pos) >= len(flat.walker) > 0
    elif case.startswith("random"):
        rng = np.random.default_rng(int(case.split()[1]))
        n, nb, mmp = 24, 512, DEFAULT
        flat, pos, lens, lens_d = synthetic(random_seeds(rng, n, nb, 400, mmp), n, nb, L=150)
    else:
        seeds, n, nb, rl, mmp = CASES[case]
        flat, pos, lens, lens_d = synthetic(seeds, n, nb, lens=rl)
    want = host_decode(flat, pos, lens, n, nb, mmp)
    rows0, kept0 = sd.decode_rows_device, sd.decode_kept_device
    got, kept = sd.decode_seeds_device(flat, pos, lens_d, n, nb, mmp)
    assert_same(got, want)
    # the same clusters stay on the device for the pairing
    assert kept.dtype == torch.int64 and kept.shape == (4, len(want.read))
    for row, f in zip(kept.numpy(), FIELDS):
        np.testing.assert_array_equal(row, getattr(want, f), err_msg=f)
    assert sd.decode_rows_device - rows0 == (len(pos) if len(flat.walker) else 0)
    assert sd.decode_kept_device - kept0 == len(want.read)
    if case.startswith("coverage"):
        # the cluster exactly at ratio * best is kept, the one below it not
        assert want.coverage.tolist() == ([40, 20] if case.endswith("ratio") else [40, 34])
    if case == "fuzz apart":
        assert want.pos.tolist() == [1000, 1000 + F + 1, 50, 50 + F + 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_device_decode_equals_host_decode_on_the_card(world, card):
    """The card's walk and locate kernels on the fixture world, and a
    synthetic draw of ~100,000 rows, decoded on the card and on the host."""
    fm, reads, lens = world
    for mmp in (DEFAULT, EXACT):
        flat, pos, lens_d, nb = walk(sd.DeviceFM.from_host(fm, card), reads, lens, mmp, card)
        want = host_decode(flat, pos, lens, len(reads), nb, mmp)
        assert len(want.read) > 0
        assert_same(sd.decode_seeds_device(flat, pos, lens_d, len(reads), nb, mmp)[0], want)
    rng = np.random.default_rng(7)
    n, nb = 4000, 4096
    flat, pos, hl, lens_d = synthetic(random_seeds(rng, n, nb, 20000, DEFAULT), n, nb, L=150,
                                      device=card)
    assert len(pos) > 50000
    want = host_decode(flat, pos, hl, n, nb, DEFAULT)
    assert_same(sd.decode_seeds_device(flat, pos, lens_d, n, nb, DEFAULT)[0], want)
