"""The generators: the same data for a seed, other data for another, the
database's layout and the mix's counts."""

import numpy as np
import torch

from portbench import gen

CPU = torch.device("cpu")
DB = {"genome_bp": 5000, "n_random": 8, "n_strains": 4, "strain_subst": 0.02, "partitions": 4}
MIX = {"read_len": 150, "insert_mean": 350, "insert_sd": 50, "insert_min": 160,
       "insert_max": 750, "subst_rate": 0.005, "from_database": 0.9, "abundance_orders": 4,
       "absent_genomes": 2}


def draw(seed, shards=1, n=300, batches=2):
    g = gen.generator(seed, CPU)
    db = gen.draw_database(DB, shards, MIX["absent_genomes"], g, CPU)
    return db, gen.draw_batches(MIX, db, n, batches, 160, g)


def test_same_seed_same_data_other_seed_other_data():
    a_db, a = draw(2**31 + 12345)
    b_db, b = draw(2**31 + 12345)
    c_db, c = draw(7)
    assert torch.equal(a_db.text, b_db.text)
    assert all(np.array_equal(x.reads1, y.reads1) and np.array_equal(x.reads2, y.reads2)
               for x, y in zip(a, b))
    assert not torch.equal(a_db.text, c_db.text)
    assert not np.array_equal(a[0].reads1, c[0].reads1)
    assert not np.array_equal(a[0].reads1, a[1].reads1)  # the pool's batches differ


def test_uint8_codes_and_padding():
    db, pool = draw(3)
    assert db.text.dtype == torch.uint8 and int(db.text.max()) <= 3
    b = pool[0]
    assert b.reads1.dtype == np.uint8 and b.reads1.shape == (300, 160)
    assert (b.reads1[:, 150:] == 0).all() and (b.lens1 == 150).all() and b.lens2.dtype == np.int32


def test_every_shard_count_aligns_the_same_text_and_strains_change_shards():
    one, _ = draw(5, shards=1)
    four, _ = draw(5, shards=4)
    assert np.array_equal(one.shard_codes(0), np.concatenate([four.shard_codes(s) for s in range(4)]))
    shard_of = np.concatenate([np.full(len(g), s) for s, g in enumerate(four.shard_genomes)])
    strains = np.flatnonzero(four.strain_of >= 0)
    assert len(strains) == DB["n_strains"]
    assert (shard_of[strains] != shard_of[four.strain_of[strains]]).all()
    gbp = DB["genome_bp"]
    text = four.text.numpy()
    for s in strains:
        diff = (text[s * gbp:(s + 1) * gbp] != text[four.strain_of[s] * gbp:(four.strain_of[s] + 1) * gbp]).mean()
        assert 0.005 < diff < 0.05


def test_reads_come_from_their_fragments():
    db, pool = draw(11, n=400, batches=1)
    text = db.text.numpy()
    b = pool[0]
    comp = np.array([3, 2, 1, 0], np.uint8)
    # every read is, to within the substitution rate, a substring of a genome or its reverse complement
    hits = 0
    for i in range(40):
        r = b.reads1[i, :150]
        for seq in (text, comp[text[::-1]]):
            k = bytes(r[:20])
            if bytes(seq).find(k) >= 0:
                hits += 1
                break
    assert hits >= 30


def test_pair_counts_are_the_same_for_every_seed():
    c = gen.pair_counts(MIX, 100000, 128)
    assert c.sum() == 100000 and len(c) == 128 + 2
    assert c[:128].sum() == 90000 and (np.diff(c[:128]) <= 0).all()
    assert c[0] / max(c[127], 1) > 1000


def test_every_seed_sends_the_same_share_of_reads_to_two_loci():
    def kinds(seed):
        g = gen.generator(seed, CPU)
        db = gen.draw_database(DB, 1, MIX["absent_genomes"], g, CPU)
        order = gen.rank_genomes(db, g).numpy()
        strain = db.strain_of >= 0
        kind = np.full(db.n_db, 2)
        kind[strain] = 1
        kind[db.strain_of[strain]] = 0
        return order, np.concatenate([kind[order[: db.n_db]], order[db.n_db:]])

    (o1, k1), (o2, k2) = kinds(1), kinds(2)
    assert np.array_equal(k1, k2) and not np.array_equal(o1, o2)
    assert sorted(o1.tolist()) == list(range(len(o1)))
