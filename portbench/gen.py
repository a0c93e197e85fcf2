"""Inputs drawn from the run's seed: the database text and the read pairs.

Everything is drawn on one torch device by one ``torch.Generator`` in a
few large calls, as ``uint8`` codes (A, C, G, T = 0..3), never through an
int64 array of the text's length. The same seed, device type and
parameters give the same inputs; only the arrays the program and the
reference take go to the host.

Database (a configuration's ``database`` group): ``n_random`` random
genomes of ``genome_bp`` and ``n_strains`` strains, each a copy of one of
them with ``strain_subst`` substitutions. The genomes fall into
``partitions`` equal partitions; partition k holds its share of the random
genomes and the strains of the previous partition's (k - 1 mod
partitions), so a strain never shares a partition with its original. A
configuration of S shards (S divides ``partitions``) gives shard s the
partitions s * P / S .. (s + 1) * P / S - 1, in order: every S aligns the
same text.

Traffic (a mix's file): pairs of ``read_len`` from fragments whose
insert is normal(``insert_mean``, ``insert_sd``) clipped to
[``insert_min``, ``insert_max``], read from either strand, with
``subst_rate`` substitutions a base on both reads. ``from_database`` of
the pairs come from the database's genomes, the count of each abundance
rank fixed by log-spaced abundance over ``abundance_orders`` orders of
magnitude and the kind of genome at each rank by a fixed pattern
(``rank_genomes``), so every seed gives the same work; the seed picks the
genome within its kind. The rest come evenly from ``absent_genomes`` more
genomes that no shard holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass
class Database:
    """The drawn genomes: ``text`` holds the database's genomes in order
    (shard 0's first), then the absent ones; ``shard_genomes[s]`` lists
    shard s's genome ids, ``strain_of[g]`` the original of strain g or -1."""

    text: torch.Tensor  # uint8 [(n_db + n_absent) * genome_bp] on the device
    genome_bp: int
    n_db: int
    n_absent: int
    shard_genomes: List[np.ndarray]
    strain_of: np.ndarray

    def shard_codes(self, s: int) -> np.ndarray:
        """Shard s's text on the host (its genomes are contiguous)."""
        g = self.shard_genomes[s]
        a, b = int(g[0]) * self.genome_bp, (int(g[-1]) + 1) * self.genome_bp
        return self.text[a:b].cpu().numpy()

    def names(self, s: int) -> List[str]:
        return [f"genome{int(g)}" for g in self.shard_genomes[s]]


@dataclass
class Batch:
    """One batch as the pipeline's stage 2 takes it: reads zero-padded to
    the configuration's ``max_read_len`` columns, int32 lengths."""

    reads1: np.ndarray
    lens1: np.ndarray
    reads2: np.ndarray
    lens2: np.ndarray

    @property
    def n(self) -> int:
        return len(self.lens1)


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def _substitute(codes: torch.Tensor, rate: float, g: torch.Generator) -> torch.Tensor:
    """``codes`` with each base changed to one of the other three with
    probability ``rate``."""
    hit = torch.rand(codes.shape, generator=g, device=codes.device) < rate
    shift = torch.randint(1, 4, codes.shape, generator=g, device=codes.device, dtype=torch.uint8)
    return torch.where(hit, (codes + shift) % 4, codes)


def draw_database(db: dict, shards: int, n_absent: int, g: torch.Generator,
                  device: torch.device) -> Database:
    """The database of a configuration's ``database`` group cut into
    ``shards``, and ``n_absent`` genomes beside it, drawn from ``g``."""
    gbp, n_rand, n_str, P = db["genome_bp"], db["n_random"], db["n_strains"], db["partitions"]
    if n_rand % P or n_str % P or P % shards:
        raise ValueError(f"{n_rand} random genomes and {n_str} strains do not split into "
                         f"{P} partitions over {shards} shards")
    rp, sp = n_rand // P, n_str // P
    if sp > rp:
        raise ValueError(f"{sp} strains a partition but only {rp} genomes to copy")
    n_db = n_rand + n_str
    rand = torch.randint(0, 4, ((n_rand + n_absent) * gbp,), generator=g, device=device,
                         dtype=torch.uint8)
    # which genomes of each partition get a strain (in the next partition)
    picks = [torch.randperm(rp, generator=g, device=device)[:sp].cpu().numpy() + k * rp
             for k in range(P)]
    originals = np.concatenate([picks[(k - 1) % P] for k in range(P)])
    strains = _substitute(rand.view(-1, gbp)[torch.as_tensor(originals, device=device)],
                          db["strain_subst"], g)
    text = torch.empty((n_db + n_absent) * gbp, dtype=torch.uint8, device=device)
    layout = text[: n_db * gbp].view(P, rp + sp, gbp)
    layout[:, :rp] = rand[: n_rand * gbp].view(P, rp, gbp)
    layout[:, rp:] = strains.view(P, sp, gbp)
    text[n_db * gbp:] = rand[n_rand * gbp:]
    del rand, strains
    strain_of = np.full(n_db, -1, np.int64)
    for k in range(P):
        for j in range(sp):
            o = int(originals[k * sp + j])
            strain_of[k * (rp + sp) + rp + j] = (o // rp) * (rp + sp) + o % rp
    per = (rp + sp) * (P // shards)
    shard_genomes = [np.arange(s * per, (s + 1) * per) for s in range(shards)]
    return Database(text, gbp, n_db, n_absent, shard_genomes, strain_of)


def pair_counts(mix: dict, n: int, n_db: int) -> np.ndarray:
    """Pairs a batch from each genome rank: database ranks first, by
    log-spaced abundance, then the absent genomes evenly. The same for
    every seed (largest remainders, ties to the lower rank)."""
    n_from_db = int(round(mix["from_database"] * n))
    w = np.logspace(0, -float(mix["abundance_orders"]), n_db)
    exact = n_from_db * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    extra = n_from_db - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:extra]] += 1
    n_abs = mix["absent_genomes"]
    rest = n - n_from_db
    absent = np.full(n_abs, rest // n_abs, np.int64)
    absent[: rest % n_abs] += 1
    return np.concatenate([counts, absent])


def rank_genomes(database: Database, g: torch.Generator) -> torch.Tensor:
    """The genome of each abundance rank: database ranks first, then the
    absent genomes. The kind of genome a rank gets follows a fixed
    pattern, so that every seed sends the same share of reads to two loci:
    an original that has a strain, a strain, then random genomes in their
    ratio to the originals, over and over. The seed picks the genome
    within its kind."""
    dev = database.text.device
    n_db = database.n_db
    strain = database.strain_of >= 0
    kind = np.full(n_db, 2)
    kind[strain] = 1
    kind[database.strain_of[strain]] = 0
    pools = []
    for k in (0, 1, 2):
        ids = np.flatnonzero(kind == k)
        pools.append(ids[torch.randperm(len(ids), generator=g, device=dev).cpu().numpy()])
    n0 = len(pools[0])
    r2 = len(pools[2]) // n0 if n0 else 0
    order = []
    for j in range(n0):
        order += [pools[0][j], pools[1][j], *pools[2][j * r2:(j + 1) * r2]]
    order += list(pools[2][n0 * r2:])
    return torch.cat([torch.as_tensor(np.array(order, np.int64), device=dev),
                      n_db + torch.arange(database.n_absent, device=dev)])


def draw_batches(mix: dict, database: Database, n: int, n_batches: int, max_read_len: int,
                 g: torch.Generator) -> List[Batch]:
    """``n_batches`` batches of ``n`` pairs of the mix from ``g``. The
    genome of each abundance rank is drawn once (``rank_genomes``: a
    sample's community); each batch draws its own fragments."""
    dev = database.text.device
    L, gbp = mix["read_len"], database.genome_bp
    if L > max_read_len:
        raise ValueError(f"reads of {L} past max_read_len {max_read_len}")
    counts = torch.as_tensor(pair_counts(mix, n, database.n_db), device=dev)
    genome_of_rank = rank_genomes(database, g)
    per_pair = torch.repeat_interleave(genome_of_rank, counts)
    cols = torch.arange(L, device=dev)
    out = []
    for _ in range(n_batches):
        genome = per_pair[torch.randperm(n, generator=g, device=dev)]
        ins = torch.randn(n, generator=g, device=dev) * mix["insert_sd"] + mix["insert_mean"]
        ins = ins.round().clamp(mix["insert_min"], mix["insert_max"]).to(torch.int64)
        start = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
                 * (gbp - ins + 1)).to(torch.int64).clamp_max(gbp - ins)
        start += genome * gbp
        flip = torch.rand(n, generator=g, device=dev) < 0.5
        head = database.text[start[:, None] + cols]  # the fragment's first L
        # the reverse complement of its last L (A, C, G, T = 0..3: complement 3 - c)
        tail = 3 - database.text[(start + ins - 1)[:, None] - cols]
        r1 = torch.where(flip[:, None], tail, head)
        r2 = torch.where(flip[:, None], head, tail)
        r1 = _substitute(r1, mix["subst_rate"], g)
        r2 = _substitute(r2, mix["subst_rate"], g)
        pad = torch.zeros((2, n, max_read_len), dtype=torch.uint8, device=dev)
        pad[0, :, :L] = r1
        pad[1, :, :L] = r2
        host = pad.cpu().numpy()
        lens = np.full(n, L, np.int32)
        out.append(Batch(host[0], lens, host[1], lens.copy()))
    return out
