"""The batch alignment engine: seed -> pair -> DP -> hits.

Port of ``megapath_tpu/align/engine.py``. It replaces soap4's per-batch
stage sequence (soap3_dp_pair_align, soap4/alignment.cpp:29-355): deep
DP on paired candidates, single-end DP for leftover reads, insert-window
mate rescue, and unpaired output. The DP of every stage runs on the
engine's torch device. Seeding runs on the host (numpy MMP walk and SA
locate, ``device_seeding=False``) or on the device (``seeding_dev``: the
walk and the locate as CUDA kernels on a card, the decode and the
insert-window pairing (``pairing_dev``) in torch ops where they ran,
``device_seeding=True``). On both, the DP gathers its candidate reads
from the pass's [reads; revcomp] walker matrix on the device and its
windows from the shard's packed text. The two paths follow the
reference's two paths and give its hits on each.

The engine never picks its device: ``device`` is required, and a CUDA
device with no CUDA present raises. A ``lazy_device`` engine holds
nothing on its device until ``commit()``, and its device calls raise until
then: the pipeline's wave rotation commits it, aligns and ``evict()``s
it, so a shard reaches the card only through the rotation.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from megapath_tpu_torch.align.device import (
    align_rows_walk,
    deep_dp_fused_walk,
    pack_ref_words,
)
from megapath_tpu_torch.align.pairing import Candidates, pair_candidates
from megapath_tpu_torch.align.pairing_dev import pair_candidates_device
from megapath_tpu_torch.align.params import AlignParams
from megapath_tpu_torch.align.seeding import (
    SeedPositions,
    decode_seeds,
    make_walkers_fast,
    mmp_seed,
)
from megapath_tpu_torch.align.seeding_dev import (
    DeviceFM,
    FlatSeeds,
    HostFM,
    build_walkers,
    decode_seeds_device,
    device_seed_pipeline_loc,
)
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import PackedReference
from megapath_tpu_torch.ops import _build
from megapath_tpu_torch.ops.dp import DPFullResult, DPParams
from megapath_tpu_torch.utils.timing import span

# the pairs ``_exact_rescue`` was given and those it re-ran through the
# exact walk, over every engine and batch (counted through ``_build.count``)
rescue_seen_pairs = 0
rescue_pairs = 0


@dataclass
class BatchHits:
    """Flat per-alignment hit table for one read-pair batch."""

    read: np.ndarray  # int32 pair index
    end: np.ndarray  # int8 0 = first mate, 1 = second
    seq: np.ndarray  # int32 reference sequence index
    score: np.ndarray  # int32 normalized score (paired => sum of ends)
    raw_score: np.ndarray  # int32 own-end DP score
    start: np.ndarray  # int64 text start (global coords)
    stop: np.ndarray  # int64 text end (exclusive)
    strand: np.ndarray  # int8 0=+, 1=-
    paired: np.ndarray  # bool properly paired on same sequence

    @classmethod
    def empty(cls) -> "BatchHits":
        z = np.zeros(0)
        i32, i8, i64 = z.astype(np.int32), z.astype(np.int8), z.astype(np.int64)
        return cls(i32, i8, i32.copy(), i32.copy(), i32.copy(), i64, i64.copy(), i8.copy(), z.astype(bool))

    @classmethod
    def concat(cls, parts: List["BatchHits"]) -> "BatchHits":
        parts = [p for p in parts if len(p.read)]
        if not parts:
            return cls.empty()
        return cls(*[np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)])

    def __len__(self) -> int:
        return len(self.read)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _concat_sp(parts: List[SeedPositions]) -> SeedPositions:
    parts = [p for p in parts if len(p.read)]
    if not parts:
        z = np.zeros(0)
        return SeedPositions(
            z.astype(np.int32), z.astype(np.int8), z.astype(np.int64),
            z.astype(np.int32),
        )
    if len(parts) == 1:
        return parts[0]
    return SeedPositions(
        *[np.concatenate([getattr(p, f) for p in parts])
          for f in ("read", "strand", "pos", "coverage")]
    )


def _bucket(n: int) -> int:
    """Round DP batch sizes up: powers of two to 4096, then a 4096 grain
    (the reference's compile-cache buckets; the kernel takes any size,
    the buckets keep the port's batches equal to the reference's)."""
    if n <= 256:
        return 256
    if n <= 4096:
        b = 256
        while b < n:
            b *= 2
        return b
    return _round_up(n, 4096)


def _pad_rows(a: np.ndarray, nb: int, dtype=None) -> np.ndarray:
    """Zero-pad the first axis of ``a`` to ``nb`` rows."""
    a = a if dtype is None else a.astype(dtype)
    if len(a) == nb:
        return a
    pad = np.zeros((nb - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


class _BatchDev(NamedTuple):
    """Read ends on the device, as the walk takes them and the DP gathers
    them: row i of ``walkers`` is the forward read end i, row nb + i its
    reverse complement, and ``lens`` holds each row's length."""

    walkers: torch.Tensor  # uint8 [2*nb, L]
    lens: torch.Tensor  # int32 [2*nb]
    nb: int


class _SeedsDev(NamedTuple):
    """A device-seeding call's kept clusters as they lie on the device
    (``decode_seeds_device``'s int64 [4, K] rows) and the seeded read
    ends' padded lengths, for the pairing of the same round."""

    kept: torch.Tensor
    lens: torch.Tensor


class AlignEngine:
    """One NT-shard aligner instance on one torch device."""

    def __init__(
        self,
        ref: PackedReference,
        fm: FMIndex,
        params: AlignParams,
        device: torch.device,
        device_seeding: bool = False,
        lazy_device: bool = False,
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"AlignEngine on {device}: CUDA is not available")
        self.ref = ref
        self.fm = fm
        self.params = params
        self.device = device
        self._device_seeding = device_seeding
        self.dfm: Optional[DeviceFM] = None
        self._ref_words_dev: Optional[torch.Tensor] = None  # packed text
        # reference-exact rescue (see _exact_rescue): pairs ending with a
        # zero-hit end re-run through the undialed walk; junk-heavy
        # streams flip to the direct exact walk
        self.exact_rescue: bool = True
        self._exact_direct = False
        # a lazy engine is re-committed every batch: it keeps what its
        # first commit packed on the host (HostFM, the packed text words)
        # so that a re-commit is an upload
        self.lazy_device = lazy_device
        self._host_fm: Optional[HostFM] = None
        self._host_words: Optional[np.ndarray] = None
        if not lazy_device:
            self.commit()

    def commit(self, dfm: Optional[DeviceFM] = None,
               ref_words: Optional[torch.Tensor] = None) -> None:
        """Put this shard's packed text, and on device seeding its FM
        tables, on the engine's device, once. ``dfm`` and ``ref_words``,
        tables of this shard already on the engine's device (the
        one-program grid's), are held instead of a copy of the engine's
        own."""
        if dfm is not None:
            self.dfm = dfm
        if ref_words is not None:
            self._ref_words_dev = ref_words
        if self._ref_words_dev is None:
            words = self._host_words
            if words is None:
                words = pack_ref_words(self.ref.codes).view(np.int32)
                if self.lazy_device:
                    self._host_words = words
            self._ref_words_dev = self._to_dev(words)
        if self._device_seeding and self.dfm is None:
            host = self._host_fm or HostFM.pack(self.fm)
            if self.lazy_device:
                self._host_fm = host
            self.dfm = host.upload(self.device)

    def evict(self) -> None:
        """Drop the shard's device copies (the host copies stay); the next
        commit() puts them back. The cross-batch state (``exact_rescue``,
        the direct exact walk) stays, as the reference's evict keeps it."""
        self.dfm = None
        self._ref_words_dev = None

    @property
    def committed(self) -> bool:
        return self._ref_words_dev is not None and (
            self.dfm is not None or not self._device_seeding
        )

    def _require_committed(self) -> None:
        """Commit a non-lazy engine that was evicted; a lazy engine that is
        not committed raises (only the rotation puts its shard on the
        device)."""
        if self.committed:
            return
        if self.lazy_device:
            raise RuntimeError(
                f"lazy AlignEngine on {self.device} is not committed: commit() it "
                "before aligning (MegaPathPipeline's wave rotation does)"
            )
        self.commit()

    # ------------------------------------------------------------------
    def seed_positions(
        self, reads: np.ndarray, lens: np.ndarray, mmp=None,
    ) -> SeedPositions:
        """MMP walk + locate + decode, on the device when the engine
        seeds there (only the kept clusters come back), else on the host.
        ``mmp`` overrides the seeding parameters for one call (deep-DP
        rounds past the first re-seed with their own MmpParams,
        alignment.cpp:91-137)."""
        return self._seed(reads, lens, mmp)[0]

    def _seed(
        self, reads: np.ndarray, lens: np.ndarray, mmp=None,
        walk: Optional[_BatchDev] = None,
    ) -> Tuple[SeedPositions, Optional[_SeedsDev]]:
        """``seed_positions``, and on device seeding the kept clusters
        where the decode left them (None on host seeding). ``walk``, the
        reads' walker matrix when it is already on the device, spares
        its upload and build."""
        mmp = mmp or self.params.mmp
        if self._device_seeding:
            self._require_committed()
            if walk is None:
                walk = self._walkers(reads, lens)
            flat, pos = self._device_seeds_pos(walk, mmp)
            lens_d = walk.lens[: walk.nb]
            sp, kept = decode_seeds_device(flat, pos, lens_d, len(reads), walk.nb, mmp)
            return sp, _SeedsDev(kept, lens_d)
        walkers, wlens = make_walkers_fast(reads, lens)
        seeds = mmp_seed(walkers, wlens, self.fm, mmp)
        return decode_seeds(seeds, self.fm, lens, len(reads), mmp), None

    def _walkers(self, reads: np.ndarray, lens: np.ndarray) -> _BatchDev:
        """Upload the read ends, padded as the reference pads its walkers
        (a 512 bucket for small batches, exact-rescue subsets, a 4096
        grain above), and build their [reads; revcomp] matrix there."""
        N = len(reads)
        nb = 512 if N <= 512 else _round_up(N, 4096)
        walkers, wlens = build_walkers(
            self._to_dev(_pad_rows(reads, nb)),
            self._to_dev(_pad_rows(lens, nb, np.int32)),
        )
        return _BatchDev(walkers, wlens, nb)

    def _device_seeds_pos(
        self, walk: _BatchDev, mmp
    ) -> Tuple[FlatSeeds, torch.Tensor]:
        """The device walk over ``walk``'s rows and the locate of every
        seed's SA rows (``engine.py:322-504, 636-681``, unsegmented and
        unstaged). Returns, on the device, the seeds in the flat order the
        reference pulls them in (walker ids of the padded batch) and the
        text position of every expanded SA row."""
        L = walk.walkers.shape[1]
        # each emitted seed advances the cursor >= seed_min_length - 1
        # chars, so L/16+2 slots bound the per-walker seed count
        max_seeds = int(min(16, max(4, L // 16 + 2)))
        # the charged walk bound; one thread per read end has no stall
        # iterations, so the iteration bound is the same number
        charge_limit = 3 * L + 64
        return device_seed_pipeline_loc(
            self.dfm, walk.walkers, walk.lens, mmp,
            max_seeds, charge_limit, charge_limit,
        )

    def _dp_params(self) -> DPParams:
        p = self.params
        return DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_rows(self, *cols: np.ndarray) -> List[torch.Tensor]:
        """int32 columns of one DP call, zero-padded to its bucket, on the
        device."""
        nb = _bucket(len(cols[0]))
        return [self._to_dev(_pad_rows(c, nb, np.int32)) for c in cols]

    @staticmethod
    def _pull(n: int, *outs: DPFullResult) -> Tuple[np.ndarray, ...]:
        """(score, start_ref, end_ref) of each result's first ``n`` rows,
        as int64, in one read-back."""
        res = torch.stack(
            [f for o in outs for f in (o.score, o.start_ref, o.end_ref)]
        ).cpu().numpy()
        return tuple(r[:n].astype(np.int64) for r in res)

    def _deep_dp_walk_call(
        self, bd: _BatchDev, l_idx, l_starts, l_wl, r_idx, r_starts,
        r_full_wl, width,
    ):
        """Bucket-pad the index and start arrays, run deep_dp_fused_walk
        against the pass's walker matrix, pull the six results at once."""
        left, right = deep_dp_fused_walk(
            self._ref_words_dev, len(self.ref.codes), bd.walkers, bd.lens, bd.nb,
            *self._upload_rows(
                l_idx, l_starts, np.clip(l_wl, 0, width),
                r_idx, r_starts, np.clip(r_full_wl, 0, width),
            ),
            width, int(self.params.insert_high), params=self._dp_params(),
        )
        return self._pull(len(l_idx), left, right)

    def _device_align_rows(
        self, bd: _BatchDev, rows: np.ndarray, lens: np.ndarray,
        win_starts: np.ndarray, width: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gather + forward DP + backward DP against the pass's walker
        matrix and the packed text (single-end and mate-rescue legs);
        ``rows`` are walker rows (read index + strand * nb). Returns numpy
        (score, start_ref, end_ref) in one pull."""
        rows_d, lens_d, starts_d = self._upload_rows(rows, lens, win_starts)
        out = align_rows_walk(
            self._ref_words_dev, len(self.ref.codes), bd.walkers,
            rows_d, lens_d, starts_d, torch.full_like(rows_d, width), width,
            params=self._dp_params(),
        )
        return self._pull(len(rows), out)

    # ------------------------------------------------------------------
    def align_pairs(
        self,
        reads1: np.ndarray,
        lens1: np.ndarray,
        reads2: np.ndarray,
        lens2: np.ndarray,
    ) -> BatchHits:
        """Full batch alignment of read pairs, then the exact rescue of
        pairs left with a zero-hit end."""
        n = len(reads1)
        if self.exact_rescue and self._exact_direct:
            # junk-heavy stream (measured on previous batches): the
            # dialed pass + near-full rescue would cost ~1.4x running
            # the exact walk outright — run exact directly, and demote
            # back when the stream turns matching-heavy again
            hits = self._run_exact(reads1, lens1, reads2, lens2)
            if len(lens1):
                have = np.zeros((2, n), bool)
                if len(hits):
                    have[hits.end, hits.read] = True
                nohit = float((~(have[0] & have[1])).sum()) / n
                if nohit < 0.3:
                    self._exact_direct = False
            return hits
        hits = self._align_pairs_impl(reads1, lens1, reads2, lens2)
        if self.exact_rescue:
            hits = self._exact_rescue(hits, reads1, lens1, reads2, lens2)
        return hits

    def _exact_params(self) -> AlignParams:
        """self.params with every walk-truncation dial disabled."""
        p = self.params
        ex = lambda m: dataclasses.replace(m, kill_ratio=0.0, sibling_kill_steps=0)
        return p.with_(
            mmp=ex(p.mmp),
            extra_rounds=tuple(ex(m) for m in p.extra_rounds),
        )

    def _run_exact(self, reads1, lens1, reads2, lens2) -> BatchHits:
        old = self.params
        self.params = self._exact_params()
        try:
            return self._align_pairs_impl(reads1, lens1, reads2, lens2)
        finally:
            self.params = old

    def _exact_rescue(
        self, hits: BatchHits, reads1, lens1, reads2, lens2
    ) -> BatchHits:
        """Reference-exact results at dialed-walk speed.

        The progress-kill/sibling dials only ever LOSE hits, and every
        lost hit surfaces as a zero-hit read end. So: re-run just the
        pairs that ended with a zero-hit end through the undialed walk
        and splice the results in. When the rescue set exceeds half the
        batch (junk-heavy shard), later batches switch to the direct
        exact walk instead of paying the double pass (see align_pairs)."""
        p = self.params
        dialed = any(
            m.kill_ratio > 0 or getattr(m, "sibling_kill_steps", 0) > 0
            for m in p.seeding_rounds
        )
        n = len(reads1)
        if not dialed or not n:
            return hits
        with span("align.rescue"):
            with span("align.rescue.select"):
                have = np.zeros((2, n), bool)
                if len(hits):
                    have[hits.end, hits.read] = True
                needy = np.flatnonzero(~(have[0] & have[1]))
                _build.count(sys.modules[__name__], "rescue_seen_pairs", n)
                if len(needy) == 0:
                    return hits
                _build.count(sys.modules[__name__], "rescue_pairs", len(needy))
                if len(needy) > n // 2:
                    self._exact_direct = True
                rows = (reads1[needy], lens1[needy], reads2[needy], lens2[needy])
            sub = self._run_exact(*rows)
            with span("align.rescue.splice"):
                keep = (
                    ~np.isin(hits.read, needy) if len(hits) else
                    np.zeros(0, bool)
                )
                old = BatchHits(
                    *[getattr(hits, f.name)[keep] for f in dataclasses.fields(BatchHits)]
                )
                if len(sub):
                    sub.read[:] = needy[sub.read]
                return BatchHits.concat([old, sub])

    def _align_pairs_impl(
        self,
        reads1: np.ndarray,
        lens1: np.ndarray,
        reads2: np.ndarray,
        lens2: np.ndarray,
    ) -> BatchHits:
        params = self.params
        n = len(reads1)
        self._require_committed()
        # the spans align.pass.* name the parts of this pass; under the
        # exact rescue they sit inside its align.rescue
        with span("align.pass.seed"):
            L = max(reads1.shape[1], reads2.shape[1])
            allr = np.zeros((2 * n, L), dtype=np.uint8)
            allr[:n, : reads1.shape[1]] = reads1
            allr[n:, : reads2.shape[1]] = reads2
            all_lens = np.concatenate([lens1, lens2]).astype(np.int32)
            # the pass's read ends on the device: the first round walks
            # them, and every round's DP gathers its reads from them
            bd = self._walkers(allr, all_lens)

        # deep-DP rounds (alignment.cpp:91-137): round r re-seeds only
        # the still-unaligned pairs with that round's MmpParams. Seeds
        # accumulate across rounds for the single-end stage, mirroring
        # the reference SeedPool reuse (SeedPool.h:80-127).
        hits_parts: List[BatchHits] = []
        sp1_parts: List[SeedPositions] = []
        sp2_parts: List[SeedPositions] = []
        todo = np.arange(n)
        for mmp in params.seeding_rounds:
            if len(todo) == 0:
                break
            t = len(todo)
            with span("align.pass.seed"):
                if t == n:
                    sp, sdev = self._seed(allr, all_lens, mmp, bd)
                else:
                    sel = np.concatenate([todo, todo + n])
                    sp, sdev = self._seed(allr[sel], all_lens[sel], mmp)
                m1 = sp.read < t
                sp1 = SeedPositions(
                    todo[sp.read[m1]].astype(np.int32),
                    sp.strand[m1], sp.pos[m1], sp.coverage[m1],
                )
                m2 = ~m1
                sp2 = SeedPositions(
                    todo[sp.read[m2] - t].astype(np.int32),
                    sp.strand[m2], sp.pos[m2], sp.coverage[m2],
                )
            sp1_parts.append(sp1)
            sp2_parts.append(sp2)

            with span("align.pass.pair"):
                if sdev is None:
                    cands = pair_candidates(sp1, sp2, lens1, lens2, params)
                else:
                    # the clusters' read ends are this round's: pair i is todo[i]
                    cands = pair_candidates_device(
                        *sdev.kept[:3], sdev.lens, t, params,
                        None if t == n else self._to_dev(todo),
                    )
            with span("align.pass.deep_dp"):
                paired_hits, aligned_pairs = self._deep_dp(cands, bd, all_lens, n)
                hits_parts.append(paired_hits)
                todo = np.setdiff1d(todo, aligned_pairs)

        # leftover pairs -> single-end DP + mate rescue + unpaired
        if len(todo):
            with span("align.pass.single"):
                hits_parts.append(
                    self._single_and_rescue(
                        todo, _concat_sp(sp1_parts), _concat_sp(sp2_parts),
                        bd, all_lens, n,
                    )
                )
        with span("align.pass.splice"):
            return BatchHits.concat(hits_parts)

    # ------------------------------------------------------------------
    def _deep_dp(
        self,
        cands: Candidates,
        bd: _BatchDev,
        all_lens: np.ndarray,
        n: int,
    ) -> Tuple[BatchHits, np.ndarray]:
        params = self.params
        C = len(cands)
        if C == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)

        # left leg: + strand; right leg: - strand (revcomp'd read)
        left_read_idx = np.where(cands.left_is_read2, cands.pair + n, cands.pair)
        right_read_idx = np.where(cands.left_is_read2, cands.pair, cands.pair + n)
        lL = all_lens[left_read_idx]
        lR = all_lens[right_read_idx]
        margin_l = np.where(lL > 100, 30, 25)
        margin_r = np.where(lR > 100, 30, 25)

        Lmax = int(all_lens.max(initial=1))
        Wwin = _round_up(Lmax + 2 * 30 + 2, 64)

        # BOTH legs in one device call: the left-hit position clips the
        # right window on the device (leftHit + insert_high,
        # DV-DPfunctions.cpp:2933-2959). The left threshold gates the
        # OUTPUT below — kept hits are identical to the reference's
        # two-phase flow.
        starts_l = cands.left_pos - margin_l
        starts_r_all = cands.right_pos - margin_r
        # the candidate reads are rows of the pass's [reads; revcomp]
        # matrix on the device; the host ships index arrays only
        s1, st_l, e_l, s2a, st_ra, e_ra = self._deep_dp_walk_call(
            bd, left_read_idx, starts_l, (lL + 2 * margin_l),
            right_read_idx, starts_r_all, (lR + 2 * margin_r), Wwin,
        )
        thr_l = np.maximum((params.cutoff_ratio * lL).astype(np.int64),
                           params.cutoff_lower_bound)
        kidx0 = np.flatnonzero(s1 >= thr_l)
        if len(kidx0) == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)

        starts_r = starts_r_all[kidx0]
        lRk = lR[kidx0]
        s2, st_r, e_r = s2a[kidx0], st_ra[kidx0], e_ra[kidx0]
        thr_r = np.maximum((params.cutoff_ratio * lRk).astype(np.int64),
                           params.cutoff_lower_bound)
        sub = np.flatnonzero(s2 >= thr_r)
        if len(sub) == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)
        kidx = kidx0[sub]
        K = len(kidx)

        sr = np.concatenate([s1[kidx], s2[sub]])
        g_start = np.concatenate(
            [starts_l[kidx] + st_l[kidx], starts_r[sub] + st_r[sub]]
        )
        g_stop = np.concatenate(
            [starts_l[kidx] + e_l[kidx], starts_r[sub] + e_r[sub]]
        )
        seq_s = self.ref.seq_of_pos(g_start)
        seq_e = self.ref.seq_of_pos(np.maximum(g_stop - 1, g_start))
        ok_bound = (seq_s == seq_e) & (g_start >= 0)
        seq_idx = seq_s.astype(np.int32)

        # layout: first K rows = left legs of kept cands, next K = right
        pair_idx = cands.pair[kidx]
        flip = cands.left_is_read2[kidx]
        end_of = np.concatenate([np.where(flip, 1, 0), np.where(flip, 0, 1)]).astype(np.int8)
        strand = np.concatenate([np.zeros(K, np.int8), np.ones(K, np.int8)])
        read_col = np.concatenate([pair_idx, pair_idx]).astype(np.int32)
        raw = sr.astype(np.int32)

        # normalizeScore (BGS-IO.cpp:1949-1963): same-seq both-valid
        # pairs get the summed score on both ends
        same = ok_bound[:K] & ok_bound[K:] & (seq_idx[:K] == seq_idx[K:])
        summed = raw[:K] + raw[K:]
        norm = raw.copy()
        norm[:K] = np.where(same, summed, raw[:K])
        norm[K:] = np.where(same, summed, raw[K:])
        paired = np.concatenate([same, same])

        keep_rows = ok_bound
        hits = BatchHits(
            read=read_col[keep_rows],
            end=end_of[keep_rows],
            seq=seq_idx[keep_rows],
            score=norm[keep_rows],
            raw_score=raw[keep_rows],
            start=g_start[keep_rows],
            stop=g_stop[keep_rows],
            strand=strand[keep_rows],
            paired=paired[keep_rows],
        )
        aligned = np.unique(pair_idx)
        return hits, aligned

    # ------------------------------------------------------------------
    def _single_and_rescue(
        self,
        todo: np.ndarray,
        sp1: SeedPositions,
        sp2: SeedPositions,
        bd: _BatchDev,
        all_lens: np.ndarray,
        n: int,
    ) -> BatchHits:
        """Single-end DP on leftover reads' seed positions, then mate
        rescue within the insert window (alignment.cpp:141-296 flow)."""
        params = self.params
        todo_set = np.zeros(n, dtype=bool)
        todo_set[todo] = True

        recs: List[BatchHits] = []
        singles: List[np.ndarray] = []
        # rows of (pair, end, strand, g_start, g_stop, score, seq)

        # both ends in one device call
        m1 = todo_set[sp1.read]
        m2 = todo_set[sp2.read]
        pair_b = np.concatenate([sp1.read[m1], sp2.read[m2]])
        end_b = np.concatenate(
            [np.zeros(int(m1.sum()), np.int8), np.ones(int(m2.sum()), np.int8)]
        )
        strand_b = np.concatenate([sp1.strand[m1], sp2.strand[m2]])
        pos_b = np.concatenate([sp1.pos[m1], sp2.pos[m2]])
        if len(pair_b):
            # cap at max_se_candidates per read end: the reference keeps
            # the first 200 clustered candidates per readID after the
            # (readID, pos) sort (DV-DPForSingleReads.cpp:191-205)
            order = np.lexsort((pos_b, strand_b, end_b, pair_b))
            pair_b, end_b, strand_b, pos_b = (
                pair_b[order], end_b[order], strand_b[order], pos_b[order]
            )
            new_grp = np.r_[
                True, (pair_b[1:] != pair_b[:-1]) | (end_b[1:] != end_b[:-1])
            ]
            first_of = np.flatnonzero(new_grp)
            gid = np.cumsum(new_grp) - 1
            rank = np.arange(len(gid)) - first_of[gid]
            keep = rank < params.max_se_candidates
            pair_b, end_b, strand_b, pos_b = (
                pair_b[keep], end_b[keep], strand_b[keep], pos_b[keep]
            )
        if len(pair_b):
            reads_idx = pair_b.astype(np.int64) + end_b.astype(np.int64) * n
            rl = all_lens[reads_idx]
            margin = np.where(rl > 100, 30, 25)
            Wwin = _round_up(int(rl.max(initial=1)) + 62, 64)
            wstart = pos_b - margin
            # the oriented read is a walker row (fwd idx, rc nb + idx)
            score, st_ref, e_ref = self._device_align_rows(
                bd, reads_idx + strand_b.astype(np.int64) * bd.nb, rl,
                wstart, Wwin,
            )
            thr = np.maximum((params.cutoff_ratio * rl).astype(np.int64),
                             params.cutoff_lower_bound)
            kidx = np.flatnonzero(score >= thr)
            if len(kidx):
                g_start = wstart[kidx] + st_ref[kidx]
                g_stop = wstart[kidx] + e_ref[kidx]
                seq_s = self.ref.seq_of_pos(g_start)
                seq_e = self.ref.seq_of_pos(np.maximum(g_stop - 1, g_start))
                ok = (seq_s == seq_e) & (g_start >= 0)
                tt = np.flatnonzero(ok)
                sel = kidx[tt]
                singles.append(np.stack(
                    [pair_b[sel], end_b[sel], strand_b[sel],
                     g_start[tt], g_stop[tt], score[sel], seq_s[tt]],
                    axis=1,
                ).astype(np.int64))

        singles = (
            np.concatenate(singles) if singles else np.zeros((0, 7), np.int64)
        )
        if not len(singles):
            return BatchHits.empty()

        # mate rescue: DP the other end inside the insert window
        mate_hits, rescued_rows, rescued_sums = self._mate_rescue(
            singles, bd, all_lens, n
        )

        # anchor records; rescued anchors get the summed pair score
        # (normalizeScore applies to both ends, BGS-IO.cpp:1949-1963)
        arr = singles
        a_score = arr[:, 5].astype(np.int32)
        a_paired = np.zeros(len(arr), dtype=bool)
        norm = a_score.copy()
        if len(rescued_rows):
            np.maximum.at(
                norm, np.asarray(rescued_rows), np.asarray(rescued_sums)
            )
            a_paired[np.asarray(rescued_rows)] = True
        unpaired = BatchHits(
            read=arr[:, 0].astype(np.int32),
            end=arr[:, 1].astype(np.int8),
            seq=arr[:, 6].astype(np.int32),
            score=norm,
            raw_score=a_score,
            start=arr[:, 3],
            stop=arr[:, 4],
            strand=arr[:, 2].astype(np.int8),
            paired=a_paired,
        )
        recs.append(unpaired)
        recs.append(mate_hits)
        return BatchHits.concat(recs)

    def _mate_rescue(
        self,
        anchors: np.ndarray,  # int64 [A, 7] rows from _single_and_rescue
        bd: _BatchDev,
        all_lens: np.ndarray,
        n: int,
    ):
        """DP the mate of each passing single-end hit within the insert
        window (DV-SemiDP.cpp semantics: anchor one end, scan the other).

        Returns (mate hits, rescued anchor rows, summed scores)."""
        params = self.params
        if not len(anchors):
            return BatchHits.empty(), [], []
        arr = np.asarray(anchors, dtype=np.int64)
        pair, end, strand = arr[:, 0], arr[:, 1], arr[:, 2]
        g_start, g_stop, a_score = arr[:, 3], arr[:, 4], arr[:, 5]

        mate_idx = (pair + (1 - end) * n).astype(np.int64)
        ml = all_lens[mate_idx]
        margin = np.where(ml > 100, 30, 25)
        # anchor +: mate is - downstream; anchor -: mate is + upstream
        W = _round_up(int(params.insert_high + ml.max(initial=1) + 62), 128)
        win_start = np.where(
            strand == 0, g_start - margin, g_stop - params.insert_high - margin
        )
        mate_strand = 1 - strand
        score, st_ref, e_ref = self._device_align_rows(
            bd, mate_idx + mate_strand * bd.nb, ml, win_start, W
        )
        thr = np.maximum((params.cutoff_ratio * ml).astype(np.int64),
                         params.cutoff_lower_bound)
        kidx = np.flatnonzero(score >= thr)
        if len(kidx) == 0:
            return BatchHits.empty(), [], []
        m_start = win_start[kidx] + st_ref[kidx]
        m_stop = win_start[kidx] + e_ref[kidx]
        seq_s = self.ref.seq_of_pos(m_start)
        seq_e = self.ref.seq_of_pos(np.maximum(m_stop - 1, m_start))
        ok = (seq_s == seq_e) & (m_start >= 0)
        t = kidx[np.flatnonzero(ok)]
        tt = np.flatnonzero(ok)

        anchor_seq = self.ref.seq_of_pos(g_start[t])
        same = anchor_seq == seq_s[tt]
        mate_score = score[t]
        summed = np.where(same, mate_score + a_score[t], mate_score)
        hits = BatchHits(
            read=pair[t].astype(np.int32),
            end=(1 - end[t]).astype(np.int8),
            seq=seq_s[tt].astype(np.int32),
            score=summed.astype(np.int32),
            raw_score=mate_score.astype(np.int32),
            start=m_start[tt],
            stop=m_stop[tt],
            strand=mate_strand[t].astype(np.int8),
            paired=same,
        )
        return hits, t[same], summed[same].astype(np.int32)
