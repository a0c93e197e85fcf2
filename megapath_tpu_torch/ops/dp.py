"""Batched affine-gap local DP: the plain PyTorch versions and the dispatch.

Port of ``megapath_tpu/ops/dp.py``. The scoring contract is the same:
match +1, mismatch -2, gap open -3 for the first gap base, extend -1 per
further base, floor 0. Within one read column the vertical gap chain
E[i] = max(E[i-1]+ge, H[i-1]+go) may use H *without* its E term, because
go <= ge makes re-opening from a gap cell never optimal; E is then a
prefix max of (H_noE[i] + go - i*ge) and the column has no sequential
dependency.

``sw_align`` and ``sw_align_full`` are the plain versions: the CPU tests
run them, and ``chip_smoke.py`` holds the CUDA kernels against them.
``sw_align_full_auto`` (forward + backward, what the engine calls) and
``sw_align_auto`` (forward only, what ``align_step`` calls) decide by
the tensors' device: the plain version for CPU tensors, the hand-written
kernel (``ops/dp_cuda.py``) for CUDA tensors, and never one in place of
the other. The protein path's DP is the same recurrence under a
substitution matrix: ``sw_align_substmat`` is its plain version and
``sw_align_protein`` (BLOSUM62, what ``blastx`` calls) decides the same
way, the kernel being ``ops/protein_cuda.py``'s.

``sw_traceback``, ``sw_traceback_ops`` and ``sw_traceback_batch`` are the
reference's host numpy tracebacks (the CIGARs of the SAM/BAM sink),
copied as they are: they run only on reported hits, on the host, in the
same tie order with the same direction-plane bits and 256 MB chunks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -(10**6)  # -inf surrogate that survives int32 adds
OFF_TEXT_CODE = 4  # a window cell past the text: never equals a read code


class DPParams(NamedTuple):
    match: int = 1
    mismatch: int = -2
    gap_open: int = -3  # first gap base
    gap_extend: int = -1


class DPResult(NamedTuple):
    score: torch.Tensor  # int32 [B] best local score
    end_ref: torch.Tensor  # int32 [B] ref index AFTER the last aligned base
    end_read: torch.Tensor  # int32 [B] read index AFTER the last aligned base


class DPFullResult(NamedTuple):
    score: torch.Tensor  # int32 [B]
    end_ref: torch.Tensor  # int32 [B] exclusive
    end_read: torch.Tensor  # int32 [B] exclusive
    start_ref: torch.Tensor  # int32 [B]
    start_read: torch.Tensor  # int32 [B]


def sw_align(
    reads: torch.Tensor,  # uint8/int32 [B, R] read codes
    refs: torch.Tensor,  # uint8/int32 [B, W] ref window codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    params: DPParams = DPParams(),
) -> DPResult:
    """Plain forward pass: score and exclusive end cell per candidate.

    Columns ``j >= read_len`` leave H and F untouched; rows
    ``>= ref_len`` are computed but never chosen. Ties go to the lowest
    ref row within a column and to the earliest column across columns.
    """
    refs = refs.to(torch.int32)
    reads = reads.to(torch.int32)
    dev = reads.device
    match = torch.tensor(params.match, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(params.mismatch, dtype=torch.int32, device=dev)
    return _forward_scan(
        lambda j: torch.where(refs == reads[:, j : j + 1], match, mismatch),
        reads.shape[1], refs.shape, read_lens, ref_lens, params, dev,
    )


def _forward_scan(sub_at, n_cols: int, shape, read_lens, ref_lens,
                  params: DPParams, dev) -> DPResult:
    """The forward recurrence of ``sw_align`` over read columns ``0 ..
    n_cols - 1``, ``sub_at(j)`` giving column j's int32 [B, W]
    substitution scores (``shape`` = (B, W))."""
    B, W = shape
    go, ge = params.gap_open, params.gap_extend
    read_lens = read_lens.to(torch.int32)
    row = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    row_valid = row < ref_lens.to(torch.int32)[:, None]
    decay = row * ge
    # packed (score, row) key: one max gives the best score and, among
    # equal scores, the lowest row
    K = 1 << max(W - 1, 1).bit_length()
    row_key = (K - 1 - row).to(torch.int64)

    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    Fg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    best_i = torch.zeros_like(best)
    best_j = torch.zeros_like(best)
    for j in range(n_cols):
        sub = sub_at(j)
        F_new = torch.maximum(H + go, Fg + ge)
        M = F.pad(H[:, :-1], (1, 0)) + sub
        H_noE = torch.clamp_min(torch.maximum(M, F_new), 0)
        Ycum = torch.cummax(H_noE + go - decay, dim=1).values
        E = F.pad(Ycum[:, :-1], (1, 0), value=NEG) + decay - ge
        H_new = torch.maximum(H_noE, E)

        col_valid = (j < read_lens)[:, None]
        Hv = torch.where(row_valid & col_valid, H_new, 0)
        kbest = (Hv.to(torch.int64) * K + row_key).amax(dim=1)
        col_best = (kbest // K).to(torch.int32)
        col_arg = (K - 1 - kbest % K).to(torch.int32)
        better = col_best > best
        best = torch.where(better, col_best, best)
        best_i = torch.where(better, col_arg + 1, best_i)
        best_j = torch.where(better, j + 1, best_j)

        H = torch.where(col_valid, H_new, H)
        Fg = torch.where(col_valid, F_new, Fg)
    return DPResult(score=best, end_ref=best_i, end_read=best_j)


def sw_align_full(
    reads: torch.Tensor,
    refs: torch.Tensor,
    read_lens: torch.Tensor,
    ref_lens: torch.Tensor,
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Plain forward pass, then the forward pass again over the reversed
    prefixes ``read[:end_read][::-1]`` x ``window[:end_ref][::-1]``: its
    end cell is the distance from the forward end back to the start
    (``megapath_tpu/align/device.py:345-369``). A row with score 0 gets 0
    in all five outputs."""
    R = reads.shape[1]
    W = refs.shape[1]
    dev = reads.device
    fwd = sw_align(reads, refs, read_lens, ref_lens, params)
    jj = torch.arange(R, device=dev)[None, :]
    rsrc = fwd.end_read.to(torch.int64)[:, None] - 1 - jj
    rev_reads = torch.where(
        rsrc >= 0, torch.gather(reads, 1, rsrc.clamp(0, R - 1)), 0
    ).to(torch.uint8)
    ii = torch.arange(W, device=dev)[None, :]
    wsrc = fwd.end_ref.to(torch.int64)[:, None] - 1 - ii
    rev_refs = torch.where(
        wsrc >= 0, torch.gather(refs, 1, wsrc.clamp(0, W - 1)), OFF_TEXT_CODE
    ).to(torch.uint8)
    rev = sw_align(rev_reads, rev_refs, fwd.end_read, fwd.end_ref, params)
    return DPFullResult(
        score=fwd.score,
        end_ref=fwd.end_ref,
        end_read=fwd.end_read,
        start_ref=fwd.end_ref - rev.end_ref,
        start_read=fwd.end_read - rev.end_read,
    )


def sw_align_auto(
    reads: torch.Tensor,  # uint8 [C, R]
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPResult:
    """Forward DP by the tensors' device (``megapath_tpu/ops/dp.py:120``):
    the plain version on the CPU, the forward-only CUDA kernel on a card
    (which raises on what it does not take; there is no fallback)."""
    if reads.device.type == "cpu":
        return sw_align(reads, refs, read_lens, ref_lens, params)
    if reads.device.type == "cuda":
        from megapath_tpu_torch.ops.dp_cuda import sw_align_cuda

        return sw_align_cuda(reads, refs, read_lens, ref_lens, params)
    raise ValueError(f"no DP for tensors on {reads.device}")


def sw_align_full_auto(
    reads: torch.Tensor,  # uint8 [C, R]
    refs: torch.Tensor,  # uint8 [C, W]
    read_lens: torch.Tensor,  # int32 [C]
    ref_lens: torch.Tensor,  # int32 [C]
    params: DPParams = DPParams(),
) -> DPFullResult:
    """Forward + backward DP by the tensors' device: the plain version on
    the CPU, the CUDA kernel on a card (which raises on what it does not
    take; there is no fallback to the plain version)."""
    if reads.device.type == "cpu":
        return sw_align_full(reads, refs, read_lens, ref_lens, params)
    if reads.device.type == "cuda":
        from megapath_tpu_torch.ops.dp_cuda import sw_align_full_cuda

        return sw_align_full_cuda(reads, refs, read_lens, ref_lens, params)
    raise ValueError(f"no DP for tensors on {reads.device}")


def sw_align_substmat(
    reads: torch.Tensor,  # uint8 [B, R] query codes
    refs: torch.Tensor,  # uint8 [B, W] subject window codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    subst: torch.Tensor,  # int32 [n_codes, n_codes] substitution matrix
    params: DPParams = DPParams(),
) -> DPResult:
    """Plain affine-gap local alignment under a substitution matrix
    (``megapath_tpu/ops/dp.py:146``, BLOSUM62 on the protein path): the
    recurrence and tie rules of ``sw_align`` with ``subst[read code, ref
    code]`` in place of match/mismatch. A code >= n_codes scores 0 against
    everything, as the JAX version's one-hot rows make it; the table gets a
    zero row and column for such codes, so one gather fetches a column's
    scores. Runs only up to the batch's longest read: later columns change
    nothing."""
    B, R = reads.shape
    dev = reads.device
    n = subst.shape[0]
    tab = torch.zeros((n + 1, n + 1), dtype=torch.int32, device=dev)
    tab[:n, :n] = subst.to(device=dev, dtype=torch.int32)
    refs_c = refs.to(torch.int64).clamp_max(n)
    reads_c = reads.to(torch.int64).clamp_max(n)
    n_cols = int(read_lens.max().clamp(0, R)) if B else 0
    return _forward_scan(
        lambda j: torch.gather(tab[reads_c[:, j]], 1, refs_c),
        n_cols, refs.shape, read_lens, ref_lens, params, dev,
    )


PROTEIN_PARAMS = DPParams(match=0, mismatch=0, gap_open=-11, gap_extend=-1)


def sw_align_protein(
    reads: torch.Tensor,  # uint8 [B, R] query aa codes
    refs: torch.Tensor,  # uint8 [B, W] subject aa codes
    read_lens: torch.Tensor,  # int32 [B]
    ref_lens: torch.Tensor,  # int32 [B]
    params: DPParams = PROTEIN_PARAMS,
) -> DPResult:
    """BLOSUM62 local alignment (the AC-DIAMOND blastx scoring) by the
    tensors' device: ``sw_align_substmat`` on the CPU, the hand-written
    kernel (``ops/protein_cuda.py``, ``csrc/sw_subst.cu``) on a card, which
    raises on what it does not take; there is no fallback."""
    from megapath_tpu_torch.classify.protein import BLOSUM62

    subst = torch.from_numpy(BLOSUM62).to(reads.device)
    if reads.device.type == "cpu":
        return sw_align_substmat(reads, refs, read_lens, ref_lens, subst, params)
    if reads.device.type == "cuda":
        from megapath_tpu_torch.ops.protein_cuda import sw_align_substmat_cuda

        return sw_align_substmat_cuda(reads, refs, read_lens, ref_lens, subst, params)
    raise ValueError(f"no DP for tensors on {reads.device}")


def sw_traceback(
    read: np.ndarray, ref: np.ndarray, end_ref: int, end_read: int,
    params: DPParams = DPParams(),
) -> Tuple[int, int, str, int]:
    """Recompute the DP up to the end cell and trace back.

    Returns (start_ref, start_read, cigar, edit_distance) where cigar
    covers read[start_read:end_read] with soft clips added by callers.
    Host-side: runs only on reported hits (a tiny fraction of DP work).
    """
    i, j, ops = sw_traceback_ops(read, ref, end_ref, end_read, params)
    cigar = _runlength(ops)
    edit = sum(1 for o in ops if o in "XID")
    return i, j, cigar, edit


def sw_traceback_ops(
    read: np.ndarray, ref: np.ndarray, end_ref: int, end_read: int,
    params: DPParams = DPParams(),
) -> Tuple[int, int, list]:
    """Like sw_traceback but returns the raw per-cell op list
    (M/X/I/D, mismatches NOT folded into M) — variant extraction
    needs the distinction."""
    R, W = int(end_read), int(end_ref)
    read = np.asarray(read[:R], dtype=np.int64)
    ref = np.asarray(ref[:W], dtype=np.int64)
    H = np.zeros((W + 1, R + 1), dtype=np.int64)
    E = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    F = np.full((W + 1, R + 1), NEG, dtype=np.int64)
    for j in range(1, R + 1):
        sub = np.where(ref == read[j - 1], params.match, params.mismatch)
        for i in range(1, W + 1):
            E[i, j] = max(E[i - 1, j] + params.gap_extend, H[i - 1, j] + params.gap_open)
            F[i, j] = max(F[i, j - 1] + params.gap_extend, H[i, j - 1] + params.gap_open)
            H[i, j] = max(0, H[i - 1, j - 1] + sub[i - 1], E[i, j], F[i, j])
    i, j = W, R
    ops: list = []
    state = "H"
    while i > 0 and j > 0 and not (state == "H" and H[i, j] == 0):
        if state == "H":
            s = params.match if read[j - 1] == ref[i - 1] else params.mismatch
            if H[i, j] == H[i - 1, j - 1] + s:
                ops.append("M" if read[j - 1] == ref[i - 1] else "X")
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":  # deletion from read (ref consumed)
            ops.append("D")
            if E[i, j] == H[i - 1, j] + params.gap_open:
                state = "H"
            i -= 1
        else:  # F: insertion to read (read consumed)
            ops.append("I")
            if F[i, j] == H[i, j - 1] + params.gap_open:
                state = "H"
            j -= 1
    ops.reverse()
    return i, j, ops


def sw_traceback_batch(
    reads: np.ndarray,  # uint8 [B, R] oriented read codes
    windows: np.ndarray,  # uint8 [B, W] ref window codes
    end_ref: np.ndarray,  # int [B] traceback start (ref cells used)
    end_read: np.ndarray,  # int [B]
    params: DPParams = DPParams(),
    chunk_bytes: int = 256 << 20,
) -> Tuple[np.ndarray, np.ndarray, list, np.ndarray]:
    """Batched ``sw_traceback`` over all hits at once.

    The per-hit Python double loop (O(W*R) cells each) is replaced by
    a fill vectorized over (hits, window) — one pass over read columns
    using the same prefix-max E decoupling as the device kernel — that
    stores a per-cell direction byte, then a lockstep vectorized
    traceback walks every hit simultaneously. Decisions compare the
    same values in the same priority order as ``sw_traceback_ops``, so
    the per-hit (start_ref, start_read, cigar, edit) are identical.

    Returns (start_ref [B], start_read [B], cigars list[str],
    edit_distances [B]).
    """
    B, R = reads.shape
    W = windows.shape[1]
    out_sr = np.zeros(B, np.int64)
    out_sj = np.zeros(B, np.int64)
    out_cigars: list = [""] * B
    out_edit = np.zeros(B, np.int64)
    if B == 0:
        return out_sr, out_sj, out_cigars, out_edit
    cb = max(1, int(chunk_bytes // max(W * R, 1)))
    for lo in range(0, B, cb):
        hi = min(lo + cb, B)
        sr, sj, cigs, ed = _traceback_chunk(
            reads[lo:hi], windows[lo:hi],
            np.asarray(end_ref[lo:hi], np.int64),
            np.asarray(end_read[lo:hi], np.int64), params,
        )
        out_sr[lo:hi] = sr
        out_sj[lo:hi] = sj
        out_cigars[lo:hi] = cigs
        out_edit[lo:hi] = ed
    return out_sr, out_sj, out_cigars, out_edit


def _traceback_chunk(reads, windows, end_ref, end_read, params):
    B, R = reads.shape
    W = windows.shape[1]
    match = np.int64(params.match)
    mm = np.int64(params.mismatch)
    go = np.int64(params.gap_open)
    ge = np.int64(params.gap_extend)
    reads_i = reads.astype(np.int64)
    wins_i = windows.astype(np.int64)
    decay = np.arange(W, dtype=np.int64)[None, :] * ge

    # direction plane: bits 0-1 H source (0 stop, 1 diag, 2 E, 3 F),
    # bit 2 E-open (E == H[i-1,j] + go), bit 3 F-open
    dirp = np.zeros((B, W, R), np.uint8)
    H_prev = np.zeros((B, W), np.int64)
    F_prev = np.full((B, W), NEG, np.int64)
    for j in range(1, R + 1):
        sub = np.where(wins_i == reads_i[:, j - 1 : j], match, mm)
        F = np.maximum(H_prev + go, F_prev + ge)
        fopen = F == H_prev + go
        diag = np.concatenate(
            [np.zeros((B, 1), np.int64), H_prev[:, :-1]], axis=1
        ) + sub
        H_noE = np.maximum(np.maximum(diag, F), 0)
        # E[i] = max_{k<i} H_noE[k] + go + (i-1-k)*ge  (prefix max;
        # opening from an E-valued cell is never optimal for go <= ge,
        # so values equal the oracle's H-or-E chain exactly)
        Y = H_noE + go - decay
        Ycum = np.maximum.accumulate(Y, axis=1)
        E = np.concatenate(
            [np.full((B, 1), NEG, np.int64), Ycum[:, :-1]], axis=1
        ) + decay - ge
        H = np.maximum(H_noE, E)
        eopen = E == np.concatenate(
            [np.zeros((B, 1), np.int64), H[:, :-1]], axis=1
        ) + go
        code = np.where(
            H == 0,
            0,
            np.where(H == diag, 1, np.where(H == E, 2, 3)),
        ).astype(np.uint8)
        dirp[:, :, j - 1] = (
            code | (eopen.astype(np.uint8) << 2)
            | (fopen.astype(np.uint8) << 3)
        )
        H_prev, F_prev = H, F

    # lockstep traceback (state machine identical to sw_traceback_ops)
    i = end_ref.copy()
    j = end_read.copy()
    state = np.zeros(B, np.uint8)  # 0=H, 1=E, 2=F
    T = 2 * (W + R) + 4
    ops_buf = np.zeros((B, T), np.uint8)  # back-to-front; 1M 2X 3I 4D
    n_ops = np.zeros(B, np.int64)
    bidx = np.arange(B)
    active = (i > 0) & (j > 0)
    for _ in range(T):
        if not active.any():
            break
        d = np.zeros(B, np.uint8)
        d[active] = dirp[bidx[active], i[active] - 1, j[active] - 1]
        code = d & 3
        # H state
        mH = active & (state == 0)
        stop = mH & (code == 0)
        active = active & ~stop
        mH = mH & ~stop
        mdiag = mH & (code == 1)
        if mdiag.any():
            is_m = (
                reads_i[bidx[mdiag], j[mdiag] - 1]
                == wins_i[bidx[mdiag], i[mdiag] - 1]
            )
            ops_buf[bidx[mdiag], n_ops[mdiag]] = np.where(is_m, 1, 2)
            n_ops[mdiag] += 1
            i[mdiag] -= 1
            j[mdiag] -= 1
        state[mH & (code == 2)] = 1
        state[mH & (code == 3)] = 2
        # E state: append D, maybe close, consume ref
        mE = active & (state == 1)
        if mE.any():
            ops_buf[bidx[mE], n_ops[mE]] = 4
            n_ops[mE] += 1
            close = mE & ((d >> 2) & 1 == 1)
            state[close] = 0
            i[mE] -= 1
        # F state: append I, maybe close, consume read
        mF = active & (state == 2)
        if mF.any():
            ops_buf[bidx[mF], n_ops[mF]] = 3
            n_ops[mF] += 1
            close = mF & ((d >> 3) & 1 == 1)
            state[close] = 0
            j[mF] -= 1
        active = active & (i > 0) & (j > 0)

    # per-hit run-length encode (X folds into M for the CIGAR text,
    # counts as edit distance); ops were emitted back-to-front
    edit = ((ops_buf >= 2) & (ops_buf <= 4)).sum(axis=1)
    sym_of = np.array(["", "M", "M", "I", "D"])
    cigars = []
    for b in range(B):
        k = int(n_ops[b])
        if k == 0:
            cigars.append("")
            continue
        seq = ops_buf[b, :k][::-1]
        sym = np.where(seq == 2, 1, seq)
        bounds = np.flatnonzero(np.r_[True, sym[1:] != sym[:-1]])
        counts = np.diff(np.r_[bounds, k])
        cigars.append(
            "".join(
                f"{c}{sym_of[sym[p]]}" for p, c in zip(bounds, counts)
            )
        )
    return i, j, cigars, edit


def _runlength(ops: list) -> str:
    out = []
    for o in ops:
        sym = "M" if o in ("M", "X") else o
        if out and out[-1][1] == sym:
            out[-1][0] += 1
        else:
            out.append([1, sym])
    return "".join(f"{n}{s}" for n, s in out)
