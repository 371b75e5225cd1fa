"""Banded affine-gap alignment, plain PyTorch, vectorized over (read,
candidate) pairs.

This is the plain version of the hand-written CUDA kernel in
csrc/banded_sw.cu (wrapper: align/cuda_sw.py). It runs the port's CPU
path and is the yardstick the kernel is held to on the card; it never
runs on the main path when a card is present.

The DP runs in diagonal-offset coordinates: for query row i, band offset
d ∈ [0, D) addresses reference position winstart + i + d, so the
diagonal predecessor keeps the same offset, the insertion predecessor is
offset d+1 in the previous row, and deletions become an intra-row
prefix-max scan (exact closed form of Gotoh's E recurrence):

    D[d] = max_{d'<d} ( H_noD[d'] - gap_open - (d-d')*gap_extend )

which is a Kogge-Stone max-scan over A[d'] = H_noD[d'] + d'*gap_extend.

The arithmetic is float32 with NEG = -1e9 and the same operation order
as the kernel, so scores (integer-valued floats) and statistics agree
bit for bit. Tie-break priority: diagonal > deletion > insertion;
earliest row, then smallest offset, for equal best cells.

Stat plane order: 0 matches, 1 mismatches, 2 gap_cols, 3 gap_opens,
4 qstart row, 5 window-start column.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference.params import ScoringParams

NEG = -1e9
N_STATS = 6
FULL_FIELDS = ("score", "qstart", "qend", "wstart", "wend", "matches",
               "mismatches", "gap_cols", "gap_opens")
SCORE_ONLY_FIELDS = ("score", "qend", "wstart", "wend")


def _shift_d(x: torch.Tensor, shift: int, fill: float) -> torch.Tensor:
    """Shift along the last (band) axis; positive shift moves data toward
    lower d (x_out[..., d] = x[..., d + shift])."""
    if shift == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(shift),), fill, dtype=x.dtype,
                     device=x.device)
    if shift > 0:
        return torch.cat([x[..., shift:], pad], dim=-1)
    return torch.cat([pad, x[..., :shift]], dim=-1)


def banded_align_plain(
    query: torch.Tensor,    # [P, L] int8 codes (4 = pad/sentinel)
    qlens: torch.Tensor,    # [P] int32
    ref_win: torch.Tensor,  # [P, W] int8 codes, W = L + band_width - 1
    params: ScoringParams,
    band_width: int = 16,
    qpen: Optional[torch.Tensor] = None,  # [P, L] int8 positive mismatch
    #                                       penalties; None = flat
    score_only: bool = False,
) -> Dict[str, torch.Tensor]:
    """Align each query against its reference window inside a band.

    Returns per-pair tensors: score (f32), qstart, qend, wstart, wend
    (window coords), matches, mismatches, gap_cols, gap_opens (int32).
    score_only=True returns only score, qend, wstart and wend — the
    fields of the kernel's score-only variant, which equal the full
    variant's.

    With qpen, mismatch columns cost the per-query-base quality-scaled
    penalty; a read-N column (query code >= 4) costs params.n_pen and a
    ref code-4 column costs -params.mismatch (ScoringParams docstring).
    """
    P, L = query.shape
    D = band_width
    if tuple(ref_win.shape) != (P, L + D - 1):
        raise ValueError(f"ref_win {tuple(ref_win.shape)} != {(P, L + D - 1)}")
    has_read = qlens > 0
    if bool(has_read.any()) and not bool(has_read.all()):
        # pairs without a read (batch padding) keep the initial state,
        # whatever the rows do, and pairs do not interact: align only
        # the others — exact, and the CPU path skips the padding
        out = banded_align_plain(query, torch.zeros_like(qlens), ref_win,
                                 params, band_width, qpen, score_only)
        idx = torch.nonzero(has_read).squeeze(1)
        part = banded_align_plain(
            query[idx], qlens[idx], ref_win[idx], params, band_width,
            None if qpen is None else qpen[idx], score_only)
        for k in out:
            out[k][idx] = part[k]
        return out
    dev = query.device
    f32 = torch.float32
    local = params.mode == "local"
    ma, mi = float(params.match), float(params.mismatch)
    go_c, ge = float(params.gap_open), float(params.gap_extend)
    npen = float(params.n_pen)
    S = N_STATS

    d_row = torch.arange(D, dtype=f32, device=dev)[None, :]       # [1, D]
    d_full = d_row.expand(P, D)
    zeros_pd = torch.zeros((P, D), dtype=f32, device=dev)
    zeros_4pd = torch.zeros((4, P, D), dtype=f32, device=dev)
    zeros_2pd = torch.zeros((2, P, D), dtype=f32, device=dev)
    ones_1pd = torch.ones((1, P, D), dtype=f32, device=dev)
    qlens_f = qlens.to(f32)
    qpen_f = None if qpen is None else qpen.to(f32)

    H = zeros_pd
    H_fresh = torch.ones((P, D), dtype=torch.bool, device=dev)
    H_st = torch.zeros((S, P, D), dtype=f32, device=dev)
    I = torch.full((P, D), NEG, dtype=f32, device=dev)
    I_st = torch.zeros((S, P, D), dtype=f32, device=dev)
    best = torch.full((P,), NEG, dtype=f32, device=dev)
    best_i = torch.zeros((P,), dtype=f32, device=dev)
    best_d = torch.zeros((P,), dtype=f32, device=dev)
    best_st = torch.zeros((S, P), dtype=f32, device=dev)

    # rows at or past every pair's read length change no pair's best
    # (local mode masks fi >= qlen; glocal records at fi == qlen-1), so
    # the loop stops at the longest read, as the kernel does per pair
    for i in range(min(L, int(qlens.max()) if P else 0)):
        Hp, Hp_fresh, Hp_st, Ip, Ip_st = H, H_fresh, H_st, I, I_st
        fi = float(i)
        q_i = query[:, i:i + 1]                                  # [P, 1]
        r_i = ref_win[:, i:i + D]                                # [P, D]
        is_match = ((q_i == r_i) & (q_i < 4) & (r_i < 4)).to(f32)
        if qpen_f is None:
            sub = torch.where(is_match > 0, ma, mi)
        else:
            qp_i = qpen_f[:, i:i + 1]
            pen = torch.where(q_i >= 4, npen,
                              torch.where(r_i >= 4, -mi, qp_i))
            sub = torch.where(is_match > 0, ma, -pen)

        # stats of a path starting with a diagonal move at row i, offset d
        fresh_st = torch.cat([zeros_4pd,
                              torch.full((1, P, D), fi, dtype=f32, device=dev),
                              (fi + d_full)[None]])
        base_st = torch.where(Hp_fresh[None], fresh_st, Hp_st)

        # --- diagonal move ---------------------------------------------
        T1 = Hp + sub
        T1_st = base_st + torch.cat([is_match[None], (1.0 - is_match)[None],
                                     zeros_4pd])

        # --- insertion (consumes query; predecessor offset d+1) --------
        Hp_shift = _shift_d(Hp, 1, NEG)
        Hp_fresh_shift = _shift_d(Hp_fresh, 1, False)
        Hp_st_shift = _shift_d(Hp_st, 1, 0.0)
        fresh_ins = torch.cat([zeros_4pd,
                               torch.full((1, P, D), fi, dtype=f32, device=dev),
                               (fi + 1.0 + d_full)[None]])
        open_st = torch.where(Hp_fresh_shift[None], fresh_ins, Hp_st_shift)
        Ip_shift = _shift_d(Ip, 1, NEG)
        Ip_st_shift = _shift_d(Ip_st, 1, 0.0)
        i_ext = Ip_shift - ge
        i_open = Hp_shift - go_c - ge
        take_ext = i_ext >= i_open
        I = torch.where(take_ext, i_ext, i_open)
        I_st = torch.where(take_ext[None], Ip_st_shift, open_st)
        I_st = I_st + torch.cat([zeros_2pd, ones_1pd,
                                 torch.where(take_ext, 0.0, 1.0)[None],
                                 zeros_2pd])

        # --- pre-deletion best (scan input); diag wins ties over ins ---
        take_I = I > T1
        H_noD = torch.where(take_I, I, T1)
        H_noD_st = torch.where(take_I[None], I_st, T1_st)
        if local:
            clamp = H_noD <= 0.0
            H_noD = torch.where(clamp, 0.0, H_noD)
            H_noD_st = torch.where(clamp[None], 0.0, H_noD_st)
            A = torch.where(clamp, NEG, H_noD + d_row * ge)
        else:
            A = H_noD + d_row * ge

        # --- deletion via exclusive prefix-max scan over the band ------
        # payload: stats + origin offset d'
        pay = torch.cat([H_noD_st, d_full[None]])
        shift = 1
        while shift < D:
            sA = _shift_d(A, -shift, NEG)
            sp = _shift_d(pay, -shift, 0.0)
            take = sA > A
            pay = torch.where(take[None], sp, pay)
            A = torch.where(take, sA, A)
            shift *= 2
        excl_A = _shift_d(A, -1, NEG)
        excl_p = _shift_d(pay, -1, 0.0)
        D_val = excl_A - go_c - d_row * ge
        gap_len = d_full - excl_p[S]
        D_st = excl_p[:S] + torch.cat([zeros_2pd, gap_len[None], ones_1pd,
                                       zeros_2pd])

        # --- final H: priority diag > del > ins ------------------------
        take_D = D_val > T1
        H = torch.where(take_D, D_val, T1)
        H_st = torch.where(take_D[None], D_st, T1_st)
        take_I2 = I > H
        H = torch.where(take_I2, I, H)
        H_st = torch.where(take_I2[None], I_st, H_st)
        if local:
            clamp = H <= 0.0
            H = torch.where(clamp, 0.0, H)
            H_st = torch.where(clamp[None], 0.0, H_st)
            H_fresh = clamp
        else:
            H_fresh = torch.zeros((P, D), dtype=torch.bool, device=dev)

        # --- track best: first maximum of the row ----------------------
        if local:
            H_masked = torch.where((fi < qlens_f)[:, None], H, NEG)
        else:
            H_masked = H
        row_best = H_masked.amax(dim=1)
        row_best_d = torch.argmax(H_masked, dim=1)   # first maximum
        if local:
            improve = row_best > best
        else:
            improve = fi == (qlens_f - 1.0)
        picked = torch.take_along_dim(
            H_st, row_best_d[None, :, None], dim=2)[:, :, 0]     # [S, P]
        best = torch.where(improve, row_best, best)
        best_i = torch.where(improve, fi, best_i)
        best_d = torch.where(improve, row_best_d.to(f32), best_d)
        best_st = torch.where(improve[None], picked, best_st)

    i32 = torch.int32
    out = dict(
        score=best,
        qstart=best_st[4].to(i32),
        qend=(best_i + 1.0).to(i32),
        wstart=best_st[5].to(i32),
        wend=(best_i + best_d + 1.0).to(i32),
        matches=best_st[0].to(i32),
        mismatches=best_st[1].to(i32),
        gap_cols=best_st[2].to(i32),
        gap_opens=best_st[3].to(i32),
    )
    if score_only:
        out = {k: out[k] for k in SCORE_ONLY_FIELDS}
    return out
