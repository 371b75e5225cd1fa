"""Seed -> window gather -> banded DP -> postprocess, plain PyTorch.

A frozen copy of the port's align/pipeline.py (midas_tpu_torch), kept
under portbench/ as part of the benchmark's plain reference: the banded
DP is always the plain version (banded.py), on whatever device the
inputs lie on, and the k-mer lookups go through the reference's own
sorted index (index.py) instead of the port's bucketed hash table.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference.banded import banded_align_plain
from portbench.reference.params import ScoringParams
from portbench.reference.seed import (SeedParams, find_candidates,
                                        gather_windows_packed,
                                        reverse_batch)


def quality_penalties(quals: torch.Tensor,
                      scoring: ScoringParams) -> torch.Tensor:
    """Per-base positive mismatch penalties from Phred qualities —
    bowtie2's --mp MX,MN table in exact integer arithmetic:
    MN + ((MX - MN) * min(Q, 40)) // 40. quals [B, L] int8 -> int8."""
    mx = -scoring.mismatch
    mn = scoring.mm_min
    q = quals.to(torch.int32).clamp(max=40)
    return (mn + torch.div((mx - mn) * q, 40, rounding_mode="floor")
            ).to(torch.int8)


def dispatch_banded_align(q_pair, qlens_pair, win_pair, scoring, band_width,
                          score_only: bool = False, qpen_pair=None):
    """The banded DP over [P, L] pairs: always the plain version, on the
    device the inputs lie on."""
    return banded_align_plain(q_pair, qlens_pair, win_pair, scoring,
                              band_width, qpen=qpen_pair,
                              score_only=score_only)


def _prepare_pairs(
    codes: torch.Tensor,
    qlens: torch.Tensor,
    strand: torch.Tensor,   # [B, C]
    rc: torch.Tensor,       # [B, L] reverse complement (find_candidates)
    qpen: Optional[torch.Tensor] = None,  # [B, L] mismatch penalties (fwd)
) -> tuple:
    """Per-candidate strand-selected queries, flattened to [B*C, L];
    with qpen, the penalty plane rides along (reversed for rc-strand
    candidates, since penalties follow the read base they qualify).
    Returns (q_pair, qlens_pair, qpen_pair-or-None)."""
    B, L = codes.shape
    C = strand.shape[1]
    is_rc = (strand == 1)[:, :, None]
    q_pair = torch.where(is_rc, rc[:, None, :], codes[:, None, :])
    q_pair = q_pair.reshape(B * C, L)
    qlens_pair = qlens[:, None].expand(B, C).reshape(B * C).contiguous()
    qpen_pair = None
    if qpen is not None:
        rpen = reverse_batch(qpen, qlens)
        qpen_pair = torch.where(is_rc, rpen[:, None, :], qpen[:, None, :])
        qpen_pair = qpen_pair.reshape(B * C, L)
    return q_pair, qlens_pair, qpen_pair


def _drop_duplicates(valid, seq_idx, strand, tstart) -> torch.Tensor:
    """Drop duplicate alignments: same (seq, strand, tstart) found via
    two nearby candidate diagonals — keep the first (candidates are
    emitted in decreasing vote order). One [B, C, C] comparison, C is
    tiny. Returns the new valid mask."""
    C = valid.shape[1]
    same = ((seq_idx[:, :, None] == seq_idx[:, None, :])
            & (strand[:, :, None] == strand[:, None, :])
            & (tstart[:, :, None] == tstart[:, None, :]))
    c_iota = torch.arange(C, device=valid.device)
    earlier = c_iota[None, :, None] > c_iota[None, None, :]
    dup = (same & earlier & valid[:, None, :]).any(dim=2)
    return valid & ~dup


def _postprocess(
    out: Dict[str, torch.Tensor],     # [B, C] banded outputs
    cands: Dict[str, torch.Tensor],
    winstart: torch.Tensor,
    seq_idx: torch.Tensor,
    seq_lo: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    tstart = winstart + out["wstart"] - seq_lo
    tend = winstart + out["wend"] - seq_lo
    return dict(
        valid=_drop_duplicates(cands["valid"], seq_idx, cands["strand"],
                               tstart),
        score=out["score"],
        seq_idx=seq_idx,
        strand=cands["strand"],
        tstart=tstart,
        tend=tend,
        qstart=out["qstart"],
        qend=out["qend"],
        matches=out["matches"],
        mismatches=out["mismatches"],
        gap_cols=out["gap_cols"],
        gap_opens=out["gap_opens"],
    )


def _candidate_pairs(index_arrays, pack_arrays, codes, qlens,
                     scoring: ScoringParams, seed_params: SeedParams,
                     max_len: int, quals: Optional[torch.Tensor] = None):
    """Seed -> window gather -> per-candidate DP inputs, the front of
    both alignment paths. Returns (cands, winstart, seq_idx, qpen,
    dp_inputs) with dp_inputs = (q_pair [B*C, L], qlens_pair [B*C],
    ref_win [B*C, W], qpen_pair or None); qpen is set when the scoring
    is quality-scaled and quals are given."""
    B, L = codes.shape
    C = seed_params.num_cands
    D = seed_params.band_width
    W = L + D - 1
    cands = find_candidates(index_arrays, codes, qlens, seed_params, max_len)
    winstart = cands["diag"] - D // 2
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_arrays["offsets"],
        winstart, W, center=cands["diag"] + qlens[:, None] // 2)
    qpen = (quality_penalties(quals, scoring)
            if scoring.qual_scaled and quals is not None else None)
    q_pair, qlens_pair, qpen_pair = _prepare_pairs(
        codes, qlens, cands["strand"], cands["rc"], qpen=qpen)
    return cands, winstart, seq_idx, qpen, (
        q_pair, qlens_pair, ref_win.reshape(B * C, W), qpen_pair)


def _align_batch_stages(
    index_arrays, pack_arrays, codes, qlens,
    scoring: ScoringParams, seed_params: SeedParams, max_len: int,
    quals: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Seed -> window gather -> banded extension -> postprocess, on the
    device the inputs lie on. Returns [B, C] result tensors."""
    B, C = codes.shape[0], seed_params.num_cands
    cands, winstart, seq_idx, _, (q, ql, win, qp) = _candidate_pairs(
        index_arrays, pack_arrays, codes, qlens, scoring, seed_params,
        max_len, quals)
    out = dispatch_banded_align(q, ql, win, scoring, seed_params.band_width,
                                qpen_pair=qp)
    out = {k: v.reshape(B, C) for k, v in out.items()}
    seq_lo = pack_arrays["offsets"][seq_idx]
    return _postprocess(out, cands, winstart, seq_idx, seq_lo)


def align_candidates_score(
    index_arrays, pack_arrays, codes, qlens,
    scoring: ScoringParams, seed_params: SeedParams, max_len: int,
    quals: Optional[torch.Tensor] = None,
):
    """Pass 1 of the two-pass alignment: seed + score-only banded DP over
    every candidate (the kernel's K3 variant; with quals and a
    quality-scaled scoring, its qpen form). Returns (out1, aux):

    out1 — [B, C] planes sufficient for best-hit selection, MAPQ and
    duplicate-drop: valid, score, seq_idx, strand, tstart, tend, qend.
    aux  — what pass 2 (align_chosen_full) needs to re-align just the
    chosen candidate with full statistics: winstart, rc, strand, qpen.

    Scores are identical to _align_batch_stages' (same DP, fewer stat
    planes), so selection is bit-equal; the full-statistics DP then runs
    over B rows instead of B*C."""
    B, C = codes.shape[0], seed_params.num_cands
    cands, winstart, seq_idx, qpen, (q, ql, win, qp) = _candidate_pairs(
        index_arrays, pack_arrays, codes, qlens, scoring, seed_params,
        max_len, quals)
    out = dispatch_banded_align(q, ql, win, scoring, seed_params.band_width,
                                score_only=True, qpen_pair=qp)
    out = {k: v.reshape(B, C) for k, v in out.items()}
    seq_lo = pack_arrays["offsets"][seq_idx]
    tstart = winstart + out["wstart"] - seq_lo
    tend = winstart + out["wend"] - seq_lo
    out1 = dict(valid=_drop_duplicates(cands["valid"], seq_idx,
                                       cands["strand"], tstart),
                score=out["score"], seq_idx=seq_idx, strand=cands["strand"],
                tstart=tstart, tend=tend, qend=out["qend"])
    aux = dict(winstart=winstart, rc=cands["rc"], strand=cands["strand"],
               qpen=qpen)
    return out1, aux


def align_chosen_full(
    pack_arrays, aux, codes, qlens, best_col,
    scoring: ScoringParams, seed_params: SeedParams,
):
    """Pass 2: full-statistics banded DP over each read's CHOSEN
    candidate only ([B] rows, padding rows included; the kernel's K2
    variant under a quality-scaled scoring). best_col [B] int64.
    Returns [B] planes: score, qstart, qend, matches, mismatches,
    gap_cols, gap_opens, tstart, tend."""
    B, L = codes.shape
    D = seed_params.band_width
    W = L + D - 1
    pack_offsets = pack_arrays["offsets"]
    col = best_col[:, None]
    winstart_b = torch.gather(aux["winstart"], 1, col)           # [B, 1]
    strand_b = torch.gather(aux["strand"], 1, col)[:, 0]         # [B]
    ref_win, seq_idx = gather_windows_packed(
        pack_arrays["words"], pack_arrays["nmask"], pack_offsets, winstart_b,
        W, center=winstart_b + D // 2 + qlens[:, None] // 2)   # [B,1,W], [B,1]
    is_rc = (strand_b == 1)[:, None]
    q_best = torch.where(is_rc, aux["rc"], codes)
    qpen_best = None
    if aux.get("qpen") is not None:
        qpen_best = torch.where(is_rc, reverse_batch(aux["qpen"], qlens),
                                aux["qpen"])
    out = dispatch_banded_align(q_best, qlens, ref_win.reshape(B, W),
                                scoring, D, qpen_pair=qpen_best)
    seq_lo = pack_offsets[seq_idx[:, 0]]
    out["tstart"] = winstart_b[:, 0] + out["wstart"] - seq_lo
    out["tend"] = winstart_b[:, 0] + out["wend"] - seq_lo
    return out
