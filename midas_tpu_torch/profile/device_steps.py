"""Device-resident profiling steps: no per-batch host readback.

Each `update` runs seed -> banded DP -> best-hit -> filter -> segment
reduction on the device the state lies on, and updates the state IN
PLACE (the JAX package donates its state to the jit for the same
effect). Reads that need host math — ambiguous marker hits, which go
through the reference's RNG assignment (midas/run/species.py:104-119)
— are spilled into a fixed-capacity device staging buffer that the
caller drains (profile/species.py, profile/snps.py). Gapped reads of
the snps pileup, whose column map needs a traceback, are spilled the
same way and go through the host oracle once, after the stream.

Filter semantics are those of midas_tpu/profile/device_steps.py, with
two deliberate changes for exactness: uniq_bp accumulates in int64 (the
JAX package sums in float32, exact only below 2^24 bp per species), and
the stream rank amb_ord is int64 (int32 overflows past 2^31 reads).
Results are equal wherever the JAX package is exact.

The species step and the genes and snps steps, single-end and
mate-paired, are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from midas_tpu_torch import tracing
from midas_tpu_torch.align import params as ap
from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.pipeline import (_align_batch_stages,
                                            align_candidates_score,
                                            align_chosen_full,
                                            count_real_pairs)
from midas_tpu_torch.align.seed import (SeedParams, revcomp_batch,
                                        reverse_batch)
from midas_tpu_torch.profile.sparse_counts import counts_host_sparse

NEG_INF = -1e30
SPILL_FIELDS = ("amb_sp", "amb_bp", "amb_seq", "amb_ord")


def _pick(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """arr [B, C], col [B] -> arr[i, col[i]]  [B]."""
    return torch.gather(arr, 1, col[:, None])[:, 0]


def _append_rows(buf: torch.Tensor, n: torch.Tensor, rows: torch.Tensor,
                 is_row: torch.Tensor) -> torch.Tensor:
    """Append rows[i] (for i where is_row[i]) into buf starting at row n,
    in place. buf has one spill row at index CAP: rows past capacity,
    and every row not appended, land there (only that row ever sees
    duplicate targets, and it is never read). Returns the new true
    count n + sum(is_row), which the caller compares to capacity."""
    cap = buf.shape[0] - 1
    rank = torch.cumsum(is_row.to(torch.int64), dim=0) - 1
    dest = torch.where(is_row, (n + rank).clamp(max=cap), cap)
    buf.index_copy_(0, dest, rows.to(buf.dtype))
    return n + is_row.sum()


def score_min_table(scoring: ScoringParams, max_len: int) -> np.ndarray:
    """bowtie2's scMin as an integer per read length: [max_len + 1] int64,
    entry L = trunc(score_min(max(L, 1))), built once on the host and
    indexed by qlen on the device.

    The values repeat the JAX package's float32 device arithmetic
    (midas_tpu score_min_device + jnp.trunc): glocal -0.6 - 0.6*L is two
    rounded float32 operations — in float64 the truncated value differs
    at 100 lengths in 1..2048 (L = 9: float32 truncates to -6, float64
    to -5; L = 24: -15 vs -14), so the table is built in float32;
    local 20 + 8 ln L truncates the same
    in float32 and float64 for every L <= 2048 (tested), so it is
    computed in float64, independent of how a device rounds its log."""
    L = np.maximum(np.arange(max_len + 1), 1)
    if scoring.mode == "glocal":
        v = np.float32(-0.6) - np.float32(0.6) * L.astype(np.float32)
    else:
        v = 20.0 + 8.0 * np.log(L.astype(np.float64))
    return np.trunc(v).astype(np.int64)


def _mapq_threshold(frac: float, diff: torch.Tensor) -> torch.Tensor:
    """Smallest integer x with x >= f32(frac) * diff, computed EXACTLY in
    int64: f32(frac) = m / 2^27 for every band fraction (>= 0.0625, so
    its float32 value has granularity 2^-27 or coarser), and the result
    is ceil(m * diff / 2^27). This reproduces bowtie2's
    `intScore >= diff * (double)0.Xf` comparisons bit for bit (the JAX
    package evaluates the same integer with an int32 split multiply)."""
    m = int(round(float(np.float32(frac)) * (1 << 27)))
    if m != float(np.float32(frac)) * (1 << 27):
        raise ValueError(f"band fraction {frac} is not a multiple of 2^-27")
    return (m * diff.to(torch.int64) + ((1 << 27) - 1)) >> 27


def mapq_device(
    best: torch.Tensor, second: torch.Tensor, smin_i: torch.Tensor,
    sperf_i: torch.Tensor, has_second: torch.Tensor, local: bool = False,
) -> torch.Tensor:
    """Vectorized params.mapq_from_scores — bowtie2 MapqV2 (mapq.h), both
    trees, in bowtie2's integer-score arithmetic. best/second are the
    float32 DP scores, smin_i the integer scMin (score_min_table),
    sperf_i the integer perfect score. diff/bestOver/bestdiff are
    integers and band thresholds exact (_mapq_threshold). The
    where-ladders are built from the same table constants the host twin
    walks. Returns int32 [B]."""
    smin_i = smin_i.to(torch.int64)
    diff = (sperf_i.to(torch.int64) - smin_i).clamp(min=1)
    best_i = torch.round(best).to(torch.int64)
    bo = best_i - smin_i
    valid2 = has_second & (second >= smin_i.to(torch.float32))
    sec_i = torch.round(torch.where(valid2, second, 0.0)).to(torch.int64)

    def full(v):
        return torch.full_like(bo, v)

    uniq_table = ap._MAPQ_UNIQ_LOCAL if local else ap._MAPQ_UNIQ_E2E
    floor = (ap._MAPQ_UNIQ_LOCAL_FLOOR if local else ap._MAPQ_UNIQ_E2E_FLOOR)
    single = full(floor)
    for frac, q in reversed(uniq_table):
        single = torch.where(bo >= _mapq_threshold(frac, diff), q, single)

    bestdiff = (best_i.abs() - sec_i.abs()).abs()
    perfect = bo == diff
    ov84 = bo >= _mapq_threshold(0.84, diff)
    ov68 = bo >= _mapq_threshold(0.68, diff)
    hi = bo >= _mapq_threshold(0.67, diff)
    rows = ap._MAPQ_TIE_LOCAL if local else ap._MAPQ_TIE_E2E
    tail = ap._MAPQ_TIE_LOCAL_TAIL if local else ap._MAPQ_TIE_E2E_TAIL
    tie = torch.where(bestdiff > 0,
                      torch.where(hi, full(tail[0][0]), full(tail[0][1])),
                      torch.where(hi, full(tail[1][0]), full(tail[1][1])))
    for frac, q_perfect, q84, q68, q_else in reversed(rows):
        band = torch.where(perfect, q_perfect,
                           torch.where(ov84, q84,
                                       torch.where(ov68, q68, full(q_else))))
        tie = torch.where(bestdiff >= _mapq_threshold(frac, diff), band, tie)

    q = torch.where(valid2, tie, single)
    return torch.where(best_i < smin_i, 0, q).to(torch.int32)


def canonical_best_col(out: Dict[str, torch.Tensor],
                       scores: torch.Tensor) -> torch.Tensor:
    """Deterministic multimapper arbitration: among the equal-best-score
    candidates pick the smallest (seq_idx, tstart, strand) — a global
    order, as the JAX package's (bowtie2's own arbitration is
    pseudorandom). Candidates with identical (seq, tstart, strand) are
    duplicates and were already dropped, so exactly one column survives
    the three filters. Returns int64 [B] (first index on ties; 0 for a
    row without any candidate)."""
    BIG = 2**31 - 1
    best = scores.amax(dim=1)
    isb = out["valid"] & (scores == best[:, None]) & (scores > NEG_INF / 2)
    for key in ("seq_idx", "tstart", "strand"):
        v = torch.where(isb, out[key].to(torch.int32), BIG)
        isb = isb & (v == v.amin(dim=1)[:, None])
    # argmax over bool is not on every backend: over int32, first max
    return torch.argmax(isb.to(torch.int32), dim=1)


def best_hit_device(
    out: Dict[str, torch.Tensor], qlens: torch.Tensor, scoring: ScoringParams,
    smin_table: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best hit per read over the pass-1 candidates, with MAPQ (the JAX
    package's best_hit_device). smin_table is score_min_table(scoring,
    max_len) on the device, indexed by qlen.

    Returns (aligned [B] bool, best_col [B] int64, mapq [B] int32)."""
    scores = torch.where(out["valid"], out["score"], NEG_INF)
    best_col = canonical_best_col(out, scores)
    best = _pick(scores, best_col)
    masked = scores.clone()
    masked[torch.arange(scores.shape[0], device=scores.device),
           best_col] = NEG_INF
    second = masked.amax(dim=1)
    has_second = second > NEG_INF / 2
    # bowtie2's scMin is the score-min function value CAST to the
    # integer score type (truncation toward zero): local 20+8ln(L)=56.8
    # admits an integer score of 56
    smin_i = smin_table[qlens.to(torch.int64)]
    sperf_i = scoring.match * qlens.to(torch.int64).clamp(min=1)
    aligned = (best > NEG_INF / 2) & (best >= smin_i.to(torch.float32))
    mapq = mapq_device(best, second, smin_i, sperf_i, has_second,
                       local=scoring.mode == "local")
    return aligned, best_col, mapq


def concordant_pairs(
    out: Dict[str, torch.Tensor], qlens: torch.Tensor, scoring: ScoringParams,
    smin_table: torch.Tensor, maxins: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The best concordant candidate pair of each mate pair (rows 2i /
    2i+1), by plain torch ops over the [P, C, C] planes of candidate
    pairs (P = B/2): the pair half of paired_best_hit_device.

    Returns (has_pair [P] bool, pair_col [B] int64 — both mates'
    columns, meaningful where has_pair — and pair_mapq [P] int32)."""
    B, C = out["score"].shape
    Pn = B // 2
    scores = torch.where(out["valid"], out["score"], NEG_INF)
    s1, s2 = scores[0::2], scores[1::2]                       # [P, C]
    seq1, seq2 = out["seq_idx"][0::2], out["seq_idx"][1::2]
    st1, st2 = out["strand"][0::2], out["strand"][1::2]
    t1s, t2s = out["tstart"][0::2], out["tstart"][1::2]
    t1e, t2e = out["tend"][0::2], out["tend"][1::2]

    same_seq = seq1[:, :, None] == seq2[:, None, :]           # [P, C, C]
    opposite = st1[:, :, None] != st2[:, None, :]
    frag = (torch.maximum(t1e[:, :, None], t2e[:, None, :])
            - torch.minimum(t1s[:, :, None], t2s[:, None, :]))
    # fr orientation: the forward-strand mate starts no later than the
    # reverse-strand mate
    fwd1 = st1[:, :, None] == 0
    fw_start = torch.where(fwd1, t1s[:, :, None], t2s[:, None, :])
    rc_start = torch.where(fwd1, t2s[:, None, :], t1s[:, :, None])
    ql = qlens.to(torch.int64)
    ql1, ql2 = ql[0::2], ql[1::2]
    # bowtie2's integer scMin per mate; a pair's is their sum, as the JAX
    # package sums its two truncated float32 values
    smin1, smin2 = smin_table[ql1], smin_table[ql2]
    both_valid = ((s1 >= smin1[:, None].to(torch.float32))[:, :, None]
                  & (s2 >= smin2[:, None].to(torch.float32))[:, None, :])
    conc = (same_seq & opposite & (frag <= maxins) & (fw_start <= rc_start)
            & both_valid)
    pair_sc = torch.where(conc, s1[:, :, None] + s2[:, None, :], NEG_INF)

    flat = pair_sc.reshape(Pn, C * C)
    # canonical pair arbitration (see canonical_best_col): among
    # equal-best concordant pairs the smallest (seq, t1start, t2start,
    # strand1), so tie resolution is pool-order independent; the strand
    # plane closes two equal-score pairings with identical coordinates
    # and swapped mate strands
    BIG = 2**31 - 1
    isb = (flat == flat.amax(dim=1)[:, None]) & (flat > NEG_INF / 2)
    shape = (Pn, C, C)
    for plane in (seq1[:, :, None].expand(shape),
                  t1s[:, :, None].expand(shape),
                  t2s[:, None, :].expand(shape),
                  st1[:, :, None].expand(shape)):
        v = torch.where(isb, plane.reshape(Pn, C * C).to(torch.int32), BIG)
        isb = isb & (v == v.amin(dim=1)[:, None])
    # argmax over bool is not on every backend: over int32, first max
    # (0 for a pair without a concordant combination: has_pair is False)
    best_flat = torch.argmax(isb.to(torch.int32), dim=1)
    pair_best = _pick(flat, best_flat)
    masked = flat.clone()
    masked[torch.arange(Pn, device=flat.device), best_flat] = NEG_INF
    pair_second = masked.amax(dim=1)

    # pair MAPQ from pair scores against pair-level score bounds
    pair_mapq = mapq_device(pair_best, pair_second, smin1 + smin2,
                            scoring.match * (ql1 + ql2).clamp(min=1),
                            pair_second > NEG_INF / 2,
                            local=scoring.mode == "local")
    pair_col = torch.stack([best_flat // C, best_flat % C], dim=1).reshape(B)
    return pair_best > NEG_INF / 2, pair_col, pair_mapq


def paired_best_hit_device(
    out: Dict[str, torch.Tensor], qlens: torch.Tensor, scoring: ScoringParams,
    smin_table: torch.Tensor, maxins: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mate-pair-aware best-hit selection (bowtie2 pairing semantics,
    which the reference relies on at midas/run/genes.py:127-132 and
    snps.py:109-114): rows 2i/2i+1 are mates of pair i.

    Concordant candidate pairs — same target sequence, opposite
    strands, forward-strand mate leftmost (fr orientation), fragment
    span <= maxins (bowtie2 --maxins default 500) — are scored as
    score1+score2; the best concordant pair fixes BOTH mates' columns
    and both mates get a pair-level MAPQ (best vs second-best pair,
    bowtie2 computes paired MAPQ from pair scores). Pairs with no
    concordant combination fall back to independent per-mate best hits
    (bowtie2's default mixed mode).

    Known divergence from bowtie2 (documented AND measured): when a
    concordant pair exists, it always wins here, even if one mate's
    best UNPAIRED alignment elsewhere scores far higher — bowtie2
    weighs concordant pairs against the mates' unpaired alignments
    with an unpaired penalty. Quantified on an engineered
    structural-variant library (tests/test_round5_fixes.py::
    test_discordant_pair_divergence_quantified: mate 2 swapped to the
    homologous locus of a 3%-divergent related genome in 7% of pairs):
    59% of the chimeric mates (13/22, i.e. ~2% of all mates at that
    chimera rate) are placed at the concordant locus where per-mate
    best-hit picks the distant one; clean pairs are entirely
    unaffected (pairing only ADDS mapped mates — +16% on that fixture
    — by lifting multimapper MAPQ over the >=20 gate). On libraries
    without structural variation the two policies pick the same pair.

    The port reproduces this divergence; it does not fix it. smin_table
    is score_min_table(scoring, max_len) on the device.

    Returns (aligned [B] bool, best_col [B] int64, mapq [B] int32) —
    the contract of best_hit_device, so every downstream filter is
    unchanged. Traced as the span steps.pair_pick, with the counters
    pair.pairs (pairs with a nonempty first mate) and pair.concordant
    (those with a concordant combination)."""
    with tracing.span("steps.pair_pick"):
        has_pair, pair_col, pair_mapq = concordant_pairs(
            out, qlens, scoring, smin_table, maxins)
        if tracing.enabled():
            tracing.count("pair.pairs", (qlens[0::2] > 0).sum())
            tracing.count("pair.concordant", has_pair.sum())
        # unpaired fallback per mate (mixed mode)
        u_aligned, u_col, u_mapq = best_hit_device(out, qlens, scoring,
                                                   smin_table)
        has_pair_b = has_pair.repeat_interleave(2)
        best_col = torch.where(has_pair_b, pair_col, u_col)
        aligned = has_pair_b | u_aligned
        mapq = torch.where(has_pair_b, pair_mapq.repeat_interleave(2), u_mapq)
        return aligned, best_col, mapq


def keep_mask_chosen(
    full: Dict[str, torch.Tensor], qlens: torch.Tensor,
    mean_qual: torch.Tensor, mapq: torch.Tensor,
    mapid: float, readq: float, min_mapq: int, aln_cov: float,
) -> torch.Tensor:
    """The reference's four keep_read filters (genes.py:153-169 ==
    snps.py:141-162) over the pass-2 per-read ([B]) statistics of the
    chosen candidate (align_chosen_full). Every comparison is in
    float32, in the JAX package's operation order."""
    f32 = torch.float32
    alen = (full["qend"] - full["qstart"]).to(f32)
    nm = (full["mismatches"] + full["gap_cols"]).to(f32)
    pid = 100.0 * (alen - nm) / alen.clamp(min=1.0)
    qlen = qlens.to(f32).clamp(min=1.0)
    return ((pid >= mapid) & (mean_qual >= readq)
            & (mapq >= min_mapq) & (alen / qlen >= aln_cov))


# ---------------------------------------------------------------------------
# species (marker-gene) profiling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpeciesState:
    uniq_count: torch.Tensor  # [S+1] int32 (slot S = no-hit dump)
    uniq_bp: torch.Tensor     # [S+1] int64
    amb_sp: torch.Tensor      # [CAP+1, C] int32, -1 padded
    amb_bp: torch.Tensor      # [CAP+1, C] int32
    amb_seq: torch.Tensor     # [CAP+1, C] int32 pack seq idx (tie ordering:
    #                           hs-blastn emits equal-score hits in
    #                           subject-index order, and the reference's
    #                           RNG draw consumes ids in that order,
    #                           species.py:104-119)
    amb_ord: torch.Tensor     # [CAP+1] int64 global stream rank of the
    #                           read (batch_global_index * batch_size +
    #                           row): the reference consumes its RNG draws
    #                           in stream order, so rows are merged by it
    amb_n: torch.Tensor       # 0-d int64 (true count, may exceed CAP)
    total_alns: torch.Tensor  # 0-d int64


def species_init(n_species: int, num_cands: int, amb_cap: int,
                 device) -> SpeciesState:
    def z(shape, dtype, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return SpeciesState(
        uniq_count=z((n_species + 1,), torch.int32),
        uniq_bp=z((n_species + 1,), torch.int64),
        amb_sp=z((amb_cap + 1, num_cands), torch.int32, -1),
        amb_bp=z((amb_cap + 1, num_cands), torch.int32),
        amb_seq=z((amb_cap + 1, num_cands), torch.int32),
        amb_ord=z((amb_cap + 1,), torch.int64),
        amb_n=z((), torch.int64),
        total_alns=z((), torch.int64),
    )


def species_update(
    state: SpeciesState,
    index_arrays: Dict[str, torch.Tensor],
    pack_arrays: Dict[str, torch.Tensor],
    seq_species: torch.Tensor,   # [num_seqs] int32
    seq_cutoff: torch.Tensor,    # [num_seqs] f32 per-marker %id cutoffs
    codes: torch.Tensor,
    qlens: torch.Tensor,
    n_reads: int,                # real rows in this batch
    ord_base: int,               # global stream rank of row 0
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    aln_cov: float,
    n_species: int,
    min_score: torch.Tensor = None,   # [max_len + 1] int: e-value gate
) -> SpeciesState:
    """One batch of the species classifier, entirely on the state's
    device, updating `state` in place (reference semantics:
    species.py:64-119). min_score, when given, is hs-blastn's
    `-evalue 1e-3` gate as an integer minimum score per read length
    (ScoringParams.evalue_min_score), indexed by max(qlen, 1)."""
    out = _align_batch_stages(index_arrays, pack_arrays, codes, qlens,
                              scoring, seed_params, max_len)
    return species_classify(state, out, seq_species, seq_cutoff, qlens,
                            n_reads, ord_base, aln_cov, n_species, min_score)


def species_classify(
    state: SpeciesState,
    out: Dict[str, torch.Tensor],  # [B, W] valid, score, seq_idx, matches,
    #                                mismatches, gap_cols of one batch
    seq_species: torch.Tensor,
    seq_cutoff: torch.Tensor,
    qlens: torch.Tensor,
    n_reads: int,
    ord_base: int,
    aln_cov: float,
    n_species: int,
    min_score: torch.Tensor = None,
) -> SpeciesState:
    """The classifier half of species_update over a batch's candidate
    table, updating `state` in place: the filters, the best score with
    ties kept, unique counts and bp, ambiguous rows spilled W wide. The
    table is one aligner's [B, C] result, or dist/species.py's [B, tp*C]
    table of every shard's candidates with global sequence ids (ids
    past the pack read its last entry, as midas_tpu's gathers clip)."""
    B = out["score"].shape[0]
    dev = qlens.device
    f32 = torch.float32
    real = torch.arange(B, device=dev) < n_reads
    aln = out["matches"] + out["mismatches"] + out["gap_cols"]
    pid = 100.0 * out["matches"].to(f32) / aln.to(f32).clamp(min=1.0)
    seq_c = out["seq_idx"].clamp(max=seq_species.shape[0] - 1)
    cutoff = seq_cutoff[seq_c]
    qcov = aln.to(f32) / qlens[:, None].to(f32).clamp(min=1.0)
    keep = (out["valid"] & (out["score"] > 0) & (pid >= cutoff)
            & (qcov >= aln_cov) & real[:, None])
    if min_score is not None:
        thr = min_score[qlens.clamp(min=1).to(torch.int64)]
        keep &= out["score"] >= thr[:, None].to(f32)
    scores = torch.where(keep, out["score"], NEG_INF)
    best = scores.amax(dim=1)
    has_hit = best > NEG_INF / 2
    best_mask = keep & (scores == best[:, None])
    n_best = best_mask.sum(dim=1)
    sp = seq_species[seq_c]                                 # [B, C]

    uniq_row = has_hit & (n_best == 1)
    col = torch.argmax(best_mask.to(torch.int32), dim=1)    # first best
    spu = torch.where(uniq_row, _pick(sp, col), n_species).to(torch.int64)
    state.uniq_count.index_add_(0, spu, torch.ones_like(spu, dtype=torch.int32))
    state.uniq_bp.index_add_(
        0, spu, torch.where(uniq_row, _pick(aln, col), 0).to(torch.int64))

    amb_row = has_hit & (n_best >= 2)
    n = state.amb_n
    _append_rows(state.amb_sp, n, torch.where(best_mask, sp, -1), amb_row)
    _append_rows(state.amb_bp, n, torch.where(best_mask, aln, 0), amb_row)
    _append_rows(state.amb_seq, n, torch.where(best_mask, out["seq_idx"], 0),
                 amb_row)
    ords = ord_base + torch.arange(B, dtype=torch.int64, device=dev)
    state.amb_n = _append_rows(state.amb_ord, n, ords, amb_row)
    state.total_alns += (out["valid"] & real[:, None]).sum()
    return state


def sliced_spill_host(bufs: Dict[str, torch.Tensor], n: torch.Tensor,
                      cap: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Read spill buffers back with only the occupied rows, as copies
    (on the CPU a plain .numpy() would alias the buffers, which the next
    batches overwrite after a drain).
    Returns ({name: [min(n, cap), ...] host rows}, true_n)."""
    true_n = int(n)
    take = min(true_n, cap)
    return {k: v[:take].to("cpu", copy=True).numpy()
            for k, v in bufs.items()}, true_n


def species_state_host(state: SpeciesState) -> Dict[str, np.ndarray]:
    """Host snapshot with spill buffers sliced to occupied rows. Used for
    the end-of-stream readback and for checkpoints; amb_n in the result
    is the TRUE count (may exceed the rows present if the buffer
    overflowed). Traced as profile.readback."""
    with tracing.span("profile.readback"):
        cap = state.amb_sp.shape[0] - 1
        out, amb_n = sliced_spill_host(
            {k: getattr(state, k) for k in SPILL_FIELDS}, state.amb_n, cap)
        for k in ("uniq_count", "uniq_bp"):
            out[k] = getattr(state, k).cpu().numpy()
        out["total_alns"] = np.int64(int(state.total_alns))
        out["amb_n"] = np.int64(amb_n)
        return out


def species_state_restore(h: Dict[str, np.ndarray], amb_cap: int,
                          device) -> SpeciesState:
    """Rebuild device state from a species_state_host snapshot."""
    n_species = h["uniq_count"].shape[0] - 1
    st = species_init(n_species, h["amb_sp"].shape[1], amb_cap, device)
    st.uniq_count.copy_(torch.from_numpy(h["uniq_count"].astype(np.int32)))
    st.uniq_bp.copy_(torch.from_numpy(h["uniq_bp"].astype(np.int64)))
    rows = h["amb_sp"].shape[0]
    for k in SPILL_FIELDS:
        buf = getattr(st, k)
        buf[:rows] = torch.from_numpy(np.asarray(h[k]).astype(
            np.int64 if k == "amb_ord" else np.int32)).to(device)
    st.amb_n.fill_(int(h["amb_n"]))
    st.total_alns.fill_(int(h["total_alns"]))
    return st


# ---------------------------------------------------------------------------
# pangenome CNV (genes) profiling
# ---------------------------------------------------------------------------

GENES_FIELDS = ("aligned_reads", "mapped_reads", "bp")


@dataclasses.dataclass
class GenesState:
    aligned_reads: torch.Tensor  # [G+1] int32 (slot G = dump row)
    mapped_reads: torch.Tensor   # [G+1] int32
    bp: torch.Tensor             # [G+1] int32 aligned bp (exact; depth =
    #                              bp/gene_len in float64 on the host)


def genes_init(num_genes: int, device) -> GenesState:
    return GenesState(*(torch.zeros(num_genes + 1, dtype=torch.int32,
                                    device=device) for _ in GENES_FIELDS))


def _two_pass_keep(index_arrays, pack_arrays, codes, quals, qlens,
                   mean_qual, n_reads, scoring, seed_params, max_len, mapid,
                   readq, min_mapq, aln_cov, smin_table, paired):
    """The two-pass alignment of genes_update and snps_update: the
    score-only DP over every candidate (pass 1, K3 with qpen), the best
    hit and its MAPQ — per read, or with paired per mate pair
    (paired_best_hit_device, bowtie2's default --maxins 500) — then the
    full-statistics DP over each read's chosen candidate (pass 2, K2).
    Returns (out1, full, best_col, aligned, keep); aligned and keep
    exclude padding rows."""
    out1, aux = align_candidates_score(index_arrays, pack_arrays, codes,
                                       qlens, scoring, seed_params, max_len,
                                       quals=quals)
    if paired:
        aligned, best_col, mapq = paired_best_hit_device(
            out1, qlens, scoring, smin_table)
    else:
        aligned, best_col, mapq = best_hit_device(out1, qlens, scoring,
                                                  smin_table)
    full = align_chosen_full(pack_arrays, aux, codes, qlens, best_col,
                             scoring, seed_params)
    count_real_pairs(out1["valid"], qlens, per_read=True)
    aligned &= torch.arange(codes.shape[0], device=codes.device) < n_reads
    keep = aligned & keep_mask_chosen(full, qlens, mean_qual, mapq,
                                      mapid, readq, min_mapq, aln_cov)
    return out1, full, best_col, aligned, keep


def genes_update(
    state: GenesState,
    index_arrays: Dict[str, torch.Tensor],
    pack_arrays: Dict[str, torch.Tensor],
    num_genes: int,
    codes: torch.Tensor,
    quals: torch.Tensor,         # [B, L] int8 (bowtie2 quality-scaled --mp)
    qlens: torch.Tensor,
    mean_qual: torch.Tensor,     # [B] float32
    n_reads: int,                # real rows in this batch
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    aln_cov: float,
    smin_table: torch.Tensor,    # score_min_table(scoring, max_len)
    paired: bool = False,        # rows 2i/2i+1 are mates
) -> GenesState:
    """One batch of CNV counting on the state's device, updating `state`
    in place (reference semantics: genes.py:153-203).

    Two-pass alignment: score-only DP over every candidate for selection
    and MAPQ (pass 1, K3), then the full-statistics DP over just each
    read's chosen candidate (pass 2, K2). With paired, rows 2i/2i+1 are
    mates and the best concordant pair picks both (paired_best_hit_
    device). The three per-gene sums are integer scatter-adds — exact
    in any order; slot G takes every read that is not counted."""
    out1, full, best_col, aligned, keep = _two_pass_keep(
        index_arrays, pack_arrays, codes, quals, qlens, mean_qual, n_reads,
        scoring, seed_params, max_len, mapid, readq, min_mapq, aln_cov,
        smin_table, paired)
    return genes_tally(state, num_genes, out1["seq_idx"], full, best_col,
                       aligned, keep)


def genes_tally(state: GenesState, num_genes: int, seq_idx: torch.Tensor,
                full: Dict[str, torch.Tensor], best_col: torch.Tensor,
                aligned: torch.Tensor, keep: torch.Tensor) -> GenesState:
    """genes_update's integer scatter-adds, in place: aligned and kept
    reads per gene (seq_idx [B, W] picked at best_col) and the kept
    reads' aligned bp (full, the pass-2 statistics). Slot G takes every
    read that is not counted, and any gene id past the pack (midas_tpu's
    scatter drops those)."""
    G = num_genes
    g = _pick(seq_idx, best_col)
    ones = torch.ones(g.shape[0], dtype=torch.int32, device=g.device)
    state.aligned_reads.index_add_(0, torch.where(aligned & (g < G), g, G),
                                   ones)
    gk = torch.where(keep & (g < G), g, G)
    state.mapped_reads.index_add_(0, gk, ones)
    alen = full["qend"] - full["qstart"]
    state.bp.index_add_(0, gk, torch.where(gk < G, alen, 0).to(torch.int32))
    return state


def genes_state_host(state: GenesState) -> Dict[str, np.ndarray]:
    """Host snapshot of the accumulators, traced as profile.readback."""
    with tracing.span("profile.readback"):
        return {k: getattr(state, k).cpu().numpy() for k in GENES_FIELDS}


def genes_state_restore(h: Dict[str, np.ndarray], device) -> GenesState:
    return GenesState(*(torch.from_numpy(
        np.asarray(h[k]).astype(np.int32)).to(device) for k in GENES_FIELDS))


# ---------------------------------------------------------------------------
# SNP pileup profiling
# ---------------------------------------------------------------------------

GAP_FIELDS = ("gap_codes", "gap_quals", "gap_meta")


@dataclasses.dataclass
class SnpsState:
    counts: torch.Tensor         # [4 * (G+1)] int32 flat pileup counts
    #                              (base-major; column G is the dump slot)
    aligned_reads: torch.Tensor  # [S+1] int32 per species (slot S = dump)
    mapped_reads: torch.Tensor   # [S+1] int32
    gap_codes: torch.Tensor      # [CAP+1, L] int8 kept gapped reads, as
    #                              aligned (strand-adjusted)
    gap_quals: torch.Tensor      # [CAP+1, L] int8
    gap_meta: torch.Tensor       # [CAP+1, 4] int32: seq_idx, tstart, tend,
    #                              qlen
    gap_n: torch.Tensor          # 0-d int64 true count (may exceed CAP)


def snps_init(total_len: int, n_species: int, gap_cap: int, max_len: int,
              device) -> SnpsState:
    def z(shape, dtype, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return SnpsState(
        counts=z((4 * (total_len + 1),), torch.int32),
        aligned_reads=z((n_species + 1,), torch.int32),
        mapped_reads=z((n_species + 1,), torch.int32),
        gap_codes=z((gap_cap + 1, max_len), torch.int8, 4),
        gap_quals=z((gap_cap + 1, max_len), torch.int8),
        gap_meta=z((gap_cap + 1, 4), torch.int32),
        gap_n=z((), torch.int64),
    )


def snps_state_host_without_counts(state) -> Dict[str, np.ndarray]:
    """snps_state_host's fields but the counts: the gap buffers sliced to
    their occupied rows, the per-species counters; gap_n is the TRUE
    count."""
    cap = state.gap_codes.shape[0] - 1
    out, gap_n = sliced_spill_host(
        {k: getattr(state, k) for k in GAP_FIELDS}, state.gap_n, cap)
    for k in ("aligned_reads", "mapped_reads"):
        out[k] = getattr(state, k).cpu().numpy()
    out["gap_n"] = np.int64(gap_n)
    return out


def snps_state_host(state: SnpsState) -> Dict[str, np.ndarray]:
    """Host snapshot: snps_state_host_without_counts and the counts
    through profile/sparse_counts.py (int32, the dump slot zeroed, as
    midas_tpu's readback gives them). Traced as profile.readback, with
    the route the counts took as its attr route."""
    with tracing.span("profile.readback"):
        out = snps_state_host_without_counts(state)
        out["counts"] = counts_host_sparse(state.counts,
                                           state.counts.shape[0] // 4 - 1)
        return out


def snps_state_restore(h: Dict[str, np.ndarray], gap_cap: int,
                       device) -> SnpsState:
    """Rebuild device state from a snps_state_host snapshot, whose gap
    rows must fit the capacity."""
    total_len = h["counts"].shape[0] // 4 - 1
    n_species = h["aligned_reads"].shape[0] - 1
    rows = h["gap_codes"].shape[0]
    if rows > gap_cap:
        raise ValueError(f"{rows} gap rows exceed the capacity {gap_cap}")
    st = snps_init(total_len, n_species, gap_cap, h["gap_codes"].shape[1],
                   device)
    for k in ("counts", "aligned_reads", "mapped_reads"):
        getattr(st, k).copy_(torch.from_numpy(
            np.asarray(h[k]).astype(np.int32)))
    for k in GAP_FIELDS:
        buf = getattr(st, k)
        buf[:rows] = torch.from_numpy(np.asarray(h[k])).to(device,
                                                          buf.dtype)
    st.gap_n.fill_(int(h["gap_n"]))
    return st


def snps_update(
    state: SnpsState,
    index_arrays: Dict[str, torch.Tensor],
    pack_arrays: Dict[str, torch.Tensor],
    contig_species: torch.Tensor,  # [num_seqs] int64
    codes: torch.Tensor,
    quals: torch.Tensor,           # [B, L] int8
    qlens: torch.Tensor,
    mean_qual: torch.Tensor,       # [B] float32
    n_reads: int,                  # real rows in this batch
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    baseq: int,
    aln_cov: float,
    smin_table: torch.Tensor,      # score_min_table(scoring, max_len)
    paired: bool = False,          # rows 2i/2i+1 are mates
) -> SnpsState:
    """One pileup batch on the state's device, updating `state` in place
    (reference semantics: snps.py:141-216). Gapless kept reads add their
    bases straight into the counts (the closed-form column map); gapped
    kept reads are appended, strand-adjusted, to the gap buffers for the
    exact host traceback. No host sync: gap_n stays on the device.

    Two-pass alignment, as genes_update: the score-only DP over every
    candidate (pass 1, K3 with qpen), then the full-statistics DP over
    each read's chosen candidate (pass 2, K2), with paired per mate pair
    as genes_update. Every sum is an integer scatter-add, exact in any
    order."""
    out1, full, best_col, aligned, keep = _two_pass_keep(
        index_arrays, pack_arrays, codes, quals, qlens, mean_qual, n_reads,
        scoring, seed_params, max_len, mapid, readq, min_mapq, aln_cov,
        smin_table, paired)
    # the genome length from the counts buffer, not the pack: the pack
    # carries a guard pad beyond its total length (refpack.py)
    G = state.counts.shape[0] // 4 - 1
    ci = _pick(out1["seq_idx"], best_col)
    qsel, qqsel = snps_tally(state, contig_species, ci,
                             _pick(out1["strand"], best_col), codes, quals,
                             qlens, aligned, keep)
    gapless = full["gap_cols"] == 0
    pileup_add(state.counts, G, pack_arrays["offsets"][ci], qsel, qqsel,
               full, keep & gapless, baseq)
    spill_gapped(state, ci, qsel, qqsel, full, qlens, keep & ~gapless)
    return state


def snps_tally(state: SnpsState, contig_species: torch.Tensor,
               ci: torch.Tensor, strand: torch.Tensor, codes, quals, qlens,
               aligned: torch.Tensor, keep: torch.Tensor):
    """snps_update's per-species aligned / kept read counters (in place),
    by each read's chosen contig ci (ids past the pack read the last
    entry, as midas_tpu's gathers clip), and the reads as aligned:
    reverse-complemented codes and reversed qualities on the reverse
    strand. Returns (qsel, qqsel) [B, L]."""
    S = state.aligned_reads.shape[0] - 1
    sp = contig_species[ci.clamp(max=contig_species.shape[0] - 1)]
    ones = torch.ones(ci.shape[0], dtype=torch.int32, device=ci.device)
    state.aligned_reads.index_add_(0, torch.where(aligned, sp, S), ones)
    state.mapped_reads.index_add_(0, torch.where(keep, sp, S), ones)
    is_rc = (strand == 1)[:, None]
    qsel = torch.where(is_rc, revcomp_batch(codes, qlens), codes)
    qqsel = torch.where(is_rc, reverse_batch(quals, qlens, fill=0), quals)
    return qsel, qqsel


def pileup_add(counts: torch.Tensor, G: int, seq_lo: torch.Tensor,
               qsel: torch.Tensor, qqsel: torch.Tensor,
               full: Dict[str, torch.Tensor], rows: torch.Tensor,
               baseq: int) -> None:
    """The closed-form pileup of gapless reads, in place: each base of
    each read in `rows` at or above baseq adds one to counts (flat
    [4 x (G+1)], base-major, column G the dump slot) at seq_lo + tstart
    + its offset past qstart, if that lies in [0, G)."""
    B, L = qsel.shape
    dev = qsel.device
    qs, ts = full["qstart"][:, None], full["tstart"][:, None]
    j = torch.arange(L, device=dev)[None, :]
    tpos = seq_lo[:, None] + ts + (j - qs)
    base = qsel.to(torch.int64)
    ok = (rows[:, None] & (j >= qs) & (j < full["qend"][:, None])
          & (qqsel.to(torch.int32) >= baseq) & (base < 4) & (tpos >= 0)
          & (tpos < G))
    flat = torch.where(ok, base * (G + 1) + tpos, G)
    counts.index_add_(0, flat.reshape(-1),
                      torch.ones(B * L, dtype=torch.int32, device=dev))


def spill_gapped(state: SnpsState, ci: torch.Tensor, qsel: torch.Tensor,
                 qqsel: torch.Tensor, full: Dict[str, torch.Tensor],
                 qlens: torch.Tensor, is_gap: torch.Tensor) -> None:
    """Append the kept gapped reads, in stream order, to the gap buffers:
    codes and qualities as aligned, meta (contig, tstart, tend, qlen)."""
    meta = torch.stack([ci.to(torch.int32), full["tstart"].to(torch.int32),
                        full["tend"].to(torch.int32), qlens.to(torch.int32)],
                       dim=1)
    n = state.gap_n
    _append_rows(state.gap_codes, n, qsel, is_gap)
    _append_rows(state.gap_quals, n, qqsel, is_gap)
    state.gap_n = _append_rows(state.gap_meta, n, meta, is_gap)
