"""Device-resident profiling steps: no per-batch host readback.

Each `update` runs seed -> banded DP -> best-hit -> filter -> segment
reduction on the device the state lies on, and updates the state IN
PLACE (the JAX package donates its state to the jit for the same
effect). Reads that need host math — ambiguous marker hits, which go
through the reference's RNG assignment (midas/run/species.py:104-119)
— are spilled into a fixed-capacity device staging buffer that the
caller drains (profile/species.py).

Filter semantics are those of midas_tpu/profile/device_steps.py, with
two deliberate changes for exactness: uniq_bp accumulates in int64 (the
JAX package sums in float32, exact only below 2^24 bp per species), and
the stream rank amb_ord is int64 (int32 overflows past 2^31 reads).
Results are equal wherever the JAX package is exact.

Only the species part is ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.pipeline import _align_batch_stages
from midas_tpu_torch.align.seed import SeedParams

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
    B, C = out["score"].shape
    dev = codes.device
    f32 = torch.float32
    real = torch.arange(B, device=dev) < n_reads
    aln = out["matches"] + out["mismatches"] + out["gap_cols"]
    pid = 100.0 * out["matches"].to(f32) / aln.to(f32).clamp(min=1.0)
    cutoff = seq_cutoff[out["seq_idx"]]
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
    sp = seq_species[out["seq_idx"]]                        # [B, C]

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
    """Read spill buffers back with only the occupied rows.
    Returns ({name: [min(n, cap), ...] host rows}, true_n)."""
    true_n = int(n)
    take = min(true_n, cap)
    return {k: v[:take].cpu().numpy() for k, v in bufs.items()}, true_n


def species_state_host(state: SpeciesState) -> Dict[str, np.ndarray]:
    """Host snapshot with spill buffers sliced to occupied rows. Used for
    the end-of-stream readback and for checkpoints; amb_n in the result
    is the TRUE count (may exceed the rows present if the buffer
    overflowed)."""
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
