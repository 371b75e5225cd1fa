"""Full seed-and-extend aligner over a packed reference.

Composes db/index.py (hashed seed tables) + align/seed.py (seed-and-
vote candidates) + the banded affine DP (align/cuda_sw.py: the CUDA
kernel on the card, the plain version on the CPU) into the equivalent
of one bowtie2 / hs-blastn invocation (reference call sites:
midas/run/species.py:29-49, genes.py:116-145, snps.py:97-128).
Alignments never leave the device as text: downstream profilers consume
the [B, C] result tensors directly, except on the species --m8 path,
which reads a batch's whole result back (Aligner.align_batch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from midas_tpu_torch import tracing
from midas_tpu_torch.align import cuda_sw
from midas_tpu_torch.align.banded import banded_align_plain
from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.seed import (SeedParams, find_candidates,
                                        gather_windows_packed,
                                        pack_words_host, reverse_batch)
from midas_tpu_torch.db.index import SeedIndex
from midas_tpu_torch.db.refpack import ReferencePack
from midas_tpu_torch.io.batch import ReadBatch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    is an error: the port never falls back from the card to the CPU.
    Under a launcher of several processes (LOCAL_RANK set, or a process
    group of several ranks) a bare "cuda" is this rank's card,
    cuda:{local rank % card count}, made the current device."""
    from midas_tpu_torch.dist.driver import local_rank

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA card is available; pass "
            "device='cpu' to run the plain CPU path")
    if device.type == "cuda" and device.index is None \
            and local_rank() is not None:
        device = torch.device("cuda",
                              local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


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


@dataclasses.dataclass
class AlignmentResult:
    """Host-side view of one aligned batch. All arrays [B, C] unless
    noted; coordinates are local to the hit sequence (0-based,
    half-open), query coordinates are in the aligned strand's frame."""

    names: list                 # [B'] read names
    n_reads: int
    valid: np.ndarray           # bool: candidate produced an alignment
    score: np.ndarray           # float32 raw DP score
    seq_idx: np.ndarray         # target sequence index into pack.names
    strand: np.ndarray          # 0 fwd, 1 rc
    tstart: np.ndarray
    tend: np.ndarray
    qstart: np.ndarray
    qend: np.ndarray
    matches: np.ndarray
    mismatches: np.ndarray
    gap_cols: np.ndarray
    gap_opens: np.ndarray

    @property
    def aln_cols(self) -> np.ndarray:
        return self.matches + self.mismatches + self.gap_cols

    @property
    def nm(self) -> np.ndarray:
        return self.mismatches + self.gap_cols

    @property
    def blast_pid(self) -> np.ndarray:
        return 100.0 * self.matches / np.maximum(self.aln_cols, 1)

    @property
    def aligned_qlen(self) -> np.ndarray:
        return self.qend - self.qstart

    @property
    def bowtie_pid(self) -> np.ndarray:
        alen = np.maximum(self.aligned_qlen, 1)
        return 100.0 * (alen - self.nm) / alen


def dispatch_banded_align(q_pair, qlens_pair, win_pair, scoring, band_width,
                          score_only: bool = False, qpen_pair=None):
    """The banded DP over [P, L] pairs: the hand-written kernel for CUDA
    tensors (align/cuda_sw.py), the plain version for CPU tensors, and an
    error for anything else — never the plain version for a CUDA tensor.
    The kernel masks its own ragged edge, so P needs no padding.
    score_only=True returns score/qend/wstart/wend only (pass 1 of the
    two-pass alignment); qpen_pair ([P, L] int8 positive penalties)
    enables the bowtie2 quality-scaled mismatch model.

    Traced as the span align.dp (attrs variant, pairs), with the
    counter dp.pairs (the pairs launched); the callers count which of
    them are real (count_real_pairs)."""
    P = q_pair.shape[0]
    with tracing.span("align.dp", pairs=P, variant=cuda_sw.variant_key(
            1 if score_only else 6, qpen_pair is not None)):
        tracing.count("dp.pairs", P)
        kind = q_pair.device.type
        if kind == "cuda":
            return cuda_sw.banded_align_cuda(
                q_pair, qlens_pair, win_pair, scoring, band_width,
                qpen=qpen_pair, score_only=score_only)
        if kind == "cpu":
            return banded_align_plain(q_pair, qlens_pair, win_pair, scoring,
                                      band_width, qpen=qpen_pair,
                                      score_only=score_only)
    raise ValueError(f"banded DP: no implementation for tensors on "
                     f"{q_pair.device}")


def count_real_pairs(valid: torch.Tensor, qlens: torch.Tensor,
                     per_read: bool = False) -> None:
    """While tracing, add to the counter dp.real_pairs the DP pairs that
    hold a real candidate. valid [B, C] is the candidates' valid flags:
    pass 1 launches a pair a candidate, real where it is valid; pass 2
    (per_read) launches a pair a read, real where the read has any
    valid candidate. A pair whose query is empty (qlens [B]) is never
    real. Off, it does nothing, so callers pass the flags as they are."""
    if tracing.enabled():
        nonempty = qlens > 0
        real = (valid.any(dim=1) & nonempty if per_read
                else valid & nonempty[:, None])
        tracing.count("dp.real_pairs", real.sum())


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
    is quality-scaled and quals are given. Traced as the span align.seed
    (seeding and the gather), with the counter seed.candidates (valid
    candidates) and, since every candidate goes to the DP, its pass-1
    dp.real_pairs."""
    B, L = codes.shape
    C = seed_params.num_cands
    D = seed_params.band_width
    W = L + D - 1
    with tracing.span("align.seed"):
        cands = find_candidates(index_arrays, codes, qlens, seed_params,
                                max_len)
        winstart = cands["diag"] - D // 2
        ref_win, seq_idx = gather_windows_packed(
            pack_arrays["words"], pack_arrays["nmask"],
            pack_arrays["offsets"], winstart, W,
            center=cands["diag"] + qlens[:, None] // 2)
        if tracing.enabled():
            tracing.count("seed.candidates", cands["valid"].sum())
        count_real_pairs(cands["valid"], qlens)
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


def _pack_result(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack the 12 [B, C] result planes into one int32 [12, B, C]
    tensor, so that the host reads a batch back in one copy. DP scores
    are integer-valued (integer match/mismatch/gap parameters), so the
    int32 round trip is exact; torch.round rounds half to even."""
    planes = [out["valid"].to(torch.int32),
              torch.round(out["score"]).to(torch.int32)]
    planes += [out[k].to(torch.int32) for k in Aligner._PACK_FIELDS[2:]]
    return torch.stack(planes)


class Aligner:
    """Aligner bound to one ReferencePack + SeedIndex, its tensors on
    one device."""

    def __init__(
        self,
        pack: ReferencePack,
        index: SeedIndex,
        scoring: ScoringParams,
        seed_params: Optional[SeedParams] = None,
        max_read_len: int = 128,
        device="cuda",
    ):
        words, nmask = pack_words_host(pack.codes)
        self._bind(
            dict(bucket1=index.bucket1, bucket2=index.bucket2,
                 positions2d=index.positions2d),
            dict(words=words, nmask=nmask, offsets=pack.offsets),
            scoring, seed_params, max_read_len, device)

    @classmethod
    def from_numpy(cls, index_arrays: Dict[str, np.ndarray],
                   pack_arrays: Dict[str, np.ndarray],
                   scoring: ScoringParams,
                   seed_params: Optional[SeedParams] = None,
                   max_read_len: int = 128, device="cuda") -> "Aligner":
        """An aligner from database-derived arrays as numpy: index_arrays
        bucket1, bucket2 ([NB, 24] int32), positions2d ([R, 8] int32);
        pack_arrays words, nmask (uint32, as pack_words_host gives them)
        and offsets ([S+1]). These are the arrays the JAX package's
        Aligner holds, so both packages can be fed the same index."""
        self = cls.__new__(cls)
        self._bind(index_arrays, pack_arrays, scoring, seed_params,
                   max_read_len, device)
        return self

    def _bind(self, index_arrays, pack_arrays, scoring, seed_params,
              max_read_len, device) -> None:
        self.device = resolve_device(device)
        self.scoring = scoring
        self.seed_params = seed_params or SeedParams()
        self.max_read_len = max_read_len

        def put(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(a).astype(dtype))
            ).to(self.device)

        self.index_arrays = {k: put(index_arrays[k], np.int32)
                             for k in ("bucket1", "bucket2", "positions2d")}
        # uint32 words / masks held in int64 (torch's uint32 support is
        # partial); offsets int64, as searchsorted wants matching dtypes
        self.pack_arrays = {k: put(pack_arrays[k], np.int64)
                            for k in ("words", "nmask", "offsets")}

    _PACK_FIELDS = ("valid", "score", "seq_idx", "strand", "tstart", "tend",
                    "qstart", "qend", "matches", "mismatches", "gap_cols",
                    "gap_opens")

    def align_batch(self, batch: ReadBatch) -> AlignmentResult:
        """Align one host batch on the aligner's device and read its whole
        result back in one copy: valid as bool, score as float32, the
        other planes as int32. Padding rows past n_reads are not valid."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        quals = put(batch.quals) if self.scoring.qual_scaled else None
        packed = _pack_result(self.align_batch_device(
            put(batch.codes), put(batch.lengths), quals=quals)).cpu().numpy()
        host = {}
        for i, k in enumerate(self._PACK_FIELDS):
            arr = packed[i]
            if k == "valid":
                arr = arr.astype(bool)
            elif k == "score":
                arr = arr.astype(np.float32)
            host[k] = arr
        host["valid"][batch.n_reads:] = False
        return AlignmentResult(names=batch.names, n_reads=batch.n_reads, **host)

    def align_batch_device(self, codes: torch.Tensor, qlens: torch.Tensor,
                           quals: Optional[torch.Tensor] = None):
        return _align_batch_stages(
            self.index_arrays, self.pack_arrays, codes, qlens,
            self.scoring, self.seed_params, self.max_read_len, quals=quals)


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
    gap_cols, gap_opens, tstart, tend. The gather is traced as
    align.seed."""
    B, L = codes.shape
    D = seed_params.band_width
    W = L + D - 1
    pack_offsets = pack_arrays["offsets"]
    col = best_col[:, None]
    winstart_b = torch.gather(aux["winstart"], 1, col)           # [B, 1]
    strand_b = torch.gather(aux["strand"], 1, col)[:, 0]         # [B]
    with tracing.span("align.seed"):
        ref_win, seq_idx = gather_windows_packed(
            pack_arrays["words"], pack_arrays["nmask"], pack_offsets,
            winstart_b, W,
            center=winstart_b + D // 2 + qlens[:, None] // 2)  # [B,1,W], [B,1]
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
