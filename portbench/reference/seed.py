"""Seed-and-vote candidate generation, plain PyTorch on any device.

A frozen copy of the port's align/seed.py (midas_tpu_torch), kept under
portbench/ as part of the benchmark's plain reference. The one change:
k-mer lookups read the reference's own sorted index (index.py: every
k-mer's positions in ascending order, found by binary search) instead of
the port's bucketed hash table with row-aligned position runs; the hit
budget is still counted in rows of ROW positions, so the same hits are
packed.

Replaces the seeding half of bowtie2 / hs-blastn: query k-mers at a
fixed stride are looked up in the hashed SeedIndex (db/index.py), every
hit votes for an alignment diagonal (ref_pos - query_pos), and the
top-C diagonals per read by vote count become banded-extension
candidates. Both strands are searched by seeding the reverse-complement
read.

Same values as midas_tpu/align/seed.py, not the same form: the TPU
package avoids gathers and sorts with shift ladders, an O(S^2) counting
rank and one-hot contractions; here plain gathers, stable sorts and
searchsorted give the same arrays. Unsigned 32-bit arithmetic (the hash,
the 2-bit word unpack) runs in int64 with explicit masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference.index import ROW, lookup

INVALID_KEY = 2**31 - 1
STRAND_OFFSET = 2**30  # keys: strand * STRAND_OFFSET + diag + L
BASES_PER_WORD = 16  # 2-bit codes packed into uint32 words


@dataclasses.dataclass(frozen=True)
class SeedParams:
    k: int = 14
    stride: int = 7          # query seed stride
    max_hits: int = 16       # hits gathered per seed
    num_cands: int = 4       # banded-extension candidates per read
    band_width: int = 16     # D of the banded DP
    max_read_hits: int = 128  # per-read per-strand packed hit budget


def _flip_rows(x: torch.Tensor, qlens: torch.Tensor,
               fill: int) -> torch.Tensor:
    """out[i, j] = x[i, qlen_i-1-j] for j < qlen_i, `fill` beyond."""
    B, L = x.shape
    j = torch.arange(L, device=x.device)[None, :]
    src = qlens.to(torch.int64)[:, None] - 1 - j
    got = torch.gather(x, 1, src.clamp(0, L - 1))
    return torch.where(src >= 0, got, torch.full_like(got, fill))


def revcomp_batch(codes: torch.Tensor, qlens: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement, keeping reads left-aligned.
    codes [B, L] int8 (4 = pad); rc[i, j] = comp(codes[i, qlen_i-1-j])."""
    comp = torch.where(codes < 4, 3 - codes, 4).to(torch.int8)
    return _flip_rows(comp, qlens, 4)


def reverse_batch(x: torch.Tensor, qlens: torch.Tensor,
                  fill: int = 0) -> torch.Tensor:
    """Per-read reversal without complement (quality / penalty planes
    riding alongside revcomp_batch'ed codes), keeping rows left-aligned:
    out[i, j] = x[i, qlen_i-1-j], `fill` beyond the read."""
    return _flip_rows(x, qlens, fill)


def _query_kmers(codes: torch.Tensor, qlens: torch.Tensor, k: int,
                 stride: int, max_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K-mers at stride positions. Returns (kmers [B,S] int64 < 2^30,
    qpos [S] int64, valid [B,S] bool)."""
    B, L = codes.shape
    n_seeds = max(1, (max_len - k) // stride + 1)
    if (n_seeds - 1) * stride + k > L:
        raise ValueError(f"{n_seeds} seeds of k={k} at stride {stride} "
                         f"exceed read length {L}")
    qpos = torch.arange(n_seeds, device=codes.device) * stride      # [S]
    cols = qpos[:, None] + torch.arange(k, device=codes.device)      # [S, k]
    wins = codes[:, cols].to(torch.int64)                             # [B, S, k]
    km = torch.zeros((B, n_seeds), dtype=torch.int64, device=codes.device)
    for i in range(k):
        km = (km << 2) | (wins[:, :, i] & 3)
    valid = (wins < 4).all(dim=2)
    valid &= qpos[None, :] + k <= qlens[:, None]
    return km, qpos, valid


def _packed_strand_keys(
    index_arrays: Dict[str, torch.Tensor],
    strand_codes: torch.Tensor,   # [B, L] int8
    qlens: torch.Tensor,
    strand: int,
    sp: SeedParams,
    max_len: int,
) -> torch.Tensor:
    """Diagonal vote keys for one strand, packed to [B, max_read_hits]
    int64. Seeds are taken in ascending hit count (stable), so unique,
    informative seeds pack first; position runs are row-aligned
    (db/index.py), so hits come as whole ROW-wide rows. Invalid slots
    carry INVALID_KEY."""
    B, L = strand_codes.shape
    dev = strand_codes.device
    positions = index_arrays["pos"]
    km, qpos, valid = _query_kmers(strand_codes, qlens, sp.k, sp.stride,
                                   max_len)
    start, count = lookup(index_arrays, km)                        # [B, S]
    c = torch.where(valid, count.clamp(max=sp.max_hits), 0)

    order = torch.argsort(c, dim=1, stable=True)
    c_s = torch.gather(c, 1, order)
    st_s = torch.gather(start, 1, order)
    qpos_s = qpos[order]

    r_s = (c_s + ROW - 1) // ROW                                   # rows per seed
    roffs = torch.cumsum(r_s, dim=1) - r_s                         # exclusive
    rtotal = roffs[:, -1] + r_s[:, -1]                             # [B]
    R = max(1, sp.max_read_hits // ROW)
    j = torch.arange(R, device=dev).expand(B, R).contiguous()      # [B, R]
    # row j belongs to seed sid = max{s : roffs[s] <= j}
    sid = torch.searchsorted(roffs, j, right=True) - 1
    st_of = torch.gather(st_s, 1, sid)
    roffs_of = torch.gather(roffs, 1, sid)
    qpos_of = torch.gather(qpos_s, 1, sid)
    c_of = torch.gather(c_s, 1, sid)
    rwi = j - roffs_of                                             # row within seed
    jvalid = j < rtotal.clamp(max=R)[:, None]
    e = torch.arange(ROW, device=dev)[None, None, :]
    flat = (st_of[:, :, None] + rwi[:, :, None] * ROW + e).clamp(
        0, positions.shape[0] - 1)
    prow = positions[flat]                                         # [B, R, ROW]
    elem_valid = (jvalid[:, :, None]
                  & ((rwi[:, :, None] * ROW + e) < c_of[:, :, None]))
    key = strand * STRAND_OFFSET + (prow - qpos_of[:, :, None]) + L
    return torch.where(elem_valid, key, INVALID_KEY).reshape(B, R * ROW)


def find_candidates(
    index_arrays: Dict[str, torch.Tensor],
    codes: torch.Tensor,   # [B, L] int8
    qlens: torch.Tensor,   # [B] int32
    sp: SeedParams,
    max_len: int,
) -> Dict[str, torch.Tensor]:
    """Top-C (diagonal, strand) candidates per read by seed votes.

    Returns dict with [B, C] tensors: diag (ref_pos - query_pos in pack
    coords, int64), strand (0 fwd / 1 rc), votes (seed hits on that
    diagonal), valid (bool) — plus rc [B, L], the reverse-complement
    reads (reused by the extension stage)."""
    B, L = codes.shape
    dev = codes.device
    rc = revcomp_batch(codes, qlens)
    keys = torch.cat(
        [_packed_strand_keys(index_arrays, sc, qlens, strand, sp, max_len)
         for strand, sc in enumerate((codes, rc))], dim=1)        # [B, M]
    keys = torch.sort(keys, dim=1).values
    M = keys.shape[1]
    j_idx = torch.arange(M, device=dev).expand(B, M)
    is_start = torch.ones((B, M), dtype=torch.bool, device=dev)
    is_start[:, 1:] = keys[:, 1:] != keys[:, :-1]
    # votes at a run start = distance to the next run start
    start_pos = torch.where(is_start, j_idx, M)
    next_start = torch.full((B, M), M, dtype=torch.int64, device=dev)
    next_start[:, :-1] = torch.flip(
        torch.cummin(torch.flip(start_pos[:, 1:], [1]), dim=1).values, [1])
    votes = next_start - j_idx
    eligible = is_start & (keys != INVALID_KEY)
    score = torch.where(eligible, votes, -1)

    # C rounds of argmax + neighborhood masking (dedup near-diagonals)
    tol = sp.band_width // 2
    cand_key, cand_votes = [], []
    for _ in range(sp.num_cands):
        best_j = torch.argmax(score, dim=1, keepdim=True)  # first = smallest key
        bvotes = torch.gather(score, 1, best_j)
        bkey = torch.gather(keys, 1, best_j)
        cand_key.append(bkey)
        cand_votes.append(bvotes)
        score = torch.where((keys - bkey).abs() <= tol, -1, score)
    cand_key = torch.cat(cand_key, dim=1)                          # [B, C]
    cand_votes = torch.cat(cand_votes, dim=1)
    strand = torch.div(cand_key, STRAND_OFFSET, rounding_mode="floor")
    diag = cand_key - strand * STRAND_OFFSET - L
    return dict(diag=diag, strand=strand, votes=cand_votes,
                valid=cand_votes > 0, rc=rc)


def _window_seq_bounds(pack_offsets: torch.Tensor, winstart: torch.Tensor,
                       W: int, center: torch.Tensor = None):
    """Target sequence owning each window, by its expected alignment
    midpoint (callers pass center = diag + qlen // 2; the window
    midpoint is only right when the read fills the window)."""
    if center is None:
        center = winstart + W // 2
    seq_idx = torch.searchsorted(pack_offsets, center.contiguous(),
                                 right=True) - 1
    seq_idx = seq_idx.clamp(0, pack_offsets.shape[0] - 2)
    return seq_idx, pack_offsets[seq_idx], pack_offsets[seq_idx + 1]


def gather_windows_packed(
    pack_words: torch.Tensor,    # [NW] int64 holding uint32, 16 bases/word
    pack_nmask: torch.Tensor,    # [NW] int64, bit j = base j is a sentinel
    pack_offsets: torch.Tensor,  # [S+1] int64
    winstart: torch.Tensor,      # [B, C] int64 global pack coords
    window_len: int,
    center: torch.Tensor = None,  # [B, C] expected alignment midpoint
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference windows from the 2-bit word-packed pack, masked to code
    4 outside the owning sequence (alignments never cross packed
    sequence boundaries) and at sentinel bases.

    Returns (ref_win [B, C, W] int8, seq_idx [B, C] int64)."""
    W = window_len
    seq_idx, seq_lo, seq_hi = _window_seq_bounds(pack_offsets, winstart, W,
                                                 center=center)
    pos = winstart[:, :, None] + torch.arange(W, device=winstart.device)
    widx = torch.div(pos, BASES_PER_WORD, rounding_mode="floor").clamp(
        0, pack_words.shape[0] - 1)
    sub = pos & (BASES_PER_WORD - 1)           # floor mod for negatives too
    base = (pack_words[widx] >> (2 * sub)) & 3
    is_n = ((pack_nmask[widx] >> sub) & 1) != 0
    in_seq = (pos >= seq_lo[:, :, None]) & (pos < seq_hi[:, :, None])
    ref_win = torch.where(in_seq & ~is_n, base, 4).to(torch.int8)
    return ref_win, seq_idx


def pack_words_host(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 2-bit packing of a reference code array.

    Returns (words [ceil(G/16)+1] uint32 with 16 bases/word, nmask of the
    same shape with bit j set where base j is a sentinel). One guard word
    is appended so clipped gathers near the end stay in range."""
    codes = np.asarray(codes, dtype=np.int8)
    G = len(codes)
    nw = (G + BASES_PER_WORD - 1) // BASES_PER_WORD
    padded = np.full(nw * BASES_PER_WORD, 4, dtype=np.int8)
    padded[:G] = codes
    grid = padded.reshape(nw, BASES_PER_WORD).astype(np.uint32)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 2)[None, :]
    words = ((grid & 3) << shifts).sum(axis=1, dtype=np.uint32)
    nmask = ((grid >= 4).astype(np.uint32)
             << np.arange(BASES_PER_WORD, dtype=np.uint32)[None, :]).sum(
                 axis=1, dtype=np.uint32)
    guard_word = np.zeros(1, np.uint32)
    guard_mask = np.full(1, 0xFFFF, np.uint32)  # all-sentinel guard
    return (np.concatenate([words, guard_word]),
            np.concatenate([nmask, guard_mask]))
