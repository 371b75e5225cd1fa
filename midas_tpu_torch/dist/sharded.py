"""Tensor parallelism: the seed index sharded across devices —
midas_tpu's dist/sharded.py on PyTorch.

A reference pack too large for one device (a 5,952-species pangenome
database) is cut into tp slices by target sequence, each with its own
bucketed seed index (shard_index). A profiler with tp = T holds T
shards, each slice's word-packed pack, index and first global sequence
id (seq_base) on the shard's device (shard_devices); every read batch
is seeded and aligned against every shard, and the per-read candidate
tables are reassembled on shard 0's device.

JAX's "tp" mesh axis lives inside one process, and so does this one:
one process drives a list of devices, and the mesh collectives become
tensor ops in the process —

- all_gather(..., "tp", axis=1, tiled=True): a torch.cat of the shards'
  [B, C] planes along dim 1, in shard order, on shard 0's device;
- psum over "tp": a sum; pmax / pmin: a max / min over the list.

So the shards may share one card (NCCL, by contrast, refuses two ranks
on one device). Data parallelism across processes stays
dist/driver.py's: one rank per card set, merged at the end of the
stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.pipeline import (_prepare_pairs,
                                            count_real_pairs,
                                            dispatch_banded_align,
                                            resolve_device)
from midas_tpu_torch.align.seed import (SeedParams, find_candidates,
                                        gather_windows, pack_words_host)
from midas_tpu_torch.db.index import build_seed_index
from midas_tpu_torch.db.refpack import GUARD, ReferencePack


def shard_devices(tp: int, device="cuda") -> List[torch.device]:
    """The devices of a profiler's tp shards — the counterpart of
    make_mesh. On the CPU every shard is on the CPU. On CUDA, rank r
    (its LOCAL_RANK under a launcher) puts shard j on
    cuda:((r * tp + j) % device_count), so one card may hold several
    shards; without a launcher an explicit cuda:i starts the list at i.
    A CUDA device without a card raises: no shard falls back to the
    CPU."""
    from midas_tpu_torch.dist.driver import local_rank

    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * tp
    n = torch.cuda.device_count()
    lr = local_rank()
    first = lr * tp if lr is not None else (device.index or 0)
    return [torch.device("cuda", (first + j) % n) for j in range(tp)]


def shard_index(
    pack: ReferencePack, tp: int, k: int = 14, max_occ: int = 256,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray, np.ndarray,
           np.ndarray]:
    """Split a ReferencePack into tp slices of whole sequences, each with
    its own seed index, padded to identical shapes (midas_tpu's
    shard_index, the same arrays).

    Returns (pack_codes [tp, Gpad] int8, index arrays each [tp, ...],
    offsets [tp, S_loc+1] int32, shard_base [tp] global offset of each
    slice, seq_base [tp] global index of each slice's first sequence)."""
    S = pack.num_seqs
    per = -(-S // tp)
    slices = []
    for r in range(tp):
        lo_seq, hi_seq = r * per, min((r + 1) * per, S)
        lo = int(pack.offsets[lo_seq]) if lo_seq < S else int(pack.offsets[-1])
        hi = int(pack.offsets[hi_seq]) if hi_seq <= S else int(pack.offsets[-1])
        sub = ReferencePack(
            codes=np.concatenate([pack.codes[lo:hi],
                                  np.full(GUARD, 4, dtype=np.int8)]),
            offsets=(pack.offsets[lo_seq: hi_seq + 1] - lo
                     if hi_seq > lo_seq else np.zeros(1, dtype=np.int64)),
            names=pack.names[lo_seq:hi_seq],
            lengths=pack.lengths[lo_seq:hi_seq],
        )
        slices.append((sub, lo, lo_seq))
    max_len = max(len(s.codes) for s, _lo, _ls in slices)
    max_pos = max(1, max(len(s.offsets) - 1 for s, _lo, _ls in slices))
    indexes = [build_seed_index(s, k=k, max_occ=max_occ)
               for s, _lo, _ls in slices]
    NB1 = max(len(ix.bucket1) for ix in indexes)
    NB2 = max(len(ix.bucket2) for ix in indexes)
    NR = max(len(ix.positions2d) for ix in indexes)
    # bucket addressing depends on the table size, so shards must agree
    # on NB1/NB2 exactly: rebuild any mismatched shard at the common
    # sizes (a forced-larger bucket2 can itself grow on overflow, hence
    # the loop; it converges because sizes only ratchet upward)
    while not all(len(ix.bucket1) == NB1 and len(ix.bucket2) == NB2
                  for ix in indexes):
        for r, ((sub, _lo, _ls), ix) in enumerate(zip(slices, indexes)):
            if len(ix.bucket1) != NB1 or len(ix.bucket2) != NB2:
                indexes[r] = build_seed_index(
                    sub, k=k, max_occ=max_occ,
                    min_table_size=NB1 * 8, min_buckets2=NB2)
        NB1 = max(len(ix.bucket1) for ix in indexes)
        NB2 = max(len(ix.bucket2) for ix in indexes)
        NR = max(len(ix.positions2d) for ix in indexes)
    codes = np.full((tp, max_len), 4, dtype=np.int8)
    bucket1 = np.full((tp, NB1, 24), 0, dtype=np.int32)
    bucket1[:, :, :8] = -1
    bucket2 = np.full((tp, NB2, 24), 0, dtype=np.int32)
    bucket2[:, :, :8] = -1
    positions2d = np.zeros((tp, NR, 8), dtype=np.int32)
    offsets = np.zeros((tp, max_pos + 1), dtype=np.int32)
    shard_base = np.zeros(tp, dtype=np.int32)
    seq_base = np.zeros(tp, dtype=np.int32)
    for r, ((sub, lo, lo_seq), ix) in enumerate(zip(slices, indexes)):
        codes[r, : len(sub.codes)] = sub.codes
        bucket1[r, : len(ix.bucket1)] = ix.bucket1
        bucket2[r, : len(ix.bucket2)] = ix.bucket2
        positions2d[r, : len(ix.positions2d)] = ix.positions2d
        n_off = len(sub.offsets)
        offsets[r, :n_off] = sub.offsets
        offsets[r, n_off:] = sub.offsets[-1]
        shard_base[r] = lo
        seq_base[r] = lo_seq
    index_arrays = dict(bucket1=bucket1, bucket2=bucket2,
                        positions2d=positions2d)
    return codes, index_arrays, offsets, shard_base, seq_base


@dataclasses.dataclass
class Shard:
    """One slice of a sharded pack on its device: the seed index
    (bucket1, bucket2, positions2d as int32) and the word-packed pack
    (words, nmask, offsets as int64, as Aligner holds them), with the
    slice's first global sequence id and global pack offset."""

    device: torch.device
    index_arrays: Dict[str, torch.Tensor]
    pack_arrays: Dict[str, torch.Tensor]
    seq_base: int
    base: int


class ShardedAligner:
    """The sharded counterpart of align/pipeline.py::Aligner: the same
    scoring, seed_params, max_read_len and device (shard 0's, where
    batches land and the gathered tables live), with the pack and index
    held as tp shards (shard_index) across shard_devices(tp, device).
    stripe_real[j] is slice j's real length, stripe_len the longest."""

    def __init__(self, pack: ReferencePack, tp: int, scoring: ScoringParams,
                 seed_params: Optional[SeedParams] = None,
                 max_read_len: int = 128, device="cuda"):
        self.scoring = scoring
        self.seed_params = seed_params or SeedParams()
        self.max_read_len = max_read_len
        self.tp = tp
        devices = shard_devices(tp, device)
        self.device = devices[0]
        codes, idx, offsets, shard_base, seq_base = shard_index(
            pack, tp=tp, k=self.seed_params.k)
        self.stripe_real = offsets[:, -1].astype(np.int64)
        self.stripe_len = int(self.stripe_real.max())

        def put(a, dtype, dev):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        self.shards = []
        for j, dev in enumerate(devices):
            words, nmask = pack_words_host(codes[j])
            self.shards.append(Shard(
                device=dev,
                index_arrays={k: put(v[j], np.int32, dev)
                              for k, v in idx.items()},
                pack_arrays={k: put(v, np.int64, dev) for k, v in dict(
                    words=words, nmask=nmask, offsets=offsets[j]).items()},
                seq_base=int(seq_base[j]), base=int(shard_base[j])))


def _shard_tensor(a, j: int, dev: torch.device, dtype) -> torch.Tensor:
    """Row j of a [tp, ...] array (numpy, a tensor, or a list of
    per-shard tensors) on dev in dtype; no copy when it is there."""
    return torch.as_tensor(a[j]).to(dev, dtype)


def distributed_profile_step(
    codes: torch.Tensor,             # [B, L] int8 (the whole batch)
    qlens: torch.Tensor,             # [B] int32
    shard_pack_codes,                # [tp, Gpad] int8
    shard_index_arrays: Dict,        # each [tp, ...]
    shard_offsets,                   # [tp, S_loc+1]
    shard_seq_base,                  # [tp] first global seq id of a slice
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    n_seqs: int,
    devices: Optional[List[torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """One sharded profiling step: seed and extend the batch against
    every index shard (the element window gather, the full-statistics
    DP: K1 once a shard), resolve the global best hit per read (max over
    the shards, the lowest shard on ties) and count mapped reads and
    aligned bp per target sequence. Shard j runs on devices[j] (default:
    the batch's device); results land on devices[0].

    midas_tpu's step, with its data-parallel axis folded into the batch
    (the per-read results do not depend on how the batch is split), and
    the counts and bp summed in int64 (it sums them in float32).
    Returns counts [n_seqs], bp [n_seqs] int64, aligned_reads (0-d)."""
    tp = len(shard_seq_base)
    devices = devices or [codes.device] * tp
    dev0 = devices[0]
    B, L = codes.shape
    C, D = seed_params.num_cands, seed_params.band_width
    W = L + D - 1
    bests, seqs, bps = [], [], []
    for j, dev in enumerate(devices):
        cj, qj = codes.to(dev), qlens.to(dev)
        idx = {k: _shard_tensor(v, j, dev, torch.int32)
               for k, v in shard_index_arrays.items()}
        cands = find_candidates(idx, cj, qj, seed_params, max_len)
        ref_win, seq_idx = gather_windows(
            _shard_tensor(shard_pack_codes, j, dev, torch.int8),
            _shard_tensor(shard_offsets, j, dev, torch.int64),
            cands["diag"] - D // 2, W,
            center=cands["diag"] + qj[:, None] // 2)
        q_pair, ql_pair, _ = _prepare_pairs(cj, qj, cands["strand"],
                                            cands["rc"])
        out = dispatch_banded_align(q_pair, ql_pair, ref_win.reshape(B * C, W),
                                    scoring, D)
        count_real_pairs(cands["valid"], qj)
        score = torch.where(cands["valid"], out["score"].reshape(B, C),
                            -torch.inf)
        best_c = torch.argmax(score, dim=1, keepdim=True)   # first max
        aln = (out["matches"] + out["mismatches"] + out["gap_cols"]
               ).reshape(B, C)
        bests.append(torch.gather(score, 1, best_c)[:, 0].to(dev0))
        seqs.append((int(torch.as_tensor(shard_seq_base[j]))
                     + torch.gather(seq_idx, 1, best_c)[:, 0]).to(dev0))
        bps.append(torch.gather(aln, 1, best_c)[:, 0].to(dev0))
    best = torch.stack(bests)                               # [tp, B]
    glob = best.amax(dim=0)
    is_best = (best == glob) & torch.isfinite(glob)
    # the lowest shard among the best wins (first max over the shards)
    win = torch.argmax(is_best.to(torch.int32), dim=0)
    i_win = is_best & (torch.arange(tp, device=dev0)[:, None] == win)
    seq = torch.stack(seqs)
    # a winner's sequence id past the pack (a padded slice) is dropped
    # as midas_tpu's scatter drops it: into a dump slot
    dest = torch.where(i_win & (seq < n_seqs), seq, n_seqs).reshape(-1)
    counts = torch.zeros(n_seqs + 1, dtype=torch.int64, device=dev0)
    counts.index_add_(0, dest, i_win.to(torch.int64).reshape(-1))
    bp = torch.zeros(n_seqs + 1, dtype=torch.int64, device=dev0)
    bp.index_add_(0, dest, torch.where(i_win, torch.stack(bps), 0)
                  .to(torch.int64).reshape(-1))
    return dict(counts=counts[:n_seqs], bp=bp[:n_seqs],
                aligned_reads=i_win.sum())
