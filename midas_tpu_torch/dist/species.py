"""Tensor-parallel species profiling: the full marker-gene classifier
over a marker pack whose seed index is sharded across devices —
midas_tpu's dist/species.py on PyTorch.

Each shard finds every read's top candidates against its slice and
aligns them (K1, B x C pairs a shard); the per-read candidate tables are
then reassembled shard-major on shard 0's device, the [B, tp*C] table
the classifier (profile/device_steps.py::species_classify) runs on —
the single-device semantics, with the candidate set drawn from per-shard
top-C searches: best score with ties kept across shards, the first
maximum for a unique read, ambiguous rows appended in stream order for
the host RNG assignment (midas/run/species.py:104-119).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.pipeline import Aligner, _align_batch_stages
from midas_tpu_torch.align.seed import SeedParams, pack_words_host
from midas_tpu_torch.db.index import build_seed_index
from midas_tpu_torch.db.refpack import ReferencePack
from midas_tpu_torch.dist.sharded import Shard, ShardedAligner, shard_index
from midas_tpu_torch.profile import device_steps as ds
from midas_tpu_torch.profile.species import SpeciesProfiler

# the alignment planes the classifier reads
_CLASSIFY_KEYS = ("valid", "score", "seq_idx", "matches", "mismatches",
                  "gap_cols")


def shard_pack_arrays(
    pack: ReferencePack, tp: int, k: int = 14, max_occ: int = 256,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], np.ndarray]:
    """Split a ReferencePack into tp sequence-disjoint slices and build
    each slice's word-packed pack arrays and bucketed index arrays (all
    stacked [tp, ...], as midas_tpu's shard_pack_arrays gives them).

    Returns (index_arrays, pack_arrays, seq_base) where seq_base[r] is
    the global index of slice r's first sequence."""
    codes, index_arrays, offsets, _shard_base, seq_base = shard_index(
        pack, tp=tp, k=k, max_occ=max_occ)
    words, nmask = zip(*(pack_words_host(codes[r]) for r in range(tp)))
    pack_arrays = dict(words=np.stack(words), nmask=np.stack(nmask),
                       offsets=offsets.astype(np.int32))
    return index_arrays, pack_arrays, seq_base.astype(np.int32)


def gather_tables(shards, outs, keys) -> Dict[str, torch.Tensor]:
    """The shards' [B, C] planes reassembled on shard 0's device: one
    torch.cat along dim 1 per plane in shard order (midas_tpu's tiled
    all_gather over "tp"), seq_idx lifted to global ids by each shard's
    seq_base first."""
    dev0 = shards[0].device
    return {k: torch.cat([(o[k] + sh.seq_base if k == "seq_idx" else o[k])
                          .to(dev0) for sh, o in zip(shards, outs)], dim=1)
            for k in keys}


def on_device(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A batch tensor on the shard's device (no copy when it is there)."""
    return None if x is None else x.to(shard.device, non_blocking=True)


def dist_species_update(
    state: ds.SpeciesState,
    shards,                      # ShardedAligner.shards
    seq_species: torch.Tensor,   # [num_seqs] int32, on shard 0's device
    seq_cutoff: torch.Tensor,    # [num_seqs] f32 per-marker %id cutoffs
    codes: torch.Tensor,         # [B, L] on shard 0's device
    qlens: torch.Tensor,
    n_reads: int,
    ord_base: int,               # global stream rank of row 0
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    aln_cov: float,
    n_species: int,
    min_score: torch.Tensor = None,
) -> ds.SpeciesState:
    """One sharded species-classifier batch, updating `state` (on shard
    0's device, its ambiguous rows tp * num_cands wide) in place: seed,
    gather and K1 on each shard, then the classifier over the gathered
    [B, tp*C] table. min_score is the e-value gate of the WHOLE pack's
    length (a whole-database statistic even when the index is sharded)."""
    outs = [_align_batch_stages(sh.index_arrays, sh.pack_arrays,
                                on_device(codes, sh), on_device(qlens, sh),
                                scoring, seed_params, max_len)
            for sh in shards]
    table = gather_tables(shards, outs, _CLASSIFY_KEYS)
    return ds.species_classify(state, table, seq_species, seq_cutoff, qlens,
                               n_reads, ord_base, aln_cov, n_species,
                               min_score)


class DistributedSpeciesProfiler(SpeciesProfiler):
    """SpeciesProfiler whose marker pack and seed index are held as tp
    shards (ShardedAligner, across dist/sharded.py::shard_devices); the
    same run() -> abundance surface, with the device classifier run by
    dist_species_update. The checkpoint is kind "species-dist", its
    fingerprint with tp (and, under several ranks, the rank's stride)."""

    def __init__(self, db, tp: int = 1, **kw):
        self.tp = int(tp)
        super().__init__(db, **kw)
        self.device = self.aligner.device

    def _make_aligner(self, scoring, seed_params, max_read_len):
        return ShardedAligner(self.pack, self.tp, scoring, seed_params,
                              max_read_len=max_read_len, device=self.device)

    def run(self, read_paths, read_length=None, max_reads=None,
            batch_size: int = 8192, m8_path=None, checkpoint_path=None):
        """As SpeciesProfiler.run. With m8_path every alignment is read
        back for the m8 rows: the inherited host path runs on one
        Aligner over the whole pack, built here on the profiler's device
        (shard 0's), as midas_tpu's sharded profiler keeps the
        single-device aligner for it."""
        if m8_path is None:
            return super().run(read_paths, read_length=read_length,
                               max_reads=max_reads, batch_size=batch_size,
                               checkpoint_path=checkpoint_path)
        sharded = self.aligner
        self.aligner = Aligner(
            self.pack, build_seed_index(self.pack, k=sharded.seed_params.k),
            sharded.scoring, sharded.seed_params,
            max_read_len=sharded.max_read_len, device=self.device)
        try:
            return super().run(read_paths, read_length=read_length,
                               max_reads=max_reads, batch_size=batch_size,
                               m8_path=m8_path)
        finally:
            self.aligner = sharded

    def _amb_width(self) -> int:
        # amb rows hold the gathered [tp * C] candidate table
        return self.tp * self.aligner.seed_params.num_cands

    def _checkpoint_kind(self) -> Dict:
        return dict(kind="species-dist", schema=3, tp=self.tp)

    def _species_step(self, state, seq_species, seq_cutoff, codes, lengths,
                      n_reads, ord_base, min_score) -> None:
        al = self.aligner
        dist_species_update(
            state, al.shards, seq_species, seq_cutoff, codes, lengths,
            n_reads, ord_base, scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            aln_cov=float(self.aln_cov), n_species=len(self.species_order),
            min_score=min_score)
