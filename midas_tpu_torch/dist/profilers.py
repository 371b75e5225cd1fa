"""Tensor-parallel CNV (genes) and SNP-pileup profiling over a pack whose
seed index is sharded across devices — midas_tpu's dist/profilers.py on
PyTorch (a 5,952-species pangenome database does not fit one device).

As in dist/species.py, each shard finds every read's top-C candidates
against its slice and scores them (pass 1, K3 with qpen, B x C pairs a
shard); the candidate tables are reassembled shard-major on shard 0's
device ([B, tp*C]), so the best hit, MAPQ, the mate-pair pick and the
four keep_read filters see every shard's hits (reference filter
semantics: genes.py:153-169, snps.py:141-162). The canonical multimapper
tie-break (score, then global seq_idx / tstart / strand —
device_steps.canonical_best_col) makes the pick independent of which
shard drew a hit, so the results equal the single-device profilers' at
any tp.

Pass 2 (K2, full statistics of each read's chosen candidate) runs on
every shard over all B rows, each at its local column
(best_col % num_cands, or 0 for a read it does not own), as midas_tpu's
SPMD step does; each read's statistics are then taken from its owner
shard, best_col // num_cands. So K3 with qpen and K2 launch once a shard
a batch, at P = B x C and P = B.

The SNP pileup count tensor, the one large accumulator ([4 x genome]),
stays striped by shard: shard j owns the [4 x (stripe_len + 1)] counts
of its slice on its device (column stripe_len the dump), and only its
own kept gapless reads add to it. At the end of the stream each stripe
is read back through the sparse readback (profile/sparse_counts.py) on
its own device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from midas_tpu_torch.align.params import ScoringParams
from midas_tpu_torch.align.pipeline import (align_candidates_score,
                                            align_chosen_full,
                                            count_real_pairs)
from midas_tpu_torch.align.seed import SeedParams
from midas_tpu_torch.dist.sharded import ShardedAligner
from midas_tpu_torch.dist.species import gather_tables, on_device
from midas_tpu_torch.profile import device_steps as ds
from midas_tpu_torch.profile.genes import GenesProfiler
from midas_tpu_torch.profile.snps import SnpsProfiler
from midas_tpu_torch.profile.sparse_counts import counts_host_sparse

# pass-1 planes: all that best-hit choice, pairing, MAPQ and the
# duplicate drop need
_GATHER_KEYS = ("valid", "score", "seq_idx", "strand", "tstart", "tend",
                "qend")


def _local_and_gathered(shards, codes, qlens, scoring, seed_params, max_len,
                        quals=None):
    """Pass 1 on every shard (the score-only DP over its B x C candidate
    pairs), then the gathered table with seq_idx lifted to global ids
    before the gather. Returns (locs, gat): per shard (out1, aux, codes,
    qlens) on its device, and the [B, tp*C] table on shard 0's device."""
    locs = []
    for sh in shards:
        c, ql = on_device(codes, sh), on_device(qlens, sh)
        out1, aux = align_candidates_score(
            sh.index_arrays, sh.pack_arrays, c, ql, scoring, seed_params,
            max_len, quals=on_device(quals, sh))
        locs.append((out1, aux, c, ql))
    return locs, gather_tables(shards, [loc[0] for loc in locs],
                               _GATHER_KEYS)


def _owner_full_stats(shards, locs, best_col, scoring, seed_params,
                      num_cands):
    """Pass 2 on every shard over all B rows at its local column (the
    gathered columns are shard-major: owner = best_col // C, local
    column best_col % C, 0 on the rows a shard does not own); each
    read's statistics taken from its owner. Returns (owner [B], the
    shards' local columns, full: [B] planes on shard 0's device)."""
    owner = torch.div(best_col, num_cands, rounding_mode="floor")
    lcols, full = [], None
    for j, (sh, (out1, aux, c, ql)) in enumerate(zip(shards, locs)):
        own = owner == j
        lc = torch.where(own, best_col % num_cands, 0)
        lcols.append(lc)
        f = align_chosen_full(sh.pack_arrays, aux, c, ql, on_device(lc, sh),
                              scoring, seed_params)
        count_real_pairs(out1["valid"], ql, per_read=True)
        f = {k: v.to(best_col.device) for k, v in f.items()}
        full = f if full is None else {k: torch.where(own, f[k], full[k])
                                       for k in f}
    return owner, lcols, full


def _pick_and_keep(shards, codes, quals, qlens, mean_qual, n_reads, scoring,
                   seed_params, max_len, mapid, readq, min_mapq, aln_cov,
                   smin_table, paired):
    """The sharded two-pass alignment of one batch (device_steps.
    _two_pass_keep's counterpart): pass 1 per shard, the best hit and
    MAPQ (per read, or per mate pair) on the gathered table, pass 2 on
    the owners. Returns (locs, gat, owner, lcols, full, best_col,
    aligned, keep); aligned and keep exclude padding rows."""
    locs, gat = _local_and_gathered(shards, codes, qlens, scoring,
                                    seed_params, max_len, quals=quals)
    pick = ds.paired_best_hit_device if paired else ds.best_hit_device
    aligned, best_col, mapq = pick(gat, qlens, scoring, smin_table)
    owner, lcols, full = _owner_full_stats(shards, locs, best_col, scoring,
                                           seed_params,
                                           seed_params.num_cands)
    aligned &= torch.arange(codes.shape[0], device=codes.device) < n_reads
    keep = aligned & ds.keep_mask_chosen(full, qlens, mean_qual, mapq,
                                         mapid, readq, min_mapq, aln_cov)
    return locs, gat, owner, lcols, full, best_col, aligned, keep


def dist_genes_update(
    state: ds.GenesState,
    shards,
    num_genes: int,
    codes: torch.Tensor,
    quals: torch.Tensor,
    qlens: torch.Tensor,
    mean_qual: torch.Tensor,
    n_reads: int,
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    aln_cov: float,
    smin_table: torch.Tensor,
    paired: bool = False,
) -> ds.GenesState:
    """One sharded CNV batch, the [G+1] accumulators (on shard 0's
    device) updated in place with genes_update's semantics
    (genes.py:153-203): each read counted once, by its owner's pass-2
    statistics."""
    _locs, gat, _owner, _lcols, full, best_col, aligned, keep = \
        _pick_and_keep(shards, codes, quals, qlens, mean_qual, n_reads,
                       scoring, seed_params, max_len, mapid, readq, min_mapq,
                       aln_cov, smin_table, paired)
    return ds.genes_tally(state, num_genes, gat["seq_idx"], full, best_col,
                          aligned, keep)


@dataclasses.dataclass
class StripedSnpsState(ds.SnpsState):
    """SnpsState whose pileup lives in per-shard stripes (its own counts
    field unused, 4 entries): stripes[j] is shard j's flat
    [4 x (stripe_len + 1)] int32 counts on its device."""
    stripes: List[torch.Tensor] = None


def dist_snps_update(
    state: StripedSnpsState,
    shards,
    contig_species: torch.Tensor,   # [num_seqs] int64, on shard 0's device
    codes: torch.Tensor,
    quals: torch.Tensor,
    qlens: torch.Tensor,
    mean_qual: torch.Tensor,
    n_reads: int,
    scoring: ScoringParams,
    seed_params: SeedParams,
    max_len: int,
    mapid: float,
    readq: float,
    min_mapq: int,
    baseq: int,
    aln_cov: float,
    stripe_len: int,
    smin_table: torch.Tensor,
    paired: bool = False,
) -> StripedSnpsState:
    """One sharded pileup batch, in place: the per-species counters and
    the gapped-read spill on shard 0's device (rows in global contig
    coordinates, their tstart / tend from the owner shard), and each
    shard's kept gapless reads added into its own stripe at its slice's
    local sequence offsets."""
    locs, gat, owner, lcols, full, best_col, aligned, keep = \
        _pick_and_keep(shards, codes, quals, qlens, mean_qual, n_reads,
                       scoring, seed_params, max_len, mapid, readq, min_mapq,
                       aln_cov, smin_table, paired)
    gci = ds._pick(gat["seq_idx"], best_col)
    qsel, qqsel = ds.snps_tally(state, contig_species, gci,
                                ds._pick(gat["strand"], best_col), codes,
                                quals, qlens, aligned, keep)
    gapless = full["gap_cols"] == 0
    for j, (sh, (out1, _aux, _c, _ql)) in enumerate(zip(shards, locs)):
        lc = on_device(lcols[j], sh)
        lci = ds._pick(out1["seq_idx"], lc)          # local sequence id
        ds.pileup_add(state.stripes[j], stripe_len,
                      sh.pack_arrays["offsets"][lci], on_device(qsel, sh),
                      on_device(qqsel, sh),
                      {k: on_device(full[k], sh)
                       for k in ("qstart", "qend", "tstart")},
                      on_device(keep & gapless & (owner == j), sh), baseq)
    ds.spill_gapped(state, gci, qsel, qqsel, full, qlens, keep & ~gapless)
    return state


class DistributedGenesProfiler(GenesProfiler):
    """GenesProfiler over a pangenome pack held as tp shards
    (ShardedAligner); the same run() / write_results() surface, with the
    per-batch update run by dist_genes_update."""

    def __init__(self, db, species_ids, tp: int = 1, **kw):
        self.tp = int(tp)
        super().__init__(db, species_ids, **kw)
        self.device = self.aligner.device

    def _make_aligner(self, scoring, seed_params, max_read_len):
        return ShardedAligner(self.pack, self.tp, scoring, seed_params,
                              max_read_len=max_read_len, device=self.device)

    def _genes_step(self, state, codes, quals, lengths, mean_qual, n_reads,
                    smin_table, paired: bool) -> None:
        al = self.aligner
        dist_genes_update(
            state, al.shards, self.pack.num_seqs, codes, quals, lengths,
            mean_qual, n_reads, scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            mapid=float(self.mapid), readq=float(self.readq),
            min_mapq=int(self.mapq), aln_cov=float(self.aln_cov),
            smin_table=smin_table, paired=paired)


class DistributedSnpsProfiler(SnpsProfiler):
    """SnpsProfiler over a pack of representative genomes held as tp
    shards, the [4 x genome] pileup striped by shard (each device holds
    its slice's stripe). Checkpoints hold the reassembled single-device
    counts layout, so a state saved at one tp resumes at any other."""

    def __init__(self, db, species_ids, tp: int = 1, **kw):
        self.tp = int(tp)
        super().__init__(db, species_ids, **kw)
        self.device = self.aligner.device
        self.shard_base = np.array([sh.base for sh in self.aligner.shards],
                                   dtype=np.int64)
        self.stripe_real = self.aligner.stripe_real
        self.stripe_len = self.aligner.stripe_len

    def _make_aligner(self, scoring, seed_params, max_read_len):
        return ShardedAligner(self.pack, self.tp, scoring, seed_params,
                              max_read_len=max_read_len, device=self.device)

    def _reassemble_counts(self, stripes: np.ndarray) -> np.ndarray:
        """[tp, 4*(stripe_len+1)] shard stripes -> the single-device flat
        [4 * (G_total + 1)] counts layout _finalize expects."""
        G = self.pack.total_len
        full = np.zeros((4, G + 1), dtype=np.int32)
        for r in range(self.tp):
            Lr = int(self.stripe_real[r])
            lo = int(self.shard_base[r])
            stripe = stripes[r].reshape(4, self.stripe_len + 1)
            full[:, lo: lo + Lr] += stripe[:, :Lr]
        return full.reshape(-1)

    def _shard_counts(self, flat: np.ndarray) -> np.ndarray:
        """Inverse of _reassemble_counts (checkpoint restore): slice the
        flat [4*(G+1)] counts back into per-shard stripes (each stripe's
        dump column resets to 0 — it only ever held discards)."""
        full = np.asarray(flat).reshape(4, self.pack.total_len + 1)
        stripes = np.zeros((self.tp, 4, self.stripe_len + 1), dtype=np.int32)
        for r in range(self.tp):
            Lr = int(self.stripe_real[r])
            lo = int(self.shard_base[r])
            stripes[r, :, :Lr] = full[:, lo: lo + Lr]
        return stripes.reshape(self.tp, -1)

    def _staging(self, batch_size: int, gap_cap, paired: bool):
        # mates need an even batch; the capacity is clamped to two of the
        # batches actually read, after that rounding (midas_tpu clamps
        # before it, so its capacity can fall one row short a batch)
        batch_size += batch_size % 2 if paired else 0
        return super()._staging(batch_size, gap_cap, paired)

    def _init_state(self, cap: int) -> StripedSnpsState:
        st = ds.snps_init(0, len(self.species_ids), cap,
                          self.aligner.max_read_len, self.device)
        return StripedSnpsState(
            **{f.name: getattr(st, f.name)
               for f in dataclasses.fields(ds.SnpsState)},
            stripes=[torch.zeros(4 * (self.stripe_len + 1), dtype=torch.int32,
                                 device=sh.device)
                     for sh in self.aligner.shards])

    def _restore_state(self, arrays: Dict, cap: int) -> StripedSnpsState:
        st = self._init_state(cap)
        for k in ("aligned_reads", "mapped_reads"):
            getattr(st, k).copy_(torch.from_numpy(
                np.asarray(arrays[k]).astype(np.int32)))
        for stripe, host in zip(st.stripes,
                                self._shard_counts(arrays["counts"])):
            stripe.copy_(torch.from_numpy(host))
        return st

    def _state_host(self, state: StripedSnpsState) -> Dict[str, np.ndarray]:
        """snps_state_host with the counts read back stripe by stripe,
        each through the sparse readback on its own device (its dump
        column at local index stripe_len), then reassembled."""
        h = ds.snps_state_host_without_counts(state)
        h["counts"] = self._reassemble_counts(np.stack(
            [counts_host_sparse(s, self.stripe_len) for s in state.stripes]))
        return h

    def _snps_step(self, state, contig_species, codes, quals, lengths,
                   mean_qual, n_reads, smin_table, paired: bool) -> None:
        al = self.aligner
        dist_snps_update(
            state, al.shards, contig_species, codes, quals, lengths,
            mean_qual, n_reads, scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            mapid=float(self.mapid), readq=float(self.readq),
            min_mapq=int(self.mapq), baseq=int(self.baseq),
            aln_cov=float(self.aln_cov), stripe_len=self.stripe_len,
            smin_table=smin_table, paired=paired)
