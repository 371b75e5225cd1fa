"""Shared pieces of the per-sample pipelines: species selection
bookkeeping (genes.py:32-48, snps.py:38-53), the choice of read-batch
stream (single-end, or mate-paired), the test for a multi-process
launch, and the host twins of the device best hit and read filters
(keep_read at genes.py:153-169 / snps.py:141-162) over a read-back
AlignmentResult."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from midas_tpu_torch.align.params import ScoringParams, mapq_from_scores
from midas_tpu_torch.align.pipeline import AlignmentResult
from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.dist.driver import process_count, process_index
from midas_tpu_torch.io.batch import ReadBatch
from midas_tpu_torch.profile.species import select_species


# reads a device batch in the run_* entry points (the profilers' default)
BATCH_SIZE = 8192


def _multi_process() -> bool:
    """True under a launch of several processes: a process group of
    several ranks, however it was joined (driver.initialize from a
    launcher's environment, or explicitly over tcp://), or a launcher's
    WORLD_SIZE > 1 before the group exists."""
    return (process_count() > 1
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def resolve_species_list(args: Dict, db: Database, subdir: str) -> List[str]:
    """Reference semantics (genes.py:32-48): with --build_db, select
    species from the species profile and persist <outdir>/<subdir>/
    species.txt; otherwise reuse the persisted list."""
    splist = os.path.join(args["outdir"], subdir, "species.txt")
    if args.get("build_db"):
        ids = select_species(
            db, args["outdir"],
            species_cov=args.get("species_cov"),
            species_topn=args.get("species_topn"),
            species_id=args.get("species_id"),
        )
        # only rank 0 of a multi-process job persists the list (every
        # rank computes the same ids; concurrent writes to a shared
        # filesystem race)
        if process_index() == 0:
            with open(splist, "w") as f:
                for sid in ids:
                    f.write(sid + "\n")
        return ids
    if os.path.isfile(splist):
        with open(splist) as f:
            return [line.rstrip() for line in f if line.rstrip()]
    return []


def select_batches(read_paths, batch_size: int, max_len: int, max_reads,
                   paired: bool = False, interleaved: bool = False,
                   read_length=None):
    """Pick the batch stream: mate-paired (rows 2i/2i+1 are mates, for
    bowtie2-style pairing) or plain concatenated single-end — the run
    layer's equivalent of bowtie2's -1/-2/--interleaved vs -U inputs
    (reference invocations: midas/run/genes.py:127-132)."""
    from midas_tpu_torch.io.batch import load_paired_batches, load_read_batches

    if paired:
        paths = ([read_paths] if isinstance(read_paths, (str, os.PathLike))
                 else list(read_paths))
        m2 = paths[1] if len(paths) > 1 else None
        return load_paired_batches(
            paths[0], m2, batch_size=batch_size, max_len=max_len,
            max_reads=max_reads, interleaved=interleaved,
            read_length=read_length)
    return load_read_batches(read_paths, batch_size=batch_size,
                             max_len=max_len, max_reads=max_reads,
                             read_length=read_length)


def keep_read_mask(
    res: AlignmentResult,
    best_col: np.ndarray,        # [B] chosen candidate per read
    batch: ReadBatch,
    mapq: np.ndarray,            # [B]
    mapid: float,
    readq: float,
    min_mapq: int,
    aln_cov: float,
) -> np.ndarray:
    """The reference's four keep_read filters, vectorized
    (genes.py:153-169 == snps.py:141-162):
      pid = 100*(alen-NM)/alen >= mapid ; mean qual >= readq ;
      mapq >= min_mapq ; alen/qlen >= aln_cov.
    The host twin of device_steps.keep_mask_chosen."""
    B = len(best_col)
    rows = np.arange(B)
    alen = (res.qend - res.qstart)[rows, best_col].astype(np.float64)
    nm = res.nm[rows, best_col].astype(np.float64)
    qlen = np.maximum(batch.lengths[:B].astype(np.float64), 1.0)
    pid = 100.0 * (alen - nm) / np.maximum(alen, 1.0)
    return (
        (pid >= mapid)
        & (batch.mean_qual[:B] >= readq)
        & (mapq >= min_mapq)
        & (alen / qlen >= aln_cov)
    )


def pick_best_hits(
    res: AlignmentResult,
    scoring: ScoringParams,
    lengths: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single best alignment per read (bowtie2 reports one record per
    read by default) plus a MAPQ from the best-vs-second-best scores.
    The host twin of device_steps.best_hit_device.

    Returns (aligned [B] bool, best_col [B] int, mapq [B] int)."""
    B, C = res.score.shape
    # bowtie2's scMin truncates to the integer score type (mapq.h)
    score_min = np.array([float(int(scoring.score_min(max(int(l), 1))))
                          for l in lengths[:B]])
    scores = np.where(res.valid, res.score, -np.inf)
    # canonical multimapper arbitration, as device_steps.canonical_best_col:
    # among equal-best candidates pick the smallest (seq_idx, tstart, strand)
    BIG = np.int64(2**62)
    best = scores.max(axis=1)
    isb = res.valid & (scores == best[:, None]) & np.isfinite(scores)
    for key in (res.seq_idx, res.tstart, res.strand):
        v = np.where(isb, key.astype(np.int64), BIG)
        isb = isb & (v == v.min(axis=1)[:, None])
    best_col = isb.argmax(axis=1)
    rows = np.arange(B)
    masked = scores.copy()
    masked[rows, best_col] = -np.inf
    second = masked.max(axis=1) if C > 1 else np.full(B, -np.inf)
    aligned = np.isfinite(best) & (best >= score_min)
    mapq = np.zeros(B, dtype=np.int32)
    for i in np.flatnonzero(aligned):
        mapq[i] = mapq_from_scores(
            float(best[i]), float(second[i]), float(score_min[i]),
            scoring.score_perfect(int(lengths[i])), bool(np.isfinite(second[i])),
            local=scoring.mode == "local",
        )
    return aligned, best_col, mapq
