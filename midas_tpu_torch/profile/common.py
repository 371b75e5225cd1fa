"""Shared pieces of the per-sample pipelines: species selection
bookkeeping (genes.py:32-48, snps.py:38-53), the choice of read-batch
stream (single-end, or mate-paired) and the guard against
multi-process launches."""

from __future__ import annotations

import os
from typing import Dict, List

from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.profile.species import select_species

def _multi_process() -> bool:
    """True under a launcher of several processes (torch.distributed
    initialized with more than one rank, or WORLD_SIZE > 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def require_single_process(program: str) -> None:
    """Raise under a multi-process launch: every rank would profile the
    whole input and write the same files (the multi-process paths are
    not yet ported)."""
    if _multi_process():
        raise NotImplementedError(
            f"multi-process {program} runs are not yet ported to "
            "midas_tpu_torch")


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
