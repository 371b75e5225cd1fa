"""The benchmark's plain reference: the outputs a sample must produce,
worked out again from the database and the reads with plain PyTorch and
NumPy (on any device), independent of the program. Modules copied from
the program are frozen copies, named so in their docstrings; none
imports the program, JAX or the JAX package."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def expected(path: str, db_dir: str, sample: Dict, settings: Dict,
             selected: List[str], device, drop_reads: int = 0
             ) -> Tuple[Dict[str, bytes], Optional[Dict[str, np.ndarray]], str]:
    """(expected output bytes by relative path, the expected end-of-stream
    state or None, the state's relative path) of one sample of `path`
    (species, genes or snps). drop_reads leaves out the sample's last
    reads (pairs): the control's broken guarantee."""
    from portbench.reference import genes, snps, species
    from portbench.reference.fastq import read_fastq

    reads = read_fastq(sample["paths"], paired=sample["paired"])
    settings = dict(settings, paired=sample["paired"])
    if path == "species":
        return (species.expected(db_dir, reads, settings, device,
                                 drop_reads=drop_reads), None, "")
    if path == "genes":
        return (genes.expected(db_dir, reads, settings, selected, device,
                               drop_reads=drop_reads), None, "")
    if path == "snps":
        files, state = snps.expected(db_dir, reads, settings, selected,
                                     device, drop_reads=drop_reads)
        return files, state, "snps/temp/state.npz"
    raise ValueError(f"unknown path {path!r}")
