"""Small host-side utilities: biology helpers (reference
midas/utility.py:288-332 semantics: complement, reverse complement,
codon translation, strand-aware base substitution), per-stage
wall-clock and peak-memory reporting (:218-225), and fd-bounded sample
batching (:38-57)."""

from __future__ import annotations

import platform
import resource
from contextlib import contextmanager
from time import time
from typing import List, Sequence


def max_mem_usage() -> float:
    """Peak RSS of self + children in GB (utility.py:218-225; ru_maxrss
    is KB on Linux, bytes on Darwin)."""
    peak = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            + resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
    scale = 1e6 if platform.system() == "Linux" else 1e9
    return round(peak / scale, 2)


def batch_samples(samples: Sequence, threads: int = 1) -> List[List]:
    """Split samples into contiguous batches that respect RLIMIT_NOFILE
    when every sample in a batch holds an open file (utility.py:38-57).
    Batches are contiguous slices (like the reference's) so cross-sample
    column order survives batch-wise processing + reassembly.

    MIDAS_TPU_MAX_OPEN overrides the rlimit-derived budget (the same
    switch as midas_tpu's; tests use it to exercise the batched path
    with a handful of samples)."""
    import os

    override = os.environ.get("MIDAS_TPU_MAX_OPEN")
    if override:
        max_open = max(int(override), 1)
    else:
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        max_open = max(int(0.8 * soft / max(threads, 1)), 1)  # 20% headroom
    size = min(max_open, len(samples)) or 1
    return [list(samples[i: i + size]) for i in range(0, len(samples), size)]


@contextmanager
def stage_timer(name: str, log=None):
    """Per-stage wall-clock + peak-RSS reporting, matching the
    reference's progress prints (e.g. midas/run/species.py:237-261)."""
    print(f"\n{name}", flush=True)
    if log is not None:
        log.write(f"\n{name}\n")
    start = time()
    yield
    mins = round((time() - start) / 60, 2)
    mem = max_mem_usage()
    print(f"  {mins} minutes", flush=True)
    print(f"  {mem} Gb maximum memory", flush=True)
    if log is not None:
        log.write(f"  {mins} minutes\n  {mem} Gb maximum memory\n")


CODON_TABLE = {
    "ATA": "I", "ATC": "I", "ATT": "I", "ATG": "M",
    "ACA": "T", "ACC": "T", "ACG": "T", "ACT": "T",
    "AAC": "N", "AAT": "N", "AAA": "K", "AAG": "K",
    "AGC": "S", "AGT": "S", "AGA": "R", "AGG": "R",
    "CTA": "L", "CTC": "L", "CTG": "L", "CTT": "L",
    "CCA": "P", "CCC": "P", "CCG": "P", "CCT": "P",
    "CAC": "H", "CAT": "H", "CAA": "Q", "CAG": "Q",
    "CGA": "R", "CGC": "R", "CGG": "R", "CGT": "R",
    "GTA": "V", "GTC": "V", "GTG": "V", "GTT": "V",
    "GCA": "A", "GCC": "A", "GCG": "A", "GCT": "A",
    "GAC": "D", "GAT": "D", "GAA": "E", "GAG": "E",
    "GGA": "G", "GGC": "G", "GGG": "G", "GGT": "G",
    "TCA": "S", "TCC": "S", "TCG": "S", "TCT": "S",
    "TTC": "F", "TTT": "F", "TTA": "L", "TTG": "L",
    "TAC": "Y", "TAT": "Y", "TAA": "_", "TAG": "_",
    "TGC": "C", "TGT": "C", "TGA": "_", "TGG": "W",
}


_COMP = {"A": "T", "T": "A", "G": "C", "C": "G"}


def complement(base: str) -> str:
    return _COMP.get(base, base)


def rev_comp(seq: str) -> str:
    return "".join(complement(b) for b in reversed(seq))


def translate(codon: str) -> str:
    return CODON_TABLE[str(codon)]


def index_replace(codon: str, allele: str, pos: int, strand: str) -> str:
    """Replace position `pos` of `codon` with `allele` (complemented on
    the minus strand), exactly like utility.index_replace."""
    bases = list(codon)
    bases[pos] = allele if strand == "+" else complement(allele)
    return "".join(bases)
