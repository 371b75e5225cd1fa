"""Small host-side utilities: per-stage wall-clock and peak-memory
reporting (reference midas/utility.py:218-225) and the codon table
(:288-332) the simulator translates genes with."""

from __future__ import annotations

import platform
import resource
from contextlib import contextmanager
from time import time


def max_mem_usage() -> float:
    """Peak RSS of self + children in GB (utility.py:218-225; ru_maxrss
    is KB on Linux, bytes on Darwin)."""
    peak = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            + resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
    scale = 1e6 if platform.system() == "Linux" else 1e9
    return round(peak / scale, 2)


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
