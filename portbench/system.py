"""The system under test: the port's three per-sample paths, each built
once in set-up (the profiler, with its index) and then run over whole
samples, as `run_midas species|genes|snps` runs a sample after it has
built the profiler. Only this module, trace.py and run.py (for the
card's nvidia-smi line) import the program.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch


class Path:
    """One path: build() makes the profiler, run(out) profiles the whole
    sample (or its first max_reads reads or pairs) into out and, unless
    write is False, writes its outputs."""

    name = ""

    def __init__(self, db_dir: str, cfg: Dict, sample: Dict,
                 selected: List[str], device):
        self.db_dir, self.cfg, self.sample = db_dir, cfg, sample
        self.selected = selected
        self.settings = cfg["settings"]
        self.device = torch.device(device)

    def max_read_len(self) -> int:
        from midas_tpu_torch.io.batch import detect_max_read_len

        return detect_max_read_len(self.sample["paths"])


class SpeciesPath(Path):
    name = "species"

    def build(self):
        from midas_tpu_torch.db.layout import Database
        from midas_tpu_torch.profile.species import SpeciesProfiler

        s = self.settings
        self.profiler = SpeciesProfiler(
            Database(self.db_dir), mapid=s.get("mapid"),
            aln_cov=s["aln_cov"], seed=s.get("seed", 42),
            max_read_len=self.max_read_len(), device=self.device)
        return self.profiler

    def run(self, out: str, max_reads=None, write: bool = True) -> None:
        from midas_tpu_torch.profile.species import write_abundance

        os.makedirs(os.path.join(out, "species/temp"), exist_ok=True)
        ab = self.profiler.run(
            self.sample["paths"], max_reads=max_reads,
            batch_size=self.settings["batch_size"],
            checkpoint_path=os.path.join(out, "species/temp/state.npz"))
        if not write:
            return
        with torch.profiler.record_function("portbench.write_abundance"):
            write_abundance(os.path.join(out, "species/species_profile.txt"),
                            ab)


class _PangenomePath(Path):
    subdir = ""

    def run(self, out: str, max_reads=None, write: bool = True) -> None:
        for d in ("temp", "output"):
            os.makedirs(os.path.join(out, self.subdir, d), exist_ok=True)
        self.profiler.run(
            self.sample["paths"], max_reads=max_reads,
            batch_size=self.settings["batch_size"],
            checkpoint_path=os.path.join(out, self.subdir, "temp/state.npz"),
            paired=self.sample["paired"])
        if write:
            self.profiler.write_results(out)


class GenesPath(_PangenomePath):
    name = subdir = "genes"

    def build(self):
        from midas_tpu_torch.db.layout import Database
        from midas_tpu_torch.profile.genes import GenesProfiler

        s = self.settings
        self.profiler = GenesProfiler(
            Database(self.db_dir), self.selected, mapid=s["mapid"],
            readq=s["readq"], mapq=s["mapq"], aln_cov=s["aln_cov"],
            mode=s["mode"], max_read_len=self.max_read_len(),
            device=self.device)
        return self.profiler


class SnpsPath(_PangenomePath):
    name = subdir = "snps"

    def build(self):
        from midas_tpu_torch.db.layout import Database
        from midas_tpu_torch.profile.snps import SnpsProfiler

        s = self.settings
        self.profiler = SnpsProfiler(
            Database(self.db_dir), self.selected, mapid=s["mapid"],
            readq=s["readq"], mapq=s["mapq"], baseq=s["baseq"],
            aln_cov=s["aln_cov"], mode=s["mode"],
            max_read_len=self.max_read_len(), device=self.device)
        return self.profiler


PATHS = {p.name: p for p in (SpeciesPath, GenesPath, SnpsPath)}
