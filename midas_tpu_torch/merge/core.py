"""Cross-sample selection shared by the mergers — midas/merge/merge.py
re-implemented. A Sample wraps one run_midas output directory; a
SpeciesGroup collects the samples in which a species passed coverage
filters (filter_sample_species :104-119, init/filter/sort
:121-163)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.io.seqio import parse_file


class Sample:
    def __init__(self, dir: str, data_type: str):
        self.dir = dir
        self.id = os.path.basename(dir.rstrip("/"))
        self.info = self._read_info(data_type)

    def _read_info(self, data_type: str) -> Optional[Dict[str, dict]]:
        path = os.path.join(self.dir, data_type, "summary.txt")
        if not os.path.isfile(path):
            return None
        return {r["species_id"]: r for r in parse_file(path)}


class SpeciesGroup:
    def __init__(self, species_id: str, species_info: Dict[str, dict],
                 genome_info: Dict[str, dict]):
        self.id = species_id
        self.samples: List[Sample] = []
        self.info = species_info.get(species_id, {})
        rep = self.info.get("rep_genome")
        self.genome_info = genome_info.get(rep, {})

    def fetch_sample_depth(self) -> None:
        self.sample_depth = [
            float(s.info[self.id]["mean_coverage"]) for s in self.samples]

    def write_sample_info(self, dtype: str, outdir: str) -> None:
        """<outdir>/<sp>/{snps,genes}_summary.txt (merge.py:31-46)."""
        path = os.path.join(outdir, self.id, f"{dtype}_summary.txt")
        if dtype == "snps":
            fields = ["genome_length", "covered_bases", "fraction_covered",
                      "mean_coverage", "aligned_reads", "mapped_reads"]
        else:
            fields = ["pangenome_size", "covered_genes", "fraction_covered",
                      "mean_coverage", "marker_coverage", "aligned_reads",
                      "mapped_reads"]
        with open(path, "w") as f:
            f.write("\t".join(["sample_id"] + fields) + "\n")
            for sample in self.samples:
                f.write(sample.id)
                for field in fields:
                    f.write("\t" + str(sample.info[self.id][field]))
                f.write("\n")


def init_samples(indirs: List[str], data_type: str) -> List[Sample]:
    samples = []
    for d in indirs:
        s = Sample(d, data_type)
        if s.info is not None:
            samples.append(s)
    return samples


def _filter_sample_species(sample: Sample, species: Dict[str, SpeciesGroup],
                           species_id: str, args: Dict, dtype: str) -> bool:
    """True = skip this (sample, species) pair (merge.py:104-119)."""
    info = sample.info[species_id]
    if args.get("species_id") and species_id not in str(args["species_id"]).split(","):
        return True
    if (args.get("max_samples") and species_id in species
            and len(species[species_id].samples) >= args["max_samples"]):
        return True
    if float(info["mean_coverage"]) < args.get("sample_depth", 1.0):
        return True
    if dtype == "snps" and float(info["fraction_covered"]) < args.get("fract_cov", 0.4):
        return True
    return False


def select_species(args: Dict, dtype: str) -> List[SpeciesGroup]:
    """Samples -> qualifying species groups, sorted by sample count
    descending, capped at max_species (merge.py:121-163)."""
    db = Database(args["db"])
    species_info = db.species_info()
    genome_info = db.genome_info()
    samples = init_samples(args["indirs"], dtype)
    species: Dict[str, SpeciesGroup] = {}
    for sample in samples:
        for species_id in sample.info:
            if species_id not in species:
                species[species_id] = SpeciesGroup(species_id, species_info, genome_info)
            if not _filter_sample_species(sample, species, species_id, args, dtype):
                species[species_id].samples.append(sample)
    ordered = sorted(species.values(), key=lambda sp: len(sp.samples), reverse=True)
    keep = []
    for sp in ordered:
        sp.nsamples = len(sp.samples)
        if sp.nsamples < int(args.get("min_samples", 1)):
            continue
        if args.get("max_species") and len(keep) >= args["max_species"]:
            continue
        sp.fetch_sample_depth()
        sp.outdir = os.path.join(args["outdir"], sp.id)
        os.makedirs(sp.outdir, exist_ok=True)
        keep.append(sp)
    return keep
