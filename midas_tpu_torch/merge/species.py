"""Cross-sample species abundance merger — midas/merge/species.py.

Builds count_reads/coverage/relative_abundance matrices (species x
samples, :62-70) and species_prevalence.txt summary stats (:44-88)."""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.profile.species import read_abundance


class _Sample:
    def __init__(self, dir: str):
        self.dir = dir
        self.id = os.path.basename(dir.rstrip("/"))
        self.path = os.path.join(dir, "species/species_profile.txt")


def identify_samples(args: Dict) -> List[_Sample]:
    samples = []
    for d in args["indirs"]:
        s = _Sample(d)
        if not os.path.exists(s.path):
            sys.stderr.write(f"Warning: missing/incomplete output: {d}\n")
        elif s.id in [x.id for x in samples]:
            sys.stderr.write(
                f"Warning: sample_id '{s.id}' specified more than one time.\nSkipping: {d}\n")
        else:
            samples.append(s)
    if not samples:
        sys.exit("\nError: no samples with species profiles\n")
    if args.get("max_samples") is not None and len(samples) > args["max_samples"]:
        samples = samples[: args["max_samples"]]
    return samples


def run_pipeline(args: Dict) -> None:
    os.makedirs(args["outdir"], exist_ok=True)
    samples = identify_samples(args)
    db = Database(args["db"])
    species_ids = list(db.species_info())
    data = {sid: {f: [] for f in ["relative_abundance", "coverage", "count_reads"]}
            for sid in species_ids}
    # one value per (species, sample) — a profile missing a species row
    # (malformed/truncated) contributes 0 instead of silently shifting
    # that species' row left (the reference's presence-keyed append at
    # midas/merge/species.py:33-40 has that misalignment bug)
    zero = {"relative_abundance": 0.0, "coverage": 0.0, "count_reads": 0}
    for sample in samples:
        abundance = read_abundance(sample.path)
        for sid in species_ids:
            values = abundance.get(sid, {})
            for field in ["relative_abundance", "coverage", "count_reads"]:
                data[sid][field].append(values.get(field, zero[field]))

    # matrices (species.py:62-70)
    for field in ["relative_abundance", "coverage", "count_reads"]:
        with open(os.path.join(args["outdir"], f"{field}.txt"), "w") as f:
            f.write("\t".join(["species_id"] + [s.id for s in samples]) + "\n")
            for sid in data:
                f.write(sid)
                for x in data[sid][field]:
                    f.write("\t" + str(x))
                f.write("\n")

    # prevalence stats (species.py:44-88)
    min_cov = args.get("min_cov", 1.0)
    stats = {}
    for sid in data:
        ab = data[sid]["relative_abundance"]
        cov = data[sid]["coverage"]
        stats[sid] = dict(
            median_abundance=float(np.median(ab)) if ab else 0.0,
            mean_abundance=float(np.mean(ab)) if ab else 0.0,
            median_coverage=float(np.median(cov)) if cov else 0.0,
            mean_coverage=float(np.mean(cov)) if cov else 0.0,
            prevalence=sum(1 for c in cov if c >= min_cov),
        )
    with open(os.path.join(args["outdir"], "species_prevalence.txt"), "w") as f:
        fields = ["mean_coverage", "median_coverage", "mean_abundance",
                  "median_abundance", "prevalence"]
        f.write("\t".join(["species_id"] + fields) + "\n")
        ranked = sorted(stats.items(), key=lambda kv: kv[1]["prevalence"], reverse=True)
        for sid, st in ranked:
            f.write(sid)
            for field in fields:
                v = st[field]
                f.write("\t" + str(v if field == "prevalence" else round(v, 2)))
            f.write("\n")
    _write_readme(args)


def _write_readme(args: Dict) -> None:
    with open(os.path.join(args["outdir"], "readme.txt"), "w") as f:
        f.write(f"""
Description of output files and file formats from 'merge_midas.py species'

Output files
############
count_reads.txt
  number of reads mapped to 15 marker genes per species
coverage.txt
  average read-depth of 15 marker genes per species (total bp of mapped reads/total bp of 15 marker-genes)
relative_abundance.txt
  values from coverage.txt scaled to sum to 1.0 across species per sample
species_prevalence.txt
  summary stats across species

Output formats
############
count_reads.txt, coverage.txt, relative_abundance.txt
  tab-delimited matrix files
  field names are sample ids
  row names are species ids
species_prevalence.txt
  species_id: species identifier
  mean_coverage: average read-depth of marker-genes for species across samples
  median_coverage: median read-depth of marker-genes for species across samples
  mean_abundance: average relative abundance of marker-genes for species across samples
  median_abundance: median relative abundance of marker-genes for species across samples
  prevalence: proportion of samples where species occured with at least {args.get('min_cov', 1.0)} read-depth

Additional information for each species can be found in the reference database:
 {args['db']}
""")
