"""Streaming reader over merge_midas snps output —
midas/analyze/parse_snps.py re-implemented.

Jointly iterates snps_{info,freq,depth}.txt row-aligned (GenomicSite
:58-90), with the reference's sample filters (fetch_samples :180-218)
and per-site sample/site flagging (:92-131)."""

from __future__ import annotations

import csv
import os
import sys
from typing import Dict, Iterator, List, Optional

import numpy as np


class Sample:
    def __init__(self, info: dict):
        self.id = info["sample_id"]
        self.info = info
        self.mean_depth = float(info["mean_coverage"])
        self.fract_cov = float(info["fraction_covered"])
        self.consensus = ""
        self.freq = 0.0
        self.depth = 0

    def fails(self, mean_depth: float, fract_cov: float) -> bool:
        return self.fract_cov < fract_cov or self.mean_depth < mean_depth


class SnpMatrix:
    """One species' merged snps directory (snps_{info,freq,depth,summary})."""

    def __init__(self, dir: str):
        self.dir = dir
        self.id = os.path.basename(dir.rstrip("/"))
        self.paths = {t: os.path.join(dir, f"snps_{t}.txt")
                      for t in ["freq", "depth", "info", "summary"]}
        self.files = {}
        for t in ["info", "summary"]:
            self.files[t] = csv.DictReader(open(self.paths[t]), delimiter="\t")
        for t in ["freq", "depth"]:
            self.files[t] = csv.reader(open(self.paths[t]), delimiter="\t")
        self.sample_ids = None
        for t in ["freq", "depth"]:
            self.sample_ids = next(self.files[t])[1:]


class GenomicSite:
    def __init__(self, species: SnpMatrix, samples: Dict[str, Sample]):
        try:
            self.info = next(species.files["info"])
        except StopIteration:
            self.id = None
            return
        self.id = self.info["site_id"]
        self.ref_allele = self.info["ref_allele"]
        self.major_allele = self.info["major_allele"]
        self.minor_allele = self.info["minor_allele"]
        self.gene_id = self.info["gene_id"]
        self.locus_type = self.info["locus_type"]
        self.site_type = self.info["site_type"]
        self.samples = samples
        freqs = next(species.files["freq"])[1:]
        depths = next(species.files["depth"])[1:]
        for s in samples.values():
            s.freq = float(freqs[s.index])
            s.depth = int(depths[s.index])

    def flag_samples(self, site_depth: int, site_ratio: float,
                     allele_support: float) -> None:
        for s in self.samples.values():
            s.keep = True
            if s.depth < site_depth:
                s.keep = False
            if s.depth / s.mean_depth > site_ratio:
                s.keep = False
            if max(s.freq, 1 - s.freq) < allele_support:
                s.keep = False

    def summary_stats(self, weight: bool = False) -> None:
        self.count_samples = sum(1 for s in self.samples.values() if s.keep)
        self.prevalence = self.count_samples / float(len(self.samples))
        self.pooled_maf = self.compute_pooled_maf(weight)

    def compute_pooled_maf(self, weight: bool = False) -> float:
        kept = [s for s in self.samples.values() if s.keep]
        if not kept:
            return 0.0
        if weight:
            depth = sum(s.depth for s in kept)
            return sum(s.depth * s.freq for s in kept) / depth if depth else 0.0
        return float(np.mean([s.freq for s in kept]))

    def filter(self, site_prev=None, site_maf=None, locus_type=None,
               site_type=None) -> None:
        self.keep = True
        if self.ref_allele not in ["A", "T", "C", "G"]:
            self.keep = False
        if site_prev and self.prevalence < max(1e-6, site_prev):
            self.keep = False
        if site_maf and self.pooled_maf < site_maf:
            self.keep = False
        if locus_type and self.locus_type != locus_type:
            self.keep = False
        if site_type and self.site_type != site_type:
            self.keep = False

    def resample_reads(self, rand_reads: int, replace_reads: bool,
                       rng: Optional[np.random.RandomState] = None) -> None:
        rng = rng or np.random
        for s in self.samples.values():
            s.depth = rand_reads
            if 0 < s.freq < 1:
                count_minor = int(round(s.freq * s.depth))
                count_major = s.depth - count_minor
                alleles = rng.choice([1] * count_minor + [0] * count_major,
                                     rand_reads, replace=replace_reads)
                s.freq = float(np.mean(alleles))

    def call_consensus(self) -> None:
        for s in self.samples.values():
            s.freq = round(s.freq)

    def fetch_consensus(self, sample: Sample) -> str:
        if not sample.keep or sample.depth == 0:
            return "-"
        if sample.freq >= 0.5:
            return self.minor_allele
        return self.major_allele


def fetch_samples(species: SnpMatrix, mean_depth: float = 0,
                  fract_cov: float = 0, max_samples: float = float("inf"),
                  keep_samples=None, exclude_samples=None,
                  rand_samples=None) -> Dict[str, Sample]:
    samples: Dict[str, Sample] = {}
    for index, info in enumerate(species.files["summary"]):
        sample = Sample(info)
        sample.index = index
        if sample.fails(mean_depth, fract_cov):
            continue
        if keep_samples and sample.id not in keep_samples:
            continue
        if exclude_samples and sample.id in exclude_samples:
            continue
        if len(samples) >= max_samples:
            continue
        samples[sample.id] = sample
    if not samples:
        sys.exit("\nError: no samples satisfied your selection criteria.\n"
                 "Try running again with more lenient parameters\n")
    if rand_samples:
        if rand_samples > len(samples):
            sys.exit("\nError: --rand_samples cannot exceed the number of samples\n")
        ids = set(np.random.choice(list(samples), rand_samples, replace=False))
        samples = {k: v for k, v in samples.items() if k in ids}
    return samples


def fetch_sites(species: SnpMatrix,
                samples: Dict[str, Sample]) -> Iterator[GenomicSite]:
    while True:
        site = GenomicSite(species, samples)
        if site.id is None:
            break
        yield site
