"""Nucleotide diversity (pi) calculator — scripts/snp_diversity.py
semantics: pi = 2f(1-f) summed over retained sites, per-sample or
pooled, genome-wide or per-gene, with site-class filters and optional
read/sample/site resampling (:189-328)."""

from __future__ import annotations

import csv
import random
import sys
from typing import Dict, Optional

import numpy as np

from midas_tpu_torch.analyze.parse_snps import SnpMatrix, fetch_samples, fetch_sites


class Diversity:
    def __init__(self):
        self.sites = 0
        self.samples = 0
        self.snps = 0
        # int 0, not 0.0: a never-accumulated gene prints '0' exactly
        # like the reference (snp_diversity.py Diversity.__init__)
        self.pi = 0
        self.depth = 0


def _list_genes(indir: str):
    genes = set()
    for r in csv.DictReader(open(f"{indir}/snps_info.txt"), delimiter="\t"):
        if r["gene_id"] != "":
            genes.add(r["gene_id"])
    return genes


def compute_pi(freq: float) -> float:
    return 2 * freq * (1 - freq)


def is_snp(freq: float, min_maf: float) -> bool:
    return min(freq, 1 - freq) >= min_maf


def snp_diversity(
    indir: str,
    out: Optional[str] = None,
    genomic_type: str = "genome-wide",
    sample_type: str = "per-sample",
    weight_by_depth: bool = False,
    rand_reads: Optional[int] = None,
    replace_reads: bool = False,
    rand_samples: Optional[int] = None,
    rand_sites: Optional[float] = None,
    snp_maf: float = 0.01,
    consensus: bool = False,
    sample_depth: float = 0.0,
    fract_cov: float = 0.0,
    max_samples: float = float("inf"),
    keep_samples=None,
    exclude_samples=None,
    site_list: Optional[str] = None,
    site_depth: int = 2,
    site_prev: float = 0.0,
    site_maf: float = 0.0,
    site_ratio: float = float("inf"),
    allele_support: float = 0.5,
    locus_type: Optional[str] = None,
    site_type: Optional[str] = None,
    max_sites: float = float("inf"),
):
    species = SnpMatrix(indir)
    samples = fetch_samples(species, sample_depth, fract_cov, max_samples,
                            keep_samples, exclude_samples, rand_samples)

    # init accumulator structure (snp_diversity.py:205-226)
    if sample_type == "per-sample":
        if genomic_type == "genome-wide":
            pi = {s: Diversity() for s in samples}
        else:
            genes = _list_genes(indir)
            pi = {s: {g: Diversity() for g in sorted(genes)} for s in samples}
    else:
        if genomic_type == "genome-wide":
            pi = Diversity()
            pi.samples = len(samples)
        else:
            genes = _list_genes(indir)
            pi = {g: Diversity() for g in sorted(genes)}
            for g in pi:
                pi[g].samples = len(samples)

    wanted = None
    if site_list:
        wanted = [line.rstrip() for line in open(site_list)]
        site_index = 0
    index = 0
    for site in fetch_sites(species, samples):
        if index >= max_sites:
            break
        if wanted is not None:
            if site_index >= len(wanted):
                break
            if site.id != wanted[site_index]:
                continue
            site_index += 1
        if rand_sites and random.uniform(0, 1) > rand_sites:
            continue
        site.flag_samples(site_depth, site_ratio, allele_support)
        if consensus:
            site.call_consensus()
        site.summary_stats(weight_by_depth)
        site.filter(site_prev, site_maf, locus_type, site_type)
        if not site.keep:
            continue
        index += 1
        if rand_reads and site.pooled_maf > 0.0:
            site.resample_reads(rand_reads, replace_reads)
            site.pooled_maf = site.compute_pooled_maf(weight_by_depth)
        if sample_type == "pooled-samples":
            tgt = pi if genomic_type == "genome-wide" else pi[site.gene_id]
            tgt.pi += compute_pi(site.pooled_maf)
            tgt.snps += 1 if is_snp(site.pooled_maf, snp_maf) else 0
            tgt.sites += 1
        else:
            for s in site.samples.values():
                if not s.keep:
                    continue
                tgt = pi[s.id] if genomic_type == "genome-wide" else pi[s.id][site.gene_id]
                tgt.pi += compute_pi(s.freq)
                tgt.snps += 1 if is_snp(s.freq, snp_maf) else 0
                tgt.sites += 1
                tgt.depth += s.depth

    if out:
        write_pi(out, sample_type, genomic_type, samples, pi)
    return pi


def _ratio(n, d, scale=1.0):
    return scale * n / float(d) if d > 0 else "NA"


def write_pi(out: str, sample_type: str, genomic_type: str, samples, pi) -> None:
    """Output tables matching snp_diversity.py:330-366."""
    with open(out, "w") as f:
        if sample_type == "pooled-samples":
            if genomic_type == "genome-wide":
                f.write("\t".join(["samples", "sites", "snps", "pi", "snps_kb", "pi_bp"]) + "\n")
                f.write("\t".join(str(x) for x in [
                    pi.samples, pi.sites, pi.snps, pi.pi,
                    _ratio(pi.snps, pi.sites, 1000), _ratio(pi.pi, pi.sites)]) + "\n")
            else:
                f.write("\t".join(["gene_id", "samples", "sites", "snps", "pi",
                                   "snps_kb", "pi_bp"]) + "\n")
                for gene, d in pi.items():
                    f.write("\t".join(str(x) for x in [
                        gene, d.samples, d.sites, d.snps, d.pi,
                        _ratio(d.snps, d.sites, 1000), _ratio(d.pi, d.sites)]) + "\n")
        elif genomic_type == "genome-wide":
            f.write("\t".join(["sample_id", "depth", "sites", "snps", "pi",
                               "snps_kb", "pi_bp"]) + "\n")
            for sid in samples:
                d = pi[sid]
                f.write("\t".join(str(x) for x in [
                    sid, d.depth, d.sites, d.snps, d.pi,
                    _ratio(d.snps, d.sites, 1000), _ratio(d.pi, d.sites)]) + "\n")
        else:
            f.write("\t".join(["sample_id", "gene_id", "depth", "sites", "snps",
                               "pi", "snps_kb", "pi_bp"]) + "\n")
            for sid in samples:
                for gene, d in pi[sid].items():
                    f.write("\t".join(str(x) for x in [
                        sid, gene, d.depth, d.sites, d.snps, d.pi,
                        _ratio(d.snps, d.sites, 1000), _ratio(d.pi, d.sites)]) + "\n")
