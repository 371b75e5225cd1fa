"""Strain tracking via rare marker alleles —
midas/analyze/track_strains.py semantics.

id_markers (:12-61): discriminative alleles = exactly-two-allele sites
where the rarer allele occurs in <= allele_prev samples (allele called
present in a sample at freq >= min_freq with >= min_reads reads).
track_markers (:63-149): per-sample marker presence, then pairwise
sharing counts."""

from __future__ import annotations

import itertools
import sys
from typing import Dict, Optional

from midas_tpu_torch.analyze.parse_snps import SnpMatrix, fetch_samples, fetch_sites
from midas_tpu_torch.io.seqio import parse_file


def _count_alleles(site, min_freq: float, min_reads: int):
    total = set()
    groups = {b: set() for b in "ATCG"}
    for s in site.samples.values():
        if s.depth == 0:
            continue
        if s.freq >= min_freq and round(s.freq * s.depth) >= min_reads:
            groups[site.minor_allele].add(s.id)
        if (1 - s.freq) >= min_freq and round((1 - s.freq) * s.depth) >= min_reads:
            groups[site.major_allele].add(s.id)
        total.add(s.id)
    return {a: len(g) for a, g in groups.items()}, len(total)


def id_markers(
    indir: str,
    out: str,
    samples_keep=None,
    min_freq: float = 0.10,
    min_reads: int = 3,
    allele_prev: int = 1,
    max_sites: float = float("inf"),
) -> int:
    species = SnpMatrix(indir)
    samples = fetch_samples(species, keep_samples=samples_keep)
    count_markers = 0
    with open(out, "w") as outfile:
        outfile.write("\t".join(
            ["site_id", "allele", "count_samples"] +
            ["count_" + b for b in "ATCG"]) + "\n")
        for index, site in enumerate(fetch_sites(species, samples)):
            if index >= max_sites:
                break
            counts, total = _count_alleles(site, min_freq, min_reads)
            alleles = sorted(((b, c) for b, c in counts.items() if c > 0),
                             key=lambda x: x[1])
            if len(alleles) != 2:
                continue
            if alleles[0][1] > allele_prev:
                continue
            count_markers += 1
            outfile.write("\t".join(str(x) for x in (
                [site.id, alleles[0][0], total] +
                [counts[b] for b in "ATCG"])) + "\n")
    return count_markers


def track_markers(
    indir: str,
    out: str,
    markers: str,
    min_freq: float = 0.10,
    min_reads: int = 3,
    max_sites: float = float("inf"),
) -> None:
    species = SnpMatrix(indir)
    samples = fetch_samples(species)
    marker_iter = parse_file(markers)
    marker = next(marker_iter, None)
    if marker is None:
        sys.exit(f"\nError: no marker alleles found in file: {markers}\n")
    for s in samples.values():
        s.markers = set()
    for index, site in enumerate(fetch_sites(species, samples)):
        if index >= max_sites or marker is None:
            break
        if site.id != marker["site_id"]:
            continue
        for s in site.samples.values():
            if s.depth == 0:
                continue
            if marker["allele"] == site.major_allele:
                marker_freq = 1 - s.freq
            elif marker["allele"] == site.minor_allele:
                marker_freq = s.freq
            else:
                continue
            if (marker_freq >= min_freq
                    and round(marker_freq * s.depth) >= min_reads):
                samples[s.id].markers.add(site.id)
        marker = next(marker_iter, None)
    with open(out, "w") as outfile:
        outfile.write("\t".join(["sample1", "sample2", "count1", "count2",
                                 "count_both", "count_either"]) + "\n")
        for s1, s2 in itertools.combinations(samples, r=2):
            a1, a2 = samples[s1].markers, samples[s2].markers
            outfile.write("\t".join(str(x) for x in [
                s1, s2, len(a1), len(a2), len(a1 & a2), len(a1 | a2)]) + "\n")
