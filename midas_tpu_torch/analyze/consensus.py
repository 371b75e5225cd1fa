"""Consensus sequence builder — scripts/call_consensus.py:140-222
semantics: per sample, append the consensus base (major/minor by
freq>=0.5, '-' when filtered/uncovered) for every retained site, then
write a multi-FASTA usable for phylogenetic trees."""

from __future__ import annotations

from typing import Dict, Optional, Set

from midas_tpu_torch.analyze.parse_snps import SnpMatrix, fetch_samples, fetch_sites


def percent_missing(seq: str):
    if len(seq) > 0:
        return round(100 * seq.count("-") / float(len(seq)), 2)
    return "NA"


def call_consensus(
    indir: str,
    out: str,
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
) -> Dict[str, str]:
    species = SnpMatrix(indir)
    samples = fetch_samples(species, sample_depth, fract_cov, max_samples,
                            keep_samples, exclude_samples)
    wanted: Optional[Set[str]] = None
    if site_list:
        wanted = {line.rstrip() for line in open(site_list)}
    retained = 0
    for site in fetch_sites(species, samples):
        if retained >= max_sites:
            break
        site.flag_samples(site_depth, site_ratio, allele_support)
        site.summary_stats(weight=False)
        if wanted is None:
            site.filter(site_prev, site_maf, locus_type, site_type)
        else:
            site.keep = site.id in wanted
        if site.keep:
            retained += 1
            for s in site.samples.values():
                samples[s.id].consensus += site.fetch_consensus(s)
    with open(out, "w") as f:
        for sample_id in sorted(samples):
            s = samples[sample_id]
            desc = dict(length=len(s.consensus),
                        percent_missing=percent_missing(s.consensus),
                        mean_depth=round(s.mean_depth, 2))
            f.write(">" + s.id + "\t")
            f.write(" ".join(f"{k}={v}" for k, v in desc.items()) + "\n")
            f.write(s.consensus + "\n")
    return {sid: samples[sid].consensus for sid in samples}
