"""Analysis CLIs: call_consensus, snp_diversity, compare_genes,
strain_tracking, query_by_compound — argparse surfaces mirroring the
reference scripts of the same names. Host numpy: no device.

    python -m midas_tpu_torch.cli.analysis <tool> [tool arguments]

runs one of them, <tool> being call_consensus, snp_diversity,
compare_genes, strain_tracking or query_by_compound."""

from __future__ import annotations

import argparse
import os
import sys


def _sample_site_args(p, site_depth_default=2):
    s = p.add_argument_group("Sample filters (select subset of samples from INDIR)")
    s.add_argument("--sample_depth", type=float, default=0.0, metavar="FLOAT",
                   help="minimum average read depth per sample (0.0)")
    s.add_argument("--sample_cov", dest="fract_cov", type=float, default=0.0,
                   metavar="FLOAT",
                   help="fraction of reference sites covered by at least 1 read (0.0)")
    s.add_argument("--max_samples", type=int, metavar="INT", default=float("inf"),
                   help="maximum number of samples to process (use all)")
    s.add_argument("--keep_samples", type=str, metavar="STR",
                   help="comma-separated list of samples to include")
    s.add_argument("--exclude_samples", type=str, metavar="STR",
                   help="comma-separated list of samples to exclude")
    t = p.add_argument_group("Site filters (select subset of genomic sites from INDIR)")
    t.add_argument("--site_list", metavar="PATH", type=str,
                   help="path to list of sites to include; other filters still apply")
    t.add_argument("--site_depth", type=int, default=site_depth_default, metavar="INT",
                   help=f"minimum number of mapped reads per site ({site_depth_default})")
    t.add_argument("--site_prev", type=float, default=0.0, metavar="FLOAT",
                   help="site has at least <site_depth> coverage in at least <site_prev> proportion of samples (0.0)")
    t.add_argument("--site_maf", type=float, default=0.0, metavar="FLOAT",
                   help="minimum average-minor-allele-frequency of site across samples (0.0)")
    t.add_argument("--site_ratio", type=float, default=float("inf"), metavar="FLOAT",
                   help="maximum ratio of site-depth to mean-genome-depth (None)")
    t.add_argument("--allele_support", type=float, default=0.5, metavar="FLOAT",
                   help="minimum fraction of reads supporting consensus allele (0.5)")
    t.add_argument("--locus_type", choices=["CDS", "RNA", "IGR"],
                   help="use genomic sites that intersect locus type")
    t.add_argument("--site_type", choices=["1D", "2D", "3D", "4D"],
                   help="site degeneracy filter (requires CDS locus_type)")
    t.add_argument("--max_sites", type=float, default=float("inf"), metavar="INT",
                   help="maximum number of sites to include in output (use all)")


def _split(s):
    return s.rstrip(",").split(",") if s else None


def call_consensus_main(argv=None):
    p = argparse.ArgumentParser(
        prog="call_consensus",
        description="Build FASTA file of consensus sequences for a species per sample")
    p.add_argument("indir", metavar="PATH", type=str,
                   help="path to output from `merge_midas snps` for one species")
    p.add_argument("--out", metavar="PATH", type=str, default="/dev/stdout",
                   help="path to output file")
    _sample_site_args(p)
    a = vars(p.parse_args(argv))
    from midas_tpu_torch.analyze.consensus import call_consensus
    call_consensus(
        a["indir"], a["out"], sample_depth=a["sample_depth"],
        fract_cov=a["fract_cov"], max_samples=a["max_samples"],
        keep_samples=_split(a["keep_samples"]),
        exclude_samples=_split(a["exclude_samples"]),
        site_list=a["site_list"], site_depth=a["site_depth"],
        site_prev=a["site_prev"], site_maf=a["site_maf"],
        site_ratio=a["site_ratio"], allele_support=a["allele_support"],
        locus_type=a["locus_type"], site_type=a["site_type"],
        max_sites=a["max_sites"])
    return 0


def snp_diversity_main(argv=None):
    p = argparse.ArgumentParser(
        prog="snp_diversity",
        description="Quantify the genomic diversity of a bacterial population")
    p.add_argument("indir", metavar="PATH", type=str,
                   help="path to output from `merge_midas snps` for one species")
    p.add_argument("--out", metavar="PATH", type=str, default="/dev/stdout",
                   help="path to output file")
    d = p.add_argument_group("Diversity options")
    d.add_argument("--genomic_type", choices=["genome-wide", "per-gene"],
                   default="genome-wide",
                   help="compute diversity for individual genes or genome-wide")
    d.add_argument("--sample_type", choices=["per-sample", "pooled-samples"],
                   default="per-sample",
                   help="compute diversity for individual samples or pooled reads")
    d.add_argument("--weight_by_depth", action="store_true", default=False,
                   help="weight data from samples by sequencing depth when --sample_type=pooled-samples")
    d.add_argument("--rand_reads", type=int, metavar="INT",
                   help="randomly select N reads from each sample for each genomic site")
    d.add_argument("--replace_reads", action="store_true", default=False,
                   help="reads drawn with replacement")
    d.add_argument("--rand_samples", type=int, metavar="INT",
                   help="randomly select N samples from each genomic site")
    d.add_argument("--rand_sites", type=float, metavar="FLOAT",
                   help="randomly select X proportion of high-quality genomic sites")
    d.add_argument("--snp_maf", type=float, metavar="FLOAT", default=0.01,
                   help="minor allele frequency cutoff for defining a SNP (0.01)")
    d.add_argument("--consensus", action="store_true", default=False,
                   help="call consensus alleles prior to calling SNPs")
    _sample_site_args(p)
    a = vars(p.parse_args(argv))
    from midas_tpu_torch.analyze.diversity import snp_diversity
    snp_diversity(
        a["indir"], out=a["out"], genomic_type=a["genomic_type"],
        sample_type=a["sample_type"], weight_by_depth=a["weight_by_depth"],
        rand_reads=a["rand_reads"], replace_reads=a["replace_reads"],
        rand_samples=a["rand_samples"], rand_sites=a["rand_sites"],
        snp_maf=a["snp_maf"], consensus=a["consensus"],
        sample_depth=a["sample_depth"], fract_cov=a["fract_cov"],
        max_samples=a["max_samples"], keep_samples=_split(a["keep_samples"]),
        exclude_samples=_split(a["exclude_samples"]), site_list=a["site_list"],
        site_depth=a["site_depth"], site_prev=a["site_prev"],
        site_maf=a["site_maf"], site_ratio=a["site_ratio"],
        allele_support=a["allele_support"], locus_type=a["locus_type"],
        site_type=a["site_type"], max_sites=a["max_sites"])
    return 0


def compare_genes_main(argv=None):
    p = argparse.ArgumentParser(
        prog="compare_genes",
        description="Compute gene-content distances between all pairs of samples")
    p.add_argument("indir", metavar="PATH", type=str,
                   help="path to output from `merge_midas genes` for one species")
    p.add_argument("--out", metavar="PATH", type=str, default="/dev/stdout",
                   help="path to output file")
    p.add_argument("--distance", choices=["jaccard", "euclidean", "manhattan"],
                   default="jaccard", help="distance metric (jaccard)")
    p.add_argument("--dtype", choices=["presabs", "copynum"], default="copynum",
                   help="data type to use for comparing genes (copynum)")
    p.add_argument("--cutoff", type=float, default=0.35, metavar="FLOAT",
                   help="cutoff to use for determining gene presence-absence (0.35)")
    p.add_argument("--max_genes", type=int, metavar="INT",
                   help="maximum number of genes to use; useful for quick tests (use all)")
    p.add_argument("--max_samples", type=int, metavar="INT",
                   help="maximum number of samples to use; useful for quick tests (use all)")
    a = vars(p.parse_args(argv))
    from midas_tpu_torch.analyze.compare_genes import compare_genes
    compare_genes(a["indir"], a["out"], dtype=a["dtype"], distance=a["distance"],
                  cutoff=a["cutoff"], max_genes=a["max_genes"],
                  max_samples=a["max_samples"])
    return 0


def strain_tracking_main(argv=None):
    p = argparse.ArgumentParser(
        prog="strain_tracking",
        description="Track strains between samples using rare SNPs")
    subs = p.add_subparsers(dest="program", required=True)
    pid = subs.add_parser("id_markers", help="identify rare SNPs that discriminate individual strains")
    pid.add_argument("indir", metavar="PATH",
                     help="path to output from `merge_midas snps` for one species")
    pid.add_argument("--out", metavar="PATH", required=True, help="path to output file")
    pid.add_argument("--samples", metavar="STR",
                     help="comma-separated list of samples to use for training")
    pid.add_argument("--min_freq", type=float, default=0.10, metavar="FLOAT",
                     help="minimum frequency for calling an allele present (0.10)")
    pid.add_argument("--min_reads", type=int, default=3, metavar="INT",
                     help="minimum number of reads supporting allele (3)")
    pid.add_argument("--allele_prev", type=int, default=1, metavar="INT",
                     help="rarer allele occurs in <= N samples (1)")
    pid.add_argument("--max_sites", type=float, default=float("inf"), metavar="INT",
                     help="maximum number of sites to process (use all)")
    ptr = subs.add_parser("track_markers", help="track rare SNPs between samples")
    ptr.add_argument("indir", metavar="PATH",
                     help="path to output from `merge_midas snps` for one species")
    ptr.add_argument("--out", metavar="PATH", required=True, help="path to output file")
    ptr.add_argument("--markers", metavar="PATH", required=True,
                     help="path to output from `strain_tracking id_markers`")
    ptr.add_argument("--min_freq", type=float, default=0.10, metavar="FLOAT",
                     help="minimum frequency for calling an allele present (0.10)")
    ptr.add_argument("--min_reads", type=int, default=3, metavar="INT",
                     help="minimum number of reads supporting allele (3)")
    ptr.add_argument("--max_sites", type=float, default=float("inf"), metavar="INT",
                     help="maximum number of sites to process (use all)")
    a = vars(p.parse_args(argv))
    from midas_tpu_torch.analyze.track_strains import id_markers, track_markers
    if a["program"] == "id_markers":
        id_markers(a["indir"], a["out"], samples_keep=_split(a.get("samples")),
                   min_freq=a["min_freq"], min_reads=a["min_reads"],
                   allele_prev=a["allele_prev"], max_sites=a["max_sites"])
    else:
        track_markers(a["indir"], a["out"], a["markers"], min_freq=a["min_freq"],
                      min_reads=a["min_reads"], max_sites=a["max_sites"])
    return 0


def query_by_compound_main(argv=None):
    p = argparse.ArgumentParser(
        prog="query_by_compound",
        description="Query MIDAS output results by KEGG compound identifier")
    p.add_argument("-i", type=str, dest="input", required=True,
                   help="Input to sample directories output by run_midas")
    p.add_argument("-t", choices=["list", "file", "dir"], dest="intype", required=True,
                   help="input type for -i")
    p.add_argument("-o", type=str, dest="out", default="/dev/stdout",
                   help="Path to output file (/dev/stdout)")
    p.add_argument("-d", type=str, dest="db", default=os.environ.get("MIDAS_DB"),
                   help="Path to MIDAS reference database")
    p.add_argument("-c", type=str, dest="compound", required=True,
                   help="KEGG Compound identifier")
    p.add_argument("--cpd_to_enzyme", type=str,
                   help="Path to compound->enzyme TSV (default: <db>/kegg/cpd_to_enzyme.txt)")
    a = vars(p.parse_args(argv))
    from midas_tpu_torch.analyze.query_compound import query_by_compound
    from midas_tpu_torch.cli.merge_midas import list_samples
    from midas_tpu_torch.db.layout import check_database
    check_database(a["db"])
    indirs = list_samples(a["input"], a["intype"])
    query_by_compound(indirs, a["db"], a["compound"], a["out"],
                      cpd_to_enzyme_path=a.get("cpd_to_enzyme"))
    return 0


TOOLS = {
    "call_consensus": call_consensus_main,
    "snp_diversity": snp_diversity_main,
    "compare_genes": compare_genes_main,
    "strain_tracking": strain_tracking_main,
    "query_by_compound": query_by_compound_main,
}


def main(argv=None):
    """Dispatch on the tool name, the first argument."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in TOOLS:
        sys.exit("usage: python -m midas_tpu_torch.cli.analysis "
                 f"{{{','.join(TOOLS)}}} [arguments]")
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
