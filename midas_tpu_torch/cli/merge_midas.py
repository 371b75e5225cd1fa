"""merge_midas — cross-sample merge CLI of the PyTorch/CUDA port,
flag-compatible with the reference scripts/merge_midas.py (subcommands
species/genes/snps, input types list/file/dir at :311-331, snps presets
at :198-280). Run as

    python -m midas_tpu_torch.cli.merge_midas species <out> -i <dirs> -t list -d <db>
    python -m midas_tpu_torch.cli.merge_midas genes <out> -i <dir> -t dir -d <db>
    python -m midas_tpu_torch.cli.merge_midas snps <out> -i <file> -t file -d <db>

Merging is host numpy over run_midas's per-sample outputs (merge/), with
midas_tpu's outputs byte for byte; it takes no --device."""

from __future__ import annotations

import argparse
import os
import sys

from midas_tpu_torch.db.layout import check_database


def _io_args(p, snps=False):
    p.add_argument("outdir", type=str, help="Directory for output files")
    p.add_argument("-i", type=str, dest="input", required=True,
                   help="Input to sample directories output by run_midas; see -t for details")
    p.add_argument("-t", choices=["list", "file", "dir"], dest="intype",
                   required=True, metavar="INPUT_TYPE",
                   help="'list': -i is a comma-separated list; "
                        "'dir': -i is a directory containing all samples; "
                        "'file': -i is a file of paths to samples")
    p.add_argument("-d", type=str, dest="db", default=os.environ.get("MIDAS_DB"),
                   help="Path to reference database. By default the MIDAS_DB environmental variable is used")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="merge_midas",
        description="midas_tpu_torch: merge per-sample results across samples")
    subs = parser.add_subparsers(dest="program", required=True)

    sp = subs.add_parser("species", help="Merge species abundance across samples")
    _io_args(sp)
    sp.add_argument("--sample_depth", dest="min_cov", metavar="FLOAT", type=float,
                    default=1.0, help="Minimum per-sample marker-gene-depth for estimating species prevalence (1.0)")
    sp.add_argument("--max_samples", type=int, metavar="INT",
                    help="Maximum number of samples to process; useful for testing (use all)")

    ge = subs.add_parser("genes", help="Merge gene copy numbers across samples")
    _io_args(ge)
    spg = ge.add_argument_group("Species filters")
    spg.add_argument("--min_samples", type=int, default=1, metavar="INT",
                     help="All species with >= MIN_SAMPLES (1)")
    spg.add_argument("--species_id", type=str, metavar="CHAR",
                     help="Comma-separated list of species ids")
    spg.add_argument("--max_species", type=int, metavar="INT",
                     help="Maximum number of species to analyze (use all)")
    sag = ge.add_argument_group("Sample filters")
    sag.add_argument("--sample_depth", type=float, default=1.0, metavar="FLOAT",
                     help="Minimum read-depth across all genes with non-zero coverage (1.0)")
    sag.add_argument("--max_samples", type=int, metavar="INT",
                     help="Maximum number of samples to process (use all)")
    qg = ge.add_argument_group("Quantification")
    qg.add_argument("--cluster_pid", type=str, default="95",
                    choices=["75", "80", "85", "90", "95", "99"],
                    help="Gene family percent identity; small values: fewer, larger gene families (95)")
    qg.add_argument("--min_copy", type=float, default=0.35, metavar="FLOAT",
                    help="Genes >= MIN_COPY are classified as present (0.35)")

    sn = subs.add_parser("snps", help="Merge SNPs across samples (core-genome SNP calling)")
    _io_args(sn, snps=True)
    sn.add_argument("--threads", type=int, default=1, metavar="INT",
                    help="Accepted for compatibility; merging is vectorized")
    pre = sn.add_argument_group("Presets")
    pre.add_argument("--core_snps", action="store_true",
                     help="Same as: --snp_type bi --site_depth 1 --site_ratio 2.0 --site_prev 0.95 (default)")
    pre.add_argument("--core_sites", action="store_true",
                     help="Same as: --snp_type any --site_depth 1 --site_ratio 2.0 --site_prev 0.95")
    pre.add_argument("--all_snps", action="store_true",
                     help="Same as: --snp_type bi --site_prev 0.0")
    pre.add_argument("--all_sites", action="store_true",
                     help="Same as: --snp_type any --site_prev 0.0")
    spf = sn.add_argument_group("Species filters")
    spf.add_argument("--min_samples", type=int, default=1, metavar="INT",
                     help="All species with >= MIN_SAMPLES (1)")
    spf.add_argument("--species_id", type=str, metavar="CHAR",
                     help="Comma-separated list of species ids")
    spf.add_argument("--max_species", type=int, metavar="INT",
                     help="Maximum number of species to call SNPs for (all with >= 1 sample)")
    saf = sn.add_argument_group("Sample filters")
    saf.add_argument("--sample_depth", type=float, default=5.0, metavar="FLOAT",
                     help="Minimum average read depth per sample (5.0)")
    saf.add_argument("--fract_cov", type=float, default=0.4, metavar="FLOAT",
                     help="Fraction of reference sites covered by at least 1 read (0.4)")
    saf.add_argument("--max_samples", type=int, metavar="INT",
                     help="Maximum number of samples to process (use all)")
    saf.add_argument("--all_samples", default=False, action="store_true",
                     help="Include all samples regardless of coverage")
    sif = sn.add_argument_group("Site filters")
    sif.add_argument("--snp_type", choices=["any", "mono", "bi", "tri", "quad"],
                     nargs="+", default=["bi"], metavar="",
                     help="Specify one or more site types: mono, bi, tri, quad, any (bi)")
    sif.add_argument("--allele_freq", type=float, default=0.01, metavar="FLOAT",
                     help="Minimum frequency for calling an allele present (0.01)")
    sif.add_argument("--site_depth", type=int, default=1, metavar="INT",
                     help="Minimum number of reads mapped to genomic site (1)")
    sif.add_argument("--site_ratio", type=float, default=2.0, metavar="FLOAT",
                     help="Maximum ratio of site depth to mean genome depth (2.0)")
    sif.add_argument("--site_prev", type=float, default=0.95, metavar="FLOAT",
                     help="Site has at least <site_depth> coverage in at least <site_prev> proportion of samples (0.95)")
    sif.add_argument("--max_sites", type=float, default=float("inf"), metavar="INT",
                     help="Maximum number of sites to include in output (use all)")
    return parser


def list_samples(input: str, intype: str):
    """Expand -i/-t into sample directories (merge_midas.py:311-331)."""
    if intype == "list":
        return input.split(",")
    if intype == "dir":
        if not os.path.isdir(input):
            sys.exit(f"\nError: specified input directory does not exist: {input}")
        return sorted(os.path.join(input, d) for d in os.listdir(input))
    if not os.path.isfile(input):
        sys.exit(f"\nError: specified input file does not exist: {input}")
    return [line.rstrip().rstrip("/") for line in open(input) if line.strip()]


def _apply_presets(args: dict) -> None:
    """Preset flag groups rewrite site filters (merge_midas.py:259-280)."""
    if args.pop("core_snps", False):
        args.update(snp_type=["bi"], site_depth=1, site_ratio=2.0, site_prev=0.95)
    elif args.pop("core_sites", False):
        args.update(snp_type=["any"], site_depth=1, site_ratio=2.0, site_prev=0.95)
    elif args.pop("all_snps", False):
        args.update(snp_type=["bi"], site_prev=0.0)
    elif args.pop("all_sites", False):
        args.update(snp_type=["any"], site_depth=1, site_ratio=float("inf"), site_prev=0.0)
    if args.pop("all_samples", False):
        args.update(sample_depth=0.0, fract_cov=0.0)


def main(argv=None):
    args = vars(build_parser().parse_args(argv))
    check_database(args.get("db"))
    args["indirs"] = list_samples(args["input"], args["intype"])
    program = args["program"]
    os.makedirs(args["outdir"], exist_ok=True)
    if program == "species":
        from midas_tpu_torch.merge.species import run_pipeline
    elif program == "genes":
        from midas_tpu_torch.merge.genes import run_pipeline
    else:
        _apply_presets(args)
        from midas_tpu_torch.merge.snps import run_pipeline
    run_pipeline(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
