"""build_midas_db — custom database construction CLI, mirroring the
reference scripts/build_midas_db.py argparse surface (:15-67)."""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="build_midas_db",
        description="Build a custom MIDAS-layout reference database from "
                    "your own genomes")
    p.add_argument("indir", type=str,
                   help="Path to directory of input genomes; each subdirectory"
                        " <genome_id> needs <genome_id>.{fna,ffn,faa}")
    p.add_argument("mapfile", type=str,
                   help="Path to mapping file with fields genome_id, "
                        "species_id[, rep_genome]")
    p.add_argument("outdir", type=str, help="Directory to store output files")
    p.add_argument("--threads", type=int, default=1, metavar="INT",
                   help="Accepted for compatibility; build is vectorized")
    p.add_argument("--compress", action="store_true", default=False,
                   help="Compress output files with gzip")
    p.add_argument("--max_species", type=int, default=None, metavar="INT",
                   help="Maximum number of species to process (use all)")
    p.add_argument("--max_genomes", type=int, default=None, metavar="INT",
                   help="Maximum number of genomes per species (use all)")
    p.add_argument("--hmms", type=str, default=None,
                   help="Path to profile HMMs (HMMER3 ASCII) for marker-gene "
                        "identification; 15 PhyEco families in the stock DB")
    p.add_argument("--marker_map", type=str, default=None,
                   help="Alternative to --hmms: TSV of gene_id<TAB>marker_id "
                        "when marker families are already known")
    p.add_argument("--max_evalue", type=float, default=1e-5,
                   help="Maximum e-value for marker HMM hits (1e-5)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="Skip steps whose outputs already exist non-empty "
                        "(reference build_db.py:120-143)")
    return p


def main(argv=None):
    args = vars(build_parser().parse_args(argv))
    if not os.path.isdir(args["indir"]):
        sys.exit(f"\nError: input directory not found: {args['indir']}")
    if not os.path.isfile(args["mapfile"]):
        sys.exit(f"\nError: mapping file not found: {args['mapfile']}")
    from midas_tpu_torch.dbbuild.build_db import run_build
    run_build(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
