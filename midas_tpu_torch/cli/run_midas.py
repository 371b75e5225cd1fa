"""run_midas — per-sample profiling CLI of the PyTorch/CUDA port.

The `species` subcommand, with the argparse surface of midas_tpu's
run_midas (itself flag-compatible with the reference scripts/run_midas.py
:86-143) plus --device. Run as

    python -m midas_tpu_torch.cli.run_midas species <out> -1 <fq> -d <db>

It runs on the card (--device cuda, the default) and raises without
one; --device cpu runs the plain PyTorch versions of the kernels.
Not yet ported: the genes and snps subcommands, --m8, multi-host runs.

Differences from the reference, by design:
- no --threads-style process parallelism: batches run data-parallel on
  the accelerator; -t is accepted and ignored for compatibility
- a --seed flag controls the ambiguous-read RNG (the reference is
  unseeded, midas/run/species.py:113-117)
"""

from __future__ import annotations

import argparse
import os
import sys
from time import time

from midas_tpu_torch.db.layout import check_database


def species_parser(subs):
    p = subs.add_parser("species", help="Estimate species abundance from marker genes")
    p.add_argument("outdir", type=str, help="Path to directory to store results")
    p.add_argument("-1", type=str, dest="m1", required=True,
                   help="FASTA/FASTQ file containing 1st mate if using paired-end reads; otherwise FASTA/FASTQ containing unpaired reads. Can be gzip'ed (extension: .gz) or bzip2'ed (extension: .bz2)")
    p.add_argument("-2", type=str, dest="m2", help="FASTA/FASTQ file containing 2nd mate if using paired-end reads")
    p.add_argument("-n", type=int, dest="max_reads", help="Number of reads to use from input file(s) (use all)")
    p.add_argument("-t", dest="threads", default=1, help="Accepted for compatibility; device batches replace host threads")
    p.add_argument("-d", type=str, dest="db",
                   default=os.environ.get("MIDAS_DB"),
                   help="Path to reference database. By default, the MIDAS_DB environmental variable is used")
    p.add_argument("--remove_temp", default=False, action="store_true",
                   help="Remove temporary files, including BLAST-like output")
    p.add_argument("--m8", default=False, action="store_true",
                   help="Write BLAST outfmt-6 alignments to species/temp/alignments.m8 "
                        "(not yet ported: raises)")
    p.add_argument("--word_size", type=int, metavar="INT", default=28,
                   help="Accepted for compatibility (seeding uses the k-mer index)")
    p.add_argument("--mapid", type=float, metavar="FLOAT",
                   help="Discard reads with alignment identity < MAPID. By default gene-specific species-level cutoffs are used")
    p.add_argument("--aln_cov", type=float, metavar="FLOAT", default=0.75,
                   help="Discard reads with alignment coverage < ALN_COV (0.75)")
    p.add_argument("--read_length", type=int, metavar="INT",
                   help="Trim reads to READ_LENGTH and discard reads with length < READ_LENGTH. By default, reads are not trimmed or filtered")
    p.add_argument("--profile", action="store_true", default=False,
                   help="Write a torch.profiler trace to "
                        "<outdir>/species/torch_trace.json")
    p.add_argument("--seed", type=int, default=42,
                   help="RNG seed for probabilistic assignment of ambiguous reads (42)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on: cuda (default; needs a card) or cpu")
    return p


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_midas",
        description="midas_tpu_torch: species profiling per sample on an NVIDIA card",
    )
    subs = parser.add_subparsers(dest="program", required=True)
    species_parser(subs)
    return parser


README = """
Description of output files and file formats from 'run_midas species'

Output files
############
species_profile.txt
  tab-delimited with header
  each line contains the abundance values for 1 species
  sorted by decreasing relative abundance
log.txt
  log file containing parameters used
temp
  directory of intermediate files
  run with `--remove_temp` to remove these files

Output formats
############
species_profile.txt
  species_id: species identifier
  count_reads: number of reads mapped to marker genes
  coverage: estimated genome-coverage (i.e. read-depth) of species in metagenome
  relative_abundance: estimated relative abundance of species in metagenome

Additional information for each species can be found in the reference database:
 {db}/marker_genes
"""


def main(argv=None):
    args = vars(build_parser().parse_args(argv))
    program = args["program"]
    check_database(args.get("db"))
    outdir = args["outdir"]
    for sub in (program, f"{program}/temp"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    with open(os.path.join(outdir, program, "readme.txt"), "w") as f:
        f.write(README.format(db=args.get("db")))
    start = time()
    with open(os.path.join(outdir, program, "log.txt"), "w") as log:
        log.write("command: " + " ".join(sys.argv) + "\n")
        for k in sorted(args):
            log.write(f"{k}: {args[k]}\n")
        args["log"] = log
        from midas_tpu_torch.profile.species import run_species

        try:
            if args.get("profile"):
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if args["device"].startswith("cuda"):
                    acts.append(ProfilerActivity.CUDA)
                trace = os.path.join(outdir, program, "torch_trace.json")
                with profile(activities=acts) as prof:
                    run_species(args)
                prof.export_chrome_trace(trace)
                log.write(f"torch trace: {trace}\n")
            else:
                run_species(args)
        finally:
            log.write(f"total minutes: {round((time() - start) / 60, 2)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
