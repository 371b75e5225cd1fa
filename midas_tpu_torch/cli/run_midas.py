"""run_midas — per-sample profiling CLI of the PyTorch/CUDA port.

The `species`, `genes` and `snps` subcommands, with the argparse surface
of midas_tpu's run_midas (itself flag-compatible with the reference
scripts/run_midas.py :86-143, :204-289, :338-430) plus --device. Run as

    python -m midas_tpu_torch.cli.run_midas species <out> -1 <fq> -d <db>
    python -m midas_tpu_torch.cli.run_midas genes <out> -1 <fq> -d <db>
    python -m midas_tpu_torch.cli.run_midas snps <out> -1 <fq> -d <db>

It runs on the card (--device cuda, the default) and raises without
one; --device cpu runs the plain PyTorch versions of the kernels.
genes and snps take mate pairs with -1/-2 or --interleaved; species
writes BLAST outfmt-6 rows with --m8.

Over N cards, one rank per card:

    torchrun --nproc_per_node=N -m midas_tpu_torch.cli.run_midas species ...

Each rank joins the launcher's process group (dist/driver.py), strides
the shared read stream on its card, and rank 0 writes the outputs,
log.txt and readme.txt; they are byte-identical to a single-process
run's. Stage splits of genes / snps and --m8 exit there.

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
                        "(forces per-batch host readback; default keeps the classifier "
                        "fully device-resident)")
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
                        "<outdir>/species/torch_trace.json and the "
                        "program's spans and counters to spans.jsonl "
                        "beside it (torch_trace.rank<R>/ under several "
                        "ranks)")
    p.add_argument("--seed", type=int, default=42,
                   help="RNG seed for probabilistic assignment of ambiguous reads (42)")
    _add_device_arg(p)
    return p


def _add_device_arg(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on: cuda (default; needs a card) or cpu")


def _add_shared_align_args(p, mode_default):
    p.add_argument("outdir", type=str, help="Path to directory to store results")
    p.add_argument("--remove_temp", default=False, action="store_true",
                   help="Remove temporary files")
    pipe = p.add_argument_group("Pipeline options (choose one or more; default=all)")
    pipe.add_argument("--build_db", action="store_true", default=False,
                      help="Build database of target sequences for abundant species")
    pipe.add_argument("--align", action="store_true", default=False,
                      help="Align reads to target database")
    db = p.add_argument_group("Database options (if using --build_db)")
    db.add_argument("-d", type=str, dest="db", default=os.environ.get("MIDAS_DB"),
                    help="Path to reference database. By default, the MIDAS_DB environmental variable is used")
    db.add_argument("--species_cov", type=float, metavar="FLOAT",
                    help="Include species with >X coverage (3.0)")
    db.add_argument("--species_topn", type=int, metavar="INT",
                    help="Include top N most abundant species")
    db.add_argument("--species_id", type=str, metavar="CHAR",
                    help="Include specified species. Separate ids with a comma")
    align = p.add_argument_group("Read alignment options (if using --align)")
    align.add_argument("-1", type=str, dest="m1", required=True,
                       help="FASTA/FASTQ file containing 1st mate if using paired-end reads; otherwise unpaired reads")
    align.add_argument("-2", type=str, dest="m2",
                       help="FASTA/FASTQ file containing 2nd mate")
    align.add_argument("--interleaved", action="store_true", default=False,
                       help="FASTA/FASTQ file in -1 are paired and contain forward AND reverse reads")
    align.add_argument("-s", type=str, dest="speed", default="very-sensitive",
                       choices=["very-fast", "fast", "sensitive", "very-sensitive"],
                       help="Accepted for compatibility; the aligner always runs full sensitivity")
    align.add_argument("-m", type=str, dest="mode", default=mode_default,
                       choices=["local", "global"],
                       help=f"Global/local read alignment ({mode_default})")
    align.add_argument("-n", type=int, dest="max_reads",
                       help="# reads to use from input file(s) (use all)")
    align.add_argument("-t", dest="threads", default=1,
                       help="Accepted for compatibility")
    p.add_argument("--force", action="store_true", default=False,
                   help="Consume an existing alignment state even when it "
                        "was written with different parameters (downgrades "
                        "the mismatch error to a warning)")
    p.add_argument("--profile", action="store_true", default=False,
                   help="Write a torch.profiler trace to "
                        "<outdir>/<program>/torch_trace.json and the "
                        "program's spans and counters to spans.jsonl "
                        "beside it (torch_trace.rank<R>/ under several "
                        "ranks)")
    _add_device_arg(p)
    return p


def genes_parser(subs):
    p = subs.add_parser("genes", help="Quantify gene copy numbers from species pangenomes")
    _add_shared_align_args(p, mode_default="local")
    g = p.add_argument_group("Quantify genes options (if using --call_genes)")
    p.add_argument("--call_genes", action="store_true", dest="cov", default=False,
                   help="Compute coverage of genes in pangenome database")
    g.add_argument("--readq", type=int, metavar="INT", default=20,
                   help="Discard reads with mean quality < READQ (20)")
    g.add_argument("--mapid", type=float, metavar="FLOAT", default=94.0,
                   help="Discard reads with alignment identity < MAPID (94.0)")
    g.add_argument("--mapq", type=int, metavar="INT", default=0, help=argparse.SUPPRESS)
    g.add_argument("--aln_cov", type=float, metavar="FLOAT", default=0.75,
                   help="Discard reads with alignment coverage < ALN_COV (0.75)")
    g.add_argument("--trim", type=int, default=0, metavar="INT",
                   help="Trim N base-pairs from 3'/right end of read")
    return p


def snps_parser(subs):
    p = subs.add_parser("snps", help="Identify SNPs from representative genomes")
    _add_shared_align_args(p, mode_default="global")
    p.add_argument("--pileup", action="store_true", dest="call", default=False,
                   help="Count alleles across genome")
    s = p.add_argument_group("Pileup options (if using --pileup)")
    s.add_argument("--mapid", type=float, metavar="FLOAT", default=94.0,
                   help="Discard reads with alignment identity < MAPID (94.0)")
    s.add_argument("--mapq", type=int, metavar="INT", default=20,
                   help="Discard reads with mapping quality < MAPQ (20)")
    s.add_argument("--baseq", type=int, metavar="INT", default=30,
                   help="Discard bases with quality < BASEQ (30)")
    s.add_argument("--readq", type=int, metavar="INT", default=20,
                   help="Discard reads with mean quality < READQ (20)")
    s.add_argument("--aln_cov", type=float, metavar="FLOAT", default=0.75,
                   help="Discard reads with alignment coverage < ALN_COV (0.75)")
    s.add_argument("--trim", metavar="INT", type=int, default=0,
                   help="Trim N base-pairs from 3'/right end of read")
    # accepted for compatibility: the reference parses these but never
    # passes them to pysam (scripts/run_midas.py:422-427 — vestigial)
    s.add_argument("--discard", default=False, action="store_true",
                   help="Accepted for compatibility (vestigial in the reference)")
    s.add_argument("--baq", default=False, action="store_true",
                   help="Accepted for compatibility (vestigial in the reference)")
    s.add_argument("--adjust_mq", default=False, action="store_true",
                   help="Accepted for compatibility (vestigial in the reference)")
    return p


def build_parser():
    parser = argparse.ArgumentParser(
        prog="run_midas",
        description="midas_tpu_torch: species, gene and SNP profiling per sample on an NVIDIA card",
    )
    subs = parser.add_subparsers(dest="program", required=True)
    species_parser(subs)
    genes_parser(subs)
    snps_parser(subs)
    return parser


SPECIES_README = """
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

GENES_README = """
Description of output files and file formats from 'run_midas genes'

Output files
############
output
  directory of per-species output files
  files are tab-delimited, gzip-compressed, with header
  naming convention of each file is: {{SPECIES_ID}}.genes.gz
species.txt
  list of species_ids included in local database
summary.txt
  tab-delimited with header
  summarizes alignment results per-species
log.txt
  log file containing parameters used
temp
  directory of intermediate files
  run with `--remove_temp` to remove these files

Output formats
############
output/{{SPECIES_ID}}.genes.gz
  gene_id: id of non-redundant gene used for read mapping; 'peg' and 'rna' indicate coding & RNA genes respectively
  count_reads: number of aligned reads to gene_id after quality filtering
  coverage: average read-depth of gene_id based on aligned reads (# aligned bp / gene length in bp)
  copy_number: estimated copy-number of gene_id based on aligned reads (coverage of gene_id / median coverage of 15 universal single copy genes)

summary.txt
  species_id: species id
  pangenome_size: number of non-redundant genes in reference pan-genome
  covered_genes: number of genes with at least 1 mapped read
  fraction_covered: proportion of genes with at least 1 mapped read
  mean_coverage: average read-depth across genes with at least 1 mapped read
  marker_coverage: median read-depth across 15 universal single copy genes
  aligned_reads: number of aligned reads BEFORE quality filtering
  mapped_reads: number of aligned reads AFTER quality filtering

Additional information for each species can be found in the reference database:
 {db}/pan_genomes
"""

SNPS_README = """
Description of output files and file formats from 'run_midas snps'

Output files
############
output
  directory of per-species output files
  files are tab-delimited, gzip-compressed, with header
  naming convention of each file is: {{SPECIES_ID}}.snps.gz
species.txt
  list of species_ids included in local database
summary.txt
  tab-delimited with header
  summarizes alignment results per-species
log.txt
  log file containing parameters used
temp
  directory of intermediate files
  run with `--remove_temp` to remove these files

Output formats
############
output/{{SPECIES_ID}}.snps.gz
  ref_id: id of reference scaffold/contig/genome
  ref_pos: position in ref_id (1-indexed)
  ref_allele: reference nucleotide
  depth: number of mapped reads
  count_a: count of A allele
  count_c: count of C allele
  count_g: count of G allele
  count_t: count of T allele

summary.txt
  species_id: species id
  genome_length: number of base pairs in representative genome
  covered_bases: number of reference sites with at least 1 mapped read
  fraction_covered: proportion of reference sites with at least 1 mapped read
  mean_coverage: average read-depth across reference sites with at least 1 mapped read
  aligned_reads: number of aligned reads BEFORE quality filtering
  mapped_reads: number of aligned reads AFTER quality filtering

Additional information for each species can be found in the reference database:
 {db}/rep_genomes
"""

README = {"species": SPECIES_README, "genes": GENES_README,
          "snps": SNPS_README}


def _check_stage_intermediates(args: dict, program: str) -> None:
    """Stage-dependency validation (scripts/run_midas.py:506-604): a
    later stage run alone must find the intermediates an earlier stage
    would have produced. Our stages persist species.txt (--build_db)
    and temp/state.npz checkpoints (--align), not BAMs."""
    outdir = args["outdir"]
    last = "cov" if program == "genes" else "call"
    splist = os.path.join(outdir, program, "species.txt")
    if not args.get("build_db") and (args.get("align") or args.get(last)):
        if not os.path.isfile(splist):
            sys.exit(f"\nError: no species list: {splist}\n"
                     f"To use --align or --{'call_genes' if program == 'genes' else 'pileup'} "
                     "you must have already run --build_db\n")
    if args.get(last) and not args.get("align") and not args.get("build_db"):
        state = os.path.join(outdir, program, "temp/state.npz")
        if not os.path.isfile(state):
            sys.exit(f"\nError: no alignment state: {state}\n"
                     "To use this stage alone you must have already run --align\n")
    # species selection flags need the species profile (ref :516-520)
    if args.get("build_db") and (args.get("species_cov") is not None
                                 or args.get("species_topn")):
        profile = os.path.join(outdir, "species/species_profile.txt")
        if not os.path.isfile(profile) and not args.get("species_id"):
            sys.exit(f"\nError: Could not find species abundance profile: {profile}\n"
                     "To specify species with --species_topn or --species_cov you "
                     "must have run: run_midas.py species\n"
                     "Alternatively, you can manually specify one or more species "
                     "using --species_id\n")


def main(argv=None):
    from midas_tpu_torch.dist import driver

    args = vars(build_parser().parse_args(argv))
    program = args["program"]
    # under a launcher (WORLD_SIZE > 1) join its process group first, so
    # that a rank failing below fails its peers' collectives at once
    driver.initialize()
    rank, n_ranks = driver.process_index(), driver.process_count()
    check_database(args.get("db"))
    if isinstance(args.get("species_id"), str):
        args["species_id"] = args["species_id"].split(",")
    if program in ("genes", "snps"):
        # default = all pipeline stages, like the reference (:72-84)
        stage_keys = ["build_db", "align",
                      "cov" if program == "genes" else "call"]
        if not any(args.get(k) for k in stage_keys):
            for k in stage_keys:
                args[k] = True
        # default species selection: coverage >= 3.0 when no selection
        # flag is given (scripts/run_midas.py:511-513)
        if not any([args.get("species_id"), args.get("species_topn"),
                    args.get("species_cov") is not None]):
            args["species_cov"] = 3.0
        _check_stage_intermediates(args, program)
    outdir = args["outdir"]
    subs = [program, f"{program}/temp"] + (
        [f"{program}/output"] if program in ("genes", "snps") else [])
    for sub in subs:
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    # only rank 0 writes readme.txt and log.txt (the others compute)
    if rank == 0:
        with open(os.path.join(outdir, program, "readme.txt"), "w") as f:
            f.write(README[program].format(db=args.get("db")))
    start = time()
    log_path = (os.path.join(outdir, program, "log.txt") if rank == 0
                else os.devnull)
    with open(log_path, "w") as log:
        log.write("command: " + " ".join(sys.argv) + "\n")
        for k in sorted(args):
            log.write(f"{k}: {args[k]}\n")
        args["log"] = log
        if program == "species":
            from midas_tpu_torch.profile.species import run_species as run
        elif program == "genes":
            from midas_tpu_torch.profile.genes import run_genes as run
        else:
            from midas_tpu_torch.profile.snps import run_snps as run

        try:
            if args.get("profile"):
                from torch._C._profiler import _ExperimentalConfig
                from torch.profiler import ProfilerActivity, profile

                from midas_tpu_torch import tracing

                acts = [ProfilerActivity.CPU]
                if args["device"].startswith("cuda"):
                    acts.append(ProfilerActivity.CUDA)
                # NOT under temp/: --remove_temp deletes it
                trace = os.path.join(outdir, program, "torch_trace.json")
                if n_ranks > 1:   # one trace a rank
                    trace = os.path.join(outdir, program,
                                         f"torch_trace.rank{rank}",
                                         "torch_trace.json")
                    os.makedirs(os.path.dirname(trace), exist_ok=True)
                # every thread: the producer's io.* spans are on the
                # trace beside the main thread's
                every_thread = _ExperimentalConfig(profile_all_threads=True)
                with profile(activities=acts,
                             experimental_config=every_thread) as prof, \
                        tracing.recording() as rec:
                    run(args)
                prof.export_chrome_trace(trace)
                spans = os.path.join(os.path.dirname(trace), "spans.jsonl")
                rec.write_jsonl(spans)
                log.write(f"torch trace: {trace}\nspans: {spans}\n")
            else:
                run(args)
        finally:
            log.write(f"total minutes: {round((time() - start) / 60, 2)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
