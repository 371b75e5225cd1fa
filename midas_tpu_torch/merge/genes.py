"""Cross-sample gene CNV merger — midas/merge/genes.py.

Aggregates per-sample .genes.gz into copynum/depth/reads matrices at
the chosen cluster identity level (read_cluster_map :91-98,
build_gene_matrices :12-30) plus a presence/absence matrix thresholded
at min_copy (default 0.35)."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict

from midas_tpu_torch.io.seqio import parse_file
from midas_tpu_torch.merge.core import SpeciesGroup, select_species


def read_cluster_map(sp: SpeciesGroup, db_dir: str, pid: str) -> Dict[str, str]:
    """centroid_99 -> centroid_{pid} (genes.py:91-98)."""
    gene_map = {}
    for ext in ["", ".gz"]:
        path = os.path.join(db_dir, "pan_genomes", sp.id, "gene_info.txt" + ext)
        if os.path.isfile(path):
            for r in parse_file(path):
                gene_map[r["centroid_99"]] = r[f"centroid_{pid}"]
            return gene_map
    raise FileNotFoundError(f"gene_info.txt for {sp.id}")


def build_gene_matrices(sp: SpeciesGroup, gene_map: Dict[str, str],
                        min_copy: float) -> None:
    """Aggregate into cluster level; presabs = copynum >= min_copy
    (genes.py:12-30)."""
    for sample in sp.samples:
        genes = {f: defaultdict(float) for f in ["presabs", "copynum", "depth"]}
        genes["reads"] = defaultdict(int)
        inpath = os.path.join(sample.dir, "genes/output", f"{sp.id}.genes.gz")
        for r in parse_file(inpath):
            if "ref_id" in r:
                r["gene_id"] = r["ref_id"]
            if "normalized_coverage" in r:
                r["copy_number"] = r["normalized_coverage"]
            if "raw_coverage" in r:
                r["coverage"] = r["raw_coverage"]
            gene_id = gene_map[r["gene_id"]]
            genes["copynum"][gene_id] += float(r["copy_number"])
            genes["depth"][gene_id] += float(r["coverage"])
            genes["reads"][gene_id] += int(r.get("count_reads", 0))
        for gene_id, copynum in genes["copynum"].items():
            genes["presabs"][gene_id] = 1 if copynum >= min_copy else 0
        sample.genes = genes


def write_gene_matrices(sp: SpeciesGroup) -> None:
    outfiles = {}
    for ftype in ["presabs", "copynum", "depth", "reads"]:
        outfiles[ftype] = open(os.path.join(sp.dir, f"genes_{ftype}.txt"), "w")
        outfiles[ftype].write("\t".join(["gene_id"] + [s.id for s in sp.samples]) + "\n")
    genes = sorted(sp.samples[0].genes["depth"])
    for gene_id in genes:
        for ftype in ["presabs", "copynum", "depth", "reads"]:
            outfiles[ftype].write(gene_id)
            for sample in sp.samples:
                outfiles[ftype].write("\t" + str(sample.genes[ftype][gene_id]))
            outfiles[ftype].write("\n")
    for f in outfiles.values():
        f.close()


def run_pipeline(args: Dict) -> None:
    os.makedirs(args["outdir"], exist_ok=True)
    species_list = select_species(args, dtype="genes")
    for sp in species_list:
        sp.dir = os.path.join(args["outdir"], sp.id)
        os.makedirs(sp.dir, exist_ok=True)
        gene_map = read_cluster_map(sp, args["db"], args.get("cluster_pid", "95"))
        build_gene_matrices(sp, gene_map, min_copy=args.get("min_copy", 0.35))
        write_gene_matrices(sp)
        sp.write_sample_info(dtype="genes", outdir=args["outdir"])
        _write_readme(args, sp)


def _write_readme(args: Dict, sp: SpeciesGroup) -> None:
    with open(os.path.join(sp.dir, "readme.txt"), "w") as f:
        f.write(f"""
Description of output files and file formats from 'merge_midas.py genes'

Output files
############
genes_depth.txt
  average-read depth of each gene per sample
genes_copynum.txt
  copy-number of each gene per sample
  estimated by dividing the read-depth of a gene by the median read-depth of 15 universal single copy genes
genes_presabs.txt
  the presence (1) or absence (0) of each gene per sample
  estimated by applying a threshold to gene copy-number values
genes_reads.txt
  number of reads mapped to each gene per sample
genes_summary.txt
  alignment summary statistics per sample

Output formats
############
genes_depth.txt, genes_copynum.txt, genes_presabs.txt, genes_reads.txt
  tab-delimited matrix files
  field names are sample ids
  row names are gene ids
genes_summary.txt
  sample_id: sample identifier
  pangenome_size: number of non-redundant genes in reference pan-genome
  covered_genes: number of genes with at least 1 mapped read
  fraction_covered: proportion of genes with at least 1 mapped read
  mean_coverage: average read-depth across genes with at least 1 mapped read
  marker_coverage: median read-depth across 15 universal single copy genes
  aligned_reads: number of reads that aligned to pangenome
  mapped_reads: number of aligned reads after applying filters for mapping quality, base quality, alignment fraction, and percent identity

Additional information for species can be found in the reference database:
 {args['db']}/pan_genomes/{sp.id}
""")
