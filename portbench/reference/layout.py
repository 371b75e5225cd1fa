"""MIDAS reference-database layout contract.

Honors the exact on-disk layout the reference validates in
utility.check_database (midas/utility.py:171-192) and
consumes throughout run/merge:

    <db>/species_info.txt                      tab file, key species_id
    <db>/genome_info.txt                       tab file, key genome_id
    <db>/exclude.txt                           optional species blacklist
    <db>/marker_genes/phyeco.fa[.gz]           15-family marker gene seqs
    <db>/marker_genes/phyeco.map[.gz]          gene_id -> species/marker meta
    <db>/marker_genes/phyeco.mapping_cutoffs   per-family %id cutoffs
    <db>/pan_genomes/<sp>/centroids.ffn[.gz]   99%-identity gene centroids
    <db>/pan_genomes/<sp>/gene_info.txt[.gz]   centroid_99 -> centroid_{pid}
    <db>/rep_genomes/<sp>/genome.fna[.gz]      representative genome
    <db>/rep_genomes/<sp>/genome.features[.gz] gene coordinate table

A database produced by our dbbuild/ (or by the reference's
build_midas_db.py) loads identically.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional


from portbench.reference.seqio import iopen, parse_file, read_fastx

# Per-marker-family %id mapping cutoffs. Data-identical to the table the
# reference writes into phyeco.mapping_cutoffs
# (midas/build/build_db.py:458-479); used as fallback when
# the file is absent from a custom DB.
DEFAULT_MARKER_CUTOFFS = {
    "B000032": 95.50, "B000039": 94.75, "B000041": 98.00, "B000062": 97.25,
    "B000063": 96.00, "B000065": 98.00, "B000071": 95.25, "B000079": 98.00,
    "B000080": 95.25, "B000081": 97.00, "B000082": 95.25, "B000086": 96.75,
    "B000096": 96.75, "B000103": 95.25, "B000114": 94.50,
}


def _first_existing(*paths: str) -> Optional[str]:
    for p in paths:
        if os.path.isfile(p):
            return p
    return None


def check_database(db_dir: str) -> None:
    """Validate the layout contract (mirrors utility.py:171-192)."""
    if db_dir is None:
        sys.exit(
            "\nError: No reference database specified\n"
            "Use the flag -d to specify a database,\n"
            "or set the MIDAS_DB environmental variable"
        )
    if not os.path.isdir(db_dir):
        sys.exit(f"\nError: Database directory not found: {db_dir}")
    for f in ["species_info.txt", "genome_info.txt"]:
        if not os.path.isfile(os.path.join(db_dir, f)):
            sys.exit(f"\nError: Could not locate required database file: {db_dir}/{f}")
    for d in ["marker_genes", "pan_genomes", "rep_genomes"]:
        if not os.path.isdir(os.path.join(db_dir, d)):
            sys.exit(f"\nError: Could not locate required database directory: {db_dir}/{d}")


class Database:
    """Lazy accessor over a MIDAS-layout reference database."""

    def __init__(self, db_dir: str):
        check_database(db_dir)
        self.dir = os.path.abspath(db_dir)

    # ---- top-level metadata -------------------------------------------------

    def species_info(self) -> Dict[str, dict]:
        return {r["species_id"]: r for r in parse_file(os.path.join(self.dir, "species_info.txt"))}

    # ---- marker genes -------------------------------------------------------

    def marker_fasta(self) -> str:
        p = _first_existing(
            os.path.join(self.dir, "marker_genes/phyeco.fa"),
            os.path.join(self.dir, "marker_genes/phyeco.fa.gz"),
        )
        if p is None:
            sys.exit(f"\nError: marker database not found under {self.dir}/marker_genes")
        return p

    def marker_info(self) -> Dict[str, dict]:
        """gene_id -> {species_id, marker_id, gene_length, ...} for genes in
        phyeco.fa (mirrors run/species.py:19-27: only genes present in the
        FASTA are kept)."""
        in_fasta = set()
        with iopen(self.marker_fasta()) as fp:
            for name, _seq, _q in read_fastx(fp):
                in_fasta.add(name)
        info: Dict[str, dict] = {}
        path = _first_existing(
            os.path.join(self.dir, "marker_genes/phyeco.map"),
            os.path.join(self.dir, "marker_genes/phyeco.map.gz"),
        )
        for r in parse_file(path):
            if r["gene_id"] in in_fasta:
                info[r["gene_id"]] = r
        return info

    def marker_cutoffs(self, override: Optional[float] = None) -> Dict[str, float]:
        """Per-family %id cutoffs (run/species.py:121-132); `override`
        replaces every cutoff with the user-specified --mapid."""
        path = os.path.join(self.dir, "marker_genes/phyeco.mapping_cutoffs")
        cutoffs: Dict[str, float] = {}
        if os.path.isfile(path):
            with open(path) as f:
                for line in f:
                    marker_id, min_pid = line.rstrip().split()
                    cutoffs[marker_id] = float(min_pid)
        else:
            cutoffs = dict(DEFAULT_MARKER_CUTOFFS)
        if override is not None:
            cutoffs = {k: float(override) for k in cutoffs}
        return cutoffs

    # ---- per-species data ---------------------------------------------------

    def pangenome_fasta(self, species_id: str) -> str:
        p = _first_existing(
            os.path.join(self.dir, "pan_genomes", species_id, "centroids.ffn"),
            os.path.join(self.dir, "pan_genomes", species_id, "centroids.ffn.gz"),
        )
        if p is None:
            sys.exit(f"\nError: pangenome for {species_id} not found")
        return p

    def rep_genome_fasta(self, species_id: str) -> str:
        p = _first_existing(
            os.path.join(self.dir, "rep_genomes", species_id, "genome.fna"),
            os.path.join(self.dir, "rep_genomes", species_id, "genome.fna.gz"),
        )
        if p is None:
            sys.exit(f"\nError: rep genome for {species_id} not found")
        return p


