"""KEGG compound query — scripts/query_by_compound.py semantics:
compound -> EC enzymes -> genes (via the DB's per-species
centroid_functions.txt.gz ontology table) -> per-sample gene abundance
report (:27900-28028).

The reference embeds a ~27.6k-row KEGG cpd_to_enzyme table inside the
script; we instead read the mapping from a two-column TSV
(<db>/kegg/cpd_to_enzyme.txt[.gz] by default, or an explicit path), so
databases ship their own ontology data instead of code carrying it.
"""

from __future__ import annotations

import csv
import gzip
import os
import sys
from typing import Dict, List

from midas_tpu_torch.io.seqio import iopen, parse_file


def load_cpd_to_enzyme(path: str) -> Dict[str, List[str]]:
    """TSV (no header): compound_id <tab> enzyme_id."""
    mapping: Dict[str, List[str]] = {}
    with iopen(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                mapping.setdefault(parts[0], []).append(parts[1])
    return mapping


def packaged_cpd_to_enzyme() -> str:
    """The 27,814-row KEGG compound->enzyme table shipped with the
    package (midas_tpu_torch/data/cpd_to_enzyme.txt.gz, extracted from the
    table the reference embeds in scripts/query_by_compound.py:9-27823)."""
    p = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "cpd_to_enzyme.txt.gz")
    return p if os.path.isfile(p) else None


def fetch_enzymes(compound_id: str, mapping: Dict[str, List[str]]) -> List[str]:
    enzymes = mapping.get(compound_id, [])
    if not enzymes:
        sys.exit(f"Error: no enzymes matched compound id '{compound_id}'")
    return enzymes


def fetch_genes(enzymes: List[str], species_id: str, db: str) -> Dict[str, str]:
    """gene_id -> enzyme_id for genes annotated with a wanted EC number."""
    genes: Dict[str, str] = {}
    path = os.path.join(db, "pan_genomes", species_id, "centroid_functions.txt.gz")
    if not os.path.isfile(path):
        path = path[:-3]
        if not os.path.isfile(path):
            return genes
    for r in parse_file(path):
        if r.get("ontology") == "ec" and r.get("function_id") in enzymes:
            genes[r["gene_id"]] = r["function_id"]
    return genes


def query_by_compound(
    indirs: List[str],
    db: str,
    compound_id: str,
    out: str,
    cpd_to_enzyme_path: str = None,
) -> int:
    if cpd_to_enzyme_path is None:
        for cand in ["kegg/cpd_to_enzyme.txt", "kegg/cpd_to_enzyme.txt.gz"]:
            p = os.path.join(db, cand)
            if os.path.isfile(p):
                cpd_to_enzyme_path = p
                break
    if cpd_to_enzyme_path is None:
        # packaged copy of the KEGG compound->EC table the reference
        # embeds as 27.6k code lines (query_by_compound.py:9-27823)
        cpd_to_enzyme_path = packaged_cpd_to_enzyme()
    if cpd_to_enzyme_path is None:
        sys.exit("Error: no cpd_to_enzyme table found; pass --cpd_to_enzyme "
                 "or add kegg/cpd_to_enzyme.txt to the database")
    mapping = load_cpd_to_enzyme(cpd_to_enzyme_path)
    enzymes = fetch_enzymes(compound_id, mapping)

    samples = {}
    for d in indirs:
        sid = os.path.basename(d.rstrip("/"))
        splist = os.path.join(d, "genes/species.txt")
        profile = os.path.join(d, "species/species_profile.txt")
        if not os.path.exists(profile):
            sys.exit(f"Error: could not locate species profile for sample '{sid}'\n")
        species_ids = [line.rstrip() for line in open(splist)] if os.path.isfile(splist) else []
        prof = {r["species_id"]: r for r in parse_file(profile)}
        samples[sid] = dict(dir=d, species_ids=species_ids, profile=prof)

    species_genes: Dict[str, Dict[str, str]] = {}
    for s in samples.values():
        for species_id in s["species_ids"]:
            if species_id not in species_genes:
                species_genes[species_id] = fetch_genes(enzymes, species_id, db)

    n_rows = 0
    with open(out, "w") as f:
        f.write("\t".join(["sample_id", "species_id", "species_abund", "gene_id",
                           "enzyme_id", "count_reads", "read_depth",
                           "copy_number"]) + "\n")
        for sid, s in samples.items():
            for species_id in s["species_ids"]:
                genes = species_genes[species_id]
                abund = s["profile"][species_id]["relative_abundance"]
                path = os.path.join(s["dir"], "genes/output", f"{species_id}.genes.gz")
                for r in parse_file(path):
                    if r["gene_id"] in genes:
                        f.write("\t".join(str(x) for x in [
                            sid, species_id, abund, r["gene_id"],
                            genes[r["gene_id"]], r["count_reads"],
                            r["coverage"], r["copy_number"]]) + "\n")
                        n_rows += 1
    return n_rows
