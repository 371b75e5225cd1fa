"""The plain reference of a genes sample: the expected per-species
.genes.gz rows and genes/summary.txt of `run_midas genes` over the
sample.

The two-pass alignment (seed and vote, the score-only DP, the best hit
or the mate-pair pick with MAPQ, the full-statistics DP of the chosen
candidate, the keep filters) and the per-gene tallies are the port's
semantics (copies: seed.py, banded.py, steps.py); the copy numbers and
writers below copy the port's profile/genes.py. Reads are aligned in
chunks far larger than the port's batches (mates stay in adjacent rows).
"""

from __future__ import annotations

import io
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import steps
from portbench.reference.common import chunks, device_arrays, drop_tail
from portbench.reference.layout import Database
from portbench.reference.params import GLOBAL_SCORING, LOCAL_SCORING
from portbench.reference.refpack import pack_from_fasta
from portbench.reference.seed import SeedParams
from portbench.reference.seqio import iopen, parse_file, read_fastx

SEED_PARAMS = SeedParams(num_cands=4)   # the port's genes and snps seeding


def _fasta_count(path: str) -> int:
    with iopen(path) as fp:
        return sum(1 for _ in read_fastx(fp))


def expected(db_dir: str, reads: Dict, settings: Dict, species_ids: List[str],
             device, chunk: int = 65536, drop_reads: int = 0
             ) -> Dict[str, bytes]:
    """{relative path: expected decompressed bytes} of a genes sample."""
    paired = bool(settings.get("paired"))
    reads = drop_tail(reads, drop_reads * (2 if paired else 1))
    db = Database(db_dir)
    pack = pack_from_fasta([db.pangenome_fasta(s) for s in species_ids])
    G = pack.num_seqs
    gene_species = np.zeros(G, dtype=np.int32)
    cursor = 0
    for si, s in enumerate(species_ids):
        n = _fasta_count(db.pangenome_fasta(s))
        gene_species[cursor: cursor + n] = si
        cursor += n
    name_to_idx = {n: i for i, n in enumerate(pack.names)}
    gene_marker = np.full(G, -1, dtype=np.int32)
    marker_ids = sorted(db.marker_cutoffs())
    marker_index = {m: i for i, m in enumerate(marker_ids)}
    for r in parse_file(f"{db.dir}/marker_genes/phyeco.map"):
        gi = name_to_idx.get(r["gene_id"])
        if gi is not None:
            gene_marker[gi] = marker_index[r["marker_id"]]

    scoring = LOCAL_SCORING if settings["mode"] == "local" else GLOBAL_SCORING
    L = reads["L"]
    index, pack_arrays = device_arrays(pack, SEED_PARAMS, device)
    state = steps.genes_init(G, device)
    smin = torch.from_numpy(steps.score_min_table(scoring, L)).to(device)
    for _lo, n, (codes, quals, lengths, mean_qual) in chunks(
            reads, chunk, device):
        steps.genes_update(
            state, index, pack_arrays, G, codes, quals, lengths, mean_qual,
            n, scoring=scoring, seed_params=SEED_PARAMS, max_len=L,
            mapid=float(settings["mapid"]), readq=float(settings["readq"]),
            min_mapq=int(settings["mapq"]),
            aln_cov=float(settings["aln_cov"]), smin_table=smin,
            paired=paired)
    host = steps.genes_state_host(state)
    return _outputs(host, pack, species_ids, gene_species, gene_marker,
                    len(marker_ids))


def _outputs(host, pack, species_ids, gene_species, gene_marker, n_markers):
    """The port's GenesProfiler._finalize and write_results, as bytes."""
    G = pack.num_seqs
    aligned_reads = np.asarray(host["aligned_reads"][:G]).astype(np.int64)
    mapped_reads = np.asarray(host["mapped_reads"][:G]).astype(np.int64)
    gene_len = pack.lengths.astype(np.float64)
    depth = (np.asarray(host["bp"][:G]).astype(np.float64)
             / np.maximum(gene_len, 1.0))
    S = len(species_ids)
    marker_cov = np.zeros(S, dtype=np.float64)
    for si in range(S):
        vals = []
        for mi in range(n_markers):
            sel = (gene_species == si) & (gene_marker == mi)
            if sel.any():
                vals.append(depth[sel].sum())
        marker_cov[si] = float(np.median(vals)) if vals else 0.0
    copies = np.zeros(G, dtype=np.float64)
    for si in range(S):
        if marker_cov[si] > 0:
            sel = gene_species == si
            copies[sel] = depth[sel] / marker_cov[si]

    files = {si: io.StringIO() for si in range(S)}
    for f in files.values():
        f.write("\t".join(["gene_id", "count_reads", "coverage",
                           "copy_number"]) + "\n")
    for gi in np.argsort(np.asarray(pack.names)):
        files[gene_species[gi]].write("\t".join(str(x) for x in [
            pack.names[gi], mapped_reads[gi], depth[gi], copies[gi]]) + "\n")
    out = {f"genes/output/{sid}.genes.gz": files[si].getvalue().encode()
           for si, sid in enumerate(species_ids)}
    s = io.StringIO()
    s.write("\t".join(["species_id", "pangenome_size", "covered_genes",
                       "fraction_covered", "mean_coverage", "marker_coverage",
                       "aligned_reads", "mapped_reads"]) + "\n")
    for si, sid in enumerate(species_ids):
        sel = gene_species == si
        d = depth[sel]
        nz = d[d > 0]
        size = int(sel.sum())
        covered = len(nz)
        s.write("\t".join(str(x) for x in [
            sid, size, covered, covered / float(size) if size else 0,
            float(nz.mean()) if covered else 0, marker_cov[si],
            int(aligned_reads[sel].sum()),
            int(mapped_reads[sel].sum())]) + "\n")
    out["genes/summary.txt"] = s.getvalue().encode()
    return out
