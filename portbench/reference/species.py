"""The plain reference of a species sample: the expected
species_profile.txt of `run_midas species` over the sample.

Seeding and the banded DP follow the port's semantics (copies: seed.py,
pipeline.py; the DP is the plain version, banded.py) and run in chunks
far larger than the port's batches. The layers behind them are written
here anew, in NumPy, from MIDAS's rules (run/species.py:64-119) and not
from the port's code: each read's hits are filtered and its best hits
kept read by read (classify_reads), ambiguous reads are assigned one by
one in stream order (assign_reads), and the profile is formatted row by
row (abundance_text).
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

from portbench.reference.common import chunks, device_arrays, drop_tail
from portbench.reference.layout import Database
from portbench.reference.params import MARKER_SCORING
from portbench.reference.pipeline import _align_batch_stages
from portbench.reference.refpack import pack_from_fasta
from portbench.reference.seed import SeedParams

SEED_PARAMS = SeedParams(num_cands=8, max_hits=32)   # the port's species seeding
HIT_FIELDS = ("valid", "score", "seq_idx", "matches", "mismatches",
              "gap_cols")


def expected(db_dir: str, reads: Dict, settings: Dict, device,
             chunk: int = 65536, drop_reads: int = 0) -> Dict[str, bytes]:
    """{relative path: expected bytes} of a species sample."""
    reads = drop_tail(reads, drop_reads)
    db = Database(db_dir)
    marker_info = db.marker_info()
    cutoffs = db.marker_cutoffs(override=settings.get("mapid"))
    pack = pack_from_fasta(db.marker_fasta())
    species_order = list(db.species_info())
    sp_index = {s: i for i, s in enumerate(species_order)}
    seq_species = np.array([sp_index[marker_info[g]["species_id"]]
                            for g in pack.names], dtype=np.int64)
    seq_cutoff = np.array([cutoffs[marker_info[g]["marker_id"]]
                           for g in pack.names], dtype=np.float64)
    gene_length = np.zeros(len(species_order), dtype=np.float64)
    for r in marker_info.values():
        gene_length[sp_index[r["species_id"]]] += int(r["gene_length"])

    L = reads["L"]
    index, pack_arrays = device_arrays(pack, SEED_PARAMS, device)
    min_score = MARKER_SCORING.evalue_min_score(
        np.maximum(np.arange(L + 1), 1), float(pack.total_len))
    unique_count = np.zeros(len(species_order), dtype=np.int64)
    unique_bp = np.zeros(len(species_order), dtype=np.int64)
    ambiguous: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for lo, n, (codes, lengths) in chunks(reads, chunk, device,
                                          ("codes", "lengths")):
        out = _align_batch_stages(index, pack_arrays, codes, lengths,
                                  MARKER_SCORING, SEED_PARAMS, L)
        hits = {k: out[k][:n].cpu().numpy() for k in HIT_FIELDS}
        ambiguous += classify_reads(
            hits, reads["lengths"][lo: lo + n], lo, seq_species, seq_cutoff,
            min_score, float(settings["aln_cov"]), unique_count, unique_bp)
        del out
    count, bp = assign_reads(unique_count, unique_bp, ambiguous,
                             int(settings.get("seed", 42)))
    return {"species/species_profile.txt": abundance_text(
        species_order, count, bp, gene_length)}


def classify_reads(hits: Dict[str, np.ndarray], qlens: np.ndarray,
                   first: int, seq_species: np.ndarray,
                   seq_cutoff: np.ndarray, min_score: np.ndarray,
                   aln_cov: float, unique_count: np.ndarray,
                   unique_bp: np.ndarray) -> List[Tuple]:
    """MIDAS's read classifier over one chunk's candidate hits ([n, C]
    planes): a hit counts if it is a real alignment with a positive
    score, at least the e-value gate's score for the read's length, its
    marker's identity cutoff (100 * matches / alignment columns) and
    aln_cov of the read covered by its columns. A read whose best
    counting score is held by one hit adds 1 read and the hit's columns
    to that species (unique_count, unique_bp, in place); a read whose
    best score is held by several hits is ambiguous. Returns the
    ambiguous reads as (stream rank, their best hits' marker ids,
    species, alignment columns)."""
    cols = hits["matches"] + hits["mismatches"] + hits["gap_cols"]
    ql = qlens.astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pid = 100.0 * hits["matches"] / np.maximum(cols, 1)
        cov = cols / np.maximum(ql, 1)[:, None]
    seq = hits["seq_idx"].astype(np.int64)
    counts = (hits["valid"] & (hits["score"] > 0)
              & (hits["score"] >= min_score[np.maximum(ql, 1)][:, None])
              & (pid >= seq_cutoff[seq]) & (cov >= aln_cov))
    ambiguous = []
    for r in np.flatnonzero(counts.any(axis=1)):
        c = np.flatnonzero(counts[r])
        s = hits["score"][r, c]
        top = c[s == s.max()]
        if len(top) == 1:
            sp = seq_species[seq[r, top[0]]]
            unique_count[sp] += 1
            unique_bp[sp] += int(cols[r, top[0]])
        else:
            ambiguous.append((first + int(r), seq[r, top],
                              seq_species[seq[r, top]],
                              cols[r, top].astype(np.int64)))
    return ambiguous


def assign_reads(unique_count: np.ndarray, unique_bp: np.ndarray,
                 ambiguous: List[Tuple], seed: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """MIDAS's assignment of ambiguous reads, one read at a time in
    stream order: its best hits in marker-id order (the order hs-blastn
    reports equal hits), each weighted by its species' unique read
    count; a read whose weights are all 0 takes a hit uniformly with
    Python's random, any other draws one with numpy's RandomState.choice
    by its weights and goes to the drawn species' first hit. Returns the
    reads and aligned columns of each species."""
    rng = np.random.RandomState(seed)
    pyrng = random.Random(seed)
    count = unique_count.astype(np.int64).copy()
    bp = unique_bp.astype(np.float64).copy()
    for _rank, seq, sp, cols in sorted(ambiguous, key=lambda t: t[0]):
        order = np.argsort(seq, kind="stable")
        sp, cols = sp[order], cols[order]
        w = unique_count[sp].astype(np.float64)
        if w.sum() > 0:
            drawn = sp[rng.choice(len(sp), p=w / w.sum())]
            j = int(np.flatnonzero(sp == drawn)[0])
        else:
            j = pyrng.randrange(len(sp))
        count[sp[j]] += 1
        bp[sp[j]] += float(cols[j])
    return count, bp


def abundance_text(species_order: List[str], count: np.ndarray,
                   bp: np.ndarray, gene_length: np.ndarray) -> bytes:
    """species_profile.txt: a header, then one row a species by reads,
    most first (ties in the database's order): id, reads, coverage (its
    aligned columns over its marker genes' length) and the coverage's
    share of all species' coverage, each as Python prints the number."""
    cov = [float(bp[i]) / float(gene_length[i]) if gene_length[i] > 0
           else 0.0 for i in range(len(species_order))]
    total = sum(cov)   # the builtin sum, as MIDAS sums the coverages
    rows = sorted(range(len(species_order)), key=lambda i: -int(count[i]))
    lines = ["species_id\tcount_reads\tcoverage\trelative_abundance"]
    for i in rows:
        rel = cov[i] / total if total > 0 else 0
        lines.append(f"{species_order[i]}\t{int(count[i])}\t{cov[i]!r}"
                     f"\t{rel!r}")
    return ("\n".join(lines) + "\n").encode()
