"""The plain reference of a snps sample: the expected per-species
.snps.gz rows, snps/summary.txt and end-of-stream state of
`run_midas snps` over the sample.

The two-pass alignment, the keep filters, the pileup of gapless reads
and the spill of gapped ones are the port's semantics (copies: seed.py,
banded.py, steps.py); the gapped reads' traceback is the copied host
oracle (oracle.py); the finalize and writers below copy the port's
profile/snps.py. Reads are aligned in chunks far larger than the port's
batches; gapped rows keep stream order.
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import steps
from portbench.reference.common import chunks, device_arrays, drop_tail
from portbench.reference.genes import SEED_PARAMS, _fasta_count
from portbench.reference.layout import Database
from portbench.reference.oracle import align_oracle_batch
from portbench.reference.params import GLOBAL_SCORING, LOCAL_SCORING
from portbench.reference.refpack import pack_from_fasta
from portbench.reference.seqio import CODE_TO_BASE


def expected(db_dir: str, reads: Dict, settings: Dict, species_ids: List[str],
             device, chunk: int = 65536, drop_reads: int = 0
             ) -> Tuple[Dict[str, bytes], Dict[str, np.ndarray]]:
    """({relative path: expected decompressed bytes}, the expected state
    of the end-of-stream checkpoint) of a snps sample."""
    paired = bool(settings.get("paired"))
    reads = drop_tail(reads, drop_reads * (2 if paired else 1))
    db = Database(db_dir)
    pack = pack_from_fasta([db.rep_genome_fasta(s) for s in species_ids])
    contig_species = np.zeros(pack.num_seqs, dtype=np.int32)
    cursor = 0
    for si, s in enumerate(species_ids):
        n = _fasta_count(db.rep_genome_fasta(s))
        contig_species[cursor: cursor + n] = si
        cursor += n
    scoring = (GLOBAL_SCORING if settings["mode"] == "global"
               else LOCAL_SCORING)
    L = reads["L"]
    index, pack_arrays = device_arrays(pack, SEED_PARAMS, device)
    state = steps.snps_init(pack.total_len, len(species_ids), chunk, L,
                            device)
    cs = torch.from_numpy(contig_species.astype(np.int64)).to(device)
    smin = torch.from_numpy(steps.score_min_table(scoring, L)).to(device)
    gaps = []
    for _lo, n, (codes, quals, lengths, mean_qual) in chunks(
            reads, chunk, device):
        steps.snps_update(
            state, index, pack_arrays, cs, codes, quals, lengths, mean_qual,
            n, scoring=scoring, seed_params=SEED_PARAMS, max_len=L,
            mapid=float(settings["mapid"]), readq=float(settings["readq"]),
            min_mapq=int(settings["mapq"]), baseq=int(settings["baseq"]),
            aln_cov=float(settings["aln_cov"]), smin_table=smin,
            paired=paired)
        spill, _m = steps.sliced_spill_host(
            {k: getattr(state, k) for k in steps.GAP_FIELDS},
            state.gap_n, chunk)
        gaps.append(spill)
        state.gap_n.zero_()
    host = steps.snps_state_host(state)
    for k in steps.GAP_FIELDS:
        host[k] = np.concatenate([g[k] for g in gaps])
    host["gap_n"] = np.int64(host["gap_codes"].shape[0])
    S = len(species_ids)
    for k in ("aligned_reads", "mapped_reads"):
        host[k] = host[k][:S]   # without the dump slot (see compare.py)
    counts, stats = _finalize(host, pack, len(species_ids), scoring,
                              int(settings["baseq"]))
    files = _outputs(counts, stats, pack, species_ids, contig_species)
    return files, host


def _finalize(host, pack, S, scoring, baseq):
    """The port's SnpsProfiler._finalize: the oracle's traceback of each
    gapped read added to the gapless counts."""
    G = pack.total_len
    gap_codes, gap_quals = host["gap_codes"], host["gap_quals"]
    gap_meta = host["gap_meta"]
    queries, windows, los, qpens = [], [], [], []
    for r in range(gap_codes.shape[0]):
        ci, tstart, tend, qlen = (int(x) for x in gap_meta[r])
        seq_lo = int(pack.offsets[ci])
        lo = max(seq_lo + tstart - 8, 0)
        hi = min(seq_lo + tend + 8, G)
        queries.append(gap_codes[r, :qlen])
        windows.append(pack.codes[lo:hi])
        los.append(lo)
        if scoring.qual_scaled:
            q = np.minimum(gap_quals[r, :qlen].astype(np.int64), 40)
            mx, mn = -scoring.mismatch, scoring.mm_min
            qpens.append(mn + ((mx - mn) * q) // 40)
    counts = np.asarray(host["counts"]).reshape(4, G + 1)[:, :G].copy()
    for r, a in enumerate(align_oracle_batch(
            queries, windows, scoring,
            qpens=qpens if scoring.qual_scaled else None)):
        m = a.qpos_to_tpos(len(queries[r]))
        qpos = np.flatnonzero(m >= 0)
        tpos = los[r] + m[qpos]
        base = gap_codes[r, qpos]
        mask = (gap_quals[r, qpos] >= baseq) & (base < 4)
        np.add.at(counts, (base[mask], tpos[mask]), 1)
    stats = dict(aligned_reads=np.asarray(host["aligned_reads"][:S]).astype(np.int64),
                 mapped_reads=np.asarray(host["mapped_reads"][:S]).astype(np.int64))
    return counts, stats


def _contigs(pack, contig_species, si):
    return sorted(np.flatnonzero(contig_species == si).tolist(),
                  key=lambda ci: pack.names[ci])


def _outputs(counts, stats, pack, species_ids, contig_species):
    """The port's SnpsProfiler.write_results, as bytes."""
    depth_all = counts.sum(axis=0)
    out = {}
    rows = []
    for si, sid in enumerate(species_ids):
        f = io.StringIO()
        f.write("\t".join(["ref_id", "ref_pos", "ref_allele", "depth",
                           "count_a", "count_c", "count_g", "count_t"]) + "\n")
        genome_length = covered = total_depth = 0
        for ci in _contigs(pack, contig_species, si):
            lo, hi = int(pack.offsets[ci]), int(pack.offsets[ci + 1])
            if hi > lo:
                f.write(_site_rows(pack.names[ci], pack.codes[lo:hi],
                                   depth_all[lo:hi], counts[:, lo:hi]))
            d = depth_all[lo:hi]
            genome_length += len(d)
            covered += int((d > 0).sum())
            total_depth += int(d.sum())
        out[f"snps/output/{sid}.snps.gz"] = f.getvalue().encode()
        rows.append([sid, genome_length, covered,
                     covered / float(genome_length) if genome_length else 0,
                     total_depth / float(covered) if covered else 0,
                     int(stats["aligned_reads"][si]),
                     int(stats["mapped_reads"][si])])
    s = io.StringIO()
    s.write("\t".join(["species_id", "genome_length", "covered_bases",
                       "fraction_covered", "mean_coverage", "aligned_reads",
                       "mapped_reads"]) + "\n")
    for r in rows:
        s.write("\t".join(str(x) for x in r) + "\n")
    out["snps/summary.txt"] = s.getvalue().encode()
    return out


def _site_rows(name, codes, depth, counts) -> str:
    alleles = CODE_TO_BASE[codes.astype(np.int64)].tobytes().decode("ascii")
    a, c, g, t = (counts[j].tolist() for j in range(4))
    prefix = name + "\t"
    return "".join(
        f"{prefix}{p}\t{r}\t{dd}\t{aa}\t{cc}\t{gg}\t{tt}\n"
        for p, r, dd, aa, cc, gg, tt in zip(
            range(1, len(alleles) + 1), alleles, depth.tolist(), a, c, g, t))
