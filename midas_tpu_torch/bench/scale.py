"""Scale runs: the profilers one to two orders above the tests' fixtures,
with every fixed cap audited against what the run measures.

    python -m midas_tpu_torch.bench.scale [--species 500] [--genome 100000]
        [--selected 20] [--extra-genes 0] [--reads 65536] [--device cuda]

The shapes are those of the reference database (5,952 species, a ~15 MB
phyeco.fa): a marker database of n_species x 15 markers of 900 bp; a
pangenome pack over the selected species, as the reference builds one
a sample; Mb-scale representative genomes for the pileup. Reads come
from the first n_sel species. A leg (species, genes, snps) builds its
profiler, runs the whole stream once to warm up (the kernels and the
native reader build on the first call), then times a second run, whose
result must equal the first's.

Measured per leg: end-to-end reads/s, the bytes of the pack and seed
index on the device (the port's own: pack words are int64), the
device's peak allocation; with audit, the ambiguous reads' tie widths
against num_cands and the gapped-read rate against the staging cap
(the capacities are the port's constants, AMB_CAP and GAP_CAP). Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from midas_tpu_torch.bench.common import (platform, same, synchronize,
                                          tensor_bytes)

N_READS = 65536
BATCH = 8192


def simulate_community(root, n_species, genome_len, n_sel, extra, n_reads):
    """A scale run's database and reads under root: n_species species
    (and n_species // 4 related copies) of genome_len bp, 900 bp genes,
    `extra` pangenome-only genes each; n_reads x 100 bp reads with
    substitutions and indels from the first n_sel species. Returns
    (community, FASTQ path, seconds of simulate_db)."""
    from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

    t0 = time.perf_counter()
    comm = simulate_db(os.path.join(root, "db"), n_species=n_species,
                       genome_len=genome_len, gene_len=900,
                       n_extra_genes=extra, related_pairs=n_species // 4,
                       divergence=0.03, seed=0)
    t_sim = time.perf_counter() - t0
    fq = os.path.join(root, "reads.fq.gz")
    abund = [1.0 / n_sel] * n_sel + [0.0] * (len(comm.species) - n_sel)
    simulate_reads(comm, fq, n_reads=n_reads, read_len=100,
                   error_rate=0.005, indel_rate=0.01, seed=7,
                   abundances=abund)
    return comm, fq, t_sim


def peak_device_mb(device):
    """torch.cuda.max_memory_allocated in MiB since the last
    reset_peak(device); None on the CPU, which has no device memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1)


def reset_peak(device) -> None:
    """Free the allocator's cached blocks and restart the peak count."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _index_bytes(aligner) -> int:
    return tensor_bytes(aligner.index_arrays) + tensor_bytes(
        aligner.pack_arrays)


def _timed_run(prof, fq, n_reads, batch, device):
    """(reads/s of prof.run over the stream, after a warm run over the
    whole stream; the timed run's result). Raises unless both runs give
    the same result."""
    warm = prof.run([fq], batch_size=batch)
    synchronize(device)
    t0 = time.perf_counter()
    res = prof.run([fq], batch_size=batch)
    synchronize(device)
    rate = round(n_reads / (time.perf_counter() - t0), 1)
    if not same(res, warm):
        raise RuntimeError(f"{type(prof).__name__}: the timed run's result "
                           "differs from the warm run's")
    return rate, res


def species_leg(db, fq, n_reads, batch, audit, device) -> dict:
    from midas_tpu_torch.profile.species import AMB_CAP, SpeciesProfiler

    reset_peak(device)
    prof = SpeciesProfiler(db, device=device)
    out = dict(marker_pack_mb=round(prof.pack.total_len / 1e6, 1),
               marker_hbm_mb=round(_index_bytes(prof.aligner) / 2**20, 1))
    out["marker_reads_per_sec"], _ = _timed_run(prof, fq, n_reads, batch,
                                                device)
    if audit:
        # how wide are the ambiguous reads' tie sets against num_cands?
        _, _, amb = prof._run_device([fq], None, None, batch)
        C = prof.aligner.seed_params.num_cands
        widths = np.array([len(t[1]) for t in amb], dtype=np.int64)
        out["amb_rate"] = round(len(amb) / prof.stats["total_reads"], 4)
        out["amb_tie_width_p99"] = (int(np.percentile(widths, 99))
                                    if len(widths) else 0)
        out["amb_tie_width_max"] = int(widths.max()) if len(widths) else 0
        out["amb_tie_at_cap_frac"] = round(
            float((widths >= C).mean()), 4) if len(widths) else 0.0
        out["num_cands"] = C
        out["amb_cap"] = AMB_CAP
    out["marker_peak_device_mb"] = peak_device_mb(device)
    return out


def genes_leg(db, species_ids, fq, n_reads, batch, device) -> dict:
    from midas_tpu_torch.profile.genes import GenesProfiler

    reset_peak(device)
    gprof = GenesProfiler(db, species_ids, device=device)
    out = dict(pangenome_genes=int(gprof.pack.num_seqs),
               pangenome_pack_mb=round(gprof.pack.total_len / 1e6, 1),
               pangenome_hbm_mb=round(_index_bytes(gprof.aligner) / 2**20,
                                      1))
    out["pangenome_reads_per_sec"], _ = _timed_run(gprof, fq, n_reads,
                                                   batch, device)
    out["pangenome_peak_device_mb"] = peak_device_mb(device)
    return out


def snps_leg(db, species_ids, fq, n_reads, batch, audit, device) -> dict:
    from midas_tpu_torch.profile.snps import GAP_CAP, SnpsProfiler

    reset_peak(device)
    sprof = SnpsProfiler(db, species_ids, device=device)
    G = sprof.pack.total_len
    out = dict(rep_pack_mb=round(G / 1e6, 1),
               # + the [4 x (G+1)] int32 counts
               rep_hbm_mb=round((_index_bytes(sprof.aligner)
                                 + 4 * 4 * (G + 1)) / 2**20, 1))
    out["snps_reads_per_sec"], res = _timed_run(sprof, fq, n_reads, batch,
                                                device)
    out["gap_rate"] = round(res["n_gapped"] / n_reads, 5)
    if audit:
        out["gap_cap_default"] = GAP_CAP
        out["gap_reads_at_default_cap_capacity"] = int(
            GAP_CAP / max(out["gap_rate"], 1e-9))
        # the staging rows this run used: the cap, or two batches if more
        out["gap_cap"] = sprof._staging(batch, None, False)[1]
    out["rep_peak_device_mb"] = peak_device_mb(device)
    return out


def run_scale(n_species: int = 500, genome_len: int = 100000,
              n_sel: int = 20, extra: int = 0, n_reads: int = N_READS,
              batch: int = BATCH, audit: bool = True,
              device="cuda") -> dict:
    """One scale configuration end to end; returns the metrics dict.
    audit=False skips the tie-width pass (the bench's trimmed scale
    line). Each leg's profiler is freed before the next is built."""
    from midas_tpu_torch.align.pipeline import resolve_device
    from midas_tpu_torch.db.layout import Database

    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="midas_scale_") as tmp:
        comm, fq, t_sim = simulate_community(tmp, n_species, genome_len,
                                             n_sel, extra, n_reads)
        db = Database(comm.db_dir)
        out = dict(n_species=n_species, genome_len=genome_len,
                   n_selected=n_sel, n_reads=n_reads,
                   sim_secs=round(t_sim, 1))
        out.update(species_leg(db, fq, n_reads, batch, audit, device))
        sel = comm.species_ids()[:n_sel]
        out.update(genes_leg(db, sel, fq, n_reads, batch, device))
        out.update(snps_leg(db, sel, fq, n_reads, batch, audit, device))
    reset_peak(device)
    out["platform"] = platform(device)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m midas_tpu_torch.bench.scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--species", type=int, default=500)
    ap.add_argument("--genome", type=int, default=100000)
    ap.add_argument("--selected", type=int, default=20)
    ap.add_argument("--extra-genes", type=int, default=0)
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run_scale(a.species, a.genome, a.selected,
                               a.extra_genes, a.reads, device=a.device)),
          flush=True)


if __name__ == "__main__":
    main()
