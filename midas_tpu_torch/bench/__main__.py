"""The port's headline bench: the profiling pipelines end to end.

    python -m midas_tpu_torch.bench [--device cuda]

Times what a user runs, SpeciesProfiler.run / GenesProfiler.run /
SnpsProfiler.run (native FASTQ parse, the pinned upload, seed, DP,
classify or best hit, pileup, the end-of-stream readback and host
tail), each the best of 3 after a warm run, on a toy community of 12
species x 40 kb and 65,536 reads; genes and snps over one species, the
condition of the reference's published single-thread rates (MIDAS on a
CPU: species ~5,000 reads/s, docs/species.md:68; pangenome and SNP
mapping ~16,000 reads/s, docs/cnvs.md:103 and docs/snvs.md:110), which
are the vs_baseline divisors. Then the device-only rates: species_update
and snps_update over 4 batches uploaded beforehand, 4 times, each timed
region ending on a synchronize, and the pileup rate in base
observations a second. Last, a trimmed scale line (bench/scale.py: 500
species x 100 kb, 20 selected, 32,768 reads, no audit).

Every rep's result must equal the first's. A leg that fails fails the
bench: nothing falls back to the CPU or to the plain DP. Prints one JSON
line: metric, value, unit, vs_baseline and detail, with the card's name
and power limit and each leg's kernel launches (cuda_sw.LAUNCHES).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import Counter

import numpy as np
import torch

REF_SPECIES_READS_PER_SEC = 5000.0   # docs/species.md:68
REF_GENES_READS_PER_SEC = 16000.0    # docs/cnvs.md:103
REF_SNPS_READS_PER_SEC = 16000.0     # docs/snvs.md:110

N_READS = 65536
BATCH = 8192
TOY_DB = dict(n_species=12, genome_len=40000, gene_len=900, n_extra_genes=10,
              related_pairs=3, divergence=0.03, seed=0)
DEVICE_BATCHES, DEVICE_REPS = 4, 4
SCALE = dict(n_species=500, genome_len=100000, n_sel=20, n_reads=32768)
# the state rows of the device-only loops, as the JAX bench sizes them
AMB_ROWS, GAP_ROWS = 65536, 1024


def upload(batches, device):
    """The batches' codes, quals, lengths and mean qualities as tensors
    on device, with their read and base counts."""
    out = []
    for b in batches:
        out.append({k: torch.from_numpy(np.ascontiguousarray(getattr(b, k)))
                    .to(device)
                    for k in ("codes", "quals", "lengths", "mean_qual")})
        out[-1].update(n_reads=b.n_reads,
                       sites=int(b.lengths[: b.n_reads].sum()))
    return out


def species_device_loop(prof, dev_batches, reps=DEVICE_REPS):
    """species_update over the uploaded batches `reps` times after one
    warm step, state updated in place. Returns (reads/s of the timed
    loop, the final SpeciesState)."""
    from midas_tpu_torch.bench.budget import species_tables
    from midas_tpu_torch.bench.common import synchronize
    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    n_species = len(prof.species_order)
    seq_species, seq_cutoff, min_score = species_tables(prof)
    state = ds.species_init(n_species, al.seed_params.num_cands, AMB_ROWS,
                            prof.device)

    def step(b):
        ds.species_update(state, al.index_arrays, al.pack_arrays,
                          seq_species, seq_cutoff, b["codes"], b["lengths"],
                          b["n_reads"], 0, scoring=al.scoring,
                          seed_params=al.seed_params,
                          max_len=al.max_read_len, aln_cov=prof.aln_cov,
                          n_species=n_species, min_score=min_score)

    step(dev_batches[0])
    synchronize(prof.device)
    t0, n = time.perf_counter(), 0
    for _ in range(reps):
        for b in dev_batches:
            step(b)
            n += b["n_reads"]
    synchronize(prof.device)
    return n / (time.perf_counter() - t0), state


def snps_device_loop(sprof, dev_batches, reps=DEVICE_REPS):
    """snps_update over the uploaded batches `reps` times after one warm
    step. Returns (pileup sites/s: every base of every read is one
    potential site update; reads/s; the final SnpsState)."""
    from midas_tpu_torch.bench.common import synchronize
    from midas_tpu_torch.profile import device_steps as ds

    al, dev = sprof.aligner, sprof.device
    contig_species = torch.from_numpy(
        sprof.contig_species.astype(np.int64)).to(dev)
    smin = torch.from_numpy(
        ds.score_min_table(al.scoring, al.max_read_len)).to(dev)
    state = ds.snps_init(sprof.pack.total_len, len(sprof.species_ids),
                         GAP_ROWS, al.max_read_len, dev)

    def step(b):
        ds.snps_update(state, al.index_arrays, al.pack_arrays, contig_species,
                       b["codes"], b["quals"], b["lengths"], b["mean_qual"],
                       b["n_reads"], scoring=al.scoring,
                       seed_params=al.seed_params, max_len=al.max_read_len,
                       mapid=sprof.mapid, readq=sprof.readq,
                       min_mapq=sprof.mapq, baseq=sprof.baseq,
                       aln_cov=sprof.aln_cov, smin_table=smin)

    step(dev_batches[0])
    synchronize(dev)
    t0 = time.perf_counter()
    sites = n = 0
    for _ in range(reps):
        for b in dev_batches:
            step(b)
            sites += b["sites"]
            n += b["n_reads"]
    synchronize(dev)
    dt = time.perf_counter() - t0
    return sites / dt, n / dt, state


def run_bench(device, n_reads=N_READS, batch=BATCH, scale=SCALE) -> dict:
    """Every leg on device; returns the bench's record (the JSON line)."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.bench.common import best_of, platform
    from midas_tpu_torch.bench.scale import run_scale
    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.io.batch import load_read_batches
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.profile.snps import SnpsProfiler
    from midas_tpu_torch.profile.species import SpeciesProfiler
    from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

    launches, r = {}, {}

    def leg(name, fn):
        before = Counter(cuda_sw.LAUNCHES)
        out = fn()
        launches[name] = dict(Counter(cuda_sw.LAUNCHES) - before)
        return out

    def end_to_end(prof):
        prof.run([fq], max_reads=batch, batch_size=batch)    # warm
        return n_reads / best_of(lambda: prof.run([fq], batch_size=batch),
                                 device)[0]

    with tempfile.TemporaryDirectory(prefix="midas_bench_") as tmp:
        comm = simulate_db(os.path.join(tmp, "db"), **TOY_DB)
        db = Database(comm.db_dir)
        fq = os.path.join(tmp, "reads.fq.gz")
        simulate_reads(comm, fq, n_reads=n_reads, read_len=100,
                       error_rate=0.005, seed=7)
        # genes and snps over a single species, the condition of the
        # reference's published rates (docs/cnvs.md:103, docs/snvs.md:110)
        one_species = comm.species_ids()[:1]
        prof = SpeciesProfiler(db, device=device)
        r["marker_reads_per_sec"] = leg("species", lambda: end_to_end(prof))
        gprof = GenesProfiler(db, one_species, device=device)
        r["pangenome_reads_per_sec"] = leg("genes", lambda: end_to_end(gprof))
        del gprof
        sprof = SnpsProfiler(db, one_species, device=device)
        r["snps_reads_per_sec"] = leg("snps", lambda: end_to_end(sprof))

        dev_batches = upload(load_read_batches(
            [fq], batch_size=batch, max_len=sprof.aligner.max_read_len,
            max_reads=DEVICE_BATCHES * batch), device)
        r["marker_device_reads_per_sec"], _ = leg(
            "species_device", lambda: species_device_loop(prof, dev_batches))
        del prof
        (r["pileup_sites_per_sec"], r["snps_device_reads_per_sec"],
         _) = leg("snps_device", lambda: snps_device_loop(sprof, dev_batches))
        del sprof, dev_batches
    if device.type == "cuda":
        torch.cuda.empty_cache()

    s = leg("scale", lambda: run_scale(batch=batch, audit=False,
                                       device=device, **scale))
    value = r["marker_reads_per_sec"]
    return {
        "metric": "marker-gene aligned reads/sec/chip (end-to-end)",
        "value": round(value, 1),
        "unit": "reads/s",
        "vs_baseline": round(value / REF_SPECIES_READS_PER_SEC, 2),
        "detail": {
            "pangenome_reads_per_sec": round(r["pangenome_reads_per_sec"], 1),
            "pangenome_vs_baseline": round(
                r["pangenome_reads_per_sec"] / REF_GENES_READS_PER_SEC, 2),
            "snps_reads_per_sec": round(r["snps_reads_per_sec"], 1),
            "snps_vs_baseline": round(
                r["snps_reads_per_sec"] / REF_SNPS_READS_PER_SEC, 2),
            "pileup_sites_per_sec": round(r["pileup_sites_per_sec"], 1),
            "marker_device_reads_per_sec": round(
                r["marker_device_reads_per_sec"], 1),
            "snps_device_reads_per_sec": round(
                r["snps_device_reads_per_sec"], 1),
            "n_reads": n_reads,
            **{f"scale_{k}": s[k] for k in (
                "marker_reads_per_sec", "pangenome_reads_per_sec",
                "snps_reads_per_sec", "rep_pack_mb", "n_reads")},
            "scale_snps_vs_baseline": round(
                s["snps_reads_per_sec"] / REF_SNPS_READS_PER_SEC, 2),
            "platform": platform(device),
            "launches": launches,
        },
    }


def main(argv=None) -> dict:
    """Run the bench, print its JSON line and return the record."""
    from midas_tpu_torch.align.pipeline import resolve_device

    ap = argparse.ArgumentParser(prog="python -m midas_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--scale-species", type=int,
                    default=SCALE["n_species"])
    ap.add_argument("--scale-genome", type=int, default=SCALE["genome_len"])
    ap.add_argument("--scale-selected", type=int, default=SCALE["n_sel"])
    ap.add_argument("--scale-reads", type=int, default=SCALE["n_reads"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    record = run_bench(resolve_device(a.device), a.reads, a.batch, dict(
        n_species=a.scale_species, genome_len=a.scale_genome,
        n_sel=a.scale_selected, n_reads=a.scale_reads))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
