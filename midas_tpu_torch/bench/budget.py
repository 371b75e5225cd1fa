"""Where a marker (species) batch's time goes on the card, at the scale
bench's first configuration (500 species, 100 kb genomes, 20 selected):

    python -m midas_tpu_torch.bench.budget

Device rows, by CUDA events on each of 4 batches of 8,192 reads, each
stage timed alone on the outputs of the one before: seed and vote,
window gather, pair prep, the banded DP (K1), and the classifier with
the rest of species_update (the step less the stages before it).

Host rows, from the spans of one recorded SpeciesProfiler.run over the
same 4 batches (midas_tpu_torch/tracing.py): the producer thread's
native parse (io.parse) and pinned side-stream upload (io.upload), the
main thread's wait for a batch (io.wait), and the run end to end
(profile.sample). Every row is ms per batch. Runs on the card only.
Prints one JSON line.
"""

from __future__ import annotations

import json
import tempfile

import numpy as np
import torch

from midas_tpu_torch.bench.common import cuda_ms, platform

BATCH = 8192
N_BATCHES = 4
N_SPECIES, N_SELECTED = 500, 20


def species_tables(prof):
    """species_update's per-database inputs on the profiler's device: the
    species and %id cutoff of each marker, and the e-value gate's
    minimum score per read length (as SpeciesProfiler._run_device)."""
    from midas_tpu_torch.align.params import MARKER_SCORING

    dev, al = prof.device, prof.aligner
    min_score = MARKER_SCORING.evalue_min_score(
        np.maximum(np.arange(al.max_read_len + 1), 1),
        float(prof.pack.total_len))
    return (torch.from_numpy(prof.seq_species).to(dev),
            torch.from_numpy(prof.seq_cutoff).to(dev),
            torch.from_numpy(min_score).to(dev))


def device_step(prof, codes, qlens, n_reads, reps=5):
    """(mean device ms of species_update on one batch; the ms of its
    stages: seed, window_gather, pair_prep, banded_dp and
    classify_and_rest, the step less the others), by CUDA events."""
    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.align.seed import (find_candidates,
                                            gather_windows_packed)
    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    sp = al.seed_params
    n_species = len(prof.species_order)
    seq_species, seq_cutoff, min_score = species_tables(prof)
    state = ds.species_init(n_species, sp.num_cands, 2 * BATCH, prof.device)

    def step():
        state.amb_n.zero_()
        ds.species_update(state, al.index_arrays, al.pack_arrays,
                          seq_species, seq_cutoff, codes, qlens, n_reads, 0,
                          scoring=al.scoring, seed_params=sp,
                          max_len=al.max_read_len, aln_cov=prof.aln_cov,
                          n_species=n_species, min_score=min_score)

    step_ms, _ = cuda_ms(step, reps)
    D, L = sp.band_width, codes.shape[1]
    B, C = codes.shape[0], sp.num_cands
    r = {}
    r["seed"], c = cuda_ms(lambda: find_candidates(
        al.index_arrays, codes, qlens, sp, al.max_read_len), reps)
    r["window_gather"], (win, _) = cuda_ms(lambda: gather_windows_packed(
        al.pack_arrays["words"], al.pack_arrays["nmask"],
        al.pack_arrays["offsets"], c["diag"] - D // 2, L + D - 1,
        center=c["diag"] + qlens[:, None] // 2), reps)
    win = win.reshape(B * C, L + D - 1)
    r["pair_prep"], (q_pair, ql_pair, _) = cuda_ms(lambda: pl._prepare_pairs(
        codes, qlens, c["strand"], c["rc"]), reps)
    r["banded_dp"], _ = cuda_ms(lambda: pl.dispatch_banded_align(
        q_pair, ql_pair, win, al.scoring, D), reps)
    r["classify_and_rest"] = step_ms - sum(r.values())
    return step_ms, r


HOST_SPANS = (("parse_ms", "io.parse"), ("upload_ms", "io.upload"),
              ("wait_ms", "io.wait"), ("end_to_end_ms", "profile.sample"))


def host_rows(prof, fq, batch_size=BATCH):
    """Wall ms per batch of one recorded SpeciesProfiler.run (after a
    warm run), by span: HOST_SPANS' rows."""
    from midas_tpu_torch import tracing

    prof.run([fq], batch_size=batch_size)
    with tracing.recording() as rec:
        prof.run([fq], batch_size=batch_size)
    n = rec.counters["io.batches"]
    return {k: 1e3 * rec.seconds(name) / n for k, name in HOST_SPANS}


def run_budget() -> dict:
    """The budget at N_SPECIES species of 100 kb genomes, reads from the
    first N_SELECTED; returns the metrics dict."""
    from midas_tpu_torch.align.pipeline import resolve_device
    from midas_tpu_torch.bench.scale import simulate_community
    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.io.batch import load_read_batches
    from midas_tpu_torch.profile.species import SpeciesProfiler

    device = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="midas_budget_") as tmp:
        comm, fq, t_sim = simulate_community(tmp, N_SPECIES, 100000,
                                             N_SELECTED, 0, N_BATCHES * BATCH)
        prof = SpeciesProfiler(Database(comm.db_dir), device=device)
        L = prof.aligner.max_read_len
        steps = []
        for b in load_read_batches([fq], batch_size=BATCH, max_len=L):
            steps.append(device_step(
                prof, torch.from_numpy(b.codes).to(device),
                torch.from_numpy(b.lengths).to(device), b.n_reads, reps=3))
        host = host_rows(prof, fq)
    step_ms = float(np.mean([s for s, _ in steps]))
    stage = {k: float(np.mean([r[k] for _, r in steps])) for k in steps[0][1]}
    out = dict(n_species=N_SPECIES, n_selected=N_SELECTED, batch=BATCH,
               batches=len(steps), sim_secs=t_sim,
               seed_ms=stage["seed"], gather_ms=stage["window_gather"],
               pair_prep_ms=stage["pair_prep"], dp_ms=stage["banded_dp"],
               classify_ms=stage["classify_and_rest"], total_ms=step_ms,
               device_reads_per_sec=BATCH / step_ms * 1e3, **host)
    out["platform"] = platform(device)
    return out


if __name__ == "__main__":
    print(json.dumps(run_budget()), flush=True)
