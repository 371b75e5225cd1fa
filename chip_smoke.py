#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (midas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card; exits non-zero without CUDA. Also prints the
             `nvidia-smi --query-gpu=name,power.limit` line as it is.
2. build   — compiles the kernels from this checkout's sources (nvcc,
             sm_90a) and the native FASTQ reader, in parallel.
3. data    — simulates a marker database the size of the production
             phyeco.fa (1,100 species + 275 related, 15 x 900 bp markers
             each, ~18.6 MB) and 65,536 x 100 bp reads from the first 20
             species, and builds the profiler (seed index) on the card.
4. kernels — every variant of the banded-DP kernel against its plain
             PyTorch version on the card, equal field by field: K1 at the
             main-path shape (one batch: 8,192 reads x 8 candidates, the
             phase-3 database's windows), K2 / K3 under LOCAL and GLOBAL
             scoring at P = 4,096 with indels. Kernel ms (CUDA events,
             after a warm-up), plain ms and the bound.
5. main    — SpeciesProfiler.run over the 65,536 reads at batch 8,192:
             end-to-end reads/s, the kernel's launch count (must equal
             the number of batches), device-step ms per batch with a
             per-stage breakdown, peak device memory. The profile is
             checked against the simulator's truth.
6. cpu     — `run_midas species -n 2048` through the CLI on the card and
             on the CPU (plain versions): species_profile.txt,
             read_count.txt and the final SpeciesState must be identical.

Then the kernels line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before the last line. Work files go to
build/chip_smoke/ in this checkout.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_SPECIES, RELATED, GENOME_LEN, GENE_LEN = 1100, 275, 30000, 900
N_READS, BATCH, N_ABUNDANT = 65536, 8192, 20
SMALL_P = 4096
N_CPU_READS = 2048

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ops_per_cell(n_stats, local, qual_pen, band=16):
    """Float32 / integer arithmetic, compares and selects per DP cell
    (one band offset of one query row), tallied from the recurrence in
    csrc/banded_sw.cu; band shifts (shuffles) and their edge fills are
    data movement and not counted."""
    S = n_stats
    NP = S + 1 if S == 6 else S
    full = S == 6
    sub = 7 + (3 if qual_pen else 0)                 # match test, penalty
    diag = S + 2 + (3 if full else 0)                # start stats, T1
    ins = S + 2 + 3 + 2 + S + (3 if full else 0)     # open, gap costs, I
    pre = 2 + S + (S + 4 if local else 1)            # H_noD, clamp, scan key
    steps = int(math.log2(band))
    dele = steps * (NP + 2) + 2 + (3 if full else 0)  # Kogge-Stone, D value
    fin = 2 * (S + 2) + (S + 2 if local else 0)      # priority, clamp
    best = 9                                          # row max, first, improve
    return sub + diag + ins + pre + dele + fin + best


def dp_bound(qlens, P, L, n_stats, local, qual_pen, band=16):
    """Least time for one DP call on these inputs: the larger of its
    operations over the float32 peak (cells this data needs: each pair
    stops at its own read length) and its bytes over the HBM rate (each
    input read once, each output written once)."""
    cells = int(np.minimum(qlens, L).sum()) * band
    ops = cells * ops_per_cell(n_stats, local, qual_pen, band)
    n_out = 9 if n_stats == 6 else 4
    nbytes = (P * L * (2 if qual_pen else 1) + P * (L + band - 1) + 4 * P
              + 4 * P * n_out)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            cells, ops, nbytes)


def cuda_ms(fn, reps):
    """(mean milliseconds of fn() on the card by CUDA events, after one
    warm-up call; fn's last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda)
    return kind, line


def phase_build():
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.io import native

    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        kern = ex.submit(cuda_sw.load_library)
        nat = ex.submit(native.load_native)
        kern.result()
        have_native = nat.result() is not None
    secs = time.time() - t0
    with open(os.path.join(ROOT, "build", "banded_sw.ptxas.txt")) as f:
        regs = sorted({int(w.split()[0]) for w in f.read().split("Used ")[1:]})
    emit("build", seconds=round(secs, 2), kernels=["banded_sw"],
         registers_per_thread=regs, native_fastq_reader=have_native)


def phase_data():
    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.profile.species import SpeciesProfiler
    from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    comm = simulate_db(os.path.join(WORK, "db"), n_species=N_SPECIES,
                       genome_len=GENOME_LEN, gene_len=GENE_LEN,
                       n_extra_genes=10, related_pairs=RELATED,
                       divergence=0.03, seed=0)
    fq = os.path.join(WORK, "reads.fq.gz")
    n_sp = len(comm.species)
    abund = [1.0 / N_ABUNDANT] * N_ABUNDANT + [0.0] * (n_sp - N_ABUNDANT)
    truth = simulate_reads(comm, fq, n_reads=N_READS, read_len=100,
                           error_rate=0.005, indel_rate=0.01, seed=7,
                           abundances=abund)
    t_sim = time.time() - t0
    t0 = time.time()
    prof = SpeciesProfiler(Database(comm.db_dir), device="cuda")
    t_prof = time.time() - t0
    idx_bytes = sum(t.numel() * t.element_size()
                    for d in (prof.aligner.index_arrays,
                              prof.aligner.pack_arrays) for t in d.values())
    emit("data", species=n_sp, marker_pack_mb=round(prof.pack.total_len / 1e6, 2),
         index_on_card_mb=round(idx_bytes / 2**20, 1), reads=N_READS,
         simulate_seconds=round(t_sim, 1), profiler_setup_seconds=round(t_prof, 1))
    return comm, fq, truth, prof


def _main_batch_pairs(prof, fq):
    """The DP inputs of the main path's first batch, on the card."""
    import torch

    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.align.seed import find_candidates, gather_windows_packed
    from midas_tpu_torch.io.batch import load_read_batches

    al = prof.aligner
    b = next(iter(load_read_batches([fq], batch_size=BATCH,
                                    max_len=al.max_read_len)))
    codes = torch.from_numpy(b.codes).cuda()
    qlens = torch.from_numpy(b.lengths).cuda()
    sp = al.seed_params
    D, L = sp.band_width, codes.shape[1]
    cands = find_candidates(al.index_arrays, codes, qlens, sp, al.max_read_len)
    ref_win, _ = gather_windows_packed(
        al.pack_arrays["words"], al.pack_arrays["nmask"],
        al.pack_arrays["offsets"], cands["diag"] - D // 2, L + D - 1,
        center=cands["diag"] + qlens[:, None] // 2)
    q_pair, qlens_pair, _ = pl._prepare_pairs(codes, qlens, cands["strand"],
                                              cands["rc"])
    return (b, codes, qlens), (q_pair, qlens_pair,
                               ref_win.reshape(q_pair.shape[0], L + D - 1))


def _small_case(seed, P, L=128, D=16):
    """Reads cut from their own window with substitutions, 1-3 bp
    deletions and insertions, reference and read Ns, and random Phred
    penalties — enough to reach every branch of the qpen model."""
    rng = np.random.default_rng(seed)
    W = L + D - 1
    ref = rng.integers(0, 4, size=(P, W)).astype(np.int8)
    ref[rng.random(ref.shape) < 0.01] = 4
    q = np.full((P, L), 4, dtype=np.int8)
    qlens = np.zeros(P, dtype=np.int32)
    for i in range(P):
        n = int(rng.integers(L // 2, L + 1))
        frag = ref[i, D // 2: D // 2 + n].copy()
        k = int(rng.integers(0, 6))
        pos = rng.choice(len(frag), k, replace=False)
        frag[pos] = (frag[pos] + 1) % 4
        if i % 3 == 0:
            at = int(rng.integers(10, len(frag) - 10))
            g = int(rng.integers(1, 4))
            frag = (np.delete(frag, range(at, at + g)) if i % 2 else
                    np.insert(frag, at, rng.integers(0, 4, g)))[:L]
        q[i, :len(frag)] = frag
        qlens[i] = len(frag)
    q[(rng.random(q.shape) < 0.01) & (q < 4)] = 4
    quals = rng.integers(2, 41, size=(P, L))
    qpen = (2 + ((6 - 2) * np.minimum(quals, 40)) // 40).astype(np.int8)
    return q, qlens, ref, qpen


def phase_kernels(prof, fq):
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.banded import banded_align_plain
    from midas_tpu_torch.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                              MARKER_SCORING)

    _, main_pairs = _main_batch_pairs(prof, fq)
    small = [torch.from_numpy(x).cuda() for x in _small_case(11, SMALL_P)]
    cases = [("K1", "marker", MARKER_SCORING, main_pairs, None, False)]
    for name, sc in (("local", LOCAL_SCORING), ("global", GLOBAL_SCORING)):
        cases.append(("K2", name, sc, small[:3], small[3], False))
        cases.append(("K3", name, sc, small[:3], None, True))
        cases.append(("K3", name, sc, small[:3], small[3], True))
    variants = []
    for kname, sname, sc, (q, ql, win), qpen, so in cases:
        P, L = q.shape

        def kern():
            return cuda_sw.banded_align_cuda(q, ql, win, sc, qpen=qpen,
                                             score_only=so)

        def plain():
            return banded_align_plain(q, ql, win, sc, qpen=qpen,
                                      score_only=so)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = 0.0
        for k in want:
            if not torch.equal(got[k], want[k]):
                fail(f"{kname} {sname} qpen={qpen is not None} "
                     f"score_only={so}: field {k} differs from the plain "
                     "version")
            err = max(err, float((got[k].double() - want[k].double())
                                 .abs().max()))
        ms, _ = cuda_ms(kern, 20)
        plain_ms, _ = cuda_ms(plain, 1)
        bound, by, cells, ops, nbytes = dp_bound(
            ql.cpu().numpy(), P, L, 1 if so else 6, sc.mode == "local",
            qpen is not None)
        v = dict(variant=kname, scoring=sname, qual_pen=qpen is not None,
                 score_only=so, P=P, L=L, equal=True, max_abs_err=err,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 cells=cells, ops=ops, bytes=nbytes,
                 ops_per_cell=ops_per_cell(1 if so else 6,
                                           sc.mode == "local",
                                           qpen is not None))
        emit("kernels", **v)
        variants.append(v)
    return variants


def phase_main(prof, fq, truth):
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.profile.species import write_abundance

    prof.run([fq], max_reads=BATCH, batch_size=BATCH)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_batches = -(-N_READS // BATCH)
    cuda_sw.banded_align_cuda.launches = 0
    t0 = time.perf_counter()
    abundance = prof.run([fq], batch_size=BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cuda_sw.banded_align_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != n_batches:
        fail(f"main path launched banded_sw {launches} times for "
             f"{n_batches} batches")
    out = os.path.join(WORK, "main_species_profile.txt")
    write_abundance(out, abundance)

    # the repo's own check: the simulator's truth. Reads come from the
    # first N_ABUNDANT species; the related species are copies of species
    # 1 at 3% divergence and may take its ambiguous reads; no other
    # species may get any.
    ids = list(abundance)
    counts = np.array([abundance[s]["count"] for s in ids])
    vals = np.array([[abundance[s]["cov"], abundance[s]["rel_abun"]]
                     for s in ids])
    first = set(ids[:N_ABUNDANT])
    related = set(ids[N_SPECIES:])
    counted = int(counts.sum())
    in_first = int(sum(c for s, c in zip(ids, counts) if s in first))
    stray = int(sum(c for s, c in zip(ids, counts)
                    if s not in first and s not in related))
    truth_first = sum(1 for t in truth if t["species_id"] in first)
    if not np.isfinite(vals).all():
        fail("non-finite coverage or abundance")
    if abs(vals[:, 1].sum() - 1.0) > 1e-9:
        fail(f"relative abundances sum to {vals[:, 1].sum()}")
    if stray or counted < N_READS // 4 or in_first < 0.9 * counted \
            or min(abundance[s]["count"] for s in ids[1:N_ABUNDANT]) == 0:
        fail(f"profile disagrees with the truth: counted={counted}, "
             f"in_first={in_first}, stray={stray}")

    # device time of one batch's update, and where it goes (CUDA events)
    step_ms, stages = _device_step(prof, fq)
    emit("main", reads=N_READS, batch=BATCH, batches=n_batches,
         seconds=dt, reads_per_sec=N_READS / dt, banded_sw_launches=launches,
         device_step_ms=step_ms, device_busy_share=step_ms * n_batches / 1e3 / dt,
         stage_ms=stages, max_memory_allocated=peak, counted_reads=counted,
         counted_in_abundant=in_first, truth_reads_abundant=truth_first,
         stray_reads=stray, total_alns=prof.stats["total_alns"])
    return launches


def _device_step(prof, fq):
    """Mean device ms of species_update on one batch, and a per-stage
    breakdown of the same work, by CUDA events."""
    import torch

    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.align.params import MARKER_SCORING
    from midas_tpu_torch.align.seed import find_candidates, gather_windows_packed
    from midas_tpu_torch.profile import device_steps as ds

    (b, codes, qlens), _ = _main_batch_pairs(prof, fq)
    al = prof.aligner
    sp = al.seed_params
    n_species = len(prof.species_order)
    seq_species = torch.from_numpy(prof.seq_species).cuda()
    seq_cutoff = torch.from_numpy(prof.seq_cutoff).cuda()
    min_score = torch.from_numpy(MARKER_SCORING.evalue_min_score(
        np.maximum(np.arange(al.max_read_len + 1), 1),
        float(prof.pack.total_len))).cuda()
    state = ds.species_init(n_species, sp.num_cands, 2 * BATCH, prof.device)

    def step():
        state.amb_n.zero_()
        ds.species_update(state, al.index_arrays, al.pack_arrays,
                          seq_species, seq_cutoff, codes, qlens, b.n_reads, 0,
                          scoring=al.scoring, seed_params=sp,
                          max_len=al.max_read_len, aln_cov=prof.aln_cov,
                          n_species=n_species, min_score=min_score)

    step_ms, _ = cuda_ms(step, 5)
    D, L = sp.band_width, codes.shape[1]
    B, C = codes.shape[0], sp.num_cands
    r = {}
    r["seed"], c = cuda_ms(lambda: find_candidates(
        al.index_arrays, codes, qlens, sp, al.max_read_len), 5)
    r["window_gather"], (win, _) = cuda_ms(lambda: gather_windows_packed(
        al.pack_arrays["words"], al.pack_arrays["nmask"],
        al.pack_arrays["offsets"], c["diag"] - D // 2, L + D - 1,
        center=c["diag"] + qlens[:, None] // 2), 5)
    win = win.reshape(B * C, L + D - 1)
    r["pair_prep"], (q_pair, ql_pair, _) = cuda_ms(lambda: pl._prepare_pairs(
        codes, qlens, c["strand"], c["rc"]), 5)
    r["banded_dp"], _ = cuda_ms(lambda: pl.dispatch_banded_align(
        q_pair, ql_pair, win, al.scoring, D), 5)
    r["classify_and_rest"] = step_ms - sum(r.values())
    return step_ms, r


def phase_cpu_vs_card(comm, fq):
    from midas_tpu_torch.cli.run_midas import main as run_midas

    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(WORK, f"cli_{dev}")
        t0 = time.time()
        run_midas(["species", out, "-1", fq, "-d", comm.db_dir,
                   "-n", str(N_CPU_READS), "--device", dev])
        outs[dev] = (out, time.time() - t0)
    (card, t_card), (cpu, t_cpu) = outs["cuda"], outs["cpu"]
    for f in ("species/species_profile.txt", "species/temp/read_count.txt"):
        with open(os.path.join(card, f), "rb") as a, \
                open(os.path.join(cpu, f), "rb") as b:
            if a.read() != b.read():
                fail(f"card and CPU differ in {f}")
    za = np.load(os.path.join(card, "species/temp/state.npz"))
    zb = np.load(os.path.join(cpu, "species/temp/state.npz"))
    keys = sorted(k for k in za.files if k != "__meta__")
    if keys != sorted(k for k in zb.files if k != "__meta__"):
        fail("card and CPU states hold different fields")
    for k in keys:
        if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k]):
            fail(f"card and CPU SpeciesState differ in {k}")
    emit("cpu", reads=N_CPU_READS, identical=True, state_fields=keys,
         amb_rows=int(za["amb_n"]), card_seconds=round(t_card, 2),
         cpu_seconds=round(t_cpu, 2))


def main():
    if not os.path.isdir(os.path.join(ROOT, "midas_tpu_torch")):
        fail("chip_smoke.py must sit at the root of a checkout of the repo "
             "(midas_tpu_torch/ beside it)")
    kind, smi_line = phase_device()
    import torch

    phase_build()
    comm, fq, truth, prof = phase_data()
    variants = phase_kernels(prof, fq)
    launches = phase_main(prof, fq, truth)
    phase_cpu_vs_card(comm, fq)
    k1 = variants[0]
    print(json.dumps({"kernels": [dict(
        name="banded_sw", route="cuda",
        source="midas_tpu_torch/csrc/banded_sw.cu",
        replaces="midas_tpu/align/pallas_sw.py:328",
        launches=launches, max_abs_err=max(v["max_abs_err"] for v in variants),
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None,
        equal=all(v["equal"] for v in variants), tolerance=0.0,
        card=smi_line,
        variants=variants)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
