#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (midas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card; exits non-zero without CUDA. Also prints the
             `nvidia-smi --query-gpu=name,power.limit` line as it is.
2. build   — compiles the kernels from this checkout's sources (nvcc,
             sm_90a) and the native FASTQ reader, in parallel, and
             reports each kernel function's registers and spills
             (ptxas), with the packed kernel's layout per variant.
3. data    — simulates a marker database the size of the production
             phyeco.fa (1,100 species + 275 related, 15 x 900 bp markers
             each, ~18.6 MB) and 65,536 x 100 bp reads from the first 20
             species, and builds the profiler (seed index) on the card.
4. kernels — every variant of the banded-DP kernel against its plain
             PyTorch version on the card, equal field by field: K1 at the
             main-path shape (one batch: 8,192 reads x 8 candidates, the
             phase-3 database's windows) and on as many pairs of
             repeat-rich windows full of ties (tests/torch_cases.py); K3
             with qpen (P = 32,768) and K2 (P = 8,192) on tie-heavy
             windows with quality penalties and read Ns, LOCAL scoring;
             K2 / K3 under LOCAL and GLOBAL scoring at P = 4,096 with
             indels; and the template kernel, K1 and K2 at P = 48,
             L = 32,768 (above the packed kernel's row limit) with short
             reads. Kernel ms (CUDA events, after a warm-up), plain ms and
             the bound.
5. main    — SpeciesProfiler.run over the 65,536 reads at batch 8,192:
             end-to-end reads/s, the kernel's launch count (must equal
             the number of batches), device-step ms per batch with a
             per-stage breakdown, peak device memory. The profile is
             checked against the simulator's truth.
6. cpu     — `run_midas species -n 2048` through the CLI on the card and
             on the CPU (plain versions): species_profile.txt,
             read_count.txt and the final SpeciesState must be identical.
7. genes_data    — simulates a pangenome database (12 species + 3
             related, 3 Mb genomes, 3,224 genome genes and 2,000
             pangenome-only genes each), 131,072 x 100 bp reads from the
             first 10 species, and builds the genes profiler over those
             10 pangenomes (52,240 centroids, ~47 MB) on the card.
8. genes_kernels — the genes path's two DP calls on its first batch,
             captured from genes_update under LOCAL and GLOBAL scoring:
             pass 1 (K3 with qpen, 8,192 reads x 4 candidates) and pass 2
             (K2, one row per read), each equal to the plain version
             field by field, and K3 equal to K2 on the fields both
             compute. Kernel ms, plain ms and the bound.
9. genes_main    — GenesProfiler.run over the 131,072 reads at batch
             8,192: reads/s, K3 and K2 launches (each must equal the
             number of batches), device-step ms of one genes_update with
             a per-stage breakdown, peak device memory. Copy numbers are
             checked against the simulator's truth.
10. genes_cpu    — `run_midas genes -n 2048` through the CLI on the
             phase-3 database's first 20 species, on the card and on the
             CPU, in -m local and -m global: summary.txt, every
             decompressed .genes.gz and the saved GenesState must be
             identical.
11. snps_data    — builds the snps profiler on the card over the
             representative genomes of the genes cell's 10 species (30 Mb,
             the [4 x (G+1)] int32 counts ~0.48 GB) and reuses phase 7's
             131,072 reads, which carry indels in 1% of reads.
12. snps_kernels — the snps path's two DP calls on its first batch,
             captured from snps_update under GLOBAL (the default) and
             LOCAL scoring: pass 1 (K3 with qpen, 8,192 reads x 4
             candidates) and pass 2 (K2), each equal to the plain version
             field by field, and K3 equal to K2 on the fields both
             compute. Kernel ms, plain ms and the bound.
13. snps_main    — SnpsProfiler.run over the 131,072 reads at batch
             8,192 with a checkpoint path, as run_snps calls it (the
             counts are read back and the state saved at the end):
             reads/s, K3 with qpen and K2 launches (each must equal the
             number of batches), device-step ms of one snps_update with a
             per-stage breakdown, busy share, peak device memory, gapped
             rows, the host seconds of the checkpoint write and of
             _finalize (the gapped-read oracle). The pileup is checked against
             the simulator's truth (genome lengths, modal allele = the
             reference at >= 99% of sites with depth >= 3, mapped reads
             for every species), and one species' sites are written and
             read back (depth = the sum of the four counts).
13a. readback    — phase 13's final counts, put back on the card as the
             flat [4 x (G+1)] int32 tensor with junk at flat G (no new
             run of the stream), and a thinned copy (every 16th covered
             run kept): the whole int32 copy and the sparse route
             (pageable and pinned host copies each) and
             counts_host_sparse, best of 3 in alternating order, all
             equal byte for byte, and the route taken no slower than
             the whole copy (READBACK_SLACK); snps_state_host's counts
             equal too. The route, the statistics, the host costs
             route_seconds weighs as measured here, its predictions and
             the seconds.
14. snps_cpu    — `run_midas snps -n 2048` through the CLI on the
             phase-3 database's first 20 species, on the card and on the
             CPU, in -m global and -m local: summary.txt, every
             decompressed .snps.gz and the saved state must be identical.

The paired phases (run between the phases above, while phase 7's genes
profiler and phase 11's snps profiler are on the card):

15. paired_data  — 65,536 mate pairs (131,072 x 100 bp reads, fr,
             fragments of 220-420 bp, maxins 500) from the genes cell's
             10 species, as -1 / -2 files; no new database.
16. paired_genes_main — GenesProfiler.run([r1, r2], paired=True) at
             batch 8,192 (4,096 pairs), after phase 9 on the same
             profiler: reads/s and pairs/s, K3 with qpen and K2 launches
             (each must equal the number of batches), device-step ms of
             one paired genes_update with its stages (pair_pick, the
             mate-pair best hit, in place of best_hit_mapq), busy share,
             peak memory, the loader's host seconds against the
             single-end loader over the same reads, and the counts of an
             unpaired run of the same files. Checked: genes_main's
             truth, the first batch's concordant share against a bound
             measured on the CPU (PAIRED_MIN_CONCORDANT), that the
             mate-pair pick changes some reads' MAPQ or candidate there,
             and K3 with qpen / K2 on that batch's DP inputs equal to
             the plain version (paired_genes_kernels).
17. paired_snps_main — SnpsProfiler.run([r1, r2], paired=True) with a
             checkpoint path, after phase 13 on the same profiler:
             snps_main's figures and checks, with pair_pick, the
             first batch's concordant share against its bound and K3 /
             K2 on its DP inputs (paired_snps_kernels).
18. paired_cli   — 1,024 mate pairs from the phase-3 community's first
             20 species: `run_midas genes -m local` and `run_midas snps
             -m global` with -1 / -2 on the card and on the CPU, and with
             --interleaved over the same pairs on the card; every output
             file and the saved state must be identical, and the CPU
             runs launch nothing.

The m8 and merge phases:

19. species_m8   — SpeciesProfiler.run(m8_path=...) right after phase 5,
             on the same profiler and reads: the host classifier over
             each batch's read-back alignments and the BLAST outfmt-6
             writer. Checked: K1 once a batch, the main phase's
             abundance and stats exactly, the first batch's align_batch
             planes equal to those of the plain DP on the same pairs (and
             K1 held to the plain version there: species_m8_kernels),
             and alignments.m8 equal to phase 25's at tp = 2.
             Reads/s beside the main phase's, the readback's bytes and ms
             a batch, the host seconds of loading, align_batch, the
             classifier, the m8 writer and the assignment, the m8 rows
             and bytes.
20. m8_cli       — `run_midas species --m8 -n 2048` on the card and on the
             CPU: species_profile.txt, read_count.txt and alignments.m8
             identical, and no temp/state.npz.
21. merge_cli    — three samples of a small community (the tests'
             sim_community and three_samples mixtures, 2,048 reads each)
             through `run_midas species`, `genes`, `snps` on the card and
             on the CPU, then `merge_midas species`, `genes`, `snps`
             (default, and --all_sites --all_samples) over each set: the
             merged trees identical.
22. merge_main   — four samples (163,840 x 100 bp reads each, ~5.5x) of
             the repgenome-10sp cell's first 3 Mb species, the fourth
             with variants, each through `run_midas snps --species_id` on
             the card, then `merge_midas snps` at its defaults (the
             --core_snps filters, --sample_depth 5), checked against a
             plain numpy recount from the four .snps.gz files (kept
             samples, sites, major and minor alleles, pooled counts,
             per-sample depths). Seconds of each stage, and the merge's
             seconds per million sites.

The multi-process phase (run after phase 18, before 21, while phase 3's
database and reads and the CLI phases' outputs are on disk):

23. multirank    — `run_midas` under 2 ranks on this one card, launched
             as torchrun launches them (RANK, LOCAL_RANK, WORLD_SIZE,
             MASTER_ADDR, MASTER_PORT; each rank is `chip_smoke.py
             --rank-worker`), against the same command in 1 rank:
             species over phase 3's database and 65,536 reads (batch
             8,192: K1 4 a rank), then genes -m local over 2,048 reads
             and over 1,024 -1/-2 pairs and snps -m global over 2,048
             reads (the first 20 species, batch 512: K3 with qpen and K2
             2 a rank). Outputs identical to the 1-rank run's (genes and
             snps also to phases 10, 14 and 18), every rank on the card.
             Each rank's profiling-stage and merge seconds, the walls,
             and the aggregate reads/s of the profiling stage, 2 ranks
             against 1. Then the snps merge at the repgenome-10sp width:
             2 ranks each load phase 13's end-of-stream state ([4 x
             (G+1)] counts over the 10 species' 30 Mb, and its gapped
             rows) and time run_snps_multihost's merge of it
             (merge_snps_accumulators), checked against twice the state.

The tensor-parallel phases (dist/sharded.py, dist/species.py,
dist/profilers.py: the pack and seed index in 2 shards, both on this
card), run beside the 1-shard profilers of the phases they follow:

24. tp_step      — after phase 4: distributed_profile_step over 8,192
             error-free reads of a synthetic 2.05 Mb pack at 2 shards
             against 1: counts equal and equal to the truth; K1 under
             GLOBAL scoring with the flat mismatch once a shard, each
             call held to the plain version.
25. tp_species   — after phase 5: run_species_multihost(tp=2) over phase
             3's database and reads: K1 2 x 8, every shard on the card,
             the profile against the truth and equal to phase 5's; the
             same reads again for reads/s beside phase 5's, one batch's
             device step and cross-shard gather, each shard's first-batch
             K1 call held to the plain version, and 2,048 reads on the
             card against the same shards on the CPU; then
             run(m8_path=...) at tp = 2: K1 once a batch on one aligner
             over the whole pack (built on shard 0's card), the
             abundance and stats of phase 5, the m8 file for phase 19.
26. tp_genes     — after phase 16: the genes cell's pangenome at 2 shards
             beside phase 7's profiler over the first 16,384 reads and
             8,192 mate pairs: results and files equal, K3 with qpen and
             K2 2 x 2, device steps, the gather, each shard's first-batch
             calls held to the plain version; then run_genes_multihost
             (tp=2) on the card against the CPU at 2,048 reads.
27. tp_snps      — after phase 17: the same for the snps cell (counts,
             counters and gapped rows equal; the stripe readback timed,
             and each stripe alone through the whole int32 copy and
             counts_host_sparse, the route taken no slower than the
             whole copy), then run_snps_multihost(tp=2) -m
             global card vs CPU.

The database-build and analysis phases:

28. dbbuild_main — after phase 14: 4 species of 1 Mb genomes (1,074
             genome genes and 300 pangenome-only genes each) and a related
             copy, written as build_midas_db's inputs and built by the
             port (`cli/build_db.py --marker_map --compress`; seconds of
             clustering, marker mapping and compression, the database's
             bytes); then `run_midas species`, `genes -m local` and
             `snps -m global` over it on the card (131,072 reads from the
             4 species; genes and snps at --species_cov 1.0), each checked
             against the simulator's truth (counted species, copy numbers
             near 1 and unread pangenome-only genes, every genome site
             written, modal allele = reference); reads/s of each run; the
             three again at 2,048 reads on the card and on the CPU,
             identical byte for byte.
29. analysis_main — after phase 22: `python -m
             midas_tpu_torch.cli.analysis` call_consensus, snp_diversity
             (per-sample, pooled-samples) and strain_tracking (id_markers,
             track_markers) over phase 22's merged snps species, the
             consensus held to a numpy recount (consensus_recount);
             compare_genes (presabs / jaccard, copynum / euclidean) and
             query_by_compound over phase 21's card samples, merged genes
             and a copy of its database with two genes annotated. Each
             tool's seconds, and seconds per million merged sites.

The bench phase (last, when every profiler of the phases above is
freed):

30. bench        — `python -m midas_tpu_torch.bench` in this process
             (bench/__main__.py, the port's bench.py: species, genes and
             snps end to end on a 12-species toy community, best of 3
             equal reps, the device-only rates, and the trimmed scale
             line at 500 species x 100 kb): its JSON line as the bench
             prints it, then the phase's checks (bench.py's keys, every
             rate above 0, the card in its platform, K1, K3 with qpen
             and K2 launched by each leg that runs them), its seconds
             and the script's seconds so far.

Then the kernels line: banded_sw (K1 on the packed kernel, timed at
the species batch as in earlier runs, species launches),
banded_sw_k3_qpen (K3 on the packed kernel, timed at genes pass 1,
genes launches), banded_sw_k2 (K2 on the packed kernel, timed at genes
pass 2, genes launches), banded_sw_template (the template kernel,
timed on the above-the-limit check, launched on no path),
banded_sw_k3_qpen_glocal (K3 GLOBAL, timed at snps pass 1, snps
launches), banded_sw_k2_glocal (K2 GLOBAL, timed at snps pass 2, snps
launches) and banded_sw_k1_glocal (K1 GLOBAL, timed at tp_step, its
launches), each with every path's launches (the paired, m8, merge,
multirank, tp, tp m8, dbbuild and bench paths' among them), and as the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero before the last line. Work files go to
build/chip_smoke/ in this checkout.
"""

import contextlib
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from midas_tpu_torch.bench.common import cuda_ms
from midas_tpu_torch.bench.common import smi_line as nvidia_smi_line

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_SPECIES, RELATED, GENOME_LEN, GENE_LEN = 1100, 275, 30000, 900
N_READS, BATCH, N_ABUNDANT = 65536, 8192, 20
SMALL_P = 4096
N_CPU_READS = 2048
# the genes cell: a pangenome database at the size of a MIDAS genes run
# over 10 selected species
GENES_DB = dict(n_species=12, genome_len=3_000_000, gene_len=900,
                n_extra_genes=2000, related_pairs=3, divergence=0.03, seed=1)
N_GENES_SPECIES, N_GENES_READS = 10, 131072
N_GENES_CPU_SPECIES = 20
# the snps cell: the representative genomes of the genes cell's species
N_SNPS_CPU_SPECIES = 20
# the paired cells: mate pairs of 100 bp reads in fr orientation from the
# genes cell's 10 species, as bowtie2 -1/-2 takes them
N_PAIRS, N_CLI_PAIRS = 65536, 1024
PAIRED_SIM = dict(read_len=100, frag_range=(220, 420), error_rate=0.005,
                  indel_rate=0.01, seed=9)
# The least share of a paired batch's real pairs that must have a
# concordant candidate pair (device_steps.concordant_pairs' has_pair).
# Measured on the CPU before the first card run, at 1,024 pairs of
# PAIRED_SIM from the genes cell's database cut to 300 kb genomes (gene
# length kept), by tests/test_torch_paired.py::test_concordant_share_bound:
# genes (LOCAL, pangenome: a pair spanning two genes is not concordant)
# 0.7217, snps (GLOBAL, representative genomes) 1.0. The bounds sit about
# four standard deviations of a 1,024-pair sample below; never lowered.
# The same run moved the MAPQ of 124 of the 2,048 genes reads and of 1
# snps read: only the genes cell is required to show moved picks.
PAIRED_MIN_CONCORDANT = {"genes": 0.66, "snps": 0.97}

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# seconds a phase waits for its share of the background worker's work
BACKGROUND_TIMEOUT = 900


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
    operations over the float32 peak and its bytes over the HBM rate,
    both counted for what this data needs. Each pair stops at its own
    read length: its cells are its rows times the band, and it reads
    each of its query (and qpen) rows once and its reference window up
    to its last row plus the band, besides its length and outputs."""
    rows = np.minimum(qlens, L).astype(np.int64)
    cells = int(rows.sum()) * band
    ops = cells * ops_per_cell(n_stats, local, qual_pen, band)
    n_out = 9 if n_stats == 6 else 4
    nbytes = int(rows.sum() * (2 if qual_pen else 1)
                 + np.where(rows > 0, rows + band - 1, 0).sum()
                 + 4 * P + 4 * P * n_out)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            cells, ops, nbytes)


def _background_init():
    """The background worker: the lowest CPU priority and one torch
    thread, so that it takes one otherwise idle core and leaves the
    timed phases theirs."""
    os.nice(19)
    import torch

    torch.set_num_threads(1)


def _in_background(fn, *args):
    """fn(*args) in the background worker; a SystemExit (fail(), a CLI's
    exit) comes back to the caller as an error instead of ending the
    worker, whose result would then never arrive."""
    try:
        return fn(*args)
    except SystemExit as e:
        raise RuntimeError(f"{fn.__name__}: exit {e.code}") from None


def _cpu_cli(argv):
    """run_midas argv (a --device cpu run), in the background worker:
    (seconds, the kernel launches it made)."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas

    cuda_sw.LAUNCHES.clear()
    t = time.time()
    run_midas(argv)
    return time.time() - t, dict(cuda_sw.LAUNCHES)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is false)")
    line = nvidia_smi_line()
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
        report = cuda_sw.ptxas_report(f.read())
    emit("build", seconds=round(secs, 2), kernels=["banded_sw"],
         packed_layout=cuda_sw.packed_layout(), kernel_functions=report,
         native_fastq_reader=have_native)


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
    from midas_tpu_torch.io.batch import load_read_batches

    al = prof.aligner
    b = next(iter(load_read_batches([fq], batch_size=BATCH,
                                    max_len=al.max_read_len)))
    codes = torch.from_numpy(b.codes).cuda()
    qlens = torch.from_numpy(b.lengths).cuda()
    *_, (q_pair, qlens_pair, ref_win, _) = pl._candidate_pairs(
        al.index_arrays, al.pack_arrays, codes, qlens, al.scoring,
        al.seed_params, al.max_read_len)
    return (b, codes, qlens), (q_pair, qlens_pair, ref_win)


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

    from midas_tpu_torch.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                              MARKER_SCORING)

    from midas_tpu_torch.align import cuda_sw

    cases_mod = _load_torch_cases()

    def card(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    _, main_pairs = _main_batch_pairs(prof, fq)
    small = card(*_small_case(11, SMALL_P))
    ties = card(*cases_mod.tie_case(12, P=main_pairs[0].shape[0], L=128))
    cases = [("K1", "marker", MARKER_SCORING, main_pairs, None, False,
              "main path batch"),
             ("K1", "marker", MARKER_SCORING, ties, None, False,
              "repeat windows, ties")]
    # K3 with qpen and K2 at their genes shapes on repeat windows, with
    # quality penalties and read Ns
    for kname, P, so in (("K3", 32768, True), ("K2", BATCH, False)):
        q, ql, ref = cases_mod.tie_case(13 + P, P=P, L=128)
        qpen, q = cases_mod.qpen_case(14 + P, q, LOCAL_SCORING)
        q, ql, ref, qpen = card(q, ql, ref, qpen)
        cases.append((kname, "local", LOCAL_SCORING, (q, ql, ref), qpen, so,
                      "repeat windows, ties"))
    for name, sc in (("local", LOCAL_SCORING), ("global", GLOBAL_SCORING)):
        cases.append(("K2", name, sc, small[:3], small[3], False, "synthetic"))
        cases.append(("K3", name, sc, small[:3], None, True, "synthetic"))
        cases.append(("K3", name, sc, small[:3], small[3], True, "synthetic"))
    # the template kernel: full-statistics rows above the packing limit
    q, ql, ref, qpen = card(*cases_mod.long_bucket_case(15, 32768,
                                                        LOCAL_SCORING))
    cases.append(("K1", "marker", MARKER_SCORING, (q, ql, ref), None, False,
                  "above the packing limit"))
    cases.append(("K2", "local", LOCAL_SCORING, (q, ql, ref), qpen, False,
                  "above the packing limit"))
    layout = cuda_sw.packed_layout()
    variants = []
    for kname, sname, sc, (q, ql, win), qpen, so, shape in cases:
        v = _check_variant(kname, sname, sc, q, ql, win, qpen, so,
                           shape=shape, layout=layout)
        v.pop("_out")
        emit("kernels", **v)
        variants.append(v)
    return variants


def _load_torch_cases():
    """tests/torch_cases.py, the tests' numpy-only input generators,
    loaded by file path so that no import of this script looks in
    tests/."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cases", os.path.join(ROOT, "tests", "torch_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_variant(kname, sname, sc, q, ql, win, qpen, so, layout,
                   **extra):
    """One kernel variant on these inputs: equal to the plain version
    field by field (fails otherwise), its ms by CUDA events (mean of 20
    after a warm-up), the plain version's ms (one call) and the bound,
    with the kernel function that ran (packed, at its layout, or the
    template kernel for full-statistics rows above the limit). Returns
    the variant's record (and the kernel's outputs under "_out", for the
    caller's own checks)."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.banded import banded_align_plain

    P, L = q.shape

    def kern():
        return cuda_sw.banded_align_cuda(q, ql, win, sc, qpen=qpen,
                                         score_only=so)

    def plain():
        return banded_align_plain(q, ql, win, sc, qpen=qpen, score_only=so)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for k in want:
        if not torch.equal(got[k], want[k]):
            fail(f"{kname} {sname} qpen={qpen is not None} "
                 f"score_only={so} P={P}: field {k} differs from the plain "
                 "version")
        err = max(err, float((got[k].double() - want[k].double())
                             .abs().max()))
    ms, _ = cuda_ms(kern, 20)
    plain_ms, _ = cuda_ms(plain, 1)
    n_stats, local = 1 if so else 6, sc.mode == "local"
    bound, by, cells, ops, nbytes = dp_bound(
        ql.cpu().numpy(), P, L, n_stats, local, qpen is not None)
    key = cuda_sw.variant_key(n_stats, qpen is not None)
    template = n_stats == 6 and L > layout["packed_max_l"]
    return dict(variant=kname, key=key,
                function="template" if template else "packed",
                layout=None if template else layout[key],
                scoring=sname, qual_pen=qpen is not None, score_only=so,
                P=P, L=L, equal=True, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, cells=cells,
                ops=ops, bytes=nbytes,
                ops_per_cell=ops_per_cell(n_stats, local, qpen is not None),
                **extra, _out=got)


def phase_main(prof, fq, truth):
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.profile.species import write_abundance

    prof.run([fq], max_reads=BATCH, batch_size=BATCH)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_batches = -(-N_READS // BATCH)
    cuda_sw.LAUNCHES.clear()
    t0 = time.perf_counter()
    abundance = prof.run([fq], batch_size=BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_sw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches != {"K1": n_batches}:
        fail(f"main path launched banded_sw {launches} for "
             f"{n_batches} batches (want K1 only, once per batch)")
    out = os.path.join(WORK, "main_species_profile.txt")
    write_abundance(out, abundance)
    counted, in_first, stray, truth_first = _species_truth(abundance, truth)

    # device time of one batch's update, and where it goes (CUDA events)
    step_ms, stages = _device_step(prof, fq)
    emit("main", reads=N_READS, batch=BATCH, batches=n_batches,
         seconds=dt, reads_per_sec=N_READS / dt, banded_sw_launches=launches,
         device_step_ms=step_ms, device_busy_share=step_ms * n_batches / 1e3 / dt,
         stage_ms=stages, max_memory_allocated=peak, counted_reads=counted,
         counted_in_abundant=in_first, truth_reads_abundant=truth_first,
         stray_reads=stray, total_alns=prof.stats["total_alns"])
    return dict(launches=launches, abundance=abundance,
                stats=dict(prof.stats), reads_per_sec=N_READS / dt,
                device_step_ms=step_ms)


def _species_truth(abundance, truth):
    """The repo's own check: the simulator's truth. Reads come from the
    first N_ABUNDANT species; the related species are copies of species
    1 at 3% divergence and may take its ambiguous reads; no other
    species may get any. Returns (reads counted, counted in the first
    N_ABUNDANT, stray reads, true reads of the first N_ABUNDANT)."""
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
    return counted, in_first, stray, truth_first


def _device_step(prof, fq):
    """Mean device ms of species_update on the main path's first batch,
    and a per-stage breakdown of the same work, by CUDA events
    (bench/budget.py)."""
    from midas_tpu_torch.bench.budget import device_step

    (b, codes, qlens), _ = _main_batch_pairs(prof, fq)
    return device_step(prof, codes, qlens, b.n_reads)


def _same_files(a, b, files, what):
    """Fail unless the files (paths relative to a and b) hold the same
    bytes; .gz files are compared decompressed."""
    import gzip

    for f in files:
        op = gzip.open if f.endswith(".gz") else open
        with op(os.path.join(a, f), "rb") as x, op(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                fail(f"{what}: {f} differs")


M8_OUTPUTS = ("species/species_profile.txt", "species/temp/read_count.txt",
              "species/temp/alignments.m8")


def _species_cli(comm, fq, dev, m8=False):
    """(output directory, argv) of `run_midas species -n 2048 [--m8]` over
    phase 3's database on dev."""
    out = os.path.join(WORK, f"{'m8_cli' if m8 else 'cli'}_{dev}")
    return out, ["species", out, "-1", fq, "-d", comm.db_dir, "-n",
                 str(N_CPU_READS), *(["--m8"] if m8 else []), "--device", dev]


def phase_cpu_vs_card(comm, fq, cpu_run):
    """`run_midas species -n 2048` on the card against the same command on
    the CPU (cpu_run: its background run, _cpu_cli)."""
    from midas_tpu_torch.cli.run_midas import main as run_midas

    card, argv = _species_cli(comm, fq, "cuda")
    t0 = time.time()
    run_midas(argv)
    t_card = time.time() - t0
    cpu = _species_cli(comm, fq, "cpu")[0]
    t_cpu, _ = cpu_run.get(BACKGROUND_TIMEOUT)
    _same_files(card, cpu, M8_OUTPUTS[:2], "species, card vs CPU")
    keys, za = _same_state(os.path.join(card, "species/temp/state.npz"),
                           os.path.join(cpu, "species/temp/state.npz"),
                           "card and CPU SpeciesState")
    emit("cpu", reads=N_CPU_READS, identical=True, state_fields=keys,
         amb_rows=int(za["amb_n"]), card_seconds=round(t_card, 2),
         cpu_seconds=round(t_cpu, 2))


def _plain_dp(q, ql, win, scoring, band_width=16, qpen=None,
              score_only=False):
    """A stand-in for cuda_sw.banded_align_cuda that runs the plain
    PyTorch version on the same (card) tensors."""
    from midas_tpu_torch.align.banded import banded_align_plain

    return banded_align_plain(q, ql, win, scoring, band_width, qpen=qpen,
                              score_only=score_only)


def phase_species_m8(prof, fq, main, smi_line):
    """SpeciesProfiler.run with an m8 path (the host classifier over each
    batch's read-back alignments, the BLAST outfmt-6 writer) over the
    main phase's reads on the same profiler. Checked: K1 once a batch,
    the main phase's abundance and stats exactly, and the first batch's
    align_batch planes equal to those of the plain DP on the same pairs.
    Host stages are timed by wrapping them here, without editing the
    package. Returns (launches, the K1 record on this path's batch)."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.io.batch import load_read_batches
    from midas_tpu_torch.profile import species as species_mod

    out_dir = os.path.join(WORK, "species_m8")
    os.makedirs(out_dir, exist_ok=True)
    m8 = os.path.join(out_dir, "alignments.m8")
    prof.run([fq], max_reads=BATCH, batch_size=BATCH, m8_path=m8)  # warm-up
    torch.cuda.synchronize()
    n_batches = -(-N_READS // BATCH)
    secs = dict(load=0.0, align_batch=0.0, write_m8=0.0, run_host=0.0)

    def timed(key, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[key] += time.perf_counter() - t
        return wrapper

    real_load = species_mod.load_read_batches

    def timed_load(*a, **k):
        it = iter(real_load(*a, **k))
        while True:
            t = time.perf_counter()
            b = next(it, None)
            secs["load"] += time.perf_counter() - t
            if b is None:
                return
            yield b

    al = prof.aligner
    al.align_batch = timed("align_batch", al.align_batch)   # ends in .cpu()
    prof._write_m8 = timed("write_m8", prof._write_m8)
    prof._run_host = timed("run_host", prof._run_host)
    species_mod.load_read_batches = timed_load
    try:
        cuda_sw.LAUNCHES.clear()
        t0 = time.perf_counter()
        abundance = prof.run([fq], batch_size=BATCH, m8_path=m8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(cuda_sw.LAUNCHES)
    finally:
        species_mod.load_read_batches = real_load
        del al.align_batch, prof._write_m8, prof._run_host
    if launches != {"K1": n_batches}:
        fail(f"m8 path launched banded_sw {launches} for {n_batches} "
             "batches (want K1 only, once per batch)")
    if abundance != main["abundance"]:
        fail("m8 path's abundance differs from the main (device) path's")
    if prof.stats != main["stats"]:
        fail(f"m8 path's stats {prof.stats} differ from the main path's "
             f"{main['stats']}")

    # the first batch: align_batch with the kernel against align_batch
    # with the plain DP on the same pairs, plane by plane
    b = next(iter(load_read_batches([fq], batch_size=BATCH,
                                    max_len=al.max_read_len)))
    ((p, k),) = _captured_dp_calls(lambda: al.align_batch(b))
    got = al.align_batch(b)
    real = cuda_sw.banded_align_cuda
    cuda_sw.banded_align_cuda = _plain_dp
    try:
        want = al.align_batch(b)
    finally:
        cuda_sw.banded_align_cuda = real
    for f in al._PACK_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            fail(f"m8 path's first batch: align_batch plane {f} differs "
                 "from the plain DP's")
    variant = _check_variant("K1", "marker", al.scoring, *p[:3], k["qpen"],
                             k["score_only"], cuda_sw.packed_layout(),
                             shape="m8 path batch")
    variant.pop("_out")
    emit("species_m8_kernels", **variant)

    # the readback alone: the 12 planes packed and copied to the host
    codes = torch.from_numpy(b.codes).cuda()
    qlens = torch.from_numpy(b.lengths).cuda()
    dev_out = al.align_batch_device(codes, qlens)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        packed = pl._pack_result(dev_out).cpu()
    readback_ms = (time.perf_counter() - t) / 10 * 1e3
    with open(m8, "rb") as f:
        m8_bytes = f.read()
    with open(os.path.join(WORK, "tp_species_m8", "alignments.m8"), "rb") as f:
        if f.read() != m8_bytes:
            fail("alignments.m8 of DistributedSpeciesProfiler(tp=2) differs "
                 "from the single-device profiler's")
    host = dict(load=secs["load"], align_batch=secs["align_batch"],
                write_m8=secs["write_m8"],
                classifier=secs["run_host"] - secs["load"]
                - secs["align_batch"] - secs["write_m8"],
                assign_and_normalize=dt - secs["run_host"])
    emit("species_m8", reads=N_READS, batch=BATCH, batches=n_batches,
         seconds=dt, reads_per_sec=N_READS / dt,
         main_reads_per_sec=main["reads_per_sec"],
         banded_sw_launches=launches,
         readback_bytes_per_batch=packed.numel() * packed.element_size(),
         readback_ms_per_batch=readback_ms,
         align_batch_ms_per_batch=secs["align_batch"] / n_batches * 1e3,
         host_seconds=host, m8_rows=m8_bytes.count(b"\n"),
         m8_bytes=len(m8_bytes), abundance_equal_main=True,
         stats_equal_main=True, stats=prof.stats,
         first_batch_equal_plain=True, tp2_m8_identical=True, card=smi_line)
    return launches, variant


def phase_m8_cli(comm, fq, cpu_run, smi_line):
    """`run_midas species --m8 -n 2048` through the CLI on the card and on
    the CPU (cpu_run: its background run, _cpu_cli): species_profile.txt,
    read_count.txt and alignments.m8 equal byte for byte, no
    temp/state.npz, K1 once on the card and nothing on the CPU. Returns
    the card run's launches."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas

    outs, secs, launches = {}, {}, {}
    outs["cuda"], argv = _species_cli(comm, fq, "cuda", m8=True)
    cuda_sw.LAUNCHES.clear()
    t0 = time.time()
    run_midas(argv)
    secs["cuda"] = round(time.time() - t0, 2)
    launches["cuda"] = dict(cuda_sw.LAUNCHES)
    outs["cpu"] = _species_cli(comm, fq, "cpu", m8=True)[0]
    secs["cpu"], launches["cpu"] = cpu_run.get(BACKGROUND_TIMEOUT)
    secs["cpu"] = round(secs["cpu"], 2)
    for dev, out in outs.items():
        if os.path.exists(os.path.join(out, "species/temp/state.npz")):
            fail(f"run_midas species --m8 ({dev}) wrote temp/state.npz")
    if launches != {"cuda": {"K1": -(-N_CPU_READS // 8192)}, "cpu": {}}:
        fail(f"run_midas species --m8 launched {launches}")
    _same_files(outs["cuda"], outs["cpu"], M8_OUTPUTS,
                "species --m8, card vs CPU")
    with open(os.path.join(outs["cuda"], M8_OUTPUTS[2]), "rb") as f:
        rows = f.read().count(b"\n")
    if rows < N_CPU_READS // 4:
        fail(f"run_midas species --m8 wrote {rows} m8 rows")
    emit("m8_cli", reads=N_CPU_READS, identical=True, m8_rows=rows,
         card_launches=launches["cuda"], seconds=secs, card=smi_line)
    return launches["cuda"]


# the merge_cli cohort: tests/conftest.py's sim_community and its
# three_samples mixtures (the third sample carries variants)
MERGE_CLI_DB = dict(n_species=3, genome_len=12000, gene_len=600,
                    n_extra_genes=4, related_pairs=1, divergence=0.03, seed=0)
MERGE_CLI_MIXES = ([0.5, 0.3, 0.15, 0.05], [0.2, 0.5, 0.2, 0.1],
                   [0.4, 0.4, 0.1, 0.1])


def _tree_bytes(root):
    """{path relative to root: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


MERGE_CLI_MERGES = (("species", []), ("genes", []), ("snps", []),
                    ("snps", ["--all_sites", "--all_samples"]))


def _merge_cli_set(dev, db, reads):
    """One device's half of phase merge_cli: the three samples through
    `run_midas species`, `genes`, `snps` on dev, then each merge of
    MERGE_CLI_MERGES over them. Returns ({merge index: merged tree},
    seconds, launches)."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.merge_midas import main as merge_midas
    from midas_tpu_torch.cli.run_midas import main as run_midas

    root = os.path.join(WORK, "merge_cli", dev)
    dirs = [os.path.join(root, f"sample{i}") for i in range(len(reads))]
    trees, secs = {}, {}
    cuda_sw.LAUNCHES.clear()
    t0 = time.time()
    for d, fq in zip(dirs, reads):
        base = [d, "-1", fq, "-d", db, "--device", dev]
        run_midas(["species", *base])
        run_midas(["genes", *base, "--species_cov", "0.1"])
        run_midas(["snps", *base, "--species_cov", "0.1"])
    secs[f"run_midas_{dev}"] = round(time.time() - t0, 2)
    launches = dict(cuda_sw.LAUNCHES)
    t0 = time.time()
    for mi, (program, flags) in enumerate(MERGE_CLI_MERGES):
        out = os.path.join(root, f"merged_{mi}_{program}")
        merge_midas([program, out, "-i", ",".join(dirs), "-t", "list",
                     "-d", db, *flags])
        trees[mi] = _tree_bytes(out)
    secs[f"merge_midas_{dev}"] = round(time.time() - t0, 2)
    return trees, secs, launches


def merge_cli_prepare():
    """The host half of phase merge_cli (run in the background worker):
    the community and the three samples' reads, then the CPU's half
    (_merge_cli_set)."""
    from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

    root = os.path.join(WORK, "merge_cli")
    comm = simulate_db(os.path.join(root, "db"), **MERGE_CLI_DB)
    reads = []
    for i, mix in enumerate(MERGE_CLI_MIXES):
        fq = os.path.join(root, f"reads{i}.fq.gz")
        simulate_reads(comm, fq, n_reads=N_CPU_READS, abundances=mix,
                       variant_rate=0.02 if i == 2 else 0.0,
                       error_rate=0.005 if i == 2 else 0.0, seed=10 + i)
        reads.append(fq)
    trees, secs, launches = _merge_cli_set("cpu", comm.db_dir, reads)
    return dict(db=comm.db_dir, reads=reads, trees=trees, seconds=secs,
                launches=launches)


def phase_merge_cli(prep, smi_line):
    """Three samples of a small community through `run_midas species`,
    `genes` and `snps` (2,048 reads each), on the card, and on the CPU
    in the background worker (merge_cli_prepare), then `merge_midas
    species`, `genes`, `snps` (the default --core_snps, and --all_sites
    --all_samples) over each set: the merged trees must be equal byte for
    byte. Returns the card runs' launches and {db, samples, genes}: the
    database, the card's sample directories and their merged genes
    tree."""
    db, reads = prep["db"], prep["reads"]
    cuda_trees, secs, card_launches = _merge_cli_set("cuda", db, reads)
    secs.update(prep["seconds"])
    launches = dict(cuda=card_launches, cpu=prep["launches"])
    if launches["cpu"] or not all(launches["cuda"].get(k)
                                  for k in ("K1", "K3_qpen", "K2")):
        fail(f"merge_cli's per-sample runs launched {launches}")
    files, rows = 0, {}
    for mi, (program, flags) in enumerate(MERGE_CLI_MERGES):
        a, b = cuda_trees[mi], prep["trees"][mi]
        if a != b:
            diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            fail(f"merge_midas {program} {flags}: card and CPU sample sets "
                 f"merge differently in {diff[:5]}")
        files += len(a)
        rows[" ".join([program, *flags])] = sum(
            v.count(b"\n") - 1 for k, v in a.items()
            if k.endswith(("count_reads.txt", "genes_copynum.txt",
                           "snps_freq.txt")))
    if not all(v for k, v in rows.items() if k != "snps"):
        fail(f"merge_cli merged no data: {rows}")
    emit("merge_cli", samples=3, reads_per_sample=N_CPU_READS,
         identical=True, merged_files=files, data_rows=rows,
         card_launches=launches["cuda"], seconds=secs, card=smi_line)
    root = os.path.join(WORK, "merge_cli", "cuda")
    genes = next(mi for mi, (program, _) in enumerate(MERGE_CLI_MERGES)
                 if program == "genes")
    return launches["cuda"], dict(
        db=db, samples=[os.path.join(root, f"sample{i}")
                        for i in range(len(reads))],
        genes=os.path.join(root, f"merged_{genes}_genes"))


# the merge_main cell: four samples of one of the repgenome-10sp cell's
# 3 Mb species at ~5.5x (163,840 x 100 bp reads each), the fourth with
# biological variants; merge_midas snps at its defaults (--core_snps,
# --sample_depth 5)
MERGE_SAMPLES, MERGE_READS = 4, 163840
MERGE_SIM = dict(read_len=100, error_rate=0.005, indel_rate=0.01)


def merge_main_simulate(gcomm):
    """merge_main's samples' reads (run in the background worker): (the
    FASTQ paths, seconds)."""
    from midas_tpu_torch.testkit.simulate import simulate_reads

    root = os.path.join(WORK, "merge_main")
    os.makedirs(root, exist_ok=True)
    abund = [1.0] + [0.0] * (len(gcomm.species) - 1)
    t0 = time.time()
    reads = []
    for i in range(MERGE_SAMPLES):
        fq = os.path.join(root, f"reads{i}.fq.gz")
        simulate_reads(gcomm, fq, n_reads=MERGE_READS, abundances=abund,
                       variant_rate=0.02 if i == MERGE_SAMPLES - 1 else 0.0,
                       seed=20 + i, **MERGE_SIM)
        reads.append(fq)
    return reads, time.time() - t0


def _read_snps_gz(path):
    """(lines without the header, [N, 5] int64 depth and A/C/G/T counts)
    of one .snps.gz file, parsed here without merge/snps.py."""
    import gzip

    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines[-1] != b"" or not lines[0].startswith(b"ref_id\t"):
        fail(f"{path}: not a .snps.gz table")
    lines = lines[1:-1]
    nums = np.fromstring(b"\t".join(ln.split(b"\t", 3)[3] for ln in lines),
                         sep="\t", dtype=np.int64)
    return lines, nums.reshape(len(lines), 5)


def _read_table(path):
    with open(path) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    return rows[0], rows[1:]


def snps_recount(sample_dirs, sp, sample_depth=5.0, fract_cov=0.4,
                 allele_freq=0.01, site_depth=1, site_ratio=2.0,
                 site_prev=0.95):
    """merge_midas snps' core-genome call at its default filters,
    recounted from the samples' .snps.gz files and summary.txt in plain
    numpy: the kept samples, then per site the pooled allele counts,
    major and minor allele (the larger count first, A/C/G/T order on
    ties), each sample's depth (major + minor reads) and the sites that
    pass. Returns a dict of the passing sites' fields."""
    kept, mean_cov = [], []
    for d in sample_dirs:
        head, rows = _read_table(os.path.join(d, "snps/summary.txt"))
        r = dict(zip(head, next(row for row in rows if row[0] == sp)))
        if (float(r["mean_coverage"]) >= sample_depth
                and float(r["fraction_covered"]) >= fract_cov):
            kept.append(d)
            mean_cov.append(float(r["mean_coverage"]))
    lines = None
    counts = []
    for d in kept:
        ls, nums = _read_snps_gz(os.path.join(d, "snps/output",
                                              f"{sp}.snps.gz"))
        if not np.array_equal(nums[:, 0], nums[:, 1:].sum(axis=1)):
            fail(f"{d}: depth is not the sum of the four counts")
        lines = lines if lines is not None else ls
        if len(ls) != len(lines):
            fail(f"{d}: {len(ls)} sites, not {len(lines)}")
        counts.append(nums[:, 1:])
    counts = np.stack(counts)                        # [S, N, 4]
    pooled = counts.sum(axis=0)                      # [N, 4]
    total = pooled.sum(axis=1)
    rows = np.arange(len(total))
    major = pooled.argmax(axis=1)                    # first of equal counts
    rest = pooled.copy()
    rest[rows, major] = -1
    minor = rest.argmax(axis=1)
    has_major = pooled[rows, major] > 0
    has_minor = pooled[rows, minor] > 0
    freq = pooled / np.maximum(total, 1)[:, None]
    n_alleles = ((freq >= allele_freq) & (total > 0)[:, None]).sum(axis=1)
    maj_n = counts[:, rows, major]
    min_n = np.where(has_minor[None, :], counts[:, rows, minor], 0)
    depth = np.where(has_major[None, :], maj_n + min_n, 0)   # [S, N]
    ok = (depth >= site_depth) & (
        depth / np.asarray(mean_cov)[:, None] <= site_ratio)
    count_samples = ok.sum(axis=0)
    passing = (count_samples / len(kept) >= site_prev) & (n_alleles == 2)
    idx = np.flatnonzero(passing)
    return dict(samples=[os.path.basename(d) for d in kept],
                site_id=idx + 1, major=major[idx], minor=minor[idx],
                pooled=pooled[idx], depth=depth[:, idx],
                count_samples=count_samples[idx],
                ref=[lines[i].split(b"\t", 2)[:2] for i in idx],
                n_sites=len(lines))


def _check_merged_snps(merged_sp_dir, want):
    """Fail unless merge_midas snps' snps_info.txt and snps_depth.txt
    hold the recount's sites, alleles, pooled counts and depths."""
    head, info = _read_table(os.path.join(merged_sp_dir, "snps_info.txt"))
    dhead, depth = _read_table(os.path.join(merged_sp_dir, "snps_depth.txt"))
    if dhead[1:] != want["samples"]:
        fail(f"merged samples {dhead[1:]} != recount's {want['samples']}")
    col = {h: i for i, h in enumerate(head)}
    got = dict(
        site_id=np.array([int(r[0]) for r in info], dtype=np.int64),
        major=np.array(["ACGT".index(r[col["major_allele"]]) for r in info]),
        minor=np.array(["ACGT".index(r[col["minor_allele"]]) for r in info]),
        pooled=np.array([[int(r[col[f"count_{a}"]]) for a in "acgt"]
                         for r in info], dtype=np.int64).reshape(-1, 4),
        count_samples=np.array([int(r[col["count_samples"]]) for r in info]),
        depth=np.array([[int(x) for x in r[1:]] for r in depth],
                       dtype=np.int64).reshape(-1, len(dhead) - 1).T,
        ref=[[r[col["ref_id"]].encode(), r[col["ref_pos"]].encode()]
             for r in info])
    if [int(r[0]) for r in depth] != list(got["site_id"]):
        fail("snps_depth.txt and snps_info.txt list different sites")
    for k in ("site_id", "major", "minor", "pooled", "count_samples",
              "depth"):
        if not np.array_equal(got[k], want[k]):
            fail(f"merged snps differ from the numpy recount in {k} "
                 f"({len(got['site_id'])} sites merged, "
                 f"{len(want['site_id'])} recounted)")
    if got["ref"] != want["ref"]:
        fail("merged snps differ from the numpy recount in ref_id/ref_pos")


def phase_merge_main(gcomm, sim, smi_line):
    """merge_midas snps at a user's scale: four samples of the
    repgenome-10sp cell's first species (3 Mb; sim: merge_main_simulate's
    result), each through `run_midas
    snps --species_id <sp>` on the card, then `merge_midas snps` at its
    defaults, checked against snps_recount. Emits each stage's seconds
    and the merge's seconds per million sites. Returns the per-sample
    runs' launches and the merged species directory."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.merge_midas import main as merge_midas
    from midas_tpu_torch.cli.run_midas import main as run_midas

    root = os.path.join(WORK, "merge_main")
    sp = gcomm.species[0].species_id
    reads, t_sim = sim
    secs = dict(simulate_in_background=t_sim)
    dirs = [os.path.join(root, f"sample{i}") for i in range(MERGE_SAMPLES)]
    cuda_sw.LAUNCHES.clear()
    run_s = []
    for d, fq in zip(dirs, reads):
        t0 = time.time()
        run_midas(["snps", d, "-1", fq, "-d", gcomm.db_dir, "--species_id",
                   sp])
        run_s.append(time.time() - t0)
    launches = dict(cuda_sw.LAUNCHES)
    n_b = MERGE_SAMPLES * -(-MERGE_READS // BATCH)
    if launches != {"K3_qpen": n_b, "K2": n_b}:
        fail(f"merge_main's run_midas snps launched {launches} for {n_b} "
             "batches")
    secs["run_midas_snps"] = run_s
    merged = os.path.join(root, "merged")
    t0 = time.time()
    merge_midas(["snps", merged, "-i", ",".join(dirs), "-t", "list",
                 "-d", gcomm.db_dir])
    secs["merge_midas_snps"] = time.time() - t0
    t0 = time.time()
    want = snps_recount(dirs, sp)
    secs["recount"] = time.time() - t0
    if len(want["samples"]) != MERGE_SAMPLES or len(want["site_id"]) == 0:
        fail(f"merge_main: the recount keeps {len(want['samples'])} samples "
             f"and {len(want['site_id'])} sites")
    _check_merged_snps(os.path.join(merged, sp), want)
    head, rows = _read_table(os.path.join(merged, sp, "snps_summary.txt"))
    emit("merge_main", species=sp, samples=MERGE_SAMPLES,
         reads_per_sample=MERGE_READS, genome_sites=want["n_sites"],
         coverage=[float(r[head.index("mean_coverage")]) for r in rows],
         merged_sites=len(want["site_id"]), equal_to_recount=True,
         banded_sw_launches=launches, seconds=secs,
         merge_seconds_per_million_sites=secs["merge_midas_snps"]
         / (want["n_sites"] / 1e6), card=smi_line)
    return launches, os.path.join(merged, sp)


def consensus_recount(merged_sp_dir, site_depth=2):
    """call_consensus at its defaults, recounted in numpy from the merged
    snps_info / snps_freq / snps_depth tables: every site with an A/C/G/T
    reference allele; per sample '-' below site_depth reads, else the
    minor allele where its frequency is >= 0.5 and the major allele
    elsewhere. Returns {sample: consensus}."""
    head, info = _read_table(os.path.join(merged_sp_dir, "snps_info.txt"))
    fhead, freq = _read_table(os.path.join(merged_sp_dir, "snps_freq.txt"))
    dhead, depth = _read_table(os.path.join(merged_sp_dir, "snps_depth.txt"))
    col = {h: i for i, h in enumerate(head)}
    ids = [r[0] for r in info]
    if [r[0] for r in freq] != ids or [r[0] for r in depth] != ids \
            or fhead != dhead:
        fail("merged snps_info / freq / depth list different sites")
    keep = np.array([r[col["ref_allele"]] in ("A", "C", "G", "T")
                     for r in info], dtype=bool)
    major = np.array([r[col["major_allele"]] for r in info])[keep]
    minor = np.array([r[col["minor_allele"]] for r in info])[keep]
    f = np.array([r[1:] for r in freq], dtype=np.float64).reshape(
        len(ids), -1)[keep]
    d = np.array([r[1:] for r in depth], dtype=np.int64).reshape(
        len(ids), -1)[keep]
    return {s: "".join(np.where(d[:, j] >= site_depth,
                                np.where(f[:, j] >= 0.5, minor, major), "-"))
            for j, s in enumerate(fhead[1:])}


def _analysis(tool, argv):
    """`python -m midas_tpu_torch.cli.analysis <tool> argv...` as a user
    runs it; returns its wall seconds."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.analysis", tool, *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"analysis {tool} {argv}: {proc.stderr[-2000:]}")
    return time.perf_counter() - t


def phase_analysis_main(snps_dir, cli, smi_line):
    """The five analysis tools through `python -m
    midas_tpu_torch.cli.analysis`: call_consensus, snp_diversity
    (per-sample and pooled-samples) and strain_tracking (id_markers, then
    track_markers, at --min_reads 1) over merge_main's merged snps
    species directory (four 3 Mb samples at ~5.5x, its default filters);
    compare_genes (presabs / jaccard and copynum / euclidean) and
    query_by_compound over merge_cli's card samples, merged genes and a
    copy of its database whose centroid_functions name two genes with
    the enzymes of one compound of the packaged KEGG table; four tools
    at a time, each in its own process. The consensus FASTA is checked
    against consensus_recount, the other tables for their rows. Emits
    each tool's seconds and seconds per million merged sites."""
    import gzip

    from midas_tpu_torch.analyze.query_compound import (
        load_cpd_to_enzyme, packaged_cpd_to_enzyme)

    root = os.path.join(WORK, "analysis")
    os.makedirs(root, exist_ok=True)
    n_sites = len(_read_table(os.path.join(snps_dir, "snps_info.txt"))[1])
    n_samples = len(_read_table(os.path.join(snps_dir, "snps_summary.txt"))[1])
    if not n_sites:
        fail(f"analysis_main: {snps_dir} holds no merged sites")
    out = {k: os.path.join(root, k) for k in (
        "consensus.fa", "pi_per_sample.txt", "pi_pooled.txt", "markers.txt",
        "sharing.txt", "genes_jaccard.txt", "genes_euclidean.txt",
        "compound.txt")}
    sp0 = min(d for d in os.listdir(cli["genes"])
              if os.path.isdir(os.path.join(cli["genes"], d)))
    genes_dir = os.path.join(cli["genes"], sp0)
    n_genes = len(_read_table(os.path.join(genes_dir,
                                           "genes_copynum.txt"))[1])
    db = os.path.join(root, "db")
    shutil.rmtree(db, ignore_errors=True)
    shutil.copytree(cli["db"], db)
    table = load_cpd_to_enzyme(packaged_cpd_to_enzyme())
    compound = next(c for c, e in sorted(table.items()) if len(e) >= 2)
    genes = [r[0] for r in _read_table(os.path.join(
        genes_dir, "genes_copynum.txt"))[1][:2]]
    with gzip.open(os.path.join(db, "pan_genomes", sp0,
                                "centroid_functions.txt.gz"), "wt") as f:
        f.write("gene_id\tfunction_id\tontology\n")
        for g, e in zip(genes, table[compound]):
            f.write(f"{g}\t{e}\tec\n")

    # (name, tool, argv) steps; the steps of one job run in order, the
    # jobs four at a time. --min_reads 1: the simulator's variants are
    # per read, so at ~5.5x an allele seldom has the default 3 reads in
    # one sample
    jobs = [
        [("call_consensus", "call_consensus",
          [snps_dir, "--out", out["consensus.fa"]])],
        [("snp_diversity_per_sample", "snp_diversity",
          [snps_dir, "--out", out["pi_per_sample.txt"]])],
        [("snp_diversity_pooled", "snp_diversity",
          [snps_dir, "--sample_type", "pooled-samples", "--out",
           out["pi_pooled.txt"]])],
        [("strain_tracking_id_markers", "strain_tracking",
          ["id_markers", snps_dir, "--min_reads", "1", "--out",
           out["markers.txt"]]),
         ("strain_tracking_track_markers", "strain_tracking",
          ["track_markers", snps_dir, "--min_reads", "1", "--out",
           out["sharing.txt"], "--markers", out["markers.txt"]])],
        [("compare_genes_jaccard", "compare_genes",
          [genes_dir, "--dtype", "presabs", "--distance", "jaccard",
           "--out", out["genes_jaccard.txt"]]),
         ("compare_genes_euclidean", "compare_genes",
          [genes_dir, "--distance", "euclidean", "--out",
           out["genes_euclidean.txt"]]),
         ("query_by_compound", "query_by_compound",
          ["-i", ",".join(cli["samples"]), "-t", "list", "-d", db, "-c",
           compound, "-o", out["compound.txt"]])],
    ]
    secs = {}
    with ThreadPoolExecutor(4) as ex:
        for done in ex.map(lambda steps: {name: _analysis(tool, argv)
                                          for name, tool, argv in steps},
                           jobs):
            secs.update(done)

    # checks: the consensus against the numpy recount, the rest by rows
    with open(out["consensus.fa"]) as f:
        fa = f.read().split("\n")
    got = {h[1:].split("\t")[0]: s for h, s in zip(fa[0:-1:2], fa[1::2])}
    want = consensus_recount(snps_dir)
    if got != want or len(next(iter(want.values()))) == 0:
        fail(f"call_consensus differs from the numpy recount "
             f"({ {k: len(v) for k, v in got.items()} } vs "
             f"{ {k: len(v) for k, v in want.items()} } bases)")
    rows = {k: len(_read_table(p)[1]) for k, p in out.items()
            if k != "consensus.fa"}
    pairs = n_samples * (n_samples - 1) // 2
    if rows["pi_per_sample.txt"] != n_samples or rows["pi_pooled.txt"] != 1 \
            or rows["sharing.txt"] != pairs \
            or rows["genes_jaccard.txt"] != 3 \
            or rows["genes_euclidean.txt"] != 3 \
            or not rows["compound.txt"]:
        fail(f"analysis_main: unexpected table rows {rows}")
    snps_tools = [k for k in secs if not k.startswith(("compare",
                                                       "query"))]
    emit("analysis_main", merged_sites=n_sites, samples=n_samples,
         consensus_equals_recount=True,
         consensus_bases=len(next(iter(want.values()))),
         genes_species=sp0, genes=n_genes, compound=compound, rows=rows,
         seconds=secs, max_sites=None,
         seconds_per_million_sites={k: secs[k] / (n_sites / 1e6)
                                    for k in snps_tools},
         card=smi_line)


def phase_genes_data():
    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

    t0 = time.time()
    comm = simulate_db(os.path.join(WORK, "genes_db"), **GENES_DB)
    fq = os.path.join(WORK, "genes_reads.fq.gz")
    simulate_reads(comm, fq, n_reads=N_GENES_READS, read_len=100,
                   error_rate=0.005, indel_rate=0.01, seed=8,
                   abundances=_first_n_abundances(comm, N_GENES_SPECIES))
    t_sim = time.time() - t0
    t0 = time.time()
    ids = [sp.species_id for sp in comm.species[:N_GENES_SPECIES]]
    prof = GenesProfiler(Database(comm.db_dir), ids, device="cuda")
    t_prof = time.time() - t0
    al = prof.aligner
    idx_bytes = sum(t.numel() * t.element_size()
                    for d in (al.index_arrays, al.pack_arrays)
                    for t in d.values())
    emit("genes_data", species=N_GENES_SPECIES, centroids=prof.pack.num_seqs,
         pangenome_pack_mb=round(prof.pack.total_len / 1e6, 2),
         index_on_card_mb=round(idx_bytes / 2**20, 1), reads=N_GENES_READS,
         simulate_seconds=round(t_sim, 1),
         profiler_setup_seconds=round(t_prof, 1))
    return comm, fq, prof


def _first_n_abundances(comm, n):
    """Equal abundances for the first n species of comm, 0 for the rest."""
    return [1.0 / n] * n + [0.0] * (len(comm.species) - n)


def _first_batch(al, fq, fields, batch_size=BATCH):
    """The first batch of fq on the aligner's device, as the main path
    uploads it: single-end reads, or mate pairs (rows 2i / 2i+1) when
    fq is a tuple (-1, -2)."""
    import torch

    from midas_tpu_torch.io.batch import load_paired_batches, load_read_batches

    if isinstance(fq, tuple):
        batches = load_paired_batches(*fq, batch_size=batch_size,
                                      max_len=al.max_read_len)
    else:
        batches = load_read_batches([fq], batch_size=batch_size,
                                    max_len=al.max_read_len)
    b = next(iter(batches))
    return b, [torch.from_numpy(getattr(b, f)).to(al.device) for f in fields]


def pair_decisions(prof, reads, batch_size=BATCH):
    """On the first paired batch, on the profiler's device: the share of
    its real pairs that have a concordant candidate pair (has_pair of
    device_steps.paired_best_hit_device), and the real reads whose
    candidate or MAPQ the mate-pair pick changes against the per-read
    best hit (best_hit_device) on the same pass-1 table."""
    import torch

    from midas_tpu_torch.align.pipeline import align_candidates_score
    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    b, (codes, quals, qlens) = _first_batch(
        al, reads, ("codes", "quals", "lengths"), batch_size)
    out1, _ = align_candidates_score(
        al.index_arrays, al.pack_arrays, codes, qlens, al.scoring,
        al.seed_params, al.max_read_len, quals=quals)
    table = torch.from_numpy(ds.score_min_table(
        al.scoring, al.max_read_len)).to(al.device)
    n = b.n_reads
    has_pair = ds.concordant_pairs(out1, qlens, al.scoring, table)[0]
    _, pcol, pmapq = ds.paired_best_hit_device(out1, qlens, al.scoring,
                                               table)
    _, ucol, umapq = ds.best_hit_device(out1, qlens, al.scoring, table)
    return dict(concordant_share=float(has_pair[: n // 2].double().mean()),
                moved_best_col=int((pcol != ucol)[:n].sum()),
                moved_mapq=int((pmapq != umapq)[:n].sum()), reads=n)


def _genes_step(prof, scoring, b, arrays, state=None, paired=False):
    """One genes_update of batch b under `scoring` (returns its state)."""
    import torch

    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    G = prof.pack.num_seqs
    table = torch.from_numpy(ds.score_min_table(scoring,
                                                al.max_read_len)).cuda()
    state = state or ds.genes_init(G, "cuda")
    codes, quals, lengths, mean_qual = arrays
    return ds.genes_update(
        state, al.index_arrays, al.pack_arrays, G, codes, quals, lengths,
        mean_qual, b.n_reads, scoring=scoring, seed_params=al.seed_params,
        max_len=al.max_read_len, mapid=float(prof.mapid),
        readq=float(prof.readq), min_mapq=int(prof.mapq),
        aln_cov=float(prof.aln_cov), smin_table=table, paired=paired)


def _captured_dp_calls(fn):
    """Run fn() with the kernel wrapper recording the inputs of every
    launch: [(args, kwargs)], in launch order."""
    from midas_tpu_torch.align import cuda_sw

    real = cuda_sw.banded_align_cuda
    calls = []

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    cuda_sw.banded_align_cuda = record
    try:
        fn()
    finally:
        cuda_sw.banded_align_cuda = real
    return calls


def _two_pass_variants(step, sname, sc, path, layout, phase):
    """Run one two-pass step (step()) with the DP launches captured:
    pass 1 must be K3 with qpen and pass 2 K2; each is held to the plain
    version on its captured inputs (_check_variant, shapes "<path> pass
    1" / "<path> pass 2"), and K3 to K2 on the fields both compute.
    Emits `phase` per variant; returns the two records."""
    import torch

    from midas_tpu_torch.align import cuda_sw

    calls = _captured_dp_calls(step)
    if len(calls) != 2:
        fail(f"{path} ({sname}) launched the DP {len(calls)} times, not "
             "twice")
    (p1, k1), (p2, k2) = calls
    if not (k1["score_only"] and k1["qpen"] is not None
            and not k2["score_only"] and k2["qpen"] is not None):
        fail(f"{path} ({sname}) did not run K3 with qpen, then K2")
    v3 = _check_variant("K3", sname, sc, *p1[:3], k1["qpen"], True,
                        layout, shape=f"{path} pass 1")
    v2 = _check_variant("K2", sname, sc, *p2[:3], k2["qpen"], False,
                        layout, shape=f"{path} pass 2")
    # K3 agrees with K2 on the fields both compute, on pass 1's pairs
    full = cuda_sw.banded_align_cuda(*p1[:3], sc, qpen=k1["qpen"])
    k3_out = v3.pop("_out")
    v2.pop("_out")
    for k in k3_out:
        if not torch.equal(k3_out[k], full[k]):
            fail(f"K3 and K2 differ in {k} ({sname}, {path} pass 1)")
    v3["equal_to_k2"] = True
    for v in (v3, v2):
        emit(phase, **v)
    return [v3, v2]


def phase_genes_kernels(prof, fq):
    """K3 (pass 1) and K2 (pass 2) at the genes path's shapes."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING

    b, arrays = _first_batch(prof.aligner, fq,
                             ("codes", "quals", "lengths", "mean_qual"))
    layout = cuda_sw.packed_layout()
    variants = []
    for sname, sc in (("local", LOCAL_SCORING), ("global", GLOBAL_SCORING)):
        variants += _two_pass_variants(
            lambda: _genes_step(prof, sc, b, arrays), sname, sc, "genes",
            layout, "genes_kernels")
    return variants


def phase_genes_main(comm, prof, fq):
    import torch

    from midas_tpu_torch.align import cuda_sw

    prof.run([fq], max_reads=BATCH, batch_size=BATCH)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_batches = -(-N_GENES_READS // BATCH)
    cuda_sw.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = prof.run([fq], batch_size=BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_sw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches != {"K3_qpen": n_batches, "K2": n_batches}:
        fail(f"genes path launched banded_sw {launches} for {n_batches} "
             "batches (want K3 with qpen and K2, once each per batch)")

    per_species = _genes_truth(comm, prof, res)
    prof.write_results(os.path.join(WORK, "genes_main"))
    step_ms, stages = _genes_device_step(prof, fq)
    emit("genes_main", reads=N_GENES_READS, batch=BATCH, batches=n_batches,
         seconds=dt, reads_per_sec=N_GENES_READS / dt,
         banded_sw_launches=launches, device_step_ms=step_ms,
         device_busy_share=step_ms * n_batches / 1e3 / dt, stage_ms=stages,
         max_memory_allocated=peak,
         aligned_reads=int(res["aligned_reads"].sum()),
         mapped_reads=int(res["mapped_reads"].sum()),
         truth=per_species)
    return launches


def _genes_truth(comm, prof, res):
    """The repo's own check (tests/test_genes_snps.py::test_genes_outputs):
    the simulator's truth. Genome genes of a selected species sit near
    copy number 1; pangenome-only genes get no reads at all. Returns the
    per-species figures."""
    name_idx = {n: i for i, n in enumerate(prof.pack.names)}
    per_species = []
    for si, sp in enumerate(comm.species[:N_GENES_SPECIES]):
        on = np.array([name_idx[g["gene_id"]] for g in sp.genes
                       if g["scaffold_id"] is not None])
        off = np.array([name_idx[g["gene_id"]] for g in sp.genes
                        if g["scaffold_id"] is None])
        med = float(np.median(res["copies"][on]))
        mapped = int(res["mapped_reads"][prof.gene_species == si].sum())
        if not np.isfinite(res["copies"]).all():
            fail("non-finite copy numbers")
        if not 0.5 < med < 2.0 or mapped == 0 or res["depth"][off].any():
            fail(f"genes disagree with the truth for {sp.species_id}: "
                 f"median copy number {med}, mapped reads {mapped}, "
                 f"{int((res['depth'][off] > 0).sum())} pangenome-only "
                 "genes covered")
        per_species.append(dict(species=sp.species_id, median_copies=med,
                                mapped_reads=mapped,
                                marker_cov=float(res["marker_cov"][si])))
    return per_species


def _pick_stage(out1, qlens, sc, table, paired):
    """(stage name, ms, best_col) of the best-hit step on pass 1's
    table: best_hit_device, or with paired the mate-pair pick
    paired_best_hit_device."""
    from midas_tpu_torch.profile import device_steps as ds

    pick = ds.paired_best_hit_device if paired else ds.best_hit_device
    ms, (_, best_col, _) = cuda_ms(lambda: pick(out1, qlens, sc, table), 5)
    return ("pair_pick" if paired else "best_hit_mapq"), ms, best_col


def _genes_device_step(prof, fq):
    """Mean device ms of genes_update on one batch, and a per-stage
    breakdown of the same work, by CUDA events. Stages without a call of
    their own are differences of two timed calls. fq a tuple (-1, -2):
    the first batch of mate pairs, through the paired step."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.align.seed import find_candidates, gather_windows_packed
    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    sp, sc = al.seed_params, al.scoring
    paired = isinstance(fq, tuple)
    b, arrays = _first_batch(al, fq, ("codes", "quals", "lengths",
                                      "mean_qual"))
    codes, quals, qlens, mean_qual = arrays
    state = ds.genes_init(prof.pack.num_seqs, "cuda")
    step_ms, _ = cuda_ms(lambda: _genes_step(prof, sc, b, arrays, state,
                                             paired), 5)
    (p1, k1), (p2, k2) = _captured_dp_calls(
        lambda: _genes_step(prof, sc, b, arrays, paired=paired))
    D, L = sp.band_width, codes.shape[1]
    table = torch.from_numpy(ds.score_min_table(sc, al.max_read_len)).cuda()
    r = {}
    r["seed"], c = cuda_ms(lambda: find_candidates(
        al.index_arrays, codes, qlens, sp, al.max_read_len), 5)
    r["window_gather"], _ = cuda_ms(lambda: gather_windows_packed(
        al.pack_arrays["words"], al.pack_arrays["nmask"],
        al.pack_arrays["offsets"], c["diag"] - D // 2, L + D - 1,
        center=c["diag"] + qlens[:, None] // 2), 5)
    r["k3"], _ = cuda_ms(lambda: cuda_sw.banded_align_cuda(*p1, **k1), 5)
    pass1_ms, (out1, aux) = cuda_ms(lambda: pl.align_candidates_score(
        al.index_arrays, al.pack_arrays, codes, qlens, sc, sp,
        al.max_read_len, quals=quals), 5)
    r["pair_prep_and_dedup"] = pass1_ms - r["seed"] - r["window_gather"] \
        - r["k3"]
    pick, r[pick], best_col = _pick_stage(out1, qlens, sc, table, paired)
    r["k2"], _ = cuda_ms(lambda: cuda_sw.banded_align_cuda(*p2, **k2), 5)
    pass2_ms, _ = cuda_ms(lambda: pl.align_chosen_full(
        al.pack_arrays, aux, codes, qlens, best_col, sc, sp), 5)
    r["pass2_gather"] = pass2_ms - r["k2"]
    r["keep_and_scatter"] = step_ms - pass1_ms - r[pick] - pass2_ms
    return step_ms, r


def _same_genes_outputs(a, b, what):
    """Fail unless two genes output directories hold the same
    summary.txt, decompressed .genes.gz files and saved state."""
    _same_files(a, b, ["genes/summary.txt", "genes/species.txt"] + sorted(
        os.path.join("genes/output", n)
        for n in os.listdir(os.path.join(a, "genes/output"))), what)
    keys, za = _same_state(os.path.join(a, "genes/temp/state.npz"),
                           os.path.join(b, "genes/temp/state.npz"),
                           f"{what}: GenesState")
    return keys, int(za["mapped_reads"][:-1].sum())   # without the dump row


def _same_state(a, b, what):
    """Fail unless two saved states hold the same fields, dtypes and
    values. Returns (field names, the first state)."""
    za, zb = np.load(a), np.load(b)
    keys = sorted(k for k in za.files if k != "__meta__")
    if keys != sorted(k for k in zb.files if k != "__meta__"):
        fail(f"{what}: the states hold different fields")
    for k in keys:
        if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k]):
            fail(f"{what} differs in {k}")
    return keys, za


def phase_genes_cpu(comm, fq):
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas

    ids = ",".join(sp.species_id for sp in comm.species[:N_GENES_CPU_SPECIES])
    result = {}
    for mode in ("local", "global"):
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(WORK, f"genes_cli_{mode}_{dev}")
            cuda_sw.LAUNCHES.clear()
            t0 = time.time()
            run_midas(["genes", out, "-1", fq, "-d", comm.db_dir,
                       "-n", str(N_CPU_READS), "--species_id", ids,
                       "-m", mode, "--device", dev])
            secs[dev] = round(time.time() - t0, 2)
            outs[dev] = out
            if dev == "cuda":
                card_launches = dict(cuda_sw.LAUNCHES)
            elif cuda_sw.LAUNCHES:
                fail("the CPU run launched the kernel")
        n_b = -(-N_CPU_READS // 8192)
        if card_launches != {"K3_qpen": n_b, "K2": n_b}:
            fail(f"genes -m {mode} on the card launched {card_launches}")
        keys, mapped = _same_genes_outputs(outs["cuda"], outs["cpu"],
                                           f"genes -m {mode}, card vs CPU")
        result[mode] = dict(identical=True, state_fields=keys,
                            mapped_reads=mapped, card_launches=card_launches,
                            card_seconds=secs["cuda"], cpu_seconds=secs["cpu"])
    emit("genes_cpu", reads=N_CPU_READS, species=N_GENES_CPU_SPECIES,
         **result)
    return result


def phase_snps_data(gcomm):
    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.profile.snps import SnpsProfiler

    t0 = time.time()
    ids = [sp.species_id for sp in gcomm.species[:N_GENES_SPECIES]]
    prof = SnpsProfiler(Database(gcomm.db_dir), ids, device="cuda")
    t_prof = time.time() - t0
    al = prof.aligner
    idx_bytes = sum(t.numel() * t.element_size()
                    for d in (al.index_arrays, al.pack_arrays)
                    for t in d.values())
    G = prof.pack.total_len
    emit("snps_data", species=len(ids), contigs=prof.pack.num_seqs,
         genome_mb=G / 1e6, index_on_card_mib=idx_bytes / 2**20,
         counts_bytes=4 * (G + 1) * 4, reads=N_GENES_READS,
         coverage=N_GENES_READS * 100 / G,
         profiler_setup_seconds=round(t_prof, 1))
    return prof


def _snps_step(prof, scoring, b, arrays, state=None, paired=False):
    """One snps_update of batch b under `scoring` (returns its state)."""
    import torch

    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    table = torch.from_numpy(ds.score_min_table(scoring,
                                                al.max_read_len)).cuda()
    if state is None:
        state = ds.snps_init(prof.pack.total_len, len(prof.species_ids),
                             2 * BATCH, al.max_read_len, "cuda")
    contig_species = torch.from_numpy(
        prof.contig_species.astype(np.int64)).cuda()
    codes, quals, lengths, mean_qual = arrays
    return ds.snps_update(
        state, al.index_arrays, al.pack_arrays, contig_species, codes,
        quals, lengths, mean_qual, b.n_reads, scoring=scoring,
        seed_params=al.seed_params, max_len=al.max_read_len,
        mapid=float(prof.mapid), readq=float(prof.readq),
        min_mapq=int(prof.mapq), baseq=int(prof.baseq),
        aln_cov=float(prof.aln_cov), smin_table=table, paired=paired)


def phase_snps_kernels(prof, fq):
    """K3 with qpen (pass 1) and K2 (pass 2) at the snps path's shapes,
    GLOBAL (the path's default) and LOCAL."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING

    b, arrays = _first_batch(prof.aligner, fq,
                             ("codes", "quals", "lengths", "mean_qual"))
    layout = cuda_sw.packed_layout()
    variants = []
    for sname, sc in (("global", GLOBAL_SCORING), ("local", LOCAL_SCORING)):
        variants += _two_pass_variants(
            lambda: _snps_step(prof, sc, b, arrays), sname, sc, "snps",
            layout, "snps_kernels")
    return variants


def _paired_variants(prof, reads, step_fn, path):
    """K3 with qpen and K2 on the first paired batch's DP inputs, under
    the profiler's scoring (the paired path's own), as the kernels
    phases check them: emitted as `<path>_kernels`."""
    from midas_tpu_torch.align import cuda_sw

    sc = prof.aligner.scoring
    b, arrays = _first_batch(prof.aligner, reads,
                             ("codes", "quals", "lengths", "mean_qual"))
    return _two_pass_variants(
        lambda: step_fn(prof, sc, b, arrays, paired=True),
        "local" if sc.mode == "local" else "global", sc,
        path.replace("_", " "), cuda_sw.packed_layout(), f"{path}_kernels")


def phase_snps_main(gcomm, prof, fq):
    """SnpsProfiler.run over the snps cell's reads (_snps_cell). Returns
    (launches, the run's result, for phase readback)."""
    launches, _, res = _snps_cell(gcomm, prof, fq, "snps_main")
    return launches, res


def phase_paired_snps_main(gcomm, prof, reads, smi_line):
    """SnpsProfiler.run over the paired cell's mate pairs (-1, -2), as
    run_snps calls it: snps_main's checks and figures, with the pair
    pick, the concordant share and K3 / K2 held to the plain version on
    the first paired batch. Returns (launches, variant records)."""
    return _snps_cell(gcomm, prof, reads, "paired_snps_main", smi_line)[:2]


def _snps_cell(gcomm, prof, fq, phase, smi_line=None):
    """One snps cell: SnpsProfiler.run with a checkpoint path over fq
    (single-end reads, or a tuple (-1, -2) of mate pairs), checked
    against the simulator's truth; emits `phase` and returns the run's
    kernel launches, (paired) the first batch's variant records and the
    run's result."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.profile import checkpoint as ckpt

    paired = isinstance(fq, tuple)
    paths = list(fq) if paired else [fq]
    n_reads = 2 * N_PAIRS if paired else N_GENES_READS
    prof.run(paths, max_reads=BATCH // 2 if paired else BATCH,
             batch_size=BATCH, paired=paired)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_batches = -(-n_reads // BATCH)
    finalize_s = []
    real_finalize = prof._finalize

    def timed_finalize(host):
        t = time.perf_counter()
        out = real_finalize(host)
        finalize_s.append(time.perf_counter() - t)
        return out

    save_s = []
    real_save = ckpt.save

    def timed_save(*a, **k):
        t = time.perf_counter()
        real_save(*a, **k)
        save_s.append(time.perf_counter() - t)

    prof._finalize = timed_finalize
    ckpt.save = timed_save
    # run_snps's arguments: the state is saved at the end of the stream
    state_path = os.path.join(WORK, phase, "state.npz")
    cuda_sw.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = prof.run(paths, batch_size=BATCH, checkpoint_path=state_path,
                   paired=paired)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del prof._finalize
    ckpt.save = real_save
    if len(save_s) != 1:
        fail(f"{phase} saved its state {len(save_s)} times (want 1)")
    launches = dict(cuda_sw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches != {"K3_qpen": n_batches, "K2": n_batches}:
        fail(f"{phase} launched banded_sw {launches} for {n_batches} "
             "batches (want K3 with qpen and K2, once each per batch)")

    # the repo's own check (tests/test_genes_snps.py:54-103): the
    # simulator's truth
    counts = res["counts"]
    pack = prof.pack
    G = pack.total_len
    depth = counts.sum(axis=0)
    for si, sp in enumerate(gcomm.species[:N_GENES_SPECIES]):
        got_len = int(pack.lengths[prof.contig_species == si].sum())
        want_len = sum(len(c) for c in sp.contigs.values())
        if got_len != want_len or res["mapped_reads"][si] <= 0:
            fail(f"snps disagree with the truth for {sp.species_id}: "
                 f"genome length {got_len} (want {want_len}), "
                 f"mapped reads {res['mapped_reads'][si]}")
    deep = depth >= 3
    modal = counts[:, deep].argmax(axis=0)
    agree = float((modal == pack.codes[:G][deep]).mean())
    if deep.sum() < 1000 or agree < 0.99:
        fail(f"modal allele equals the reference at {agree:.4f} of "
             f"{int(deep.sum())} sites with depth >= 3")
    # one species' sites file (the writer is host work outside reads/s)
    t = time.perf_counter()
    path = prof.write_sites(os.path.join(WORK, phase), 0, depth)
    write_s = time.perf_counter() - t
    sites = _check_sites_file(path, counts, pack, prof.contig_species, 0)
    extra, variants = {}, []
    if paired:
        dec = pair_decisions(prof, fq)
        _check_concordant_share(phase, dec, "snps")
        extra = dict(pairs=n_reads // 2, pairs_per_sec=n_reads / 2 / dt,
                     first_batch=dec, card=smi_line)
        variants = _paired_variants(prof, fq, _snps_step, "paired_snps")
    step_ms, stages = _snps_device_step(prof, fq)
    emit(phase, reads=n_reads, batch=BATCH, batches=n_batches,
         seconds=dt, reads_per_sec=n_reads / dt,
         banded_sw_launches=launches, device_step_ms=step_ms,
         device_busy_share=step_ms * n_batches / 1e3 / dt, stage_ms=stages,
         max_memory_allocated=peak, gapped_rows=int(res["n_gapped"]),
         finalize_host_seconds=finalize_s[0],
         checkpoint_save_seconds=save_s[0],
         checkpoint_bytes=os.path.getsize(state_path),
         aligned_reads=int(res["aligned_reads"].sum()),
         mapped_reads=int(res["mapped_reads"].sum()),
         sites_depth_ge3=int(deep.sum()), modal_equals_reference=agree,
         covered_sites=int((depth > 0).sum()),
         writer_sites=sites, writer_seconds=write_s,
         writer_seconds_per_million_sites=write_s / (sites / 1e6), **extra)
    return launches, variants, res


# the pileup's dump slot (flat index G) as the readback finds it: the
# bases the stream discarded; every route must zero it
READBACK_JUNK = 1 << 20
# counts_host_sparse may take this much longer than the whole int32 copy
# (its statistics pass, ~2% of the copy at 30 Mb, and the spread of the
# host's clock between best-of-3 times)
READBACK_SLACK = 1.15
# the thinned counts keep every READBACK_THIN-th covered run
READBACK_THIN = 16


def _timed(fn, n=3):
    """(seconds of each of n calls, each between card synchronisations;
    the last call's result)."""
    import torch

    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return secs, out


def _pinned_host(t):
    """sparse_counts._host through a pinned buffer and a non_blocking
    copy, synchronised before numpy sees the buffer (the alternative the
    readback phase measures)."""
    import torch

    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf.numpy()


def _fill_host(n):
    """A fresh zeroed int32 host array of n entries, one entry of every
    4 KiB page written (the sparse decode's output before its sites)."""
    out = np.zeros(n, np.int32)
    out[::1024] = 1
    return out


def _thin_runs(full, G):
    """[4, G+1] counts with only every READBACK_THIN-th covered run kept."""
    covered = full[:, :G].any(axis=0)
    start = covered & ~np.concatenate([[False], covered[:-1]])
    keep = np.cumsum(start) % READBACK_THIN == 1
    out = full.copy()
    out[:, :G] *= keep
    return out


def _readback_case(counts, G, want):
    """Both routes and counts_host_sparse on one flat count tensor on the
    card, best of 3 in alternating order, against want; the host costs
    route_seconds weighs as measured on these counts; fails unless every
    result equals want, the tensor is unchanged and the route taken is
    within READBACK_SLACK of the whole copy. Returns the figures."""
    import torch

    from midas_tpu_torch.profile import sparse_counts as sc

    phase_a_s, (pa, stats) = _timed(lambda: sc._phase_a(counts, G))
    del pa
    real_host = sc._host
    whole = lambda: sc._whole_host(counts, G)  # noqa: E731
    sparse = lambda: sc._sparse_host(*sc._phase_a(counts, G), G)  # noqa
    runs = [("whole", whole, real_host),
            ("counts_host_sparse",
             lambda: sc.counts_host_sparse(counts, G), real_host),
            ("whole_pinned", whole, _pinned_host),
            ("sparse", sparse, real_host),
            ("sparse_pinned", sparse, _pinned_host)]
    secs, outs = {}, {}
    sc.ROUTES.clear()
    try:
        # three rounds, every other one in reverse order, so that no
        # variant always runs first (the host's allocator warms up)
        for rnd in range(3):
            for name, fn, host in runs[::-1] if rnd % 2 else runs:
                sc._host = host
                t, outs[name] = _timed(fn, 1)
                secs.setdefault(name, []).extend(t)
    finally:
        sc._host = real_host
    route, = sc.ROUTES
    # the sparse route's host copies alone, each after a synchronisation
    copy_s = []

    def timed_host(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real_host(t)
        finally:
            copy_s.append(time.perf_counter() - t0)

    sc._host = timed_host
    try:
        sc._sparse_host(*sc._phase_a(counts, G), G)
    finally:
        sc._host = real_host
    fill_s, _ = _timed(lambda: _fill_host(want.shape[0]))
    for name, out in outs.items():
        if out.dtype != np.int32 or out.tobytes() != want.tobytes():
            fail(f"readback: {name} differs from the counts")
    if int(counts[G]) != READBACK_JUNK:
        fail("readback: a route wrote into the device counts")
    best = {k: min(v) for k, v in secs.items()}
    if best["counts_host_sparse"] > READBACK_SLACK * best["whole"]:
        fail(f"readback: the {route} route took "
             f"{best['counts_host_sparse']:.4f} s, the whole copy "
             f"{best['whole']:.4f} s")
    whole_b = want.nbytes
    pred_sparse, pred_whole = sc.route_seconds(G, stats)
    return dict(
        stats=dict(zip(("n_covered", "n_impure", "n_runs", "max_depth",
                        "max_count"), stats)),
        route=route, bytes=dict(whole=whole_b,
                                sparse=sc.sparse_bytes(G, stats)),
        phase_a_seconds=min(phase_a_s),
        sparse_copies_seconds=sum(copy_s),
        fill_seconds=min(fill_s),
        host_costs=dict(
            whole_bytes_per_s=whole_b / best["whole"],
            fill_bytes_per_s=whole_b / min(fill_s),
            site_s=(best["sparse"] - min(phase_a_s) - sum(copy_s)
                    - min(fill_s)) / max(stats[0], 1)),
        predicted_seconds=dict(sparse=pred_sparse, whole=pred_whole),
        seconds=best, all_seconds=secs)


def phase_readback(prof, res, smi_line):
    """The end-of-stream counts readback on phase snps_main's final counts
    (no new run of the stream), put back on the card as the flat
    [4 x (G+1)] int32 tensor with junk at flat G, and on a thinned copy
    of them (every READBACK_THIN-th covered run: the coverage of fewer
    reads over the same genomes): _readback_case on each; then
    snps_state_host's counts on the full ones."""
    import torch

    from midas_tpu_torch.profile import device_steps as ds

    G, S = prof.pack.total_len, len(prof.species_ids)
    full = np.zeros((4, G + 1), np.int32)
    full[:, :G] = res["counts"]
    cases = {}
    for name, arr in (("full", full), ("thinned", _thin_runs(full, G))):
        want = arr.reshape(-1)
        counts = torch.from_numpy(want).to("cuda")
        counts[G] = READBACK_JUNK
        cases[name] = _readback_case(counts, G, want)
        del counts
    want = full.reshape(-1)
    state = ds.snps_init(G, S, 1, prof.aligner.max_read_len, "cuda")
    state.counts.copy_(torch.from_numpy(want))
    state.counts[G] = READBACK_JUNK
    t = time.perf_counter()
    host = ds.snps_state_host(state)
    state_s = time.perf_counter() - t
    if host["counts"].tobytes() != want.tobytes():
        fail("readback: snps_state_host's counts differ from the counts")
    del state
    torch.cuda.empty_cache()
    emit("readback", genome=G, counts_bytes_int32=want.nbytes,
         slack=READBACK_SLACK, thin=READBACK_THIN, **cases,
         state_host_seconds=state_s, equal=True, card=smi_line)


def _check_sites_file(path, counts, pack, contig_species, si):
    """Read one species' .snps.gz back: one row per site of its contigs
    in sorted id order, the reference allele, the counts of the pileup,
    and depth = the sum of the four counts. Returns the number of rows."""
    import gzip

    from midas_tpu_torch.io.seqio import CODE_TO_BASE

    cis = sorted((ci for ci in range(pack.num_seqs)
                  if contig_species[ci] == si), key=lambda ci: pack.names[ci])
    want_cols = np.concatenate(
        [np.arange(pack.offsets[ci], pack.offsets[ci + 1]) for ci in cis])
    with gzip.open(path, "rt") as f:
        lines = f.read().split("\n")
    if lines[0].split("\t")[0] != "ref_id" or lines[-1] != "" \
            or len(lines) != len(want_cols) + 2:
        fail(f"{path}: {len(lines) - 2} rows for {len(want_cols)} sites")
    num = np.array([ln.split("\t", 3)[3].split("\t")
                    for ln in lines[1:-1]], dtype=np.int64)
    if not (num[:, 0] == num[:, 1:].sum(axis=1)).all():
        fail(f"{path}: depth is not the sum of the four counts")
    if not np.array_equal(num[:, 1:].T, counts[:, want_cols]):
        fail(f"{path}: the counts differ from the pileup")
    alleles = "".join(ln.split("\t", 3)[2] for ln in lines[1:-1])
    if alleles.encode() != CODE_TO_BASE[pack.codes[want_cols]].tobytes():
        fail(f"{path}: the reference alleles differ from the genome")
    return len(want_cols)


def _snps_device_step(prof, fq):
    """Mean device ms of snps_update on one batch, and a per-stage
    breakdown of the same work, by CUDA events. Stages without a call of
    their own are differences of two timed calls. fq a tuple (-1, -2):
    the first batch of mate pairs, through the paired step."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align import pipeline as pl
    from midas_tpu_torch.align.seed import find_candidates, gather_windows_packed
    from midas_tpu_torch.profile import device_steps as ds

    al = prof.aligner
    sp, sc = al.seed_params, al.scoring
    paired = isinstance(fq, tuple)
    b, arrays = _first_batch(al, fq, ("codes", "quals", "lengths",
                                      "mean_qual"))
    codes, quals, qlens, mean_qual = arrays
    state = _snps_step(prof, sc, b, arrays, paired=paired)
    step_ms, _ = cuda_ms(lambda: _snps_step(prof, sc, b, arrays, state,
                                            paired), 5)
    (p1, k1), (p2, k2) = _captured_dp_calls(
        lambda: _snps_step(prof, sc, b, arrays, state, paired))
    D, L = sp.band_width, codes.shape[1]
    table = torch.from_numpy(ds.score_min_table(sc, al.max_read_len)).cuda()
    r = {}
    r["seed"], c = cuda_ms(lambda: find_candidates(
        al.index_arrays, codes, qlens, sp, al.max_read_len), 5)
    r["window_gather"], _ = cuda_ms(lambda: gather_windows_packed(
        al.pack_arrays["words"], al.pack_arrays["nmask"],
        al.pack_arrays["offsets"], c["diag"] - D // 2, L + D - 1,
        center=c["diag"] + qlens[:, None] // 2), 5)
    r["k3"], _ = cuda_ms(lambda: cuda_sw.banded_align_cuda(*p1, **k1), 5)
    pass1_ms, (out1, aux) = cuda_ms(lambda: pl.align_candidates_score(
        al.index_arrays, al.pack_arrays, codes, qlens, sc, sp,
        al.max_read_len, quals=quals), 5)
    r["pair_prep_and_dedup"] = pass1_ms - r["seed"] - r["window_gather"] \
        - r["k3"]
    pick, r[pick], best_col = _pick_stage(out1, qlens, sc, table, paired)
    r["k2"], _ = cuda_ms(lambda: cuda_sw.banded_align_cuda(*p2, **k2), 5)
    pass2_ms, _ = cuda_ms(lambda: pl.align_chosen_full(
        al.pack_arrays, aux, codes, qlens, best_col, sc, sp), 5)
    r["pass2_gather"] = pass2_ms - r["k2"]
    r["pileup_and_spill"] = step_ms - pass1_ms - r[pick] - pass2_ms
    return step_ms, r


def _same_snps_outputs(a, b, what):
    """Fail unless two snps output directories hold the same
    summary.txt, species list, decompressed .snps.gz files and saved
    state."""
    names = sorted(os.listdir(os.path.join(a, "snps/output")))
    if names != sorted(os.listdir(os.path.join(b, "snps/output"))):
        fail(f"{what}: different output files")
    _same_files(a, b, ["snps/summary.txt", "snps/species.txt"] + [
        os.path.join("snps/output", n) for n in names], what)
    keys, za = _same_state(os.path.join(a, "snps/temp/state.npz"),
                           os.path.join(b, "snps/temp/state.npz"),
                           f"{what}: SnpsState")
    return keys, int(za["mapped_reads"][:-1].sum()), int(za["gap_n"])


def phase_snps_cpu(comm, fq):
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas

    ids = ",".join(sp.species_id for sp in comm.species[:N_SNPS_CPU_SPECIES])
    result = {}
    for mode in ("global", "local"):
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(WORK, f"snps_cli_{mode}_{dev}")
            cuda_sw.LAUNCHES.clear()
            t0 = time.time()
            run_midas(["snps", out, "-1", fq, "-d", comm.db_dir,
                       "-n", str(N_CPU_READS), "--species_id", ids,
                       "-m", mode, "--device", dev])
            secs[dev] = round(time.time() - t0, 2)
            outs[dev] = out
            if dev == "cuda":
                card_launches = dict(cuda_sw.LAUNCHES)
            elif cuda_sw.LAUNCHES:
                fail("the CPU run launched the kernel")
        n_b = -(-N_CPU_READS // 8192)
        if card_launches != {"K3_qpen": n_b, "K2": n_b}:
            fail(f"snps -m {mode} on the card launched {card_launches}")
        keys, mapped, gapped = _same_snps_outputs(
            outs["cuda"], outs["cpu"], f"snps -m {mode}, card vs CPU")
        result[mode] = dict(identical=True, state_fields=keys,
                            mapped_reads=mapped, gapped_rows=gapped,
                            card_launches=card_launches,
                            card_seconds=secs["cuda"], cpu_seconds=secs["cpu"])
    emit("snps_cpu", reads=N_CPU_READS, species=N_SNPS_CPU_SPECIES, **result)
    return result


# the dbbuild_main cell: a custom database of a few 1 Mb genomes built by
# the port (marker-map mode, --compress), then profiled on the card. Sized
# before the first card run as the largest community whose run_build
# stayed under ~90 s on a CPU: 4 species + 1 related copy (PERF.md §4).
DBBUILD_SIM = dict(n_species=4, genome_len=1_000_000, gene_len=900,
                   n_extra_genes=300, related_pairs=1, divergence=0.03,
                   seed=5)
N_DBBUILD_SPECIES, N_DBBUILD_READS = 4, 131072


@contextlib.contextmanager
def _call_spans(owner, names):
    """While the block runs, record each call of the functions `names` of
    owner (a module or a class) as a (start, end) perf_counter span in
    the yielded {name: [spans]}; restore them after."""
    real = {n: getattr(owner, n) for n in names}
    spans = {n: [] for n in names}

    def timed(n):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return real[n](*a, **k)
            finally:
                spans[n].append((t, time.perf_counter()))
        return run

    for n in names:
        setattr(owner, n, timed(n))
    try:
        yield spans
    finally:
        for n, fn in real.items():
            setattr(owner, n, fn)


def _timed_build(argv):
    """build_db's CLI in this process, its stages timed by the functions
    it calls: clustering (cluster_levels), marker mapping (from the last
    gene located on its rep genome to the KEGG install: step 5 of
    run_build), compression (_compress), and the rest. Returns the
    seconds."""
    from midas_tpu_torch.cli.build_db import main as build_db
    from midas_tpu_torch.dbbuild import build_db as bd

    with _call_spans(bd, ("cluster_levels", "find_gene", "_install_kegg",
                          "_compress")) as spans:
        t0 = time.perf_counter()
        if build_db(argv) != 0:
            fail(f"build_db {argv} failed")
        secs = dict(total=time.perf_counter() - t0)
    for key, name in (("clustering", "cluster_levels"),
                      ("compression", "_compress")):
        secs[key] = sum(b - a for a, b in spans[name])
    secs["marker_mapping"] = (spans["_install_kegg"][0][0]
                              - spans["find_gene"][-1][1])
    secs["rest"] = (secs["total"] - secs["clustering"]
                    - secs["marker_mapping"] - secs["compression"])
    return secs


def _dbbuild_truth(comm, out, n_reads):
    """The simulator's truth over one run_midas species / genes / snps
    output directory of the dbbuild_main cell, as phases main, genes_main
    and snps_main check it: reads only from the first N_DBBUILD_SPECIES
    species (the related copy may take ambiguous ones), each of them
    counted and selected, at least half as many counted as the reads the
    marker genes' share of the genomes would hold; their genome genes
    near copy number 1 and
    their pangenome-only genes without reads; each rep genome's sites
    all written, with the modal allele the reference at >= 99% of sites
    of depth >= 3. Returns the per-species figures."""
    import gzip

    true = [sp.species_id for sp in comm.species[:N_DBBUILD_SPECIES]]
    related = {sp.species_id for sp in comm.species[N_DBBUILD_SPECIES:]}
    head, rows = _read_table(os.path.join(out, "species/species_profile.txt"))
    prof = {r[0]: dict(zip(head, r)) for r in rows}
    counts = {s: int(r["count_reads"]) for s, r in prof.items()}
    rel = np.array([float(r["relative_abundance"]) for r in prof.values()])
    stray = sum(c for s, c in counts.items()
                if s not in true and s not in related)
    counted = sum(counts.values())
    marker_share = np.mean([
        sum(len(g["seq"]) for g in sp.genes
            if g["gene_id"] in set(sp.marker_gene_ids.values()))
        / sum(len(c) for c in sp.contigs.values())
        for sp in comm.species[:N_DBBUILD_SPECIES]])
    if not np.isfinite(rel).all() or abs(rel.sum() - 1.0) > 1e-9 or stray \
            or counted < 0.5 * marker_share * n_reads \
            or min(counts.get(s, 0) for s in true) == 0:
        fail(f"dbbuild_main: the species profile disagrees with the truth: "
             f"counted={counted} (marker share {marker_share:.4f} of "
             f"{n_reads} reads), stray={stray}, counts={counts}")
    figures = []
    for sp in comm.species[:N_DBBUILD_SPECIES]:
        sid = sp.species_id
        path = os.path.join(out, "genes/output", f"{sid}.genes.gz")
        if not os.path.exists(path):
            fail(f"dbbuild_main: genes did not select {sid}")
        with gzip.open(path, "rt") as f:
            g = {r[0]: r for r in (ln.rstrip("\n").split("\t")
                                   for ln in list(f)[1:])}
        on = [float(g[x["gene_id"]][3]) for x in sp.genes
              if x["scaffold_id"] is not None]
        off = [int(g[x["gene_id"]][1]) for x in sp.genes
               if x["scaffold_id"] is None]
        med = float(np.median(on))
        if len(g) != len(sp.genes) or not 0.5 < med < 2.0 or any(off):
            fail(f"dbbuild_main: genes disagree with the truth for {sid}: "
                 f"{len(g)} genes of {len(sp.genes)}, median copy number "
                 f"{med}, {sum(1 for c in off if c)} pangenome-only genes "
                 "with reads")
        lines, nums = _read_snps_gz(os.path.join(out, "snps/output",
                                                 f"{sid}.snps.gz"))
        genome = sum(len(c) for c in sp.contigs.values())
        ref = np.array(["ACGT".find(ln.split(b"\t", 3)[2].decode())
                        for ln in lines])
        deep = nums[:, 0] >= 3
        agree = float((nums[deep, 1:].argmax(axis=1) == ref[deep]).mean())
        if len(lines) != genome or deep.sum() < 1000 or agree < 0.99:
            fail(f"dbbuild_main: snps disagree with the truth for {sid}: "
                 f"{len(lines)} sites of {genome}, modal allele = reference "
                 f"at {agree:.4f} of {int(deep.sum())} sites of depth >= 3")
        figures.append(dict(species=sid, count_reads=counts[sid],
                            median_copies=med, sites_depth_ge3=int(deep.sum()),
                            modal_equals_reference=agree))
    return figures


def _dbbuild_check_commands(comm, fq, db, dev):
    """run_midas species, genes -m local and snps -m global at 2,048 reads
    on dev, over the species the truth names, into one directory: (the
    directory, the argv lists)."""
    ids = ",".join(comm.species_ids()[:N_DBBUILD_SPECIES])
    out = os.path.join(WORK, "dbbuild", f"check_{dev}")
    base = [out, "-1", fq, "-d", db, "-n", str(N_CPU_READS), "--device", dev]
    return out, [["species", *base],
                 ["genes", *base, "-m", "local", "--species_id", ids],
                 ["snps", *base, "-m", "global", "--species_id", ids]]


def dbbuild_prepare():
    """The host half of phase dbbuild_main (run in the background
    worker): simulate DBBUILD_SIM's genomes, write the builder's inputs
    (marker-map mode, as tests/test_dbbuild.py's built_db) and the reads,
    build with build_db --compress (_timed_build), then run the card
    check's commands with --device cpu. Returns what the phase needs."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas
    from midas_tpu_torch.testkit.simulate import (simulate_db, simulate_reads,
                                                  write_genome_inputs)

    root = os.path.join(WORK, "dbbuild")
    t0 = time.time()
    comm = simulate_db(os.path.join(root, "truth_db"), **DBBUILD_SIM)
    indir = os.path.join(root, "genomes")
    mapfile = write_genome_inputs(comm, indir)
    marker_map = os.path.join(root, "markers.tsv")
    with open(marker_map, "w") as f:
        for sp in comm.species:
            for marker_id, gene_id in sp.marker_gene_ids.items():
                f.write(f"{gene_id}\t{marker_id}\n")
    fq = os.path.join(root, "reads.fq.gz")
    simulate_reads(comm, fq, n_reads=N_DBBUILD_READS, read_len=100,
                   error_rate=0.005, indel_rate=0.01, seed=12,
                   abundances=_first_n_abundances(comm, N_DBBUILD_SPECIES))
    t_sim = time.time() - t0
    db = os.path.join(root, "built")
    build_secs = _timed_build([indir, mapfile, db, "--marker_map", marker_map,
                               "--compress"])
    db_bytes = sum(os.path.getsize(os.path.join(d, n))
                   for d, _, files in os.walk(db) for n in files)
    t = time.perf_counter()
    for argv in _dbbuild_check_commands(comm, fq, db, "cpu")[1]:
        run_midas(argv)
    return dict(comm=comm, fq=fq, db=db, simulate_seconds=t_sim,
                build_seconds=build_secs, db_bytes=db_bytes,
                cpu_check_seconds=time.perf_counter() - t,
                cpu_launches=dict(cuda_sw.LAUNCHES))


def phase_dbbuild_main(prep, smi_line):
    """A custom database built by the port (dbbuild_prepare, in the
    background worker), profiled on the card: `run_midas species`,
    `genes -m local` and `snps -m global` over it (N_DBBUILD_READS reads
    from the first N_DBBUILD_SPECIES species, genes and snps at
    --species_cov 1.0 in the species run's directory), each checked
    against the truth; then the three at 2,048 reads on the card,
    identical byte for byte to the worker's CPU runs. Returns the full
    runs' launches."""
    from collections import Counter

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.profile.snps import SnpsProfiler
    from midas_tpu_torch.profile.species import SpeciesProfiler

    comm, fq, db = prep["comm"], prep["fq"], prep["db"]
    # each run end to end, and its profiler's run (the profiling stage)
    out = os.path.join(WORK, "dbbuild", "card")
    commands = (("species", SpeciesProfiler, []),
                ("genes", GenesProfiler, ["-m", "local", "--species_cov",
                                          "1.0"]),
                ("snps", SnpsProfiler, ["-m", "global", "--species_cov",
                                        "1.0"]))
    runs, launches = {}, Counter()
    for program, cls, flags in commands:
        with _call_spans(cls, ("run",)) as spans:
            cuda_sw.LAUNCHES.clear()
            t = time.perf_counter()
            run_midas([program, out, "-1", fq, "-d", db, *flags])
            wall = time.perf_counter() - t
        got = dict(cuda_sw.LAUNCHES)
        launches.update(got)
        (a, b), = spans["run"]
        runs[program] = dict(seconds=wall,
                             reads_per_sec=N_DBBUILD_READS / wall,
                             profile_seconds=b - a,
                             profile_reads_per_sec=N_DBBUILD_READS / (b - a),
                             banded_sw_launches=got)
    n_b = -(-N_DBBUILD_READS // BATCH)
    if dict(launches) != {"K1": n_b, "K3_qpen": 2 * n_b, "K2": 2 * n_b}:
        fail(f"dbbuild_main's runs launched {dict(launches)} for {n_b} "
             "batches each")
    truth = _dbbuild_truth(comm, out, N_DBBUILD_READS)

    # card = CPU at 2,048 reads
    card, argvs = _dbbuild_check_commands(comm, fq, db, "cuda")
    cpu = _dbbuild_check_commands(comm, fq, db, "cpu")[0]
    cuda_sw.LAUNCHES.clear()
    t = time.perf_counter()
    for argv in argvs:
        run_midas(argv)
    card_secs = time.perf_counter() - t
    if not cuda_sw.LAUNCHES or prep["cpu_launches"]:
        fail(f"dbbuild_main's 2,048-read runs launched "
             f"{dict(cuda_sw.LAUNCHES)} on the card, "
             f"{prep['cpu_launches']} on the CPU")
    _same_files(card, cpu, M8_OUTPUTS[:2],
                "dbbuild_main species, card vs CPU")
    _same_state(os.path.join(card, "species/temp/state.npz"),
                os.path.join(cpu, "species/temp/state.npz"),
                "dbbuild_main SpeciesState, card vs CPU")
    _same_genes_outputs(card, cpu, "dbbuild_main genes, card vs CPU")
    _same_snps_outputs(card, cpu, "dbbuild_main snps, card vs CPU")
    emit("dbbuild_main", species=len(comm.species),
         genome_len=DBBUILD_SIM["genome_len"],
         genes_per_species=[len(sp.genes) for sp in comm.species],
         simulate_seconds=prep["simulate_seconds"],
         build_seconds=prep["build_seconds"], db_bytes=prep["db_bytes"],
         reads=N_DBBUILD_READS, batch=BATCH, runs=runs,
         banded_sw_launches=dict(launches), truth=truth,
         cpu_identical=True, cpu_check_reads=N_CPU_READS,
         cpu_check_seconds=dict(cuda=card_secs,
                                cpu=prep["cpu_check_seconds"]),
         card=smi_line)
    return dict(launches)


def phase_paired_data(gcomm, smi_line):
    """The paired cells' reads: N_PAIRS mate pairs from the genes cell's
    10 species (its community, pangenome profiler and snps profiler are
    reused: no new database)."""
    from midas_tpu_torch.testkit.simulate import simulate_paired_reads

    reads = tuple(os.path.join(WORK, f"paired_r{i}.fq.gz") for i in (1, 2))
    t0 = time.time()
    simulate_paired_reads(gcomm, *reads, n_pairs=N_PAIRS,
                          abundances=_first_n_abundances(gcomm,
                                                         N_GENES_SPECIES),
                          **PAIRED_SIM)
    emit("paired_data", pairs=N_PAIRS, reads=2 * N_PAIRS,
         species=N_GENES_SPECIES, maxins=500,
         simulate_seconds=round(time.time() - t0, 1), card=smi_line,
         **{k: v for k, v in PAIRED_SIM.items() if k != "seed"})
    return reads


def _loader_seconds(reads, max_len):
    """Host seconds to parse the two files into BATCH-row batches with no
    device work: as mate pairs (load_paired_batches: two half-size
    native streams, interleaved in numpy with the name list) and as
    single-end reads of the same files (load_read_batches)."""
    from midas_tpu_torch.io.batch import load_paired_batches, load_read_batches

    t = time.perf_counter()
    n_paired = sum(b.n_reads for b in load_paired_batches(
        *reads, batch_size=BATCH, max_len=max_len))
    paired_s = time.perf_counter() - t
    t = time.perf_counter()
    n_single = sum(b.n_reads for b in load_read_batches(
        list(reads), batch_size=BATCH, max_len=max_len))
    single_s = time.perf_counter() - t
    if n_paired != n_single:
        fail(f"the paired loader gave {n_paired} reads, the single-end "
             f"loader {n_single}")
    return dict(load_paired_batches=paired_s, load_read_batches=single_s,
                interleave=paired_s - single_s)


def phase_paired_genes_main(gcomm, prof, reads, smi_line):
    """GenesProfiler.run over the paired cell's mate pairs (-1, -2):
    genes_main's checks and figures, with the pair pick, the concordant
    share, the counts of an unpaired run of the same files, the loader's
    host seconds, and K3 / K2 held to the plain version on the first
    paired batch. Returns (launches, variant records)."""
    import torch

    from midas_tpu_torch.align import cuda_sw

    paths = list(reads)
    prof.run(paths, max_reads=BATCH // 2, batch_size=BATCH,
             paired=True)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_reads = 2 * N_PAIRS
    n_batches = -(-n_reads // BATCH)
    cuda_sw.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = prof.run(paths, batch_size=BATCH, paired=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_sw.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches != {"K3_qpen": n_batches, "K2": n_batches}:
        fail(f"paired genes path launched banded_sw {launches} for "
             f"{n_batches} batches (want K3 with qpen and K2, once each "
             "per batch)")
    per_species = _genes_truth(gcomm, prof, res)
    counted = {k: int(res[k].sum()) for k in ("aligned_reads",
                                              "mapped_reads")}
    # The pairing must take effect. On these reads that cannot be required
    # of the counts: the 10 selected species share no sequence (their
    # related copies are not selected), so a concordant pair picks the
    # candidates each mate picks alone, and nearly every read clears the
    # MAPQ gates either way (a tiny CPU rehearsal: equal genes and snps
    # counts). So it is required of the picks: the pair MAPQ must move
    # some reads' MAPQ on the first batch. The counts of an unpaired run
    # are reported beside the paired ones (the CPU tests, whose selection
    # holds a related genome, require them to differ).
    unpaired = prof.run(paths, batch_size=BATCH)
    dec = pair_decisions(prof, reads)
    _check_concordant_share("paired_genes_main", dec, "genes")
    if not (dec["moved_best_col"] or dec["moved_mapq"]):
        fail("paired_genes_main: the mate-pair pick changed no read's "
             "candidate or MAPQ on the first batch")
    step_ms, stages = _genes_device_step(prof, reads)
    variants = _paired_variants(prof, reads, _genes_step, "paired_genes")
    emit("paired_genes_main", reads=n_reads, pairs=N_PAIRS, batch=BATCH,
         batches=n_batches, seconds=dt, reads_per_sec=n_reads / dt,
         pairs_per_sec=N_PAIRS / dt, banded_sw_launches=launches,
         device_step_ms=step_ms,
         device_busy_share=step_ms * n_batches / 1e3 / dt, stage_ms=stages,
         max_memory_allocated=peak, first_batch=dec,
         loader_host_seconds=_loader_seconds(reads, prof.aligner.max_read_len),
         unpaired={k: int(unpaired[k].sum()) for k in counted},
         counts_differ_from_unpaired=not all(
             np.array_equal(res[k], unpaired[k]) for k in counted),
         truth=per_species, card=smi_line, **counted)
    return launches, variants


def _check_concordant_share(phase, dec, path):
    """Fail unless the first batch's concordant share reaches its bound."""
    bound = PAIRED_MIN_CONCORDANT[path]
    if dec["concordant_share"] < bound:
        fail(f"{phase}: {dec['concordant_share']} of the first batch's "
             f"pairs are concordant (bound {bound})")


def phase_paired_cli(comm, smi_line):
    """run_midas genes (-m local) and snps (-m global) over 1,024 mate
    pairs from the phase-3 community's first 20 species: -1/-2 on the
    card and on the CPU, and --interleaved over the same pairs on the
    card. Every output file and the saved state must be identical; the
    CPU runs launch nothing."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas
    from midas_tpu_torch.testkit.simulate import simulate_paired_reads

    abund = _first_n_abundances(comm, N_ABUNDANT)
    r1, r2, inter = (os.path.join(WORK, f"cli_pairs_{n}.fq.gz")
                     for n in ("1", "2", "interleaved"))
    for out1, out2 in ((r1, r2), (inter, None)):   # the same pairs twice
        simulate_paired_reads(comm, out1, out2, n_pairs=N_CLI_PAIRS,
                              abundances=abund, **PAIRED_SIM)
    ids = ",".join(sp.species_id for sp in comm.species[:N_GENES_CPU_SPECIES])
    n_b = -(-2 * N_CLI_PAIRS // 8192)
    result = {}
    for program, mode, same in (("genes", "local", _same_genes_outputs),
                                ("snps", "global", _same_snps_outputs)):
        outs, secs, launches = {}, {}, {}
        for run, dev, reads in (
                ("mates", "cuda", ["-1", r1, "-2", r2]),
                ("mates", "cpu", ["-1", r1, "-2", r2]),
                ("interleaved", "cuda", ["-1", inter, "--interleaved"])):
            name = f"{run}_{dev}"
            outs[name] = os.path.join(WORK, f"paired_cli_{program}_{name}")
            cuda_sw.LAUNCHES.clear()
            t0 = time.time()
            run_midas([program, outs[name], *reads, "-d", comm.db_dir,
                       "--species_id", ids, "-m", mode, "--device", dev])
            secs[name] = round(time.time() - t0, 2)
            launches[name] = dict(cuda_sw.LAUNCHES)
        if launches["mates_cpu"]:
            fail(f"paired {program} on the CPU launched the kernel")
        for name in ("mates_cuda", "interleaved_cuda"):
            if launches[name] != {"K3_qpen": n_b, "K2": n_b}:
                fail(f"paired {program} -m {mode} ({name}) launched "
                     f"{launches[name]}")
        found = same(outs["mates_cuda"], outs["mates_cpu"],
                     f"paired {program} -m {mode}, card vs CPU")
        same(outs["interleaved_cuda"], outs["mates_cuda"],
             f"paired {program} -m {mode}, --interleaved vs -1/-2")
        result[program] = dict(mode=mode, identical=True,
                               interleaved_identical=True,
                               state_fields=found[0], mapped_reads=found[1],
                               card_launches=launches["mates_cuda"],
                               seconds=secs)
    emit("paired_cli", pairs=N_CLI_PAIRS, species=N_GENES_CPU_SPECIES,
         card=smi_line, **result)
    return result


# the multirank phase: ranks launched as a launcher launches them, each
# running `chip_smoke.py --rank-worker` on the card
MULTIRANK_BATCH = 512          # genes / snps: 2,048 reads in 4 batches
MULTIRANK_TIMEOUT = 600        # seconds a launch may take, set-up included
MULTIRANK_DIST_TIMEOUT = 300   # seconds a collective waits for a rank


def _timed_methods(rec):
    """Wrap the profiling stage (each profiler's stream over its batches)
    and the end-of-stream merge (the driver's gathers) with timers into
    rec: summed seconds, the stage's first start and last end (epoch
    seconds) and the profiler's device. Nested merge calls count once."""
    import functools

    from midas_tpu_torch.dist import driver
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.profile.snps import SnpsProfiler
    from midas_tpu_torch.profile.species import SpeciesProfiler

    depth = [0]

    def wrap(owner, name, key):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def timed(*a, **kw):
            depth[0] += 1
            t0, e0 = time.perf_counter(), time.time()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0
                    rec.setdefault(f"{key}_start", e0)
                    rec[f"{key}_end"] = time.time()
                if key == "profile_seconds":
                    rec["device"] = str(a[0].device)

        setattr(owner, name, timed)

    wrap(SpeciesProfiler, "_run_device", "profile_seconds")
    wrap(GenesProfiler, "_accumulate", "profile_seconds")
    wrap(SnpsProfiler, "_accumulate", "profile_seconds")
    for name in ("merge_species_accumulators", "merge_snps_accumulators",
                 "_allgather_sum", "_allgather_rows"):
        wrap(driver, name, "merge_seconds")


def rank_worker(spec):
    """One rank of a multirank launch. With spec["commands"]: `run_midas`
    over each command in turn, in batches of spec["batch_size"] reads
    (the run_* entry points' BATCH_SIZE when None), printing for each a
    RANK_RESULT line: its rank and world size, the profiler's device,
    this command's kernel launches, the seconds of its profiling stage
    and of its end-of-stream merge, and the command's seconds. With
    spec["snps_state"]: the merge of that snps state (as
    run_snps_multihost merges a rank's), timed from a barrier, checked
    against the state summed over the ranks, in one RANK_RESULT line."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.cli.run_midas import main as run_midas
    from midas_tpu_torch.dist import driver
    from midas_tpu_torch.profile import common

    driver.DEFAULT_TIMEOUT_S = MULTIRANK_DIST_TIMEOUT
    if spec.get("batch_size"):
        common.BATCH_SIZE = spec["batch_size"]
    if spec.get("snps_state"):
        _snps_merge_worker(spec["snps_state"])
        return
    rec = {}
    _timed_methods(rec)
    for argv in spec["commands"]:
        rec.clear()
        cuda_sw.LAUNCHES.clear()
        t0 = time.perf_counter()
        run_midas(argv)
        rec.update(rank=driver.process_index(), world=driver.process_count(),
                   launches=dict(cuda_sw.LAUNCHES),
                   command_seconds=time.perf_counter() - t0)
        print("RANK_RESULT " + json.dumps(rec), flush=True)


def _snps_merge_worker(state_path):
    import numpy as np
    import torch.distributed as dist

    from midas_tpu_torch.dist import driver
    from midas_tpu_torch.profile import checkpoint as ckpt

    driver.initialize()
    got = ckpt.load_any(state_path)
    if got is None:
        raise SystemExit(f"no snps state at {state_path}")
    host = got[0]
    n = driver.process_count()
    dist.barrier()
    t0 = time.perf_counter()
    merged = driver.merge_snps_accumulators(host)
    dt = time.perf_counter() - t0
    for k in ("counts", "aligned_reads", "mapped_reads"):
        want = n * host[k].astype(np.int64)
        if merged[k].dtype != np.int64 or not np.array_equal(merged[k], want):
            raise SystemExit(f"snps merge: {k} is not {n} x the state's")
    for k in ("gap_codes", "gap_quals", "gap_meta"):
        if not np.array_equal(merged[k], np.concatenate([host[k]] * n)):
            raise SystemExit(f"snps merge: {k} is not the state's "
                             f"rows {n} times")
    print("RANK_RESULT " + json.dumps(dict(
        rank=driver.process_index(), world=n, merge_seconds=dt,
        counts=int(host["counts"].size),
        counts_bytes_int32=int(host["counts"].nbytes),
        gap_rows=int(host["gap_codes"].shape[0]))), flush=True)


def _launch_ranks(n, commands, name, batch_size=None, snps_state=None):
    """Launch n ranks of rank_worker over commands in batches of
    batch_size reads (or over the merge of snps_state), with the
    environment torchrun sets (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); all ranks on this card. Fails at once when a rank exits
    nonzero (the others are killed), or after MULTIRANK_TIMEOUT. Returns
    (the ranks' RANK_RESULT records per command, wall seconds)."""
    spec = dict(commands=commands, batch_size=batch_size,
                snps_state=snps_state)
    if snps_state:
        commands = [None]     # one record a rank
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    logdir = os.path.join(WORK, "multirank_logs", name)
    os.makedirs(logdir, exist_ok=True)
    # the host's cores split evenly between the ranks (torchrun sets one
    # thread a rank): torch's default of a thread a core in every rank
    # oversubscribes the host
    env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="localhost",
               MASTER_PORT=str(port),
               OMP_NUM_THREADS=str(max(os.cpu_count() // n, 1)))
    procs, files = [], []
    t0 = time.perf_counter()
    for r in range(n):
        out = open(os.path.join(logdir, f"rank{r}.out"), "w+")
        err = open(os.path.join(logdir, f"rank{r}.err"), "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             json.dumps(spec)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
            stdout=out, stderr=err, text=True))
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.perf_counter() - t0 > MULTIRANK_TIMEOUT:
                r = bad[0] if bad else 0
                files[r][1].seek(0)
                fail(f"multirank {name}: rank {r} of {n} "
                     + (f"exited {procs[r].returncode}" if bad else
                        f"timed out after {MULTIRANK_TIMEOUT} s")
                     + f":\n{files[r][1].read()[-3000:]}")
            time.sleep(0.2)
        wall = time.perf_counter() - t0
        recs = []
        for r, (p, (out, err)) in enumerate(zip(procs, files)):
            if p.returncode != 0:
                err.seek(0)
                fail(f"multirank {name}: rank {r} of {n} exited "
                     f"{p.returncode}:\n{err.read()[-3000:]}")
            out.seek(0)
            recs.append([json.loads(line[12:]) for line in out
                         if line.startswith("RANK_RESULT ")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in files:
            out.close()
            err.close()
    if any(len(rr) != len(commands) for rr in recs):
        fail(f"multirank {name}: a rank reported {[len(r) for r in recs]} "
             f"of {len(commands)} commands")
    for rr in recs:
        for rec in rr:
            if not snps_state and not rec.get("device", "").startswith(
                    "cuda"):
                fail(f"multirank {name}: rank {rec['rank']} ran on "
                     f"{rec.get('device')}, not on the card")
            if rec["world"] != n:
                fail(f"multirank {name}: rank {rec['rank']} saw "
                     f"{rec['world']} ranks, not {n}")
    # per command: the ranks' records
    return [[rr[i] for rr in recs] for i in range(len(commands))], wall


def _sum_launches(recs):
    out = {}
    for rec in recs:
        for k, v in rec["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _rank_figures(recs, reads):
    """A run's figures from its ranks' records: the profiling stage's
    span (first start to last end over the ranks) and aggregate reads/s
    over it, each rank's stage and merge seconds and launches."""
    span = (max(r["profile_seconds_end"] for r in recs)
            - min(r["profile_seconds_start"] for r in recs))
    return dict(
        profile_span_seconds=span, reads_per_sec=reads / span,
        command_seconds=max(r["command_seconds"] for r in recs),
        ranks=[dict(rank=r["rank"], device=r["device"],
                    launches=r["launches"],
                    profile_seconds=r["profile_seconds"],
                    merge_seconds=r.get("merge_seconds", 0.0))
               for r in recs])


def phase_multirank(comm, fq, smi_line):
    """run_midas under 2 ranks on this one card against the same command
    in 1 rank: species over the phase-3 database and its 65,536 reads
    (batch 8,192: 4 batches a rank), then genes -m local over 2,048
    reads and over 1,024 -1/-2 pairs and snps -m global over 2,048 reads
    (the first 20 species, batch 512: 2 batches a rank). Outputs equal
    byte for byte (genes and snps also equal to the earlier phases'
    in-process runs at batch 8,192), K1 4 + 4, K3 with qpen and K2
    summed over the ranks equal to the single run's, every rank on the
    card. Reports the profiling stage's aggregate reads/s of 2 ranks
    against 1, each rank's stage and merge seconds, and the walls."""
    species_cmd = ["species", None, "-1", fq, "-d", comm.db_dir]
    ids = ",".join(sp.species_id for sp in comm.species[:N_GENES_CPU_SPECIES])
    pairs = [os.path.join(WORK, f"cli_pairs_{i}.fq.gz") for i in (1, 2)]
    cli = {   # name: (argv, reads, the earlier phase's in-process run)
        "genes": (["genes", None, "-1", fq, "-n", str(N_CPU_READS),
                   "-m", "local"], N_CPU_READS, "genes_cli_local_cuda"),
        "paired_genes": (["genes", None, "-1", pairs[0], "-2", pairs[1],
                          "-m", "local"], 2 * N_CLI_PAIRS,
                         "paired_cli_genes_mates_cuda"),
        "snps": (["snps", None, "-1", fq, "-n", str(N_CPU_READS),
                  "-m", "global"], N_CPU_READS, "snps_cli_global_cuda"),
    }
    runs, outs = {}, {}
    for n in (1, 2):
        out = os.path.join(WORK, f"multirank_species_{n}")
        outs["species", n] = out
        species_cmd[1] = out
        recs, wall = _launch_ranks(n, [species_cmd], f"species_{n}")
        runs["species", n] = dict(_rank_figures(recs[0], N_READS),
                                  wall_seconds=wall)
        cmds = []
        for name, (argv, _reads, _prior) in sorted(cli.items()):
            outs[name, n] = os.path.join(WORK, f"multirank_{name}_{n}")
            cmds.append([argv[0], outs[name, n], *argv[2:], "-d",
                         comm.db_dir, "--species_id", ids])
        recs, wall = _launch_ranks(n, cmds, f"cli_{n}",
                                   batch_size=MULTIRANK_BATCH)
        for (name, (_argv, reads, _prior)), rr in zip(sorted(cli.items()),
                                                      recs):
            runs[name, n] = _rank_figures(rr, reads)
        runs["cli", n] = dict(wall_seconds=wall)

    _same_files(outs["species", 1], outs["species", 2], M8_OUTPUTS[:2],
                "species, 2 ranks vs 1")
    if runs["species", 1]["ranks"][0]["launches"] != {"K1": 8} or [
            r["launches"] for r in runs["species", 2]["ranks"]] != [
            {"K1": 4}, {"K1": 4}]:
        fail(f"multirank species launched "
             f"{[r['launches'] for r in runs['species', 2]['ranks']]} "
             f"(2 ranks), {runs['species', 1]['ranks'][0]['launches']} "
             "(1 rank)")
    by_path = {"multirank_species": _sum_launches(runs["species", 2]["ranks"])}
    for name, (argv, _reads, prior) in sorted(cli.items()):
        program = argv[0]
        files = [f"{program}/summary.txt", f"{program}/species.txt"] + [
            f"{program}/output/{f}" for f in sorted(os.listdir(
                os.path.join(outs[name, 1], program, "output")))]
        _same_files(outs[name, 1], outs[name, 2], files,
                    f"{name}, 2 ranks vs 1")
        _same_files(os.path.join(WORK, prior), outs[name, 2], files,
                    f"{name}, 2 ranks vs the in-process card run")
        one = runs[name, 1]["ranks"][0]["launches"]
        each = [r["launches"] for r in runs[name, 2]["ranks"]]
        if one != {"K3_qpen": 4, "K2": 4} or each != [
                {"K3_qpen": 2, "K2": 2}] * 2:
            fail(f"multirank {name} launched {each} (2 ranks), {one} "
                 "(1 rank)")
        key = "multirank_snps" if program == "snps" else "multirank_genes"
        got = by_path.setdefault(key, {})
        for k, v in _sum_launches(runs[name, 2]["ranks"]).items():
            got[k] = got.get(k, 0) + v
    # the snps merge at the repgenome-10sp width, on phase 13's state
    state = os.path.join(WORK, "snps_main", "state.npz")
    recs, wall = _launch_ranks(2, None, "snps_merge", snps_state=state)
    runs["snps_merge", 2] = dict(
        wall_seconds=wall, counts=recs[0][0]["counts"],
        counts_bytes_int32=recs[0][0]["counts_bytes_int32"],
        gap_rows=recs[0][0]["gap_rows"],
        merge_seconds=[r["merge_seconds"] for r in recs[0]])
    emit("multirank", card=smi_line, identical=True,
         species_reads=N_READS, species_batch=BATCH,
         cli_batch=MULTIRANK_BATCH,
         **{f"{name}_{n}rank": v for (name, n), v in sorted(runs.items())},
         species_reads_per_sec_2_over_1=(
             runs["species", 2]["reads_per_sec"]
             / runs["species", 1]["reads_per_sec"]),
         launches_by_path=by_path)
    return by_path


# the tensor-parallel phases: profilers whose pack and seed index are held
# as TP shards (dist/sharded.py::shard_devices), all on this one card
TP = 2
N_TP_READS = 16384      # tp_genes / tp_snps: the reads cut, no database
TP_STEP_SEQS, TP_STEP_LEN = 256, 8000   # tp_step's synthetic 2.05 Mb pack


def _shard_figures(al, phase):
    """Each shard's device, first sequence, pack offset and bytes on the
    card; fails unless every shard is on the card."""
    out = []
    for sh in al.shards:
        if sh.device.type != "cuda":
            fail(f"{phase}: a shard is on {sh.device}, not on the card")
        out.append(dict(
            device=str(sh.device), seq_base=sh.seq_base, pack_offset=sh.base,
            index_bytes=sum(t.numel() * t.element_size()
                            for t in sh.index_arrays.values()),
            pack_bytes=sum(t.numel() * t.element_size()
                           for t in sh.pack_arrays.values())))
    return out


def _cpu_twin(prof):
    """A shallow copy of a sharded profiler with its shards' arrays copied
    to the CPU, where the wrappers run the plain versions."""
    import copy
    import dataclasses

    import torch

    cpu = torch.device("cpu")
    twin, al = copy.copy(prof), copy.copy(prof.aligner)
    al.shards = [dataclasses.replace(
        sh, device=cpu,
        index_arrays={k: v.cpu() for k, v in sh.index_arrays.items()},
        pack_arrays={k: v.cpu() for k, v in sh.pack_arrays.items()})
        for sh in prof.aligner.shards]
    al.device = twin.device = cpu
    twin.aligner = al
    return twin


def _shard_variants(calls, plan, sc, sname, path, phase):
    """Hold each captured DP call of one sharded step to the plain
    version. plan: per call (variant name, score_only, pass label), in
    launch order. Emits `phase` per record; returns the records."""
    from midas_tpu_torch.align import cuda_sw

    if len(calls) != len(plan):
        fail(f"{path} launched the DP {len(calls)} times, want {len(plan)}")
    layout = cuda_sw.packed_layout()
    out = []
    for j, ((p, k), (kname, so, label)) in enumerate(zip(calls, plan)):
        if k["score_only"] != so:
            fail(f"{path}: launch {j} is not {kname}")
        v = _check_variant(kname, sname, sc, *p[:3], k["qpen"], so, layout,
                           shape=f"{path} {label}")
        v.pop("_out")
        emit(phase, **v)
        out.append(v)
    return out


def phase_tp_step(smi_line):
    """dist/sharded.py::distributed_profile_step over one batch of 8,192
    error-free 100 bp reads from a synthetic 2.05 Mb pack (256 random
    contigs), at tp = 2 against tp = 1 on this card: per-contig counts
    and bp equal, and equal to the truth; K1 under GLOBAL scoring with
    the flat mismatch (the step's own DP, no other caller) once a shard,
    each shard's call held to the plain version. Returns (launches,
    variant records)."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.params import GLOBAL_SCORING
    from midas_tpu_torch.align.seed import SeedParams
    from midas_tpu_torch.db.refpack import build_pack
    from midas_tpu_torch.dist.sharded import (distributed_profile_step,
                                              shard_devices, shard_index)

    rng = np.random.default_rng(21)
    letters = np.array(list("ACGT"))
    pack = build_pack([(f"ctg{s}", "".join(letters[rng.integers(
        0, 4, TP_STEP_LEN)])) for s in range(TP_STEP_SEQS)])
    origin = rng.integers(0, TP_STEP_SEQS, BATCH)
    starts = pack.offsets[origin] + rng.integers(0, TP_STEP_LEN - 99, BATCH)
    codes = np.full((BATCH, 128), 4, np.int8)
    codes[:, :100] = pack.codes[starts[:, None] + np.arange(100)]
    codes_t = torch.from_numpy(codes).cuda()
    qlens_t = torch.full((BATCH,), 100, dtype=torch.int32, device="cuda")
    sp = SeedParams()
    steps, res, launches, ms = {}, {}, {}, {}
    for tp in (1, TP):
        devices = shard_devices(tp, "cuda")
        pc, idx, off, _base, sb = shard_index(pack, tp=tp, k=sp.k)
        on = [torch.device(d) for d in devices]
        args = ([torch.from_numpy(pc[j]).to(d) for j, d in enumerate(on)],
                {k: [torch.from_numpy(v[j]).to(d) for j, d in enumerate(on)]
                 for k, v in idx.items()},
                [torch.from_numpy(off[j].astype(np.int64)).to(d)
                 for j, d in enumerate(on)], sb)

        def step(args=args, devices=devices):
            return distributed_profile_step(
                codes_t, qlens_t, *args, GLOBAL_SCORING, sp, 128,
                pack.num_seqs, devices=devices)

        steps[tp] = step
        cuda_sw.LAUNCHES.clear()
        out = step()
        res[tp] = {k: v.cpu().numpy() for k, v in out.items()}
        launches[tp] = dict(cuda_sw.LAUNCHES)
        ms[tp], _ = cuda_ms(step, 5)
        if launches[tp] != {"K1": tp}:
            fail(f"tp_step at tp = {tp} launched {launches[tp]}")
    truth = np.bincount(origin, minlength=TP_STEP_SEQS)
    for tp in (1, TP):
        if not (np.array_equal(res[tp]["counts"], truth)
                and int(res[tp]["bp"].sum()) == 100 * BATCH
                and int(res[tp]["aligned_reads"]) == BATCH):
            fail(f"tp_step at tp = {tp}: counts disagree with the truth")
    variants = _shard_variants(
        _captured_dp_calls(steps[TP]),
        [("K1", False, f"shard {j}") for j in range(TP)], GLOBAL_SCORING,
        "global", "tp step", "tp_step_kernels")
    emit("tp_step", reads=BATCH, contigs=TP_STEP_SEQS,
         pack_mb=pack.total_len / 1e6, tp=TP, banded_sw_launches=launches[TP],
         launches_tp1=launches[1], step_ms={str(k): v for k, v in ms.items()},
         counts_equal_tp1=True, counts_equal_truth=True, card=smi_line)
    return launches[TP], variants


def phase_tp_species(comm, fq, truth, main, smi_line):
    """run_species_multihost(tp=2) over phase 3's database and 65,536
    reads (batch 8,192) on this card: K1 2 x 8, every shard on the card,
    the profile against the truth and equal to phase main's (tp = 1:
    the CPU tests find tp = 2 = tp = 1 on sim_community and on a
    community whose tie sets differ); then on the same profiler the
    reads again, warm, for reads/s beside phase main's, one batch's
    device step and the cross-shard gather, the first batch's K1 calls
    held to the plain version, and 2,048 reads on the card against the
    same shards on the CPU; then run(m8_path=...) at tp = 2 (fault k):
    K1 once a batch on one aligner over the whole pack, the abundance
    and stats of phase main, its alignments.m8 left for phase species_m8
    to compare. Returns ({tp_species, tp_species_m8: launches}, variant
    records)."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.align.params import MARKER_SCORING
    from midas_tpu_torch.align.pipeline import _align_batch_stages
    from midas_tpu_torch.dist import driver
    from midas_tpu_torch.dist.species import (_CLASSIFY_KEYS,
                                              DistributedSpeciesProfiler,
                                              gather_tables)
    from midas_tpu_torch.io.batch import load_read_batches
    from midas_tpu_torch.profile import device_steps as ds
    from midas_tpu_torch.profile.species import write_abundance

    made, stage = [], []
    real_init = DistributedSpeciesProfiler.__init__
    real_run = DistributedSpeciesProfiler._run_device

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def run_device(self, *a, **k):
        t = time.perf_counter()
        try:
            return real_run(self, *a, **k)
        finally:
            torch.cuda.synchronize()
            stage.append(time.perf_counter() - t)

    DistributedSpeciesProfiler.__init__ = init
    DistributedSpeciesProfiler._run_device = run_device
    out = os.path.join(WORK, "tp_species")
    try:
        cuda_sw.LAUNCHES.clear()
        t0 = time.perf_counter()
        abundance = driver.run_species_multihost(
            comm.db_dir, [fq], outdir=out, tp=TP, batch_size=BATCH,
            device="cuda")
        wall = time.perf_counter() - t0
        launches = dict(cuda_sw.LAUNCHES)
    finally:
        DistributedSpeciesProfiler.__init__ = real_init
        DistributedSpeciesProfiler._run_device = real_run
    n_batches = -(-N_READS // BATCH)
    if launches != {"K1": TP * n_batches}:
        fail(f"tp_species launched {launches} for {n_batches} batches "
             f"(want K1 {TP} x {n_batches})")
    prof = made[0]
    al = prof.aligner
    shards = _shard_figures(al, "tp_species")
    counted, in_first, stray, _ = _species_truth(abundance, truth)
    differ = sorted(s for s in abundance
                    if abundance[s] != main["abundance"][s])
    if differ:
        fail(f"tp_species: {len(differ)} species differ from phase main's "
             f"tp = 1 profile, e.g. {differ[:3]}")
    with open(os.path.join(WORK, "main_species_profile.txt"), "rb") as f, \
            open(os.path.join(out, "species/species_profile.txt"), "rb") as g:
        if f.read() != g.read():
            fail("tp_species: species_profile.txt differs from phase main's")

    # warm: the same reads on the same profiler, timed as phase main is
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    again = prof.run([fq], batch_size=BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    if again != abundance:
        fail("tp_species: a second run on the same profiler differs")

    # one batch: the device step, the gather, the K1 calls per shard
    b = next(iter(load_read_batches([fq], batch_size=BATCH,
                                    max_len=al.max_read_len)))
    codes = torch.from_numpy(b.codes).cuda()
    qlens = torch.from_numpy(b.lengths).cuda()
    n_species = len(prof.species_order)
    state = ds.species_init(n_species, prof._amb_width(), 2 * BATCH,
                            prof.device)
    seq_species = torch.from_numpy(prof.seq_species).cuda()
    seq_cutoff = torch.from_numpy(prof.seq_cutoff).cuda()
    min_score = torch.from_numpy(MARKER_SCORING.evalue_min_score(
        np.maximum(np.arange(al.max_read_len + 1), 1),
        float(prof.pack.total_len))).cuda()

    def step():
        state.amb_n.zero_()
        prof._species_step(state, seq_species, seq_cutoff, codes, qlens,
                           b.n_reads, 0, min_score)

    step_ms, _ = cuda_ms(step, 5)
    outs = [_align_batch_stages(sh.index_arrays, sh.pack_arrays, codes, qlens,
                                al.scoring, al.seed_params, al.max_read_len)
            for sh in al.shards]
    gather_ms, _ = cuda_ms(lambda: gather_tables(al.shards, outs,
                                                 _CLASSIFY_KEYS), 5)
    variants = _shard_variants(
        _captured_dp_calls(step),
        [("K1", False, f"shard {j}") for j in range(TP)], al.scoring,
        "marker", "tp species", "tp_species_kernels")

    # the card against the same shards on the CPU, at 2,048 reads
    files, secs = {}, {}
    for dev, p in (("cuda", prof), ("cpu", _cpu_twin(prof))):
        cuda_sw.LAUNCHES.clear()
        t = time.perf_counter()
        ab = p.run([fq], max_reads=N_CPU_READS, batch_size=BATCH)
        secs[dev] = time.perf_counter() - t
        if (dev == "cpu") == bool(cuda_sw.LAUNCHES):
            fail(f"tp_species at 2,048 reads on {dev} launched "
                 f"{dict(cuda_sw.LAUNCHES)}")
        d = os.path.join(WORK, f"tp_species_{dev}")
        os.makedirs(os.path.join(d, "species/temp"), exist_ok=True)
        write_abundance(os.path.join(d, M8_OUTPUTS[0]), ab)
        with open(os.path.join(d, M8_OUTPUTS[1]), "w") as f:
            f.write(f"{p.stats['total_reads']}\t{p.stats['total_bp']}")
        files[dev] = d
    _same_files(files["cuda"], files["cpu"], M8_OUTPUTS[:2],
                "tp_species at 2,048 reads, card vs CPU")

    # --m8 at tp = 2: the host path on one aligner over the whole pack,
    # built on shard 0's card; phase species_m8 compares the file
    m8 = os.path.join(WORK, "tp_species_m8", "alignments.m8")
    os.makedirs(os.path.dirname(m8), exist_ok=True)
    cuda_sw.LAUNCHES.clear()
    t = time.perf_counter()
    ab_m8 = prof.run([fq], batch_size=BATCH, m8_path=m8)
    torch.cuda.synchronize()
    m8_secs = time.perf_counter() - t
    m8_launches = dict(cuda_sw.LAUNCHES)
    if m8_launches != {"K1": n_batches}:
        fail(f"tp_species --m8 launched {m8_launches} for {n_batches} "
             "batches (want K1 once a batch, on one aligner)")
    if ab_m8 != main["abundance"] or prof.stats != main["stats"]:
        fail("tp_species --m8: abundance or stats differ from phase main's")
    if prof.aligner is not al:
        fail("tp_species --m8 left the profiler without its shards")
    emit("tp_species", reads=N_READS, batch=BATCH, batches=n_batches, tp=TP,
         entry_point_seconds=wall, setup_seconds=wall - stage[0],
         profile_seconds=stage[0], seconds=dt, reads_per_sec=N_READS / dt,
         main_reads_per_sec=main["reads_per_sec"],
         reads_per_sec_over_main=N_READS / dt / main["reads_per_sec"],
         banded_sw_launches=launches, device_step_ms=step_ms,
         main_device_step_ms=main["device_step_ms"],
         device_busy_share=step_ms * n_batches / 1e3 / dt,
         gather_ms=gather_ms, max_memory_allocated=peak, shards=shards,
         counted_reads=counted, counted_in_abundant=in_first,
         stray_reads=stray, species_differing_from_tp1=len(differ),
         cpu_identical=True, cpu_check_seconds=secs,
         m8=dict(seconds=m8_secs, reads_per_sec=N_READS / m8_secs,
                 banded_sw_launches=m8_launches, abundance_equal_main=True,
                 stats_equal_main=True, m8_bytes=os.path.getsize(m8)),
         card=smi_line)
    return {"tp_species": launches, "tp_species_m8": m8_launches}, variants


def _tp_cli_check(comm, fq, program, mode, smi_line):
    """run_<program>_multihost(tp=2) over 2,048 reads of the phase-3
    community's first 20 species, on the card and on the CPU: every
    output file identical, the CPU run launching nothing. Returns (the
    card run's launches, seconds per device)."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.dist import driver

    ids = [sp.species_id for sp in comm.species[:N_GENES_CPU_SPECIES]]
    fn = getattr(driver, f"run_{program}_multihost")
    outs, secs, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(WORK, f"tp_{program}_cli_{dev}")
        cuda_sw.LAUNCHES.clear()
        t = time.perf_counter()
        fn(comm.db_dir, [fq], ids, outdir=outs[dev], tp=TP,
           max_reads=N_CPU_READS, mode=mode, device=dev)
        secs[dev] = time.perf_counter() - t
        launches[dev] = dict(cuda_sw.LAUNCHES)
    n_b = -(-N_CPU_READS // BATCH)
    if launches != {"cuda": {"K3_qpen": TP * n_b, "K2": TP * n_b},
                    "cpu": {}}:
        fail(f"tp {program} at 2,048 reads launched {launches}")
    names = sorted(os.listdir(os.path.join(outs["cuda"], program, "output")))
    _same_files(outs["cuda"], outs["cpu"], [f"{program}/summary.txt"] + [
        f"{program}/output/{n}" for n in names],
        f"tp {program} -m {mode} at 2,048 reads, card vs CPU")
    return launches["cuda"], secs


def _tp_two_pass(phase, path, tprof, prof, reads, fields, keys, smi_line,
                 extra_timer=None):
    """The body of tp_genes / tp_snps: the sharded profiler tprof (tp = 2)
    and the single-device profiler prof over the first N_TP_READS reads
    (and mate pairs `reads`), results equal array by array; K3 with qpen
    and K2 2 x batches; one batch's sharded step against prof's, the
    gather, each shard's two DP calls on the first batch held to the
    plain version. Returns (figures, launches, variant records)."""
    import torch

    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.dist.profilers import (_GATHER_KEYS,
                                                _local_and_gathered)
    from midas_tpu_torch.dist.species import gather_tables
    from midas_tpu_torch.profile import device_steps as ds

    fq, pairs = reads
    al = tprof.aligner
    tprof.run([fq], max_reads=BATCH, batch_size=BATCH)     # warm-up
    n_b = N_TP_READS // BATCH
    runs = {}
    for name, p, paths, paired in (
            ("tp2", tprof, [fq], False), ("tp1", prof, [fq], False),
            ("tp2_paired", tprof, list(pairs), True),
            ("tp1_paired", prof, list(pairs), True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_sw.LAUNCHES.clear()
        t = time.perf_counter()
        res = p.run(paths, max_reads=N_TP_READS // (2 if paired else 1),
                    batch_size=BATCH, paired=paired)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        runs[name] = dict(res=res, seconds=dt, reads_per_sec=N_TP_READS / dt,
                          launches=dict(cuda_sw.LAUNCHES),
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        t_ = TP if name.startswith("tp2") else 1
        if runs[name]["launches"] != {"K3_qpen": t_ * n_b, "K2": t_ * n_b}:
            fail(f"{phase} ({name}) launched {runs[name]['launches']} for "
                 f"{n_b} batches")
    for a, b in (("tp2", "tp1"), ("tp2_paired", "tp1_paired")):
        for k in keys:
            if not np.array_equal(np.asarray(runs[a]["res"][k]),
                                  np.asarray(runs[b]["res"][k])):
                fail(f"{phase}: {k} at tp = {TP} differs from tp = 1 ({a})")
    b, arrays = _first_batch(al, fq, fields)
    table = torch.from_numpy(ds.score_min_table(al.scoring,
                                                al.max_read_len)).cuda()
    if path == "tp genes":
        def make(p):
            st = ds.genes_init(p.pack.num_seqs, "cuda")
            return lambda: p._genes_step(st, *arrays, b.n_reads, table, False)
    else:
        cs = torch.from_numpy(prof.contig_species.astype(np.int64)).cuda()

        def make(p):
            st = p._init_state(2 * BATCH)
            return lambda: p._snps_step(st, cs, *arrays, b.n_reads, table,
                                        False)
    step_fns = [make(p) for p in (tprof, prof)]
    (step_ms, _), (step1_ms, _) = (cuda_ms(f, 5) for f in step_fns)
    codes, quals, qlens = arrays[0], arrays[1], arrays[2]
    locs, _ = _local_and_gathered(al.shards, codes, qlens, al.scoring,
                                  al.seed_params, al.max_read_len, quals=quals)
    gather_ms, _ = cuda_ms(lambda: gather_tables(
        al.shards, [loc[0] for loc in locs], _GATHER_KEYS), 5)
    sname = "local" if al.scoring.mode == "local" else "global"
    variants = _shard_variants(
        _captured_dp_calls(step_fns[0]),
        [("K3", True, f"pass 1 shard {j}") for j in range(TP)]
        + [("K2", False, f"pass 2 shard {j}") for j in range(TP)],
        al.scoring, sname, path, f"{phase}_kernels")
    figures = dict(
        reads=N_TP_READS, batch=BATCH, batches=n_b, tp=TP,
        **{f"{name}_{k}": r[k] for name, r in runs.items()
           for k in ("seconds", "reads_per_sec", "launches",
                     "max_memory_allocated")},
        reads_per_sec_tp2_over_tp1=runs["tp2"]["reads_per_sec"]
        / runs["tp1"]["reads_per_sec"],
        device_step_ms=step_ms, device_step_ms_tp1=step1_ms,
        gather_ms=gather_ms, equal_to_tp1=True,
        shards=_shard_figures(al, phase), card=smi_line)
    return figures, runs["tp2"]["launches"], variants


def phase_tp_genes(gcomm, gprof, gfq, pairs, comm, fq, smi_line):
    """The genes cell's 10-species pangenome (52,240 centroids) at tp = 2
    on this card, beside phase genes_main's tp = 1 profiler, over the
    first 16,384 reads and 8,192 mate pairs (_tp_two_pass), then
    run_genes_multihost(tp=2) card against CPU at 2,048 reads.
    Returns (launches by path, variant records)."""
    import torch

    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.dist.profilers import DistributedGenesProfiler

    t = time.perf_counter()
    tprof = DistributedGenesProfiler(Database(gcomm.db_dir),
                                     gprof.species_ids, tp=TP, device="cuda")
    setup = time.perf_counter() - t
    figures, launches, variants = _tp_two_pass(
        "tp_genes", "tp genes", tprof, gprof, (gfq, pairs),
        ("codes", "quals", "lengths", "mean_qual"),
        ("aligned_reads", "mapped_reads", "depth", "copies", "marker_cov"),
        smi_line)
    # the written files, at tp = 2 and tp = 1, from the single-end runs
    tprof.run([gfq], max_reads=N_TP_READS, batch_size=BATCH)
    gprof.run([gfq], max_reads=N_TP_READS, batch_size=BATCH)
    dirs = [os.path.join(WORK, f"tp_genes_{n}") for n in ("tp2", "tp1")]
    for p, d in zip((tprof, gprof), dirs):
        p.write_results(d)
    _same_files(dirs[0], dirs[1], ["genes/summary.txt"] + [
        f"genes/output/{n}" for n in sorted(os.listdir(
            os.path.join(dirs[1], "genes/output")))],
        "tp_genes files, tp = 2 vs tp = 1")
    del tprof
    torch.cuda.empty_cache()
    cli_launches, cli_secs = _tp_cli_check(comm, fq, "genes", "local",
                                           smi_line)
    emit("tp_genes", setup_seconds=setup, files_equal_tp1=True,
         cli_identical=True, cli_seconds=cli_secs, **figures)
    return {"tp_genes": launches, "tp_genes_cli": cli_launches}, variants


def phase_tp_snps(gcomm, sprof, gfq, pairs, comm, fq, smi_line):
    """The snps cell's 10 species (30 Mb, two count stripes) at tp = 2 on
    this card, beside phase snps_main's tp = 1 profiler, over the first
    16,384 reads and 8,192 mate pairs: counts, counters and gapped rows
    equal (_tp_two_pass), the end-of-stream stripe readback timed, and
    each stripe alone through the whole int32 copy and counts_host_sparse
    (the route taken within READBACK_SLACK of the whole copy); then
    run_snps_multihost(tp=2) -m global card against CPU at 2,048 reads.
    Returns (launches by path, variant records)."""
    import torch

    from midas_tpu_torch.db.layout import Database
    from midas_tpu_torch.dist.profilers import DistributedSnpsProfiler
    from midas_tpu_torch.profile import sparse_counts as sc

    t = time.perf_counter()
    tprof = DistributedSnpsProfiler(Database(gcomm.db_dir),
                                    sprof.species_ids, tp=TP, device="cuda")
    setup = time.perf_counter() - t
    readback, last = [], {}
    real = tprof._state_host

    def state_host(state):
        t = time.perf_counter()
        try:
            return real(state)
        finally:
            readback.append(time.perf_counter() - t)
            last["stripes"] = state.stripes

    tprof._state_host = state_host
    figures, launches, variants = _tp_two_pass(
        "tp_snps", "tp snps", tprof, sprof, (gfq, pairs),
        ("codes", "quals", "lengths", "mean_qual"),
        ("counts", "aligned_reads", "mapped_reads", "n_gapped"), smi_line)
    # the last run's stripes alone: the whole int32 copy against
    # counts_host_sparse (the route its statistics pick), best of 3
    SL = tprof.stripe_len
    stripes = []
    for n, stripe in zip(tprof.stripe_real, last.pop("stripes")):
        whole_s, whole = _timed(lambda: stripe.to("cpu", copy=True).numpy())
        sc.ROUTES.clear()
        route_s, got = _timed(lambda: sc.counts_host_sparse(stripe, SL))
        whole[SL] = 0
        if not np.array_equal(got, whole):
            fail("tp_snps: a stripe's counts_host_sparse differs from it")
        route, = sc.ROUTES
        if min(route_s) > READBACK_SLACK * min(whole_s):
            fail(f"tp_snps: a stripe's {route} route took {min(route_s):.4f}"
                 f" s, the whole copy {min(whole_s):.4f} s")
        _, stats = sc._phase_a(stripe, SL)
        stripes.append(dict(real_len=int(n), bytes=4 * 4 * (SL + 1),
                            n_covered=stats[0],
                            whole_readback_seconds=min(whole_s),
                            route_readback_seconds=min(route_s),
                            route=route))
    del tprof
    torch.cuda.empty_cache()
    cli_launches, cli_secs = _tp_cli_check(comm, fq, "snps", "global",
                                           smi_line)
    emit("tp_snps", setup_seconds=setup, stripes=stripes,
         stripe_readback_seconds=readback, cli_identical=True,
         cli_seconds=cli_secs, **figures)
    return {"tp_snps": launches, "tp_snps_cli": cli_launches}, variants


# the bench line's keys (bench.py's) and the kernels each of its legs
# must launch
BENCH_DETAIL_KEYS = (
    "pangenome_reads_per_sec", "pangenome_vs_baseline", "snps_reads_per_sec",
    "snps_vs_baseline", "pileup_sites_per_sec", "marker_device_reads_per_sec",
    "snps_device_reads_per_sec", "n_reads", "scale_marker_reads_per_sec",
    "scale_pangenome_reads_per_sec", "scale_snps_reads_per_sec",
    "scale_rep_pack_mb", "scale_n_reads", "scale_snps_vs_baseline",
    "platform", "launches")
BENCH_LEG_KERNELS = {"species": ("K1",), "genes": ("K3_qpen", "K2"),
                     "snps": ("K3_qpen", "K2"), "species_device": ("K1",),
                     "snps_device": ("K3_qpen", "K2"),
                     "scale": ("K1", "K3_qpen", "K2")}


def phase_bench(kind, smi, t_start):
    """`python -m midas_tpu_torch.bench` in this process at bench.py's
    sizes, after every profiler of the earlier phases is freed: its JSON
    line's keys, every rate above 0, the card in its platform, and each
    leg's kernels launched. Equal results across reps are the bench's own
    check (bench.common.best_of raises otherwise)."""
    from midas_tpu_torch.align import cuda_sw
    from midas_tpu_torch.bench.__main__ import main as bench_main

    cuda_sw.LAUNCHES.clear()
    t0 = time.time()
    rec = bench_main([])
    secs = time.time() - t0
    launches = dict(cuda_sw.LAUNCHES)
    det = rec["detail"]
    if set(rec) != {"metric", "value", "unit", "vs_baseline", "detail"} \
            or set(BENCH_DETAIL_KEYS) - set(det):
        fail(f"bench line keys {sorted(rec)}, detail {sorted(det)}")
    rates = {k: v for k, v in det.items() if k.endswith("_per_sec")}
    if rec["value"] <= 0 or min(rates.values()) <= 0:
        fail(f"bench rates not above 0: {rec['value']}, {rates}")
    if kind not in det["platform"] or smi not in det["platform"]:
        fail(f"bench platform {det['platform']!r} does not name the card")
    missing = [(leg, k) for leg, ks in BENCH_LEG_KERNELS.items() for k in ks
               if det["launches"][leg].get(k, 0) <= 0]
    if missing:
        fail(f"bench legs launched no {missing}: {det['launches']}")
    emit("bench", seconds=round(secs, 1),
         script_seconds=round(time.time() - t_start, 1),
         banded_sw_launches=launches, platform=det["platform"])
    return launches


def kernels_line(variants, by_path, smi_line):
    """The kernels line: one entry per kernel the paths run, timed at its
    path's shape, with its path's launches — banded_sw (K1, packed, at
    the species batch), banded_sw_k3_qpen (K3, packed, at genes pass 1),
    banded_sw_k2 (K2, packed, at genes pass 2) — and banded_sw_template
    (the template kernel, on the above-the-limit check, on no path).
    Marks each variant record with its path and that path's launches
    (the paired paths' records, "paired genes / snps pass 1 / 2", and the
    m8 path's K1 record, "m8 path batch", sit in their kernels'
    variants)."""
    for v in variants:
        tp_path = next((p for p in ("tp step", "tp species", "tp genes",
                                    "tp snps") if v["shape"].startswith(p)),
                       None)
        path = (tp_path.replace(" ", "_") if tp_path else
                "species" if v["shape"] == "main path batch" else
                "species_m8" if v["shape"] == "m8 path batch" else
                "paired_genes" if v["shape"].startswith("paired genes") else
                "paired_snps" if v["shape"].startswith("paired snps") else
                "genes" if v["shape"].startswith("genes") and
                v["scoring"] == "local" else
                "genes_cli_global" if v["shape"].startswith("genes") else
                "snps" if v["shape"].startswith("snps") and
                v["scoring"] == "global" else
                "snps_cli_local" if v["shape"].startswith("snps") else None)
        v["path"] = path
        v["launches"] = by_path[path].get(v["key"], 0) if path else 0

    def group(function, variant=None):
        return [v for v in variants if v["function"] == function
                and variant in (None, v["variant"])]

    def entry(name, group, shape, launches, scorings=("marker", "local")):
        timed = next(v for v in group if v["shape"] == shape
                     and v["scoring"] in scorings)
        return dict(
            name=name, route="cuda", source="midas_tpu_torch/csrc/banded_sw.cu",
            replaces="midas_tpu/align/pallas_sw.py:328", launches=launches,
            launches_by_path=by_path,
            max_abs_err=max(v["max_abs_err"] for v in group),
            ms=timed["ms"], plain_ms=timed["plain_ms"],
            bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
            library_ms=None, equal=all(v["equal"] for v in group),
            tolerance=0.0, card=smi_line, variants=group)

    return {"kernels": [
        entry("banded_sw", group("packed", "K1"), "main path batch",
              by_path["species"].get("K1", 0)),
        entry("banded_sw_k3_qpen", group("packed", "K3"), "genes pass 1",
              by_path["genes"].get("K3_qpen", 0)),
        entry("banded_sw_k2", group("packed", "K2"), "genes pass 2",
              by_path["genes"].get("K2", 0)),
        entry("banded_sw_template", group("template"),
              "above the packing limit", 0),
        entry("banded_sw_k3_qpen_glocal", group("packed", "K3"),
              "snps pass 1", by_path["snps"].get("K3_qpen", 0),
              scorings=("global",)),
        entry("banded_sw_k2_glocal", group("packed", "K2"), "snps pass 2",
              by_path["snps"].get("K2", 0), scorings=("global",)),
        entry("banded_sw_k1_glocal", group("packed", "K1"),
              "tp step shard 0", by_path["tp_step"].get("K1", 0),
              scorings=("global",)),
    ]}


def main():
    if not os.path.isdir(os.path.join(ROOT, "midas_tpu_torch")):
        fail("chip_smoke.py must sit at the root of a checkout of the repo "
             "(midas_tpu_torch/ beside it)")
    t_start = time.time()
    kind, smi_line = phase_device()
    # CPU work that no phase times runs beside the phases, in one
    # background process on one niced core: the CPU halves of phases cpu,
    # m8_cli and merge_cli, dbbuild_main's simulation, build and CPU
    # check, and merge_main's reads
    background = multiprocessing.get_context("spawn").Pool(
        1, initializer=_background_init)
    try:
        _phases(kind, smi_line, background, t_start)
    finally:
        background.terminate()
        background.join()


def _phases(kind, smi_line, background, t_start):
    import torch

    phase_build()
    comm, fq, truth, prof = phase_data()
    variants = phase_kernels(prof, fq)
    tp_step_launches, tp_variants = phase_tp_step(smi_line)
    variants += tp_variants
    main_run = phase_main(prof, fq, truth)
    cpu_run, m8_cpu_run = (
        background.apply_async(_in_background,
                               (_cpu_cli, _species_cli(comm, fq, "cpu",
                                                       m8)[1]))
        for m8 in (False, True))
    dbbuild_run, merge_cli_run = (
        background.apply_async(_in_background, (fn,))
        for fn in (dbbuild_prepare, merge_cli_prepare))
    tp_species_launches, tp_variants = phase_tp_species(comm, fq, truth,
                                                        main_run, smi_line)
    variants += tp_variants
    torch.cuda.empty_cache()
    m8_launches, m8_variant = phase_species_m8(prof, fq, main_run, smi_line)
    variants.append(m8_variant)
    phase_cpu_vs_card(comm, fq, cpu_run)
    m8_cli_launches = phase_m8_cli(comm, fq, m8_cpu_run, smi_line)
    del prof
    torch.cuda.empty_cache()
    gcomm, gfq, gprof = phase_genes_data()
    merge_main_sim = background.apply_async(_in_background,
                                            (merge_main_simulate, gcomm))
    variants += phase_genes_kernels(gprof, gfq)
    genes_launches = phase_genes_main(gcomm, gprof, gfq)
    genes_cli = phase_genes_cpu(comm, fq)
    pairs = phase_paired_data(gcomm, smi_line)
    paired_genes_launches, paired_variants = phase_paired_genes_main(
        gcomm, gprof, pairs, smi_line)
    variants += paired_variants
    tp_genes_launches, tp_variants = phase_tp_genes(gcomm, gprof, gfq, pairs,
                                                    comm, fq, smi_line)
    variants += tp_variants
    del gprof
    torch.cuda.empty_cache()
    sprof = phase_snps_data(gcomm)
    variants += phase_snps_kernels(sprof, gfq)
    snps_launches, snps_res = phase_snps_main(gcomm, sprof, gfq)
    phase_readback(sprof, snps_res, smi_line)
    del snps_res
    paired_snps_launches, paired_variants = phase_paired_snps_main(
        gcomm, sprof, pairs, smi_line)
    variants += paired_variants
    tp_snps_launches, tp_variants = phase_tp_snps(gcomm, sprof, gfq, pairs,
                                                  comm, fq, smi_line)
    variants += tp_variants
    del sprof
    torch.cuda.empty_cache()
    snps_cli = phase_snps_cpu(comm, fq)
    dbbuild_launches = phase_dbbuild_main(
        dbbuild_run.get(BACKGROUND_TIMEOUT), smi_line)
    paired_cli = phase_paired_cli(comm, smi_line)
    multirank_launches = phase_multirank(comm, fq, smi_line)
    merge_cli_launches, merge_cli_dirs = phase_merge_cli(
        merge_cli_run.get(BACKGROUND_TIMEOUT), smi_line)
    merge_main_launches, merged_snps = phase_merge_main(
        gcomm, merge_main_sim.get(BACKGROUND_TIMEOUT), smi_line)
    phase_analysis_main(merged_snps, merge_cli_dirs, smi_line)
    bench_launches = phase_bench(kind, smi_line, t_start)
    by_path = {"species": main_run["launches"], "genes": genes_launches,
               "genes_cli_global": genes_cli["global"]["card_launches"],
               "snps": snps_launches,
               "snps_cli_local": snps_cli["local"]["card_launches"],
               "paired_genes": paired_genes_launches,
               "paired_snps": paired_snps_launches,
               "paired_cli_genes": paired_cli["genes"]["card_launches"],
               "paired_cli_snps": paired_cli["snps"]["card_launches"],
               "species_m8": m8_launches, "m8_cli": m8_cli_launches,
               "merge_cli": merge_cli_launches,
               "merge_main": merge_main_launches, **multirank_launches,
               "dbbuild_main": dbbuild_launches,
               "tp_step": tp_step_launches, **tp_species_launches,
               **tp_genes_launches, **tp_snps_launches,
               "bench": bench_launches}
    print(json.dumps(kernels_line(variants, by_path, smi_line)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:   # one rank of phase multirank
        rank_worker(json.loads(sys.argv[2]))
    else:
        main()
