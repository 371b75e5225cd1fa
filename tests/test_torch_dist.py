"""The port's multi-process runs (midas_tpu_torch/dist/driver.py) on the
CPU, with gloo and subprocess ranks: the input sharding rules against
midas_tpu.dist.driver's; the end-of-stream gathers and the species merge
in 2 ranks against a numpy rank-major concatenation, dtypes included;
run_species_multihost in 2 and 3 ranks, and `run_midas genes -m local`
/ `snps -m global` in 2 ranks over single-end reads and -1/-2 pairs,
byte for byte against midas_tpu's single-process runs (snps at Q40,
where the two gapped-read oracles agree); `torchrun` over the CLI and a
rerun under another rank count; the guards (--m8, stage splits, tp > 1)
with midas_tpu's messages; and the failures that must fail the run: a
rank that dies, a rank that hangs past the timeout, and a card asked
for where there is none. Exact equality throughout."""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from midas_tpu.dist import driver as jdriver
from midas_tpu.testkit import simulate_paired_reads, simulate_reads
from midas_tpu_torch.dist import driver as tdriver

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 128

# one rank: the driver's entry points, run from a JSON spec
_WORKER = r"""
import json, os, pickle, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from midas_tpu_torch.dist import driver

from midas_tpu_torch.profile import common

spec = json.loads(sys.argv[1])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
mode = spec["mode"]
driver.DEFAULT_TIMEOUT_S = spec.get("timeout", 120)
common.BATCH_SIZE = spec.get("batch_size", common.BATCH_SIZE)
if mode == "cli":
    from midas_tpu_torch.cli.run_midas import main
    if spec.get("fault") and rank == 1:
        driver.initialize()
        if spec["fault"] == "dies":
            os._exit(3)
        time.sleep(600)   # hangs
    exits = []
    for argv in spec["commands"]:
        try:
            main(argv)
            exits.append(None)
        except SystemExit as e:
            exits.append(str(e.code))
    print("RESULT " + json.dumps(dict(rank=rank, exits=exits)), flush=True)
elif mode in ("species", "entry"):
    # the explicit form of initialize (tcp://), as a user's script calls
    # it; "entry" then calls the per-sample entry point with no launcher
    # variables left in the environment
    driver.initialize(f"{os.environ['MASTER_ADDR']}:"
                      f"{os.environ['MASTER_PORT']}", world, rank)
    if mode == "species":
        driver.run_species_multihost(
            spec["db"], spec["fq"], outdir=spec["outdir"],
            batch_size=spec["batch_size"], max_reads=spec["max_reads"],
            device="cpu")
    else:
        for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                  "MASTER_PORT"):
            del os.environ[k]
        from midas_tpu_torch.profile import genes, species
        run = dict(species=species.run_species, genes=genes.run_genes)
        run[spec["program"]](dict(spec["args"], device="cpu"))
    print("RESULT " + json.dumps(dict(rank=rank)), flush=True)
elif mode == "gather":
    driver.initialize()
    exec(spec["gen"])
    x = rank_inputs(rank)
    out = dict(
        sum_int32=driver._allgather_sum(x["sum_int32"]),
        sum_float64=driver._allgather_sum(x["sum_float64"]),
        rows_int8=driver._allgather_rows(x["rows_int8"]),
        rows_int32=driver._allgather_rows(x["rows_int32"]),
        merge=driver.merge_species_accumulators(*x["merge"]))
    with open(f"{spec['out']}.{rank}", "wb") as f:
        pickle.dump(out, f)
    print("RESULT " + json.dumps(dict(rank=rank)), flush=True)
"""

# each rank's inputs to the gathers: ragged rows, one rank without any
_GEN = r"""
def rank_inputs(rank):
    rng = np.random.default_rng(rank)
    n_amb = (5, 0)[rank]
    amb = []
    for r in range(n_amb):
        w = int(rng.integers(2, 6))
        amb.append((rng.integers(0, 50, w).astype(np.int32),
                    rng.integers(0, 7, w).astype(np.int32),
                    rng.random(w) * 100.0, 1000 * rank + 7 * r))
    return dict(
        sum_int32=rng.integers(-1000, 1000, (5, 3)).astype(np.int32),
        sum_float64=rng.random(7),
        rows_int8=rng.integers(0, 5, ((4, 0)[rank], 6)).astype(np.int8),
        rows_int32=rng.integers(0, 9, ((0, 3)[rank], 4)).astype(np.int32),
        merge=(rng.integers(0, 9, 7).astype(np.int64), rng.random(7) * 90,
               amb, dict(total_reads=100 + rank, total_bp=10000 * (rank + 1),
                         total_alns=3 + rank)))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(n, spec, logdir, timeout=240, wait=None):
    """Start n ranks of the worker above with the environment a launcher
    sets (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); wait
    for the ranks in `wait` (all by default), then kill the rest. Returns
    [(rc, stdout, stderr)] of the waited ranks."""
    base = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-c", _WORKER, json.dumps(spec)]
    os.makedirs(logdir, exist_ok=True)
    procs, logs = [], []
    for r in range(n):
        out = open(os.path.join(logdir, f"rank{r}.out"), "w+")
        err = open(os.path.join(logdir, f"rank{r}.err"), "w+")
        procs.append(subprocess.Popen(
            cmd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=out, stderr=err, text=True, cwd=ROOT))
        logs.append((out, err))
    results = []
    try:
        for r in (range(n) if wait is None else wait):
            try:
                procs[r].wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {n} timed out")
            out, err = logs[r]
            out.seek(0)
            err.seek(0)
            results.append((procs[r].returncode, out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()
    return results


def _ok(results):
    for rc, out, err in results:
        assert rc == 0, f"rank failed:\n{out}\n{err[-3000:]}"
    return [json.loads(next(line[7:] for line in out.splitlines()
                            if line.startswith("RESULT ")))
            for _, out, _ in results]


def _read(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def _same_outputs(want_dir, got_dir, program):
    """Every output file of a run (decompressed) and its species list,
    byte for byte."""
    rels = ["summary.txt", "species.txt"] + [
        f"output/{f}" for f in sorted(os.listdir(
            os.path.join(want_dir, program, "output")))]
    assert len(rels) > 2
    for rel in rels:
        assert _read(os.path.join(got_dir, program, rel)) == \
            _read(os.path.join(want_dir, program, rel)), rel


def _q40(src, dst):
    """Copy a gzipped FASTQ with every quality line set to Phred 40."""
    with gzip.open(src, "rt") as fi, gzip.open(dst, "wt") as fo:
        for i, line in enumerate(fi):
            if i % 4 == 3:
                line = "I" * len(line.rstrip("\n")) + "\n"
            fo.write(line)


# ---------------------------------------------------------------------------
# (a) input sharding
# ---------------------------------------------------------------------------

SHARDING = {
    "files": dict(n_files=4, pcount=2),
    "paired": dict(n_files=2, pcount=2, paired=True),
    "max_reads": dict(n_files=4, pcount=2, max_reads=10),
    "force_stride": dict(n_files=4, pcount=2, force_stride=True),
    "fewer_files_than_ranks": dict(n_files=1, pcount=3),
    "three_files_three_ranks": dict(n_files=3, pcount=3),
    "one_rank": dict(n_files=2, pcount=1),
}


@pytest.mark.parametrize("case", sorted(SHARDING))
def test_sharding_equals_midas_tpu(case):
    """shard_read_paths, _stride_setup and stride_batches give every rank
    midas_tpu's paths and batches, each batch tagged with its global
    stream index: pairs never split, max_reads caps the shared stream."""
    c = dict(SHARDING[case])
    n_files, pcount = c.pop("n_files"), c.pop("pcount")
    paths = [f"r{i}.fq.gz" for i in range(n_files)]
    for pid in range(pcount):
        assert tdriver.shard_read_paths(paths, pid, pcount) == \
            jdriver.shard_read_paths(paths, pid, pcount)
        got, want = types.SimpleNamespace(), types.SimpleNamespace()
        assert tdriver._stride_setup(got, paths, pid, pcount, **c) == \
            jdriver._stride_setup(want, paths, pid, pcount, **c)
        assert hasattr(got, "_batch_filter") == hasattr(want, "_batch_filter")
        if not hasattr(want, "_batch_filter"):
            continue
        streams = []
        for prof in (got, want):
            batches = [types.SimpleNamespace(i=i) for i in range(11)]
            streams.append([(b.i, b.global_index)
                            for b in prof._batch_filter(iter(batches))])
        assert streams[0] == streams[1]
        assert streams[0] == [(i, i) for i in range(pid, 11, pcount)]
        assert got._stride == (pid, pcount)
    # items that take no attribute pass through untagged
    assert list(tdriver.stride_batches(iter(range(5)), 1, 2)) == [1, 3]


@pytest.mark.parametrize("layout", ["mates", "interleaved"])
def test_paired_batches_take_global_index(sim_community, tmp_path, layout):
    """Mate-paired batches are tagged like single-end ones, and the
    prefetch hands the tag on (DeviceBatch.global_index)."""
    from midas_tpu_torch.io.batch import load_paired_batches
    from midas_tpu_torch.io.prefetch import prefetch_device_batches

    fq1, fq2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    simulate_paired_reads(sim_community, fq1, fq2, n_pairs=200, seed=5)
    if layout == "interleaved":
        inter = str(tmp_path / "inter.fq.gz")
        with gzip.open(fq1, "rt") as a, gzip.open(fq2, "rt") as b, \
                gzip.open(inter, "wt") as out:
            while True:
                r1 = [a.readline() for _ in range(4)]
                if not r1[0]:
                    break
                out.writelines(r1 + [b.readline() for _ in range(4)])
        fq1, fq2 = inter, None

    def stream():
        return load_paired_batches(fq1, fq2, batch_size=64,
                                   interleaved=layout == "interleaved")

    everything = list(stream())
    assert len(everything) == 7
    kept = list(tdriver.stride_batches(stream(), 1, 3))
    assert [b.global_index for b in kept] == [1, 4]
    for b in kept:
        np.testing.assert_array_equal(b.codes,
                                      everything[b.global_index].codes)
        assert b.names == everything[b.global_index].names
    got = [(d.index, d.global_index) for d in prefetch_device_batches(
        tdriver.stride_batches(stream(), 2, 3), device="cpu")]
    assert got == [(0, 2), (1, 5)]


# ---------------------------------------------------------------------------
# (b) the end-of-stream gathers, in 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """Both ranks' results of the gathers and the species merge over
    _GEN's inputs, and those inputs."""
    import pickle

    root = tmp_path_factory.mktemp("gather")
    out = str(root / "result")
    _ok(_launch(2, dict(mode="gather", gen=_GEN, out=out), str(root)))
    ns = {"np": np}
    exec(_GEN, ns)
    inputs = [ns["rank_inputs"](r) for r in range(2)]
    results = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return inputs, results


def _same_array(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["sum_int32", "sum_float64"])
def test_allgather_sum(gathered, key):
    """On every rank: np.sum over the rank axis, in its dtype (int32
    -> int64), the float sum in rank order."""
    inputs, results = gathered
    want = np.stack([x[key] for x in inputs]).sum(axis=0)
    assert want.dtype == (np.int64 if key == "sum_int32" else np.float64)
    for res in results:
        _same_array(res[key], want)


@pytest.mark.parametrize("key", ["rows_int8", "rows_int32"])
def test_allgather_rows(gathered, key):
    """Ragged row blocks, one rank with none, concatenated rank-major in
    the rows' dtype."""
    inputs, results = gathered
    want = np.concatenate([x[key] for x in inputs])
    assert want.shape[0] in (3, 4)
    for res in results:
        _same_array(res[key], want)


def test_merge_species_accumulators(gathered):
    """Counts and bp summed, the ambiguous rows rank-major with their
    exact float64 bp and stream ranks (rank 1 holds none), stats summed."""
    inputs, results = gathered
    counts = [x["merge"][0] for x in inputs]
    bps = [x["merge"][1] for x in inputs]
    amb = [t for x in inputs for t in x["merge"][2]]
    assert len(amb) == 5
    for res in results:
        g_count, g_bp, g_amb, g_stats = res["merge"]
        _same_array(g_count, np.stack(counts).sum(axis=0))
        _same_array(g_bp, np.stack(bps).sum(axis=0))
        assert len(g_amb) == len(amb)
        for g, w in zip(g_amb, amb):
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
            assert g[2].dtype == np.float64
            assert g[3] == w[3]
        assert g_stats == dict(total_reads=201, total_bp=30000, total_alns=7)


# ---------------------------------------------------------------------------
# (c) run_species_multihost in 2 and 3 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_species(sim_community):
    from midas_tpu.db import Database
    from midas_tpu.profile.species import SpeciesProfiler

    return SpeciesProfiler(Database(sim_community.db_dir))


@pytest.fixture(scope="module")
def mixed_ties(tmp_path_factory):
    """A community where the ambiguous reads' stream order decides the
    profile: 6 species and 3 related copies at 3% divergence, equal
    abundances, 1,200 reads with 3% errors and indels in one of ten, so
    the tie sets differ in species and in aligned bp (in sim_reads every
    tie set is the same pair at 100 bp, and any order gives the same
    profile). Returns (db_dir, fq, midas_tpu's SpeciesProfiler)."""
    from midas_tpu.db import Database
    from midas_tpu.profile.species import SpeciesProfiler
    from midas_tpu.testkit import simulate_db

    root = tmp_path_factory.mktemp("mixed_ties")
    comm = simulate_db(str(root / "db"), n_species=6, genome_len=12000,
                       gene_len=600, n_extra_genes=4, related_pairs=3,
                       divergence=0.03, seed=0)
    fq = str(root / "mix.fq.gz")
    simulate_reads(comm, fq, n_reads=1200, read_len=100,
                   abundances=[1.0 / len(comm.species)] * len(comm.species),
                   error_rate=0.03, indel_rate=0.1, seed=4)
    return comm.db_dir, fq, SpeciesProfiler(Database(comm.db_dir))


def _species_files(outdir):
    return [_read(os.path.join(outdir, f)) for f in (
        "species/species_profile.txt", "species/temp/read_count.txt")]


def _single_process_species(prof, fq, outdir, max_reads=None):
    """midas_tpu's single-process species files, as run_species writes
    them, from its SpeciesProfiler at batch 128."""
    from midas_tpu.profile.species import write_abundance

    os.makedirs(os.path.join(outdir, "species/temp"))
    abundance = prof.run([fq], batch_size=BATCH, max_reads=max_reads)
    write_abundance(os.path.join(outdir, "species/species_profile.txt"),
                    abundance)
    with open(os.path.join(outdir, "species/temp/read_count.txt"),
              "w") as f:
        f.write(f"{prof.stats['total_reads']}\t{prof.stats['total_bp']}")
    return abundance


@pytest.mark.parametrize(
    "ranks,max_reads,data",
    [(2, None, "sim"), (3, None, "sim"), (3, 200, "sim"),
     (3, None, "mixed_ties")],
    ids=["2ranks", "3ranks", "3ranks_fewer_batches", "3ranks_mixed_ties"])
def test_species_multihost_equals_single_process(
        request, jax_species, sim_community, sim_reads, tmp_path, ranks,
        max_reads, data):
    """Rank 0's species_profile.txt and read_count.txt equal midas_tpu's
    single-process SpeciesProfiler + write_abundance at batch 128 (7
    batches striding over the ranks; with -n 200, 2 batches for 3 ranks,
    so one rank streams nothing and merges empty accumulators; on
    mixed_ties, only the merged rows' stream order gives the profile)."""
    if data == "sim":
        db_dir, fq, prof = sim_community.db_dir, sim_reads[0], jax_species
    else:
        db_dir, fq, prof = request.getfixturevalue("mixed_ties")
    want_dir = str(tmp_path / "single")
    abundance = _single_process_species(prof, fq, want_dir, max_reads)
    outdir = str(tmp_path / "multi")
    _ok(_launch(ranks, dict(mode="species", db=db_dir, fq=fq,
                            outdir=outdir, batch_size=BATCH,
                            max_reads=max_reads), str(tmp_path / "logs")))
    assert _species_files(outdir) == _species_files(want_dir)
    assert sum(abundance[s]["count"] for s in abundance) > 100


def test_species_torchrun_cli_and_rerun(jax_species, sim_community,
                                        sim_reads, tmp_path):
    """`torchrun --nproc_per_node=2` over run_midas's main (`run_midas
    species`, batches of 128 reads) writes midas_tpu's single-process
    files (log.txt and readme.txt from rank 0 only, a checkpoint a rank);
    a rerun in the same directory under 3 ranks resumes no rank's
    checkpoint (its stride is in the fingerprint) and writes them again."""
    fq, db = sim_reads[0], sim_community.db_dir
    want = str(tmp_path / "single")
    _single_process_species(jax_species, fq, want)
    out = str(tmp_path / "multi")
    spec = dict(mode="cli", batch_size=BATCH, commands=[
        ["species", out, "-1", fq, "-d", db, "--device", "cpu"]])
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", str(worker), json.dumps(spec)], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count('"exits": [null]') == 2
    assert _species_files(out) == _species_files(want)
    temp = os.path.join(out, "species/temp")
    assert sorted(os.listdir(temp)) == [
        "read_count.txt", "state.rank0.npz", "state.rank1.npz"]
    with open(os.path.join(out, "species/log.txt")) as f:
        assert f.read().count("command: ") == 1
    assert os.path.isfile(os.path.join(out, "species/readme.txt"))
    os.remove(os.path.join(out, "species/species_profile.txt"))
    results = _ok(_launch(3, spec, str(tmp_path / "logs")))
    assert [r["exits"] for r in results] == [[None]] * 3
    assert _species_files(out) == _species_files(want)
    assert "state.rank2.npz" in os.listdir(temp)


def test_entry_points_route_after_explicit_initialize(
        jax_species, sim_community, sim_reads, cli_runs, tmp_path):
    """A script that joins the job with initialize(address, n, rank) over
    tcp:// and then calls run_species / run_genes, with no launcher
    variables in its environment, takes the multi-process route: in 2
    ranks (batches of 128 reads) rank 0's species files equal midas_tpu's
    single-process run's, and its genes outputs equal midas_tpu's
    single-process CLI run's."""
    fq, db = sim_reads[0], sim_community.db_dir
    want = str(tmp_path / "single")
    _single_process_species(jax_species, fq, want)
    out = str(tmp_path / "species")
    _ok(_launch(2, dict(mode="entry", program="species", batch_size=BATCH,
                        args=dict(outdir=out, db=db, m1=fq)),
                str(tmp_path / "logs_species")))
    assert _species_files(out) == _species_files(want)
    assert sorted(os.listdir(os.path.join(out, "species/temp"))) == [
        "read_count.txt", "state.rank0.npz", "state.rank1.npz"]

    want, _got = cli_runs["genes_single"]
    out = str(tmp_path / "genes")
    with open(os.path.join(want, "genes/species.txt")) as f:
        ids = f.read().split()
    reads = os.path.join(os.path.dirname(want), "reads.fq.gz")
    _ok(_launch(2, dict(mode="entry", program="genes", batch_size=BATCH,
                        args=dict(outdir=out, db=db, m1=reads,
                                  species_id=ids, mode="local",
                                  build_db=True, align=True, cov=True)),
                str(tmp_path / "logs_genes")))
    _same_outputs(want, out, "genes")
    assert not os.path.exists(os.path.join(out, "genes/temp/state.npz"))


# ---------------------------------------------------------------------------
# (d) run_midas genes / snps in 2 ranks
# ---------------------------------------------------------------------------

CLI_RUNS = {
    # (program, mode, reads, quality)
    "genes_single": ("genes", "local", "single", "natural"),
    "genes_paired": ("genes", "local", "paired", "natural"),
    "snps_single": ("snps", "global", "single", "q40"),
    "snps_paired": ("snps", "global", "paired", "q40"),
}


@pytest.fixture(scope="module")
def cli_runs(sim_community, tmp_path_factory):
    """midas_tpu's single-process CLI and a 2-rank launch of the port's
    CLI (batch 128, so both ranks stream) over the same inputs: 800
    reads with indels in one of ten, 300 mate pairs (-1/-2), and their
    Q40 copies for snps."""
    from midas_tpu.cli.run_midas import main as j_run_midas

    root = tmp_path_factory.mktemp("dist_cli")
    reads = {}
    fq = str(root / "reads.fq.gz")
    simulate_reads(sim_community, fq, n_reads=800, read_len=100,
                   abundances=[0.5, 0.3, 0.15, 0.05], error_rate=0.005,
                   indel_rate=0.1, seed=3)
    fq1, fq2 = str(root / "r1.fq.gz"), str(root / "r2.fq.gz")
    simulate_paired_reads(sim_community, fq1, fq2, n_pairs=300,
                          error_rate=0.01, indel_rate=0.1, seed=11)
    for name, files in (("single", [fq]), ("paired", [fq1, fq2])):
        reads[name, "natural"] = files
        q40 = [f.replace(".fq.gz", "_q40.fq.gz") for f in files]
        for src, dst in zip(files, q40):
            _q40(src, dst)
        reads[name, "q40"] = q40
    ids = ",".join(s.species_id for s in sim_community.species)
    runs, commands = {}, []
    for key, (program, mode, layout, qual) in sorted(CLI_RUNS.items()):
        files = reads[layout, qual]
        mates = ["-1", files[0]] + (["-2", files[1]] if len(files) > 1
                                    else [])
        common = [*mates, "-d", sim_community.db_dir, "-m", mode,
                  "--species_id", ids]
        want, got = str(root / f"jax_{key}"), str(root / f"torch_{key}")
        j_run_midas([program, want] + common)
        commands.append([program, got] + common + ["--device", "cpu"])
        runs[key] = (want, got)
    results = _ok(_launch(2, dict(mode="cli", commands=commands,
                                  batch_size=BATCH), str(root / "logs")))
    assert [r["exits"] for r in results] == [[None] * len(commands)] * 2
    return runs


@pytest.mark.parametrize("key", sorted(CLI_RUNS))
def test_cli_two_ranks_equal_single_process(cli_runs, key):
    """Every decompressed output, summary.txt and species.txt of a 2-rank
    run equal midas_tpu's single-process CLI run's; rank 0 alone wrote
    log.txt (one command line) and no state checkpoint."""
    program = CLI_RUNS[key][0]
    want, got = cli_runs[key]
    _same_outputs(want, got, program)
    with open(os.path.join(got, program, "log.txt")) as f:
        assert f.read().count("command: ") == 1
    assert not os.path.exists(os.path.join(got, program, "temp/state.npz"))
    if program == "snps":   # the gapped-row merge was exercised
        z = np.load(os.path.join(want, "snps/temp/state.npz"))
        assert int(z["gap_n"]) > 10


# ---------------------------------------------------------------------------
# (e) the guards, and the failures that fail the run
# ---------------------------------------------------------------------------

def test_guards_exit_with_midas_tpu_messages(sim_community, sim_reads,
                                             tmp_path, monkeypatch):
    """Under 2 ranks, --m8 and the genes / snps stage splits exit with
    midas_tpu's messages (taken from its run_* under a 2-process count),
    on every rank, writing no outputs."""
    import jax

    from midas_tpu.profile.genes import run_genes as j_run_genes
    from midas_tpu.profile.snps import run_snps as j_run_snps
    from midas_tpu.profile.species import run_species as j_run_species

    fq, db = sim_reads[0], sim_community.db_dir
    sid = sim_community.species[0].species_id
    base = dict(db=db, m1=fq, species_id=[sid])
    want = []
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for fn, extra in ((j_run_species, dict(m8=True)),
                      (j_run_genes, dict(build_db=True, align=True)),
                      (j_run_snps, dict(build_db=True, call=True))):
        with pytest.raises(SystemExit) as e:
            fn(dict(base, outdir=str(tmp_path / "jax"), **extra))
        want.append(str(e.value.code))
    monkeypatch.undo()
    out = str(tmp_path / "torch")
    common = ["-1", fq, "-d", db, "--device", "cpu"]
    commands = [["species", out, "--m8"] + common,
                ["genes", out, "--build_db", "--align", "--species_id",
                 sid] + common,
                ["snps", out, "--build_db", "--pileup", "--species_id",
                 sid] + common]
    results = _ok(_launch(2, dict(mode="cli", commands=commands),
                          str(tmp_path / "logs")))
    assert [r["exits"] for r in results] == [want, want]
    assert "single-host feature" in want[0] and "stage splits" in want[1]
    for rel in ("species/species_profile.txt", "genes/summary.txt",
                "snps/summary.txt"):
        assert not os.path.exists(os.path.join(out, rel))


@pytest.mark.parametrize("entry", ["species", "genes", "snps"])
def test_tp_sharding_raises(sim_community, sim_reads, entry):
    """tp > 1 (the seed index split across cards) is not ported."""
    fn = getattr(tdriver, f"run_{entry}_multihost")
    args = (sim_community.db_dir, sim_reads[0])
    if entry != "species":
        args += ([sim_community.species[0].species_id],)
    with pytest.raises(NotImplementedError, match="15b"):
        fn(*args, tp=2, device="cpu")


@pytest.mark.parametrize("fault", ["dies", "hangs", "no_card"])
def test_failed_rank_fails_the_run(sim_community, sim_reads, tmp_path,
                                   fault):
    """No fallback: a rank that dies before the merge, one that hangs
    past the collective timeout, or ranks asked for a card where there
    is none, each make rank 0 exit nonzero with no profile written."""
    if fault == "no_card" and torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = str(tmp_path / "o")
    device = "cuda" if fault == "no_card" else "cpu"
    spec = dict(mode="cli", fault=None if fault == "no_card" else fault,
                batch_size=BATCH,
                commands=[["species", out, "-1", sim_reads[0], "-d",
                           sim_community.db_dir, "--device", device]])
    if fault == "hangs":
        # a 10 s collective timeout (the rendezvous shares it: both ranks
        # join it right after importing torch)
        spec["timeout"] = 10
    results = _launch(2, spec, str(tmp_path / "logs"), wait=[0])
    rc, _out, err = results[0]
    assert rc != 0
    assert not os.path.exists(os.path.join(out, "species/species_profile.txt"))
    assert {"dies": "Connection closed by peer",
            "hangs": "Timed out waiting 10000ms",
            "no_card": "no CUDA card"}[fault] in err


def _lone_rank_of_two(monkeypatch):
    """The environment of rank 0 of a 2-process launch whose rank 1
    never starts, with a 2 s rendezvous timeout."""
    monkeypatch.setattr(tdriver, "DEFAULT_TIMEOUT_S", 2.0)
    for k, v in dict(WORLD_SIZE="2", RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# concurrent builds of the native pieces
# ---------------------------------------------------------------------------

_BUILD_SCRIPT = r"""
import os, sys
target, tool, out = sys.argv[1:4]
if target == "native":
    from midas_tpu_torch.io import native as mod
    mod.build_dir = lambda: out
    so = mod._build()
else:
    from midas_tpu_torch.align import cuda_sw as mod
    mod.build_dir = lambda: out
    mod._nvcc = lambda: tool
    so = mod.build_library()
print(so)
"""

_FAKE_COMPILER = r"""#!{python}
import os, sys, time
args = sys.argv[1:]
time.sleep(1.0)                       # both builds overlap
with open(args[args.index("-o") + 1], "w") as f:
    f.write("library built by %d\n" % os.getpid())
print("ptxas info    : Used 1 registers", file=sys.stderr)
"""


@pytest.mark.parametrize("target", ["native", "cuda"])
def test_concurrent_builds_are_atomic(tmp_path, target):
    """Two ranks starting on a fresh checkout both build build/ at first
    use: each compiles to a file of its own pid and renames it into
    place, so both end with one whole library and no partial file.
    (Compilers replaced by a script that takes a second.)"""
    tools = tmp_path / "bin"
    tools.mkdir()
    fake = tools / ("g++" if target == "native" else "nvcc")
    fake.write_text(_FAKE_COMPILER.replace("{python}", sys.executable))
    fake.chmod(0o755)
    out = tmp_path / "build"
    out.mkdir()
    env = dict(os.environ, PATH=f"{tools}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, target, str(fake), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e
    so = {o.strip() for o, _ in outs}
    assert len(so) == 1
    lib = so.pop()
    with open(lib) as f:
        assert f.read().startswith("library built by ")
    assert sorted(os.listdir(out)) == sorted(
        [os.path.basename(lib)]
        + (["banded_sw.ptxas.txt"] if target == "cuda" else []))
    shutil.rmtree(out)
