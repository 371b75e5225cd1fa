"""The port's benches (midas_tpu_torch.bench) against the JAX package's, on
the CPU, at a small size.

- bench/scale.py's run_scale(audit=True) against the root bench_scale.py's
  run_scale over midas_tpu, at 6 species of 20 kb, 3 selected, 2,048
  reads in batches of 512: every count, size and cap of the audit equal.
  Rates are only checked to be above 0, and the byte fields
  (*_hbm_mb, *_peak_device_mb) are the port's own (its pack words are
  int64; the CPU has no device memory) and are not compared.
- The device-only loops of `python -m midas_tpu_torch.bench` against the
  same loops through midas_tpu.profile.device_steps on the same batches:
  species_update with the e-value gate (SpeciesProfiler's runs apply it;
  the JAX twin gets it through dblen) and snps_update, final states
  equal.
- The bench's main at the least sizes that run every leg prints one JSON
  line with bench.py's keys; every entry point refuses the default
  device="cuda" without a card.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align.params import GLOBAL_SCORING as J_GLOBAL
from midas_tpu.db import Database as JDatabase
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.snps import SnpsProfiler as JSnpsProfiler
from midas_tpu.profile.species import SpeciesProfiler as JSpeciesProfiler
from midas_tpu_torch.bench import __main__ as tbench
from midas_tpu_torch.bench.budget import run_budget
from midas_tpu_torch.bench.scale import run_scale
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.snps import SnpsProfiler as TSnpsProfiler
from midas_tpu_torch.profile.species import SpeciesProfiler as TSpeciesProfiler
from midas_tpu_torch.testkit.simulate import simulate_db, simulate_reads

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = dict(n_species=6, genome_len=20000, n_sel=3, n_reads=2048,
             batch=512, audit=True)
EQUAL_FIELDS = ("n_species", "genome_len", "n_selected", "n_reads",
                "marker_pack_mb", "amb_rate", "amb_tie_width_p99",
                "amb_tie_width_max", "amb_tie_at_cap_frac", "num_cands",
                "pangenome_genes", "pangenome_pack_mb", "rep_pack_mb",
                "gap_rate", "gap_cap_default",
                "gap_reads_at_default_cap_capacity")
RATES = ("marker_reads_per_sec", "pangenome_reads_per_sec",
         "snps_reads_per_sec")
# bench.py's line: its keys and its detail's keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {
    "pangenome_reads_per_sec", "pangenome_vs_baseline", "snps_reads_per_sec",
    "snps_vs_baseline", "pileup_sites_per_sec", "marker_device_reads_per_sec",
    "snps_device_reads_per_sec", "n_reads", "scale_marker_reads_per_sec",
    "scale_pangenome_reads_per_sec", "scale_snps_reads_per_sec",
    "scale_rep_pack_mb", "scale_n_reads", "scale_snps_vs_baseline",
    "platform"}
LOOP_BATCH = 256
# the loops' repeats here: enough to carry a state across repeats
LOOP_REPS = 2


def _root_script(name):
    """A root script of the JAX package (bench_scale.py), loaded by file
    path: it is no package module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scale_pair():
    """(midas_tpu's run_scale dict, the port's) at SCALE."""
    want = _root_script("bench_scale").run_scale(**SCALE)
    got = run_scale(**SCALE, device="cpu")
    return want, got


@pytest.mark.parametrize("field", EQUAL_FIELDS)
def test_run_scale_audit_equals_midas_tpu(scale_pair, field):
    want, got = scale_pair
    assert got[field] == want[field]


def test_run_scale_rates_and_caps(scale_pair):
    from midas_tpu_torch.profile.snps import GAP_CAP
    from midas_tpu_torch.profile.species import AMB_CAP

    want, got = scale_pair
    assert set(want) <= set(got)
    for k in RATES:
        assert got[k] > 0, k
    # the audit saw ambiguous and gapped reads, so its widths and rates
    # are measured, not defaults
    assert got["amb_rate"] > 0 and got["gap_rate"] > 0
    assert got["amb_cap"] == AMB_CAP and got["gap_cap"] == GAP_CAP
    assert got["gap_cap_default"] == GAP_CAP
    assert got["platform"] == "cpu"
    assert got["marker_peak_device_mb"] is None
    assert got["marker_hbm_mb"] > 0 and got["rep_hbm_mb"] > 0


@pytest.fixture(scope="module")
def loop_data(tmp_path_factory):
    """The bench's toy database and 4 batches of LOOP_BATCH reads."""
    root = str(tmp_path_factory.mktemp("bench_loops"))
    comm = simulate_db(os.path.join(root, "db"), **tbench.TOY_DB)
    fq = os.path.join(root, "reads.fq.gz")
    simulate_reads(comm, fq, n_reads=tbench.DEVICE_BATCHES * LOOP_BATCH,
                   read_len=100, error_rate=0.005, seed=7)
    batches = list(load_read_batches(fq, batch_size=LOOP_BATCH, max_len=128))
    assert len(batches) == tbench.DEVICE_BATCHES
    return comm, batches


def _jax_dev(batches):
    return [(jnp.asarray(b.codes), jnp.asarray(b.quals),
             jnp.asarray(b.lengths), jnp.asarray(b.mean_qual),
             jnp.int32(b.n_reads)) for b in batches]


def test_species_device_loop_equals_midas_tpu(loop_data):
    comm, batches = loop_data
    jprof = JSpeciesProfiler(JDatabase(comm.db_dir))
    al = jprof.aligner
    n_species = len(jprof.species_order)
    seq_species = jnp.asarray(jprof.seq_species)
    seq_cutoff = jnp.asarray(jprof.seq_cutoff)

    def step(state, d):
        codes, _q, lengths, _mq, n = d
        return jds.species_update(
            state, al.index_arrays, al.pack_arrays, seq_species, seq_cutoff,
            codes, lengths, n, jnp.int32(0), scoring=al.scoring,
            seed_params=al.seed_params, max_len=al.max_read_len,
            aln_cov=0.75, n_species=n_species,
            dblen=float(jprof.pack.total_len))

    dev = _jax_dev(batches)
    state = step(jds.species_init(n_species, al.seed_params.num_cands,
                                  tbench.AMB_ROWS), dev[0])
    for _ in range(LOOP_REPS):
        for d in dev:
            state = step(state, d)
    want = jds.species_state_host(state)

    tprof = TSpeciesProfiler(TDatabase(comm.db_dir), device="cpu")
    rate, tstate = tbench.species_device_loop(
        tprof, tbench.upload(batches, "cpu"), LOOP_REPS)
    got = tds.species_state_host(tstate)
    assert rate > 0
    assert want["uniq_count"][:-1].sum() > 0
    for k in ("uniq_count", "uniq_bp", "total_alns", "amb_n"):
        # midas_tpu holds uniq_bp in float32, the port in int64: equal
        # values
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_snps_device_loop_equals_midas_tpu(loop_data):
    comm, batches = loop_data
    one = comm.species_ids()[:1]
    jprof = JSnpsProfiler(JDatabase(comm.db_dir), one)
    al = jprof.aligner
    contig_species = jnp.asarray(jprof.contig_species)

    def step(state, d):
        return jds.snps_update(
            state, al.index_arrays, al.pack_arrays, contig_species, *d,
            scoring=J_GLOBAL, seed_params=al.seed_params,
            max_len=al.max_read_len, mapid=94.0, readq=20.0, min_mapq=20,
            baseq=30, aln_cov=0.75)

    dev = _jax_dev(batches)
    G = jprof.pack.total_len
    state = step(jds.snps_init(G, 1, tbench.GAP_ROWS, al.max_read_len),
                 dev[0])
    for _ in range(LOOP_REPS):
        for d in dev:
            state = step(state, d)

    tprof = TSnpsProfiler(TDatabase(comm.db_dir), one, device="cpu")
    sites_rate, rate, tstate = tbench.snps_device_loop(
        tprof, tbench.upload(batches, "cpu"), LOOP_REPS)
    assert sites_rate > rate > 0
    want_counts = np.asarray(state.counts).reshape(4, G + 1)[:, :G]
    got_counts = tstate.counts.numpy().reshape(4, G + 1)[:, :G]
    assert want_counts.sum() > 0
    np.testing.assert_array_equal(got_counts, want_counts)
    for k in ("aligned_reads", "mapped_reads"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy()[:1],
                                      np.asarray(getattr(state, k))[:1],
                                      err_msg=k)
    assert int(tstate.gap_n) == int(state.gap_n)


def test_bench_main_prints_one_json_line(capsys):
    record = tbench.main([
        "--reads", "256", "--batch", "256", "--scale-species", "3",
        "--scale-genome", "10000", "--scale-selected", "1",
        "--scale-reads", "256", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == json.loads(json.dumps(record))
    assert set(got) == BENCH_KEYS
    assert BENCH_DETAIL_KEYS <= set(got["detail"])
    assert got["value"] > 0 and got["detail"]["platform"] == "cpu"
    for k in BENCH_DETAIL_KEYS:
        if k.endswith("_per_sec"):
            assert got["detail"][k] > 0, k
    # each leg's launches, none on the CPU (the plain DP runs there)
    assert set(got["detail"]["launches"]) == {
        "species", "genes", "snps", "species_device", "snps_device", "scale"}
    assert not any(got["detail"]["launches"].values())


@pytest.mark.parametrize("entry", ["run_scale", "bench_main", "run_budget"])
def test_default_device_needs_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"run_scale": lambda: run_scale(n_species=3, genome_len=10000,
                                           n_sel=1, n_reads=256),
            "bench_main": lambda: tbench.main([]),
            "run_budget": run_budget}[entry]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
