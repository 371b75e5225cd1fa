"""The port's species slice against midas_tpu, on the CPU: one
species_update batch, run_species end to end (species_profile.txt and
read_count.txt byte for byte), checkpointed reruns and forced staging
drains, and the integer e-value gate. Exact equality throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align.params import MARKER_SCORING as J_MARKER
from midas_tpu.db import Database as JDatabase
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.species import SpeciesProfiler as JProfiler
from midas_tpu.profile.species import run_species as j_run_species
from midas_tpu_torch.align.params import MARKER_SCORING as T_MARKER
from midas_tpu_torch.align.pipeline import Aligner as TAligner
from midas_tpu_torch.align.seed import SeedParams as TSeedParams
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.species import SpeciesProfiler as TProfiler
from midas_tpu_torch.profile.species import run_species as t_run_species
from midas_tpu_torch.db.layout import Database as TDatabase

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

OUTPUTS = ("species/species_profile.txt", "species/temp/read_count.txt")


def _read(outdir, f):
    with open(os.path.join(outdir, f), "rb") as fh:
        return fh.read()


def test_species_update_batch_equal(sim_community, sim_reads):
    jprof = JProfiler(JDatabase(sim_community.db_dir))
    jal = jprof.aligner
    sp = jal.seed_params
    tal = TAligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        T_MARKER, TSeedParams(num_cands=sp.num_cands, max_hits=sp.max_hits),
        max_read_len=128, device="cpu")
    b = next(iter(load_read_batches(sim_reads[0], batch_size=1024,
                                    max_len=128)))
    n_species = len(jprof.species_order)
    dblen = float(jprof.pack.total_len)
    cap, ord_base = 2048, 3 * 1024

    jstate = jds.species_update(
        jds.species_init(n_species, sp.num_cands, cap), jal.index_arrays,
        jal.pack_arrays, jnp.asarray(jprof.seq_species),
        jnp.asarray(jprof.seq_cutoff), jnp.asarray(b.codes),
        jnp.asarray(b.lengths), jnp.int32(b.n_reads), np.int32(ord_base),
        scoring=J_MARKER, seed_params=sp, max_len=128, aln_cov=0.75,
        n_species=n_species, dblen=dblen)
    want = jds.species_state_host(jstate)

    tstate = tds.species_init(n_species, sp.num_cands, cap, "cpu")
    min_score = torch.from_numpy(T_MARKER.evalue_min_score(
        np.maximum(np.arange(129), 1), dblen))
    tds.species_update(
        tstate, tal.index_arrays, tal.pack_arrays,
        torch.from_numpy(jprof.seq_species), torch.from_numpy(jprof.seq_cutoff),
        torch.from_numpy(b.codes), torch.from_numpy(b.lengths), b.n_reads,
        ord_base, scoring=T_MARKER, seed_params=tal.seed_params, max_len=128,
        aln_cov=0.75, n_species=n_species, min_score=min_score)
    got = tds.species_state_host(tstate)

    assert set(got) == set(want)
    assert got["uniq_bp"].dtype == np.int64 and got["amb_ord"].dtype == np.int64
    assert want["amb_n"] > 0 and want["uniq_count"][:-1].sum() > 0
    for k in want:
        # the JAX package holds uniq_bp in float32 and amb_ord in int32;
        # the port in int64: equal values wherever the reference is exact
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # host snapshot -> device state -> host snapshot round trip
    back = tds.species_state_host(tds.species_state_restore(got, cap, "cpu"))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)


def test_run_species_byte_identical(sim_community, sim_reads, tmp_path):
    base = dict(db=sim_community.db_dir, m1=sim_reads[0])
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_run_species(dict(base, outdir=jout))
    t_run_species(dict(base, outdir=tout, device="cpu"))
    for f in OUTPUTS:
        assert _read(tout, f) == _read(jout, f), f


def test_checkpoint_rerun_and_forced_drain(sim_community, sim_reads,
                                           tmp_path, monkeypatch):
    base = dict(db=sim_community.db_dir, m1=sim_reads[0], device="cpu")
    out = str(tmp_path / "run")
    t_run_species(dict(base, outdir=out))
    first = {f: _read(out, f) for f in OUTPUTS}
    # a rerun restores the end-of-stream checkpoint and skips every batch
    os.remove(os.path.join(out, OUTPUTS[0]))
    t_run_species(dict(base, outdir=out))
    for f in OUTPUTS:
        assert _read(out, f) == first[f], f

    # small batches and the smallest staging buffer drain the ambiguous
    # spill every other batch; a checkpoint every 3 batches; the first
    # run dies after 5 batches and the second resumes from batch 3
    from midas_tpu_torch.io import prefetch
    from midas_tpu_torch.profile.species import write_abundance

    prof = TProfiler(TDatabase(sim_community.db_dir), device="cpu")
    kw = dict(batch_size=64, amb_cap=1, checkpoint_every=3,
              checkpoint_path=str(tmp_path / "drain" / "state.npz"))
    real = prefetch.prefetch_device_batches

    def dies_after_5(*a, **k):
        for i, db in enumerate(real(*a, **k)):
            if i == 5:
                raise KeyboardInterrupt("killed")
            yield db

    monkeypatch.setattr(prefetch, "prefetch_device_batches", dies_after_5)
    with pytest.raises(KeyboardInterrupt):
        prof._run_device([sim_reads[0]], None, None, **kw)
    from midas_tpu_torch.profile.checkpoint import load_any

    assert load_any(kw["checkpoint_path"])[1]["batches_done"] == 3
    monkeypatch.setattr(prefetch, "prefetch_device_batches", real)
    unique_count, unique_bp, amb = prof._run_device(
        [sim_reads[0]], None, None, **kw)
    assert len(amb) > 0
    write_abundance(str(tmp_path / "drained.txt"),
                    prof.assign_and_normalize(unique_count, unique_bp, amb))
    with open(tmp_path / "drained.txt", "rb") as f:
        assert f.read() == first[OUTPUTS[0]]


def test_evalue_gate_integer_equals_f32(sim_community):
    """The port's integer minimum score ceil(threshold) and the JAX
    package's float32 gate `score >= threshold` accept the same integer
    scores for every read length 1..512 at the test database's size."""
    from midas_tpu.db.refpack import pack_from_fasta

    dblen = float(pack_from_fasta(
        JDatabase(sim_community.db_dir).marker_fasta()).total_len)
    qlen = np.arange(1, 513)
    thr_f32 = np.asarray(J_MARKER.evalue_score_threshold(
        jnp.asarray(qlen, jnp.int32), dblen))
    assert thr_f32.dtype == np.float32
    min_score = T_MARKER.evalue_min_score(qlen, dblen)
    scores = (min_score[:, None] + np.arange(-3, 4)[None, :]).astype(np.float32)
    np.testing.assert_array_equal(scores >= thr_f32[:, None],
                                  scores >= min_score[:, None])
    # and the float64 host path's gate (the JAX package's _run_host)
    thr_f64 = J_MARKER.evalue_score_threshold(qlen.astype(np.float64), dblen)
    np.testing.assert_array_equal(scores >= thr_f64[:, None],
                                  scores >= min_score[:, None])


def test_forced_drains_keep_the_drained_rows(sim_community, sim_reads):
    """Draining the ambiguous spill every other batch gives the same rows,
    in the same order, as one drain at the end: on the CPU the drained
    rows are copies, not views of the buffer that later batches refill."""
    prof = TProfiler(TDatabase(sim_community.db_dir), device="cpu")
    one = prof._run_device([sim_reads[0]], None, None, batch_size=64)
    many = prof._run_device([sim_reads[0]], None, None, batch_size=64,
                            amb_cap=1)
    assert len(one[2]) > 3
    assert repr(many) == repr(one)
