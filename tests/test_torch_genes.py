"""The port's genes slice against midas_tpu, on the CPU: the best-hit and
MAPQ steps (bowtie2's integer scMin table, exact band thresholds, the
canonical tie order), the keep filters, one genes_update batch, and
run_genes end to end in -m local and -m global (summary.txt and every
decompressed .genes.gz byte for byte), with checkpoint resume and the
--call_genes stage split. Also the read batches' qualities, which genes
is the first consumer of. Exact equality throughout."""

import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import params as jparams
from midas_tpu.db import Database as JDatabase
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.genes import GenesProfiler as JGenesProfiler
from midas_tpu.profile.genes import run_genes as j_run_genes
from midas_tpu_torch.align import params as tparams
from midas_tpu_torch.align.pipeline import Aligner as TAligner
from midas_tpu_torch.align.seed import SeedParams as TSeedParams
from midas_tpu_torch.cli.run_midas import main as t_run_midas
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.genes import run_genes as t_run_genes

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

MODES = {"local": "LOCAL_SCORING", "global": "GLOBAL_SCORING"}
BAND_FRACTIONS = sorted(
    {r[0] for r in jparams._MAPQ_UNIQ_E2E + jparams._MAPQ_UNIQ_LOCAL
     + jparams._MAPQ_TIE_E2E + jparams._MAPQ_TIE_LOCAL} | {0.84, 0.68, 0.67})


def _scorings(mode):
    return getattr(jparams, MODES[mode]), getattr(tparams, MODES[mode])


def _genes_outputs(outdir, species_ids):
    """summary.txt and every decompressed .genes.gz (the gzip header
    holds a time stamp)."""
    files = {}
    with open(os.path.join(outdir, "genes/summary.txt"), "rb") as f:
        files["summary.txt"] = f.read()
    for sid in species_ids:
        with gzip.open(os.path.join(outdir, f"genes/output/{sid}.genes.gz"),
                       "rb") as f:
            files[sid] = f.read()
    return files


# ---------------------------------------------------------------------------
# best hit and MAPQ
# ---------------------------------------------------------------------------

def test_mapq_threshold_equal():
    diff = np.arange(1, 2**13 + 1, dtype=np.int32)
    for frac in BAND_FRACTIONS:
        want = np.asarray(jds._mapq_threshold(frac, jnp.asarray(diff)))
        got = tds._mapq_threshold(frac, torch.from_numpy(diff)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(frac))
        # and it is the exact ceiling of f32(frac) * diff
        exact = np.ceil(np.float64(np.float32(frac)) * diff)
        np.testing.assert_array_equal(got, exact, err_msg=str(frac))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_score_min_table_equal(mode):
    jsc, tsc = _scorings(mode)
    qlen = np.arange(0, 2049, dtype=np.int32)
    want = np.asarray(jnp.trunc(jds.score_min_device(jsc, jnp.asarray(qlen))))
    assert want.dtype == np.float32
    got = tds.score_min_table(tsc, 2048)
    assert got.dtype == np.int64 and got.shape == (2049,)
    np.testing.assert_array_equal(got, want)
    if mode == "global":
        # the float64 host formula would not do (PERF.md, Findings)
        f64 = np.trunc(np.array([jsc.score_min(max(int(q), 1)) for q in qlen]))
        assert (f64 != want).sum() == 100


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mapq_device_grid_equal(mode):
    jsc, tsc = _scorings(mode)
    local = mode == "local"
    table = tds.score_min_table(tsc, 128)
    qls, bests, seconds = [], [], []
    for ql in (1, 5, 20, 75, 100, 128):
        smin = int(table[ql])
        top = tsc.match * ql
        grid = np.arange(smin - 3, top + 2)
        b, s = np.meshgrid(grid, grid, indexing="ij")
        qls.append(np.full(b.size, ql))
        bests.append(b.ravel())
        seconds.append(s.ravel())
    qlen = np.concatenate(qls).astype(np.int32)
    best = np.concatenate(bests).astype(np.float32)
    second = np.concatenate(seconds).astype(np.float32)
    rng = np.random.default_rng(0)
    has_second = rng.random(best.shape) < 0.8
    second = np.where(has_second, second, np.float32(jds.NEG_INF))

    smin = jnp.trunc(jds.score_min_device(jsc, jnp.asarray(qlen)))
    sperf = jsc.match * jnp.maximum(jnp.asarray(qlen).astype(jnp.float32), 1.0)
    want = np.asarray(jds.mapq_device(
        jnp.asarray(best), jnp.asarray(second), smin, sperf,
        jnp.asarray(has_second), local=local))
    tq = torch.from_numpy(qlen).to(torch.int64)
    got = tds.mapq_device(
        torch.from_numpy(best), torch.from_numpy(second),
        torch.from_numpy(table)[tq], tsc.match * tq.clamp(min=1),
        torch.from_numpy(has_second), local=local)
    assert got.dtype == torch.int32
    assert len(np.unique(want)) > 10
    np.testing.assert_array_equal(got.numpy(), want)


def _tie_heavy_out(seed, B=2048, C=4, qlen_max=128, scoring=None):
    """[B, C] pass-1 planes with many equal scores, and equal seq_idx /
    tstart / strand among the equal-best, so every tie-break rule of
    the canonical order is reached."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(0, qlen_max + 1, size=B).astype(np.int32)
    qlens[:4] = (0, 1, qlen_max, qlen_max)
    table = tds.score_min_table(scoring, qlen_max)
    smin = table[qlens][:, None]
    top = scoring.match * np.maximum(qlens, 1)[:, None]
    span = np.maximum(top - smin, 1)
    score = smin + (rng.integers(-1, 4, size=(B, C)) * span) // 3
    out = dict(
        valid=rng.random((B, C)) < 0.85,
        score=score.astype(np.float32),
        seq_idx=rng.integers(0, 3, size=(B, C)).astype(np.int64),
        tstart=rng.integers(0, 3, size=(B, C)).astype(np.int64),
        strand=rng.integers(0, 2, size=(B, C)).astype(np.int64),
    )
    out["valid"][5] = False
    return out, qlens


@pytest.mark.parametrize("mode", sorted(MODES))
def test_best_hit_device_ties_equal(mode):
    jsc, tsc = _scorings(mode)
    out, qlens = _tie_heavy_out(1, scoring=tsc)
    jout = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in out.items()}
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    scores = np.where(out["valid"], out["score"], np.float32(jds.NEG_INF))
    want_col = np.asarray(jds.canonical_best_col(jout, jnp.asarray(scores)))
    got_col = tds.canonical_best_col(tout, torch.from_numpy(scores))
    np.testing.assert_array_equal(got_col.numpy(), want_col)

    want = jds.best_hit_device(jout, jnp.asarray(qlens), jsc)
    table = torch.from_numpy(tds.score_min_table(tsc, 128))
    got = tds.best_hit_device(tout, torch.from_numpy(qlens), tsc, table)
    for name, w, g in zip(("aligned", "best_col", "mapq"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    aligned = np.asarray(want[0])
    assert 0 < aligned.sum() < aligned.size
    # ties were there to break
    best = scores.max(axis=1, keepdims=True)
    assert ((scores == best) & out["valid"]).sum(axis=1).max() >= 3


def test_keep_mask_chosen_equal():
    rng = np.random.default_rng(2)
    B = 4096
    qlens = rng.integers(0, 129, size=B).astype(np.int32)
    qstart = rng.integers(0, 30, size=B).astype(np.int32)
    qend = np.minimum(qstart + rng.integers(0, 129, size=B), 128).astype(np.int32)
    # boundary rows: pid exactly 94, coverage exactly 0.75, readq exactly 20
    qlens[:3], qstart[:3], qend[:3] = 100, 0, (100, 75, 50)
    full = dict(qstart=qstart, qend=qend,
                mismatches=rng.integers(0, 8, size=B).astype(np.int32),
                gap_cols=rng.integers(0, 3, size=B).astype(np.int32))
    full["mismatches"][:3], full["gap_cols"][:3] = (4, 3, 3), (2, 0, 0)
    mean_qual = rng.uniform(15, 25, size=B).astype(np.float32)
    mean_qual[:40] = 20.0
    mapq = rng.integers(0, 45, size=B).astype(np.int32)
    for mapid, readq, min_mapq, aln_cov in ((94.0, 20.0, 0, 0.75),
                                            (97.3, 21.7, 20, 0.6)):
        want = np.asarray(jds.keep_mask_chosen(
            {k: jnp.asarray(v) for k, v in full.items()}, jnp.asarray(qlens),
            jnp.asarray(mean_qual), jnp.asarray(mapq),
            mapid, readq, min_mapq, aln_cov))
        got = tds.keep_mask_chosen(
            {k: torch.from_numpy(v) for k, v in full.items()},
            torch.from_numpy(qlens), torch.from_numpy(mean_qual),
            torch.from_numpy(mapq), mapid, readq, min_mapq, aln_cov)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < B


# ---------------------------------------------------------------------------
# one genes_update batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genes_profiler(sim_community):
    db = JDatabase(sim_community.db_dir)
    return JGenesProfiler(db, [s.species_id for s in sim_community.species])


def test_genes_update_batch_equal(genes_profiler, sim_reads):
    from midas_tpu.io.batch import load_read_batches

    jprof = genes_profiler
    jal = jprof.aligner
    sp = jal.seed_params
    tsc = tparams.LOCAL_SCORING
    tal = TAligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        tsc, TSeedParams(num_cands=sp.num_cands), max_read_len=128,
        device="cpu")
    b = next(iter(load_read_batches(sim_reads[0], batch_size=1024,
                                    max_len=128)))
    n_reads = b.n_reads - 100          # padding rows must not count
    G = jprof.pack.num_seqs
    kw = dict(mapid=94.0, readq=20.0, min_mapq=0, aln_cov=0.75)
    jstate = jds.genes_update(
        jds.genes_init(G), jal.index_arrays, jal.pack_arrays, G,
        jnp.asarray(b.codes), jnp.asarray(b.quals), jnp.asarray(b.lengths),
        jnp.asarray(b.mean_qual), jnp.int32(n_reads), scoring=jal.scoring,
        seed_params=sp, max_len=128, **kw)
    want = jds.genes_state_host(jstate)

    tstate = tds.genes_init(G, "cpu")
    tds.genes_update(
        tstate, tal.index_arrays, tal.pack_arrays, G,
        torch.from_numpy(b.codes), torch.from_numpy(b.quals),
        torch.from_numpy(b.lengths), torch.from_numpy(b.mean_qual), n_reads,
        scoring=tsc, seed_params=tal.seed_params, max_len=128,
        smin_table=torch.from_numpy(tds.score_min_table(tsc, 128)), **kw)
    got = tds.genes_state_host(tstate)
    assert set(got) == set(want)
    assert want["mapped_reads"][:G].sum() > 0
    assert want["aligned_reads"][G] > 100   # padding + unaligned rows
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k

    # host snapshot -> device state -> host snapshot round trip
    back = tds.genes_state_host(tds.genes_state_restore(got, "cpu"))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    # the same rows as mate pairs (2i, 2i+1) now run (the paired step is
    # held to midas_tpu's in tests/test_torch_paired.py)
    pstate = tds.genes_init(G, "cpu")
    tds.genes_update(
        pstate, tal.index_arrays, tal.pack_arrays, G,
        torch.from_numpy(b.codes), torch.from_numpy(b.quals),
        torch.from_numpy(b.lengths), torch.from_numpy(b.mean_qual), n_reads,
        scoring=tsc, seed_params=tal.seed_params, max_len=128,
        smin_table=torch.from_numpy(tds.score_min_table(tsc, 128)),
        paired=True, **kw)
    paired = tds.genes_state_host(pstate)
    assert paired["aligned_reads"].sum() == b.codes.shape[0]
    assert paired["mapped_reads"][:G].sum() > 0


# ---------------------------------------------------------------------------
# run_genes end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genes_runs(sim_community, sim_reads, tmp_path_factory):
    """The JAX package's run_genes in both modes, and the port's through
    its CLI on the CPU. -m local selects every species by --species_id;
    -m global selects the top 3 of a species profile (the JAX package's
    species run, copied into both output directories)."""
    from midas_tpu.profile.species import run_species as j_run_species

    root = tmp_path_factory.mktemp("genes_runs")
    db, fq = sim_community.db_dir, sim_reads[0]
    ids = [s.species_id for s in sim_community.species]
    species_dir = str(root / "species_run")
    j_run_species(dict(outdir=species_dir, db=db, m1=fq))
    profile = os.path.join(species_dir, "species/species_profile.txt")
    runs = {}
    for mode in sorted(MODES):
        jout, tout = str(root / f"jax_{mode}"), str(root / f"torch_{mode}")
        if mode == "local":
            sel = dict(species_id=ids)
            cli_sel = ["--species_id", ",".join(ids)]
        else:
            sel = dict(species_topn=3)
            cli_sel = ["--species_topn", "3"]
            for out in (jout, tout):
                os.makedirs(os.path.join(out, "species"))
                shutil.copy(profile, os.path.join(out, "species"))
        j_run_genes(dict(outdir=jout, db=db, m1=fq, build_db=True,
                         align=True, cov=True, mode=mode, **sel))
        t_run_midas(["genes", tout, "-1", fq, "-d", db, "-m", mode,
                     "--device", "cpu"] + cli_sel)
        with open(os.path.join(jout, "genes/species.txt")) as f:
            chosen = f.read().split()
        runs[mode] = (jout, tout, chosen)
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_genes_byte_identical(genes_runs, mode):
    jout, tout, chosen = genes_runs[mode]
    assert len(chosen) == (4 if mode == "local" else 3)
    want = _genes_outputs(jout, chosen)
    got = _genes_outputs(tout, chosen)
    assert set(got) == set(want)
    for f in want:
        assert got[f] == want[f], f
    with open(os.path.join(tout, "genes/species.txt")) as f:
        assert f.read().split() == chosen
    # the checkpointed state holds the JAX package's values
    zj = np.load(os.path.join(jout, "genes/temp/state.npz"))
    zt = np.load(os.path.join(tout, "genes/temp/state.npz"))
    for k in tds.GENES_FIELDS:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert zt["mapped_reads"].sum() > 100


def test_checkpoint_resume_and_call_genes_only(genes_runs, sim_community,
                                               sim_reads, tmp_path,
                                               monkeypatch):
    """A run killed after 3 batches resumes from its checkpoint; a later
    --call_genes alone consumes the saved state; both equal the plain
    run."""
    jout, tout, chosen = genes_runs["local"]
    plain = _genes_outputs(tout, chosen)
    from midas_tpu_torch.io import prefetch
    from midas_tpu_torch.profile import checkpoint as ckpt
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.db.layout import Database

    out = str(tmp_path / "resumed")
    state_path = os.path.join(out, "genes/temp/state.npz")
    prof = GenesProfiler(Database(sim_community.db_dir), chosen, device="cpu")
    real = prefetch.prefetch_device_batches

    def dies_after_3(*a, **k):
        for i, db in enumerate(real(*a, **k)):
            if i == 3:
                raise KeyboardInterrupt("killed")
            yield db

    kw = dict(batch_size=128, checkpoint_path=state_path)
    monkeypatch.setattr(prefetch, "prefetch_device_batches", dies_after_3)
    with pytest.raises(KeyboardInterrupt):
        prof._accumulate([sim_reads[0]], None, 0, checkpoint_every=2, **kw)
    assert ckpt.load_any(state_path)[1]["batches_done"] == 2
    monkeypatch.setattr(prefetch, "prefetch_device_batches", real)
    host = prof._accumulate([sim_reads[0]], None, 0, checkpoint_every=2, **kw)
    plain_state = np.load(os.path.join(tout, "genes/temp/state.npz"))
    for k in tds.GENES_FIELDS:
        # slot G, the dump row, also counts the padding rows, whose
        # number depends on the batch size
        np.testing.assert_array_equal(host[k][:-1], plain_state[k][:-1],
                                      err_msg=k)
    prof._finalize(host)
    prof.write_results(out)
    assert _genes_outputs(out, chosen) == plain

    # --call_genes alone, from the plain run's state, into a fresh dir
    staged = str(tmp_path / "staged")
    os.makedirs(os.path.join(staged, "genes/temp"))
    shutil.copy(os.path.join(tout, "genes/species.txt"),
                os.path.join(staged, "genes"))
    shutil.copy(os.path.join(tout, "genes/temp/state.npz"),
                os.path.join(staged, "genes/temp"))
    t_run_midas(["genes", staged, "-1", sim_reads[0], "-d",
                 sim_community.db_dir, "--call_genes", "--device", "cpu"])
    assert _genes_outputs(staged, chosen) == plain


def test_paired_and_multi_process_not_yet_ported(sim_community, sim_reads,
                                                 tmp_path, monkeypatch):
    """Paired reads (-2, --interleaved) now run; multi-process runs are
    still not ported and raise."""
    for i, extra in enumerate((["-2", sim_reads[0]], ["--interleaved"])):
        out = str(tmp_path / f"o{i}")
        t_run_midas(["genes", out, "-1", sim_reads[0], "-d",
                     sim_community.db_dir, "--species_id",
                     sim_community.species[0].species_id, "-n", "4",
                     "--device", "cpu"] + extra)
        assert os.path.isfile(os.path.join(out, "genes/summary.txt"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_run_genes(dict(outdir=str(tmp_path / "p"), db=sim_community.db_dir,
                         m1=sim_reads[0], build_db=True, align=True,
                         cov=True, device="cpu",
                         species_id=[sim_community.species[0].species_id]))


# ---------------------------------------------------------------------------
# read batches: qualities and mean quality
# ---------------------------------------------------------------------------

def _mixed_fastq(path):
    """Reads of mixed lengths (some past the padded length) with random
    Phred+33 qualities."""
    rng = np.random.default_rng(4)
    with gzip.open(path, "wt") as f:
        for i in range(300):
            n = int(rng.integers(1, 160))
            seq = "".join(rng.choice(list("ACGTN"), n))
            qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")


@pytest.mark.parametrize("reader", ["native", "python"])
def test_read_batches_quals_equal(sim_reads, tmp_path, monkeypatch, reader):
    from midas_tpu.io import batch as jbatch
    from midas_tpu.io import native as jnative
    from midas_tpu_torch.io import batch as tbatch
    from midas_tpu_torch.io import native as tnative

    if reader == "python":
        monkeypatch.setattr(jnative, "load_native", lambda: None)
        monkeypatch.setattr(tnative, "load_native", lambda: None)
    else:
        assert tnative.load_native() is not None
    mixed = str(tmp_path / "mixed.fq.gz")
    _mixed_fastq(mixed)
    for paths, kw in (([sim_reads[0]], {}), ([mixed], {}),
                      ([mixed, sim_reads[0]], dict(max_reads=700)),
                      ([mixed], dict(read_length=60))):
        want = list(jbatch.load_read_batches(paths, batch_size=256,
                                             max_len=128, **kw))
        got = list(tbatch.load_read_batches(paths, batch_size=256,
                                            max_len=128, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.n_reads == w.n_reads
            for k in ("codes", "lengths", "quals", "mean_qual"):
                a, b = getattr(g, k), getattr(w, k)
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_trim_equal(sim_reads):
    """--trim: the port's trim_batch against the JAX package's prefetch,
    which trims in its producer thread."""
    from midas_tpu.io import batch as jbatch
    from midas_tpu.io.prefetch import prefetch_device_batches as j_prefetch
    from midas_tpu_torch.io import batch as tbatch
    from midas_tpu_torch.io.prefetch import prefetch_device_batches

    fields = ("codes", "quals", "lengths", "mean_qual")
    want = [db.arrays for db in j_prefetch(
        jbatch.load_read_batches(sim_reads[0], batch_size=256, max_len=128),
        fields, trim=7)]
    got = [db.arrays for db in prefetch_device_batches(
        tbatch.load_read_batches(sim_reads[0], batch_size=256, max_len=128),
        fields, device="cpu", trim=7)]
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for name, a, b in zip(fields, g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        assert int(g[2].max()) == 93
