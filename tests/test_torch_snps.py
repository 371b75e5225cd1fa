"""The port's snps slice against midas_tpu, on the CPU: the batched
gapped-read oracle, one snps_update batch, run_snps end to end in
-m global and -m local (summary.txt and every decompressed .snps.gz
byte for byte), the pileup of gapped reads under natural qualities,
staging drains, checkpoint resume and the --align / --pileup stage
split; also the species repairs (multi-process launch, --m8 with
--remove_temp). Exact equality throughout."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import oracle as joracle
from midas_tpu.align import params as jparams
from midas_tpu.db import Database as JDatabase
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.snps import SnpsProfiler as JSnpsProfiler
from midas_tpu.profile.snps import run_snps as j_run_snps
from midas_tpu.testkit import simulate_reads
from midas_tpu_torch.align import oracle as toracle
from midas_tpu_torch.align import params as tparams
from midas_tpu_torch.align.pipeline import Aligner as TAligner
from midas_tpu_torch.align.seed import SeedParams as TSeedParams
from midas_tpu_torch.cli.run_midas import main as t_run_midas
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile import snps as tsnps
from midas_tpu_torch.profile.snps import SnpsProfiler as TSnpsProfiler
from midas_tpu_torch.profile.snps import run_snps as t_run_snps
from tests.test_torch_dist import _lone_rank_of_two

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

MODES = {"global": "GLOBAL_SCORING", "local": "LOCAL_SCORING"}


def _scorings(mode):
    return getattr(jparams, MODES[mode]), getattr(tparams, MODES[mode])


def _species_ids(sim_community):
    return [s.species_id for s in sim_community.species]


def _snps_outputs(outdir, species_ids):
    """summary.txt and every decompressed .snps.gz (the gzip header holds
    a time stamp)."""
    files = {}
    with open(os.path.join(outdir, "snps/summary.txt"), "rb") as f:
        files["summary.txt"] = f.read()
    for sid in species_ids:
        with gzip.open(os.path.join(outdir, f"snps/output/{sid}.snps.gz"),
                       "rb") as f:
            files[sid] = f.read()
    return files


def _q40(src, dst):
    """Copy a gzipped FASTQ with every quality line set to Phred 40."""
    with gzip.open(src, "rt") as fi, gzip.open(dst, "wt") as fo:
        for i, line in enumerate(fi):
            if i % 4 == 3:
                line = "I" * len(line.rstrip("\n")) + "\n"
            fo.write(line)


@pytest.fixture(scope="module")
def indel_reads(sim_community, tmp_path_factory):
    """Reads with natural qualities (Phred 32-40, errors at 2-20), 1-3 bp
    indels in one read of ten, and the same reads at Q40."""
    root = tmp_path_factory.mktemp("snps_reads")
    fq = str(root / "indel.fq.gz")
    simulate_reads(sim_community, fq, n_reads=800, read_len=100,
                   abundances=[0.5, 0.3, 0.15, 0.05], error_rate=0.005,
                   indel_rate=0.1, seed=3)
    q40 = str(root / "indel_q40.fq.gz")
    _q40(fq, q40)
    return fq, q40


@pytest.fixture(scope="module")
def noisy_reads(sim_community, tmp_path_factory):
    """Reads with the simulator's natural qualities at a 3% error rate
    and an indel in three reads of ten: low-quality errors then fall
    beside indels often enough that the flat and the quality-scaled
    mismatch penalties place some gapped reads differently (none do in
    indel_reads)."""
    fq = str(tmp_path_factory.mktemp("snps_noisy") / "noisy.fq.gz")
    simulate_reads(sim_community, fq, n_reads=800, read_len=100,
                   abundances=[0.5, 0.3, 0.15, 0.05], error_rate=0.03,
                   indel_rate=0.3, seed=3)
    return fq


# ---------------------------------------------------------------------------
# the batched gapped-read oracle (fault a)
# ---------------------------------------------------------------------------

def _oracle_pairs(seed, n=40, ns=False):
    """Random (query, target, qpen) triples with substitutions and
    indels; with ns=True, read and reference Ns too."""
    rng = np.random.default_rng(seed)
    queries, targets, qpens = [], [], []
    for _ in range(n):
        m = int(rng.integers(40, 130))
        t = rng.integers(0, 4, size=m).astype(np.int8)
        if ns:
            t[rng.random(m) < 0.03] = 4
        k = int(rng.integers(20, min(m, 100)))
        lo = int(rng.integers(0, m - k + 1))
        q = t[lo: lo + k].copy()
        q[q == 4] = 0
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(q)))
            q[p] = (q[p] + int(rng.integers(1, 4))) % 4
        if rng.random() < 0.6 and len(q) > 6:
            p = int(rng.integers(1, len(q) - 2))
            g = int(rng.integers(1, 4))
            q = (np.delete(q, slice(p, p + g)) if rng.random() < 0.5
                 else np.insert(q, p, rng.integers(0, 4, g)))
        if ns:
            q[rng.random(len(q)) < 0.03] = 4
        queries.append(q.astype(np.int8))
        targets.append(t)
        quals = rng.integers(2, 41, size=len(q))
        qpens.append(2 + ((6 - 2) * np.minimum(quals, 40)) // 40)
    return queries, targets, qpens


def _same_alignment(g, w):
    if w is None:
        assert g is None
        return
    assert g is not None
    assert g.score == w.score
    assert (g.qstart, g.qend, g.tstart, g.tend) == \
        (w.qstart, w.qend, w.tstart, w.tend)
    assert (g.matches, g.mismatches, g.gap_opens, g.gap_cols) == \
        (w.matches, w.mismatches, w.gap_opens, w.gap_cols)
    np.testing.assert_array_equal(g.col_qpos, w.col_qpos)
    np.testing.assert_array_equal(g.col_tpos, w.col_tpos)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_oracle_batch_flat_equals_midas_tpu(mode, monkeypatch):
    """Without qpens the port's batched oracle is midas_tpu's, chunked
    (a chunk of 7 cuts the 40 pairs into ragged chunks)."""
    jsc, tsc = _scorings(mode)
    queries, targets, _ = _oracle_pairs(0, ns=True)
    want = joracle.align_oracle_batch(queries, targets, jsc)
    monkeypatch.setattr(toracle, "CHUNK", 7)
    got = toracle.align_oracle_batch(queries, targets, tsc)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        _same_alignment(g, w)
    assert toracle.align_oracle_batch([], [], tsc) == []


@pytest.mark.parametrize("mode", sorted(MODES))
def test_oracle_scalar_equals_midas_tpu(mode):
    """The port's scalar align_oracle is midas_tpu's, with and without
    per-base penalties, read Ns and reference Ns."""
    jsc, tsc = _scorings(mode)
    queries, targets, qpens = _oracle_pairs(2, n=24, ns=True)
    for q, t, qp in zip(queries, targets, qpens):
        for pen in (None, qp):
            _same_alignment(toracle.align_oracle(q, t, tsc, qpen=pen),
                            joracle.align_oracle(q, t, jsc, qpen=pen))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_oracle_batch_qpen_equals_scalar(mode, monkeypatch):
    """With per-base penalties, read Ns and reference Ns, every pair of
    the port's batched oracle equals midas_tpu's scalar align_oracle
    with qpen (the model the device DP scores with); midas_tpu's own
    batched oracle differs from it on some of these pairs."""
    jsc, tsc = _scorings(mode)
    queries, targets, qpens = _oracle_pairs(1, n=60, ns=True)
    monkeypatch.setattr(toracle, "CHUNK", 16)
    got = toracle.align_oracle_batch(queries, targets, tsc, qpens=qpens)
    flat = joracle.align_oracle_batch(queries, targets, jsc, qpens=qpens)
    differs = 0
    for q, t, qp, g, f in zip(queries, targets, qpens, got, flat):
        want = joracle.align_oracle(q, t, jsc, qpen=qp)
        _same_alignment(g, want)
        differs += (f is None) != (want is None) or (
            want is not None and f.score != want.score)
    assert differs > 0


# ---------------------------------------------------------------------------
# one snps_update batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_snps_profilers(sim_community):
    db = JDatabase(sim_community.db_dir)
    ids = _species_ids(sim_community)
    return {mode: JSnpsProfiler(db, ids, mode=mode) for mode in MODES}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_snps_update_batch_equal(jax_snps_profilers, indel_reads, mode):
    jprof = jax_snps_profilers[mode]
    jal = jprof.aligner
    sp = jal.seed_params
    _, tsc = _scorings(mode)
    tal = TAligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        tsc, TSeedParams(num_cands=sp.num_cands), max_read_len=128,
        device="cpu")
    b = next(iter(load_read_batches(indel_reads[0], batch_size=1024,
                                    max_len=128)))
    n_reads = b.n_reads - 100          # padding rows must not count
    G, S = jprof.pack.total_len, len(jprof.species_ids)
    cap = 2048
    kw = dict(mapid=94.0, readq=20.0, min_mapq=20, baseq=30, aln_cov=0.75)
    jstate = jds.snps_update(
        jds.snps_init(G, S, cap, 128), jal.index_arrays, jal.pack_arrays,
        jnp.asarray(jprof.contig_species), jnp.asarray(b.codes),
        jnp.asarray(b.quals), jnp.asarray(b.lengths),
        jnp.asarray(b.mean_qual), jnp.int32(n_reads), scoring=jal.scoring,
        seed_params=sp, max_len=128, **kw)
    want = jds.snps_state_host(jstate)
    want["counts"] = jds.resolve_counts(want["counts"])

    tstate = tds.snps_init(G, S, cap, 128, "cpu")
    tds.snps_update(
        tstate, tal.index_arrays, tal.pack_arrays,
        torch.from_numpy(jprof.contig_species.astype(np.int64)),
        torch.from_numpy(b.codes), torch.from_numpy(b.quals),
        torch.from_numpy(b.lengths), torch.from_numpy(b.mean_qual), n_reads,
        scoring=tsc, seed_params=tal.seed_params, max_len=128,
        smin_table=torch.from_numpy(tds.score_min_table(tsc, 128)), **kw)
    assert int(tstate.gap_n) > 3          # gapped reads were spilled
    got = tds.snps_state_host(tstate)
    assert set(got) == set(want)
    assert want["mapped_reads"][:S].sum() > 300
    assert want["aligned_reads"][S] >= 100     # padding rows
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in ("counts", "aligned_reads", "mapped_reads", "gap_codes",
              "gap_quals", "gap_meta"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k

    # host snapshot -> device state -> host snapshot round trip
    back = tds.snps_state_host(tds.snps_state_restore(got, cap, "cpu"))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    # the same rows as mate pairs (2i, 2i+1) now run (the paired step is
    # held to midas_tpu's in tests/test_torch_paired.py)
    pstate = tds.snps_init(G, S, cap, 128, "cpu")
    tds.snps_update(
        pstate, tal.index_arrays, tal.pack_arrays,
        torch.from_numpy(jprof.contig_species.astype(np.int64)),
        torch.from_numpy(b.codes), torch.from_numpy(b.quals),
        torch.from_numpy(b.lengths), torch.from_numpy(b.mean_qual), n_reads,
        scoring=tsc, seed_params=tal.seed_params, max_len=128,
        smin_table=torch.from_numpy(tds.score_min_table(tsc, 128)),
        paired=True, **kw)
    paired = tds.snps_state_host(pstate)
    assert paired["aligned_reads"].sum() == b.codes.shape[0]
    assert paired["mapped_reads"][:S].sum() > 0


# ---------------------------------------------------------------------------
# run_snps end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snps_runs(sim_community, indel_reads, tmp_path_factory):
    """The JAX package's run_snps and the port's CLI on the CPU over the
    Q40 reads, in both modes, every species selected by --species_id."""
    root = tmp_path_factory.mktemp("snps_runs")
    db, fq = sim_community.db_dir, indel_reads[1]
    ids = _species_ids(sim_community)
    runs = {}
    for mode in sorted(MODES):
        jout, tout = str(root / f"jax_{mode}"), str(root / f"torch_{mode}")
        j_run_snps(dict(outdir=jout, db=db, m1=fq, build_db=True,
                        align=True, call=True, mode=mode, species_id=ids))
        t_run_midas(["snps", tout, "-1", fq, "-d", db, "-m", mode,
                     "--species_id", ",".join(ids), "--device", "cpu"])
        runs[mode] = (jout, tout)
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_snps_byte_identical(snps_runs, sim_community, mode):
    """At Q40 with no read Ns every quality penalty is the flat one, so
    midas_tpu's batched oracle and the port's agree and the outputs are
    byte-identical, gapped reads included."""
    jout, tout = snps_runs[mode]
    ids = _species_ids(sim_community)
    want = _snps_outputs(jout, ids)
    got = _snps_outputs(tout, ids)
    assert set(got) == set(want)
    for f in want:
        assert got[f] == want[f], f
    with open(os.path.join(tout, "snps/species.txt")) as f:
        assert f.read().split() == ids
    zj = np.load(os.path.join(jout, "snps/temp/state.npz"))
    zt = np.load(os.path.join(tout, "snps/temp/state.npz"))
    for k in ("counts", "aligned_reads", "mapped_reads") + tds.GAP_FIELDS:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert int(zt["gap_n"]) == int(zj["gap_n"]) > 10
    assert zt["mapped_reads"].sum() > 300
    with open(os.path.join(tout, "snps/readme.txt")) as f:
        assert "run_midas snps" in f.read()


def test_fault_a_natural_qualities(jax_snps_profilers, sim_community,
                                   noisy_reads, monkeypatch):
    """On natural qualities the device counts and the spilled gap rows
    equal midas_tpu's, and each gapped read is piled up as the scalar
    align_oracle with qpen places it — the model the device DP scored
    with. midas_tpu's batched oracle re-aligns these reads with the flat
    mismatch penalty instead (its oracle.py:307-309): some gapped reads
    of this data are placed differently by the two models, so
    midas_tpu's final counts differ from the port's, and the port's
    _finalize with its oracle handed no penalties gives midas_tpu's
    counts back."""
    jprof = jax_snps_profilers["global"]
    fq = noisy_reads
    jhost = jprof._accumulate([fq], None, 0, 1024)
    jcounts = jds.resolve_counts(jhost["counts"])
    tprof = TSnpsProfiler(TDatabase(sim_community.db_dir),
                          _species_ids(sim_community), device="cpu")
    thost = tprof._accumulate([fq], None, 0, 1024)
    np.testing.assert_array_equal(thost["counts"], jcounts)
    for k in ("aligned_reads", "mapped_reads", "gap_n") + tds.GAP_FIELDS:
        np.testing.assert_array_equal(thost[k], np.asarray(jhost[k]),
                                      err_msg=k)
    n_gap = int(thost["gap_n"])
    assert n_gap > 10
    got = tprof._finalize(dict(thost))["counts"]

    # the scalar oracle, read by read
    pack, sc = tprof.pack, tprof.aligner.scoring
    G = pack.total_len
    want = jcounts.reshape(4, G + 1)[:, :G].copy()
    moved = 0
    for r in range(n_gap):
        ci, tstart, tend, qlen = (int(x) for x in thost["gap_meta"][r])
        lo = max(int(pack.offsets[ci]) + tstart - 8, 0)
        hi = min(int(pack.offsets[ci]) + tend + 8, G)
        q = thost["gap_codes"][r, :qlen]
        quals = thost["gap_quals"][r, :qlen].astype(np.int64)
        qpen = 2 + ((6 - 2) * np.minimum(quals, 40)) // 40
        a = joracle.align_oracle(q, pack.codes[lo:hi], jparams.GLOBAL_SCORING,
                                 qpen=qpen)
        m = a.qpos_to_tpos(qlen)
        flat = joracle.align_oracle(q, pack.codes[lo:hi],
                                    jparams.GLOBAL_SCORING)
        moved += not np.array_equal(m, flat.qpos_to_tpos(qlen))
        qpos = np.flatnonzero(m >= 0)
        mask = (quals[qpos] >= 30) & (q[qpos] < 4)
        np.add.at(want, (q[qpos][mask], lo + m[qpos][mask]), 1)
    assert moved > 0, "no gapped read is placed differently by the flat model"
    np.testing.assert_array_equal(got, want)

    # midas_tpu's flat-scored traceback lands the moved reads elsewhere;
    # the port's _finalize without the penalties does the same
    jgot = jprof._finalize(jhost)["counts"]
    assert not np.array_equal(jgot, got)

    def flat_oracle(queries, windows, scoring, qpens=None):
        return toracle.align_oracle_batch(queries, windows, scoring)

    monkeypatch.setattr(tsnps, "align_oracle_batch", flat_oracle)
    np.testing.assert_array_equal(tprof._finalize(dict(thost))["counts"],
                                  jgot)


# ---------------------------------------------------------------------------
# staging drains, checkpoints and stage splits
# ---------------------------------------------------------------------------

def test_forced_drains_equal_one_drain(sim_community, indel_reads):
    """gap_cap=1 gives a staging capacity of two batches, so the buffer
    drains every other batch; the outputs equal a run with one drain."""
    prof = TSnpsProfiler(TDatabase(sim_community.db_dir),
                         _species_ids(sim_community), device="cpu")
    fq = indel_reads[0]
    one = prof._accumulate([fq], None, 0, 64)
    many = prof._accumulate([fq], None, 0, 64, gap_cap=1)
    assert int(one["gap_n"]) > 20
    for k in ("aligned_reads", "mapped_reads", "gap_n") + tds.GAP_FIELDS:
        np.testing.assert_array_equal(many[k], one[k], err_msg=k)
    a = prof._finalize(one)
    b = prof._finalize(many)
    np.testing.assert_array_equal(a["counts"], b["counts"])


def test_checkpoint_resume_and_pileup_only(snps_runs, sim_community,
                                           indel_reads, tmp_path,
                                           monkeypatch):
    """A run killed after 3 batches resumes from its checkpoint; --align
    and then --pileup alone; both equal the plain run."""
    jout, tout = snps_runs["global"]
    ids = _species_ids(sim_community)
    plain = _snps_outputs(tout, ids)
    from midas_tpu_torch.io import prefetch
    from midas_tpu_torch.profile import checkpoint as ckpt

    out = str(tmp_path / "resumed")
    state_path = os.path.join(out, "snps/temp/state.npz")
    prof = TSnpsProfiler(TDatabase(sim_community.db_dir), ids, device="cpu")
    real = prefetch.prefetch_device_batches

    def dies_after_3(*a, **k):
        for i, db in enumerate(real(*a, **k)):
            if i == 3:
                raise KeyboardInterrupt("killed")
            yield db

    fq = indel_reads[1]
    kw = dict(batch_size=128, checkpoint_path=state_path)
    monkeypatch.setattr(prefetch, "prefetch_device_batches", dies_after_3)
    with pytest.raises(KeyboardInterrupt):
        prof._accumulate([fq], None, 0, checkpoint_every=2, **kw)
    saved = ckpt.load_any(state_path)
    assert saved[1]["batches_done"] == 2 and saved[0]["gap_n"] > 0
    monkeypatch.setattr(prefetch, "prefetch_device_batches", real)
    host = prof._accumulate([fq], None, 0, checkpoint_every=2, **kw)
    plain_state = np.load(os.path.join(tout, "snps/temp/state.npz"))
    for k in ("aligned_reads", "mapped_reads") + tds.GAP_FIELDS:
        # slot S, the dump row, also counts the padding rows, whose number
        # depends on the batch size
        want = plain_state[k][:-1] if k.endswith("reads") else plain_state[k]
        got = host[k][:-1] if k.endswith("reads") else host[k]
        np.testing.assert_array_equal(got, want, err_msg=k)
    prof._finalize(host)
    prof.write_results(out)
    assert _snps_outputs(out, ids) == plain

    # --build_db --align, then --pileup alone in a second invocation
    staged = str(tmp_path / "staged")
    base = ["snps", staged, "-1", fq, "-d", sim_community.db_dir,
            "--device", "cpu"]
    t_run_midas(base + ["--build_db", "--align", "--species_id",
                        ",".join(ids)])
    assert os.path.isfile(os.path.join(staged, "snps/temp/state.npz"))
    assert not os.path.isfile(os.path.join(staged, "snps/summary.txt"))
    t_run_midas(base + ["--pileup", "--remove_temp"])
    assert _snps_outputs(staged, ids) == plain
    assert not os.path.isdir(os.path.join(staged, "snps/temp"))


def test_paired_and_multi_process_not_yet_ported(sim_community, indel_reads,
                                                 tmp_path, monkeypatch):
    """Paired reads (-2, --interleaved, paired=True) run. Multi-process
    runs are ported now (tests/test_torch_dist.py): under WORLD_SIZE=2,
    run_snps joins the launcher's process group instead of raising "not
    yet ported", and a lone rank 0 fails the run once the rendezvous
    times out, writing nothing."""
    fq = indel_reads[1]
    sid = sim_community.species[0].species_id
    for i, extra in enumerate((["-2", fq], ["--interleaved"])):
        out = str(tmp_path / f"o{i}")
        t_run_midas(["snps", out, "-1", fq, "-d", sim_community.db_dir,
                     "--species_id", sid, "-n", "4", "--device", "cpu"]
                    + extra)
        assert os.path.isfile(os.path.join(out, "snps/summary.txt"))
    prof = TSnpsProfiler(TDatabase(sim_community.db_dir), [sid],
                         device="cpu")
    got = prof.run([fq], max_reads=4, batch_size=64, paired=True)
    assert got["aligned_reads"].sum() <= 8
    _lone_rank_of_two(monkeypatch)
    with pytest.raises(torch.distributed.DistError, match="1/2 clients"):
        t_run_snps(dict(outdir=str(tmp_path / "p"), db=sim_community.db_dir,
                        m1=fq, build_db=True, align=True, call=True,
                        device="cpu", species_id=[sid]))
    assert not os.path.exists(tmp_path / "p")


# ---------------------------------------------------------------------------
# species repairs: the multi-process launch and --m8 --remove_temp
# ---------------------------------------------------------------------------

def test_species_multi_process_not_yet_ported(sim_community, sim_reads,
                                              tmp_path, monkeypatch):
    """Multi-process species runs are ported now (tests/
    test_torch_dist.py): under WORLD_SIZE=2, run_species joins the
    launcher's process group instead of raising "not yet ported", and a
    lone rank 0 fails the run once the rendezvous times out, writing
    nothing."""
    from midas_tpu_torch.profile.species import run_species

    _lone_rank_of_two(monkeypatch)
    with pytest.raises(torch.distributed.DistError, match="1/2 clients"):
        run_species(dict(outdir=str(tmp_path / "o"), db=sim_community.db_dir,
                         m1=sim_reads[0], device="cpu"))
    assert not os.path.exists(tmp_path / "o")


def test_species_m8_with_remove_temp(sim_community, sim_reads, tmp_path):
    """--m8 --remove_temp ignores --m8, as midas_tpu does, and writes
    midas_tpu's species_profile.txt; --m8 alone writes midas_tpu's
    profile, read count and alignments.m8, and no state.npz."""
    from midas_tpu.cli.run_midas import main as j_run_midas

    fq, db = sim_reads[0], sim_community.db_dir
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_run_midas(["species", jout, "-1", fq, "-d", db, "--m8",
                 "--remove_temp"])
    t_run_midas(["species", tout, "-1", fq, "-d", db, "--m8",
                 "--remove_temp", "--device", "cpu"])
    f = "species/species_profile.txt"
    with open(os.path.join(jout, f), "rb") as a, \
            open(os.path.join(tout, f), "rb") as b:
        want = a.read()
        assert b.read() == want
    assert len(want.splitlines()) > 2
    for out in (jout, tout):
        assert not os.path.isdir(os.path.join(out, "species/temp"))
    jout, tout = str(tmp_path / "jax_m8"), str(tmp_path / "torch_m8")
    j_run_midas(["species", jout, "-1", fq, "-d", db, "--m8"])
    t_run_midas(["species", tout, "-1", fq, "-d", db, "--m8", "--device",
                 "cpu"])
    for f in (f, "species/temp/read_count.txt", "species/temp/alignments.m8"):
        with open(os.path.join(jout, f), "rb") as a, \
                open(os.path.join(tout, f), "rb") as b:
            want = a.read()
            assert b.read() == want, f
        assert want, f
    for out in (jout, tout):
        assert not os.path.exists(os.path.join(out, "species/temp/state.npz"))
