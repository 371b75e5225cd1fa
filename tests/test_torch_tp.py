"""The port's tensor parallelism (midas_tpu_torch/dist/sharded.py,
dist/species.py, dist/profilers.py) against midas_tpu's, on the CPU:
shard_index at tp = 1, 2, 3; distributed_profile_step at (dp, tp) = (1,
2) and (2, 2); one dist_species_update batch, state field by field; the
distributed species, genes and snps profilers at tp = 2, output files
byte for byte against midas_tpu's on make_mesh(2, tp=2) (snps at Q40,
where the two gapped-read oracles agree) and genes / snps against the
port's tp = 1; the snps checkpoint across an interrupted run and the
stripe reassembly; the species checkpoint's fingerprint; the snps
staging capacity (fault e); and run_*_multihost(tp=2) under 2 gloo
ranks against 1 rank at tp = 1. Exact equality throughout."""

import gzip
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align.params import GLOBAL_SCORING as J_GLOBAL
from midas_tpu.align.params import MARKER_SCORING as J_MARKER
from midas_tpu.align.seed import SeedParams as JSeedParams
from midas_tpu.db import Database as JDatabase
from midas_tpu.db import refpack as jrefpack
from midas_tpu.dist import sharded as jsharded
from midas_tpu.dist import species as jspecies
from midas_tpu.dist.profilers import (DistributedGenesProfiler as JDGenes,
                                      DistributedSnpsProfiler as JDSnps)
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.species import write_abundance as j_write_abundance
from midas_tpu.testkit import simulate_db, simulate_paired_reads, simulate_reads
from midas_tpu_torch.align.params import GLOBAL_SCORING as T_GLOBAL
from midas_tpu_torch.align.params import MARKER_SCORING as T_MARKER
from midas_tpu_torch.align.seed import SeedParams as TSeedParams
from midas_tpu_torch.db import refpack as trefpack
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.dist import driver as tdriver
from midas_tpu_torch.dist import sharded as tsharded
from midas_tpu_torch.dist import species as tspecies
from midas_tpu_torch.dist.profilers import (DistributedGenesProfiler,
                                            DistributedSnpsProfiler)
from midas_tpu_torch.dist.species import DistributedSpeciesProfiler
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.genes import GenesProfiler
from midas_tpu_torch.profile.snps import SnpsProfiler
from midas_tpu_torch.profile.species import SpeciesProfiler, write_abundance

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 128


def _read(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def _same_tree(want_dir, got_dir, program):
    """summary.txt and every decompressed output file, byte for byte."""
    names = sorted(os.listdir(os.path.join(want_dir, program, "output")))
    assert names and names == sorted(os.listdir(
        os.path.join(got_dir, program, "output")))
    for rel in ["summary.txt"] + [f"output/{n}" for n in names]:
        assert _read(os.path.join(got_dir, program, rel)) == \
            _read(os.path.join(want_dir, program, rel)), rel


def _q40(src, dst):
    """Copy a gzipped FASTQ with every quality line set to Phred 40."""
    with gzip.open(src, "rt") as fi, gzip.open(dst, "wt") as fo:
        for i, line in enumerate(fi):
            if i % 4 == 3:
                line = "I" * len(line.rstrip("\n")) + "\n"
            fo.write(line)


def _species_ids(sim_community):
    return [s.species_id for s in sim_community.species]


@pytest.fixture(scope="module")
def reads(sim_community, tmp_path_factory):
    """500 reads and 200 mate pairs with indels in one read of ten, and
    their Q40 copies: {(layout, quality): [paths]}."""
    root = tmp_path_factory.mktemp("tp_reads")
    fq = str(root / "r.fq.gz")
    simulate_reads(sim_community, fq, n_reads=500, read_len=100,
                   abundances=[0.5, 0.3, 0.15, 0.05], error_rate=0.005,
                   indel_rate=0.1, seed=23)
    fq1, fq2 = str(root / "p1.fq.gz"), str(root / "p2.fq.gz")
    simulate_paired_reads(sim_community, fq1, fq2, n_pairs=200,
                          error_rate=0.01, indel_rate=0.1, seed=24)
    out = {}
    for layout, files in (("single", [fq]), ("paired", [fq1, fq2])):
        out[layout, "natural"] = files
        q40 = [f.replace(".fq.gz", "_q40.fq.gz") for f in files]
        for src, dst in zip(files, q40):
            _q40(src, dst)
        out[layout, "q40"] = q40
    return out


# ---------------------------------------------------------------------------
# shard_index and the profiling step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 3])
def test_shard_index_equals_midas_tpu(sim_community, tp):
    """Every array of shard_index and shard_pack_arrays, dtypes included,
    on the marker pack (60 sequences; at tp = 3 two shards are rebuilt
    to the common bucket counts)."""
    fasta = JDatabase(sim_community.db_dir).marker_fasta()
    jpack, tpack = jrefpack.pack_from_fasta(fasta), \
        trefpack.pack_from_fasta(fasta)
    want = jsharded.shard_index(jpack, tp=tp, k=14)
    got = tsharded.shard_index(tpack, tp=tp, k=14)
    for w, g in zip(want, got):
        for k in (w if isinstance(w, dict) else {"": w}):
            a, b = (w[k], g[k]) if k else (w, g)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(b, a, err_msg=k)
    for w, g in zip(jspecies.shard_pack_arrays(jpack, tp),
                    tspecies.shard_pack_arrays(tpack, tp)):
        for k in (w if isinstance(w, dict) else {"": w}):
            a, b = (w[k], g[k]) if k else (w, g)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.fixture(scope="module")
def synthetic():
    """6 random 1.5 kb contigs in both packages' packs and 32 error-free
    100 bp reads cut from them (midas_tpu's tests/test_dist.py)."""
    rng = np.random.default_rng(3)
    seqs = [(f"ctg{s}", "".join("ACGT"[b] for b in rng.integers(0, 4, 1500)))
            for s in range(6)]
    B, L = 32, 128
    codes = np.full((B, L), 4, dtype=np.int8)
    qlens = np.full(B, 100, dtype=np.int32)
    origin = np.zeros(B, dtype=np.int64)
    for i in range(B):
        s = i % len(seqs)
        origin[i] = s
        pos = int(rng.integers(0, 1400))
        frag = seqs[s][1][pos: pos + 100]
        codes[i, :100] = np.frombuffer(
            frag.translate(str.maketrans("ACGT", "\x00\x01\x02\x03"))
            .encode("latin1"), dtype=np.int8)
    return (jrefpack.build_pack(seqs), trefpack.build_pack(seqs), codes,
            qlens, origin)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_distributed_profile_step_equals_midas_tpu(synthetic, dp, tp):
    """Per-sequence mapped reads and aligned bp and the aligned count
    equal midas_tpu's step on make_mesh(dp * tp, tp) by value (its
    float32 sums, the port's int64), and the truth: every read on its
    contig, 100 bp each."""
    jpack, tpack, codes, qlens, origin = synthetic
    k = 12
    jsp = JSeedParams(k=k, num_cands=2, max_hits=8, band_width=16)
    tsp = TSeedParams(k=k, num_cands=2, max_hits=8, band_width=16)
    pc, idx, off, _base, sb = jsharded.shard_index(jpack, tp=tp, k=k)
    want = jsharded.distributed_profile_step(
        jsharded.make_mesh(dp * tp, tp=tp), jnp.asarray(codes),
        jnp.asarray(qlens), jnp.asarray(pc),
        {n: jnp.asarray(v) for n, v in idx.items()}, jnp.asarray(off),
        jnp.asarray(sb), J_GLOBAL, jsp, 128, jpack.num_seqs)
    pc, idx, off, _base, sb = tsharded.shard_index(tpack, tp=tp, k=k)
    got = tsharded.distributed_profile_step(
        torch.from_numpy(codes), torch.from_numpy(qlens), pc, idx, off, sb,
        T_GLOBAL, tsp, 128, tpack.num_seqs)
    for key in ("counts", "bp"):
        assert got[key].dtype == torch.int64
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]).astype(np.int64))
    assert int(got["aligned_reads"]) == int(want["aligned_reads"]) == 32
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.bincount(origin, minlength=6))
    assert int(got["bp"].sum()) == 100 * 32


# ---------------------------------------------------------------------------
# species
# ---------------------------------------------------------------------------

def test_dist_species_update_batch_equal(sim_community, sim_reads):
    """One batch at tp = 2 against midas_tpu's dist_species_update on
    make_mesh(2, tp=2): every field of the state (ambiguous rows 2 x 8
    wide; uniq_bp and amb_ord compared by value, the port's int64)."""
    jdb, tdb = JDatabase(sim_community.db_dir), TDatabase(sim_community.db_dir)
    tprof = DistributedSpeciesProfiler(tdb, tp=2, device="cpu")
    jpack = jrefpack.pack_from_fasta(jdb.marker_fasta())
    sp = tprof.aligner.seed_params
    jsp = JSeedParams(num_cands=sp.num_cands, max_hits=sp.max_hits)
    idx, packa, seq_base = jspecies.shard_pack_arrays(jpack, 2)
    b = next(iter(load_read_batches(sim_reads[0], batch_size=512,
                                    max_len=128)))
    n_species = len(tprof.species_order)
    dblen = float(jpack.total_len)
    cap, ord_base, width = 1024, 3 * 512, 2 * sp.num_cands
    jstate = jspecies.dist_species_update(
        jsharded.make_mesh(2, tp=2), jds.species_init(n_species, width, cap),
        {k: jnp.asarray(v) for k, v in idx.items()},
        {k: jnp.asarray(v) for k, v in packa.items()}, jnp.asarray(seq_base),
        jnp.asarray(tprof.seq_species), jnp.asarray(tprof.seq_cutoff),
        jnp.asarray(b.codes), jnp.asarray(b.lengths), jnp.int32(b.n_reads),
        np.int32(ord_base), scoring=J_MARKER, seed_params=jsp, max_len=128,
        aln_cov=0.75, n_species=n_species, dblen=dblen)
    want = jds.species_state_host(jstate)

    tstate = tds.species_init(n_species, width, cap, "cpu")
    min_score = torch.from_numpy(T_MARKER.evalue_min_score(
        np.maximum(np.arange(129), 1), dblen))
    al = tprof.aligner
    tspecies.dist_species_update(
        tstate, al.shards, torch.from_numpy(tprof.seq_species),
        torch.from_numpy(tprof.seq_cutoff), torch.from_numpy(b.codes),
        torch.from_numpy(b.lengths), b.n_reads, ord_base, scoring=T_MARKER,
        seed_params=sp, max_len=128, aln_cov=0.75, n_species=n_species,
        min_score=min_score)
    got = tds.species_state_host(tstate)
    assert set(got) == set(want)
    assert want["amb_n"] > 0 and want["uniq_count"][:-1].sum() > 0
    assert got["amb_sp"].shape[1] == width
    for k in want:
        # without slot S, the no-hit dump nothing reads: midas_tpu's
        # distributed step adds 0 there, its single-device step and the
        # port's classifier 1 a read that is not unique
        g, w = (x[:-1] if k in ("uniq_count", "uniq_bp") else x
                for x in (got[k], want[k]))
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def mixed_ties(tmp_path_factory):
    """A community whose ambiguous reads' stream and column order decide
    the profile (tests/test_torch_dist.py's): 6 species and 3 related
    copies at 3% divergence, equal abundances, 1,200 reads with 3% errors
    and indels in one of ten. Returns (db_dir, fq)."""
    root = tmp_path_factory.mktemp("tp_mixed_ties")
    comm = simulate_db(str(root / "db"), n_species=6, genome_len=12000,
                       gene_len=600, n_extra_genes=4, related_pairs=3,
                       divergence=0.03, seed=0)
    fq = str(root / "mix.fq.gz")
    simulate_reads(comm, fq, n_reads=1200, read_len=100,
                   abundances=[1.0 / len(comm.species)] * len(comm.species),
                   error_rate=0.03, indel_rate=0.1, seed=4)
    return comm.db_dir, fq


@pytest.mark.parametrize("data", ["sim", "mixed_ties"])
def test_species_profile_tp2_equals_midas_tpu(request, sim_community,
                                              sim_reads, tmp_path, data):
    """DistributedSpeciesProfiler.run at tp = 2 (batches of 128): the
    species_profile.txt of midas_tpu's DistributedSpeciesProfiler on
    make_mesh(2, tp=2), byte for byte, and its stats; on sim_community
    also the port's tp = 1 profile."""
    if data == "sim":
        db_dir, fq = sim_community.db_dir, sim_reads[0]
    else:
        db_dir, fq = request.getfixturevalue("mixed_ties")
    jprof = jspecies.DistributedSpeciesProfiler(
        JDatabase(db_dir), mesh=jsharded.make_mesh(2, tp=2))
    j_write_abundance(str(tmp_path / "jax.txt"),
                      jprof.run([fq], batch_size=BATCH))
    tprof = DistributedSpeciesProfiler(TDatabase(db_dir), tp=2, device="cpu")
    abundance = tprof.run([fq], batch_size=BATCH)
    write_abundance(str(tmp_path / "tp2.txt"), abundance)
    assert _read(str(tmp_path / "tp2.txt")) == _read(str(tmp_path / "jax.txt"))
    assert tprof.stats == jprof.stats
    assert sum(v["count"] for v in abundance.values()) > 300
    if data == "sim":
        one = SpeciesProfiler(TDatabase(db_dir), device="cpu")
        write_abundance(str(tmp_path / "tp1.txt"),
                        one.run([fq], batch_size=BATCH))
        assert _read(str(tmp_path / "tp1.txt")) == \
            _read(str(tmp_path / "tp2.txt"))


@pytest.mark.parametrize("data", ["sim", "mixed_ties"])
def test_species_m8_tp2_equals_midas_tpu(request, sim_community, sim_reads,
                                         tmp_path, data):
    """DistributedSpeciesProfiler.run(m8_path=...) at tp = 2 (fault k):
    alignments.m8 byte for byte and the abundance equal to midas_tpu's
    DistributedSpeciesProfiler on make_mesh(2, tp=2), which runs the
    inherited host path on its single-device aligner; afterwards the
    profiler still holds its shards and its device path still gives the
    same abundance."""
    if data == "sim":
        db_dir, fq = sim_community.db_dir, sim_reads[0]
    else:
        db_dir, fq = request.getfixturevalue("mixed_ties")
    jprof = jspecies.DistributedSpeciesProfiler(
        JDatabase(db_dir), mesh=jsharded.make_mesh(2, tp=2))
    want = jprof.run([fq], batch_size=BATCH, m8_path=str(tmp_path / "j.m8"))
    tprof = DistributedSpeciesProfiler(TDatabase(db_dir), tp=2, device="cpu")
    got = tprof.run([fq], batch_size=BATCH, m8_path=str(tmp_path / "t.m8"))
    m8 = _read(str(tmp_path / "t.m8"))
    assert m8 == _read(str(tmp_path / "j.m8"))
    assert m8.count(b"\n") > 300
    assert got == want
    assert tprof.stats == jprof.stats
    assert isinstance(tprof.aligner, tsharded.ShardedAligner)
    assert tprof.run([fq], batch_size=BATCH) == got


def test_species_fingerprint_changes_with_tp(sim_community, sim_reads,
                                             tmp_path, monkeypatch):
    """The species checkpoint's fingerprint holds tp: a state saved at
    one tp is not resumed at another, and is resumed at the same tp
    (with the same profile)."""
    from midas_tpu_torch.profile import checkpoint as ckpt

    loads = []
    real = ckpt.load

    def load(path, fp):
        got = real(path, fp)
        loads.append((fp, got is not None))
        return got

    monkeypatch.setattr(ckpt, "load", load)
    db, fq = TDatabase(sim_community.db_dir), sim_reads[0]
    path = str(tmp_path / "state.npz")
    profiles = []
    for tp in (1, 2, 3, 2):
        prof = (SpeciesProfiler(db, device="cpu") if tp == 1 else
                DistributedSpeciesProfiler(db, tp=tp, device="cpu"))
        profiles.append(prof.run([fq], batch_size=BATCH,
                                 checkpoint_path=path))
    fps = [fp for fp, _ in loads]
    assert len(set(fps[:3])) == 3 and fps[3] == fps[1]
    assert [hit for _, hit in loads] == [False, False, False, False]
    # the last run resumes the tp = 2 state of the run before it only if
    # nothing else was saved in between: rerun at tp = 2 now
    prof = DistributedSpeciesProfiler(db, tp=2, device="cpu")
    assert prof.run([fq], batch_size=BATCH, checkpoint_path=path) == \
        profiles[3] == profiles[0]
    assert loads[-1] == (fps[1], True)


# ---------------------------------------------------------------------------
# genes and snps
# ---------------------------------------------------------------------------

TP_RUNS = {
    # (program, mode, layout, quality)
    "genes_single": ("genes", "local", "single", "natural"),
    "genes_paired": ("genes", "local", "paired", "natural"),
    "snps_single": ("snps", "global", "single", "q40"),
    "snps_paired": ("snps", "global", "paired", "q40"),
}


def _profile(cls, db, ids, program, mode, files, outdir, **kw):
    """Run a profiler over files (mate pairs when two) at batch 128 and
    write its outputs under outdir; returns the profiler's results."""
    prof = cls(db, ids, mode=mode, **kw)
    res = prof.run(files, batch_size=BATCH, paired=len(files) == 2)
    os.makedirs(os.path.join(outdir, program), exist_ok=True)
    prof.write_results(outdir)
    return res


@pytest.mark.parametrize("key", sorted(TP_RUNS))
def test_genes_snps_tp2_equal_midas_tpu_and_tp1(sim_community, reads,
                                                tmp_path, key):
    """The distributed genes / snps profilers at tp = 2 over single-end
    reads and -1/-2 pairs: every output file equal to midas_tpu's
    distributed profiler's on make_mesh(2, tp=2) and to the port's
    single-device profiler's, and the results arrays to the latter's."""
    program, mode, layout, qual = TP_RUNS[key]
    files = reads[layout, qual]
    ids = _species_ids(sim_community)
    jcls, tcls, one = ((JDGenes, DistributedGenesProfiler, GenesProfiler)
                       if program == "genes" else
                       (JDSnps, DistributedSnpsProfiler, SnpsProfiler))
    want_dir, got_dir, one_dir = (str(tmp_path / n)
                                  for n in ("jax", "tp2", "tp1"))
    _profile(jcls, JDatabase(sim_community.db_dir), ids, program, mode,
             files, want_dir, mesh=jsharded.make_mesh(2, tp=2))
    tdb = TDatabase(sim_community.db_dir)
    got = _profile(tcls, tdb, ids, program, mode, files, got_dir, tp=2,
                   device="cpu")
    single = _profile(one, tdb, ids, program, mode, files, one_dir,
                      device="cpu")
    _same_tree(want_dir, got_dir, program)
    _same_tree(one_dir, got_dir, program)
    for k in single:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(single[k]), err_msg=k)
    assert int(np.sum(got["mapped_reads"])) > 100
    if program == "snps":
        assert got["n_gapped"] > 5      # the gapped rows took the spill


def test_snps_checkpoint_resumes_across_an_interrupted_run(
        sim_community, reads, tmp_path):
    """A snps run at tp = 2 that saves its state every 2 batches and
    dies in batch 4 resumes from that state (at tp = 2, and the state's
    single-device layout at tp = 1) to the uninterrupted run's counts."""
    ids = _species_ids(sim_community)
    tdb = TDatabase(sim_community.db_dir)
    files = reads["single", "q40"]
    want = DistributedSnpsProfiler(tdb, ids, tp=2, device="cpu")._accumulate(
        files, None, 0, BATCH)

    def dies_in_batch_4(batches):
        for i, b in enumerate(batches):
            if i == 3:
                raise RuntimeError("killed")
            yield b

    for resume_tp in (2, 1):
        path = str(tmp_path / f"state_{resume_tp}.npz")
        prof = DistributedSnpsProfiler(tdb, ids, tp=2, device="cpu")
        prof._batch_filter = dies_in_batch_4
        with pytest.raises(RuntimeError, match="killed"):
            prof._accumulate(files, None, 0, BATCH, checkpoint_path=path,
                             checkpoint_every=2)
        z = np.load(path)
        assert json.loads(str(z["__meta__"]))["batches_done"] == 2
        again = (DistributedSnpsProfiler(tdb, ids, tp=2, device="cpu")
                 if resume_tp == 2 else SnpsProfiler(tdb, ids, device="cpu"))
        got = again._accumulate(files, None, 0, BATCH, checkpoint_path=path,
                                checkpoint_every=2)
        for k in ("counts", "aligned_reads", "mapped_reads", "gap_codes",
                  "gap_quals", "gap_meta", "gap_n"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_stripes_reassemble_and_shard_back(sim_community):
    """_shard_counts after _reassemble_counts is the identity on stripes
    whose padding and dump columns are empty, and _reassemble_counts
    after _shard_counts the identity on flat counts whose dump column is
    empty; the stripes tile the genome."""
    ids = _species_ids(sim_community)
    prof = DistributedSnpsProfiler(TDatabase(sim_community.db_dir), ids,
                                   tp=3, device="cpu")
    G, SL = prof.pack.total_len, prof.stripe_len
    assert int(prof.stripe_real.sum()) == G
    assert list(prof.shard_base) == list(np.cumsum(
        [0] + list(prof.stripe_real[:-1])))
    rng = np.random.default_rng(5)
    stripes = rng.integers(0, 1000, (3, 4, SL + 1)).astype(np.int32)
    for r in range(3):
        stripes[r, :, prof.stripe_real[r]:] = 0
    stripes = stripes.reshape(3, -1)
    flat = prof._reassemble_counts(stripes)
    assert flat.dtype == np.int32 and flat.shape == (4 * (G + 1),)
    np.testing.assert_array_equal(prof._shard_counts(flat), stripes)
    flat = rng.integers(0, 1000, (4, G + 1)).astype(np.int32)
    flat[:, G] = 0
    np.testing.assert_array_equal(
        prof._reassemble_counts(prof._shard_counts(flat.reshape(-1))),
        flat.reshape(-1))


@pytest.mark.parametrize("paired", [False, True])
def test_snps_staging_holds_two_batches_read(sim_community, paired):
    """Fault e: the gapped-row staging capacity is clamped to twice the
    batch size the stream is actually read at, after an odd paired batch
    is rounded up to even (midas_tpu clamps first: 2 x 127 = 254 < 256)."""
    prof = DistributedSnpsProfiler(TDatabase(sim_community.db_dir),
                                   _species_ids(sim_community)[:1], tp=2,
                                   device="cpu")
    batch, cap = prof._staging(127, 100, paired)
    assert batch == (128 if paired else 127)
    assert cap == 2 * batch
    assert prof._staging(127, 10_000, paired) == (batch, 10_000)


# ---------------------------------------------------------------------------
# run_*_multihost(tp=2) under 2 gloo ranks
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from midas_tpu_torch.dist import driver

spec = json.loads(sys.argv[1])
driver.DEFAULT_TIMEOUT_S = 120
driver.initialize()
for call in spec["calls"]:
    fn = getattr(driver, "run_%s_multihost" % call["entry"])
    fn(*call["args"], tp=spec["tp"], device="cpu", batch_size=spec["batch"],
       **call["kw"])
print("RESULT " + json.dumps(dict(rank=driver.process_index())), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multihost_calls(sim_community, reads, sim_reads, root):
    """run_species / genes -m local over -1/-2 pairs / snps -m global at
    Q40, each into root/<entry>."""
    db, ids = sim_community.db_dir, _species_ids(sim_community)
    return [
        dict(entry="species", args=[db, [sim_reads[0]]],
             kw=dict(outdir=os.path.join(root, "species"))),
        dict(entry="genes", args=[db, reads["paired", "natural"], ids],
             kw=dict(outdir=os.path.join(root, "genes"), paired=True,
                     mode="local")),
        dict(entry="snps", args=[db, reads["single", "q40"], ids],
             kw=dict(outdir=os.path.join(root, "snps"), mode="global")),
    ]


@pytest.fixture(scope="module")
def multihost_runs(sim_community, reads, sim_reads, tmp_path_factory):
    """The three entry points at tp = 2 in 2 gloo ranks (subprocesses,
    batch 128, so both ranks stream) and at tp = 1 in this process."""
    root = tmp_path_factory.mktemp("tp_multihost")
    for call in _multihost_calls(sim_community, reads, sim_reads,
                                 str(root / "one")):
        getattr(tdriver, f"run_{call['entry']}_multihost")(
            *call["args"], tp=1, device="cpu", batch_size=BATCH, **call["kw"])
    spec = dict(tp=2, batch=BATCH, calls=_multihost_calls(
        sim_community, reads, sim_reads, str(root / "two")))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps(spec)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RESULT " in out
    return str(root / "one"), str(root / "two")


@pytest.mark.parametrize("entry", ["species", "genes", "snps"])
def test_multihost_tp2_two_ranks_equal_one_rank(multihost_runs, entry):
    """run_species|genes|snps_multihost(tp=2) under 2 ranks: rank 0's
    outputs equal 1 rank's at tp = 1, byte for byte."""
    one, two = (os.path.join(d, entry) for d in multihost_runs)
    if entry == "species":
        for rel in ("species/species_profile.txt",
                    "species/temp/read_count.txt"):
            assert _read(os.path.join(two, rel)) == \
                _read(os.path.join(one, rel)), rel
    else:
        _same_tree(one, two, entry)
