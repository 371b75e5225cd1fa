"""The port's paired-end reads against midas_tpu, on the CPU: the mate-pair
batch loader (-1/-2 and --interleaved, with its three input errors),
the mate-pair best hit (paired_best_hit_device) on random and hand-made
candidate tables, one paired genes_update / snps_update batch, run_genes
and run_snps over mate pairs (outputs byte for byte, snps at Q40), and
the documented divergence from bowtie2's mixed-mode pairing on a
chimeric library. Exact equality throughout. Each midas_tpu pipeline
runs once, in a module-scoped fixture."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import params as jparams
from midas_tpu.db import Database as JDatabase
from midas_tpu.io import batch as jbatch
from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.genes import GenesProfiler as JGenesProfiler
from midas_tpu.profile.genes import run_genes as j_run_genes
from midas_tpu.profile.snps import SnpsProfiler as JSnpsProfiler
from midas_tpu.profile.snps import run_snps as j_run_snps
from midas_tpu.testkit import simulate_paired_reads
from midas_tpu_torch.align import params as tparams
from midas_tpu_torch.align.pipeline import Aligner as TAligner
from midas_tpu_torch.align.seed import SeedParams as TSeedParams
from midas_tpu_torch.cli.run_midas import main as t_run_midas
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.io import batch as tbatch
from midas_tpu_torch.io.prefetch import prefetch_device_batches
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.snps import SnpsProfiler as TSnpsProfiler

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

MODES = {"local": "LOCAL_SCORING", "global": "GLOBAL_SCORING"}
NEG_INF = np.float32(jds.NEG_INF)
BATCH_FIELDS = ("codes", "lengths", "quals", "mean_qual")


def _scorings(mode):
    return getattr(jparams, MODES[mode]), getattr(tparams, MODES[mode])


def _species_ids(sim_community):
    return [s.species_id for s in sim_community.species]


def _interleave(fq1, fq2, dst):
    """Write the pairs of two gzipped FASTQ files into one, mates
    alternating."""
    with gzip.open(fq1, "rt") as a, gzip.open(fq2, "rt") as b, \
            gzip.open(dst, "wt") as out:
        while True:
            r1 = [a.readline() for _ in range(4)]
            r2 = [b.readline() for _ in range(4)]
            if not r1[0]:
                break
            out.writelines(r1 + r2)


def _q40(src, dst):
    """Copy a gzipped FASTQ with every quality line set to Phred 40."""
    with gzip.open(src, "rt") as fi, gzip.open(dst, "wt") as fo:
        for i, line in enumerate(fi):
            if i % 4 == 3:
                line = "I" * len(line.rstrip("\n")) + "\n"
            fo.write(line)


@pytest.fixture(scope="module")
def paired_files(sim_community, tmp_path_factory):
    """300 mate pairs with natural qualities (-1/-2 and interleaved),
    indels in one mate of ten, and the same pairs at Q40."""
    root = tmp_path_factory.mktemp("paired")
    files = {}
    fq1, fq2 = str(root / "r1.fq.gz"), str(root / "r2.fq.gz")
    simulate_paired_reads(sim_community, fq1, fq2, n_pairs=300,
                          error_rate=0.01, indel_rate=0.1, seed=11)
    files["natural"] = (fq1, fq2, str(root / "inter.fq.gz"))
    q1, q2 = str(root / "r1_q40.fq.gz"), str(root / "r2_q40.fq.gz")
    _q40(fq1, q1)
    _q40(fq2, q2)
    files["q40"] = (q1, q2, str(root / "inter_q40.fq.gz"))
    for a, b, inter in files.values():
        _interleave(a, b, inter)
    return files


# ---------------------------------------------------------------------------
# the mate-pair batch loader
# ---------------------------------------------------------------------------

def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.n_reads == w.n_reads
        assert g.names == w.names
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
            assert getattr(g, f).dtype == getattr(w, f).dtype, f


@pytest.mark.parametrize("batch_size,max_reads", [(127, None), (64, 50)])
def test_load_paired_batches_equal(paired_files, batch_size, max_reads):
    """-1/-2 and --interleaved give midas_tpu's batches (an odd batch
    size bumped to even, max_reads counting pairs), and the same ones."""
    fq1, fq2, inter = paired_files["natural"]
    kw = dict(batch_size=batch_size, max_len=128, max_reads=max_reads)
    mates = list(tbatch.load_paired_batches(fq1, fq2, **kw))
    _same_batches(mates, list(jbatch.load_paired_batches(fq1, fq2, **kw)))
    il = list(tbatch.load_paired_batches(inter, None, interleaved=True, **kw))
    _same_batches(il, list(jbatch.load_paired_batches(
        inter, None, interleaved=True, **kw)))
    _same_batches(il, mates)
    assert all(b.batch_size == batch_size + batch_size % 2 for b in mates)
    assert sum(b.n_reads for b in mates) == 2 * (max_reads or 300)
    b0 = mates[0]
    assert b0.names[0] == b0.names[1][:-2] + "/1"
    assert b0.names[1].endswith("/2")


def _fastq(path, names):
    with open(path, "w") as f:
        for n in names:
            f.write(f"@{n}\nACGTACGTAC\n+\nIIIIIIIIII\n")


@pytest.mark.parametrize("case", ["count_mismatch", "odd_interleaved",
                                  "broken_names"])
def test_paired_input_errors(tmp_path, case):
    """Both packages refuse the same inputs with the same message; the
    odd-total check fires after the last batch, in the prefetch
    producer thread, and surfaces in the consumer."""
    a, b = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    if case == "count_mismatch":
        _fastq(a, ["r1/1", "r2/1", "r3/1"])
        _fastq(b, ["r1/2", "r2/2"])
        args, kw, msg = (a, b), {}, "different read counts"
    elif case == "odd_interleaved":
        _fastq(a, ["r1/1", "r1/2", "r2/1", "r2/2", "r3/1"])
        args, kw, msg = (a, None), dict(interleaved=True), "odd read count"
    else:
        _fastq(a, ["r1/1", "r1/2", "r2/1", "r3/2"])
        args, kw, msg = (a, None), dict(interleaved=True), "pairing broken"
    kw.update(batch_size=4, max_len=16)
    for load in (jbatch.load_paired_batches, tbatch.load_paired_batches):
        with pytest.raises(ValueError, match=msg):
            list(load(*args, **kw))
    if case == "odd_interleaved":
        got = []
        with pytest.raises(ValueError, match=msg):
            for db in prefetch_device_batches(
                    tbatch.load_paired_batches(*args, **kw), device="cpu"):
                got.append(db.n_reads)
        assert got == [4, 1]        # every batch arrived before the error


# ---------------------------------------------------------------------------
# the mate-pair best hit
# ---------------------------------------------------------------------------

def _random_pair_out(seed, scoring, P=512, C=4):
    """A candidate table [2P, C] for P mate pairs, drawn to reach every
    branch: few sequences and a small score set (exact pair ties),
    candidates with the same coordinates on both strands (swapped-strand
    duplicates), fragment spans of exactly 500 and 501, mates of mixed
    lengths (9 and 24, where float32 and float64 scMin differ, up to
    128), rows without a valid candidate, and a padding tail."""
    rng = np.random.default_rng(seed)
    B = 2 * P
    table = tds.score_min_table(scoring, 128)
    qlens = rng.choice([9, 24, 60, 100, 100, 128], size=B).astype(np.int32)
    qlens[-16:] = 0                                    # padding pairs
    smin = table[qlens].astype(np.float32)
    top = scoring.match * np.maximum(qlens, 1).astype(np.float32)
    steps = rng.integers(-2, 5, size=(B, C)).astype(np.float32)
    score = np.where(rng.random((B, C)) < 0.5, smin[:, None] + 3 * steps,
                     top[:, None] - 2 * np.abs(steps))
    seq_idx = rng.integers(0, 3, size=(B, C))
    strand = rng.integers(0, 2, size=(B, C))
    tstart = rng.integers(0, 1500, size=(B, C))
    # mate 2 near mate 1's candidate of the same column
    tstart[1::2] = tstart[0::2] + rng.integers(-200, 500, size=(P, C))
    tstart = np.maximum(tstart, 0)
    tend = tstart + rng.integers(60, 129, size=(B, C))
    # spans of exactly 500 and 501 (mate 1 forward, leftmost)
    edge = rng.random(P) < 0.25
    span = np.where(rng.random(P) < 0.5, 500, 501)
    for p in np.flatnonzero(edge):
        r1, r2 = 2 * p, 2 * p + 1
        seq_idx[r2, 0] = seq_idx[r1, 0]
        strand[r1, 0], strand[r2, 0] = 0, 1
        tend[r2, 0] = tstart[r1, 0] + span[p]
        tstart[r2, 0] = tend[r2, 0] - 100
    # swapped-strand duplicates: column 1 repeats column 0's coordinates
    # on the other strand, for both mates, at equal scores; where the
    # mates also start together, pairings (0, 0) and (1, 1) are equal
    # but for the strand plane of the tie order
    dup = np.repeat(rng.random(P) < 0.2, 2)
    same = np.flatnonzero(dup[0::2] & (rng.random(P) < 0.5))
    for v in (seq_idx, tstart, tend):
        v[2 * same + 1, 0] = v[2 * same, 0]
    strand[2 * same + 1, 0] = 1 - strand[2 * same, 0]
    for v in (seq_idx, tstart, tend, score):
        v[dup, 1] = v[dup, 0]
    strand[dup, 1] = 1 - strand[dup, 0]
    valid = rng.random((B, C)) < 0.85
    valid[rng.random(B) < 0.05] = False                # no valid candidate
    valid[-16:] = False
    out = dict(valid=valid, score=score.astype(np.float32),
               seq_idx=seq_idx.astype(np.int64),
               strand=strand.astype(np.int64),
               tstart=tstart.astype(np.int64), tend=tend.astype(np.int64))
    return out, qlens


def _both_paired(out, qlens, mode, maxins=500):
    """(midas_tpu's, the port's) paired_best_hit_device on one table,
    as numpy arrays."""
    jsc, tsc = _scorings(mode)
    jout = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in out.items()}
    want = jds.paired_best_hit_device(jout, jnp.asarray(qlens), jsc,
                                      maxins=maxins)
    table = torch.from_numpy(tds.score_min_table(tsc, 256))
    got = tds.paired_best_hit_device(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(qlens), tsc, table, maxins=maxins)
    assert got[1].dtype == torch.int64 and got[2].dtype == torch.int32
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_paired_best_hit_equal(mode):
    out, qlens = _random_pair_out(21, _scorings(mode)[1])
    want, got = _both_paired(out, qlens, mode)
    for name, w, g in zip(("aligned", "best_col", "mapq"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the draw reached the cases it was made for: concordant pairs and
    # fallbacks, several pair MAPQs, padding not aligned
    j_unpaired = jds.best_hit_device(
        {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in out.items()}, jnp.asarray(qlens), _scorings(mode)[0])
    moved = np.asarray(j_unpaired[1]) != want[1]
    assert 20 < moved.sum() and want[0][:-16].mean() > 0.3
    assert len(np.unique(want[2][want[0]])) > 3
    assert not want[0][-16:].any()


def _mk_out(score, seq_idx, strand, tstart, tend):
    """A minimal pass-1 table (as tests/test_paired.py builds it)."""
    score = np.asarray(score, np.float32)
    return dict(valid=score > NEG_INF / 2, score=score,
                seq_idx=np.asarray(seq_idx, np.int64),
                strand=np.asarray(strand, np.int64),
                tstart=np.asarray(tstart, np.int64),
                tend=np.asarray(tend, np.int64))


HAND_CASES = {
    # mate 1 ties two loci, mate 2 hits one of them: the concordant pair
    # picks it, and the pair MAPQ clears the >= 20 gate
    "multimapper": (_mk_out(score=[[-10.0, -10.0], [-12.0, NEG_INF]],
                            seq_idx=[[0, 1], [0, 0]],
                            strand=[[0, 0], [1, 0]],
                            tstart=[[1000, 5000], [1250, 0]],
                            tend=[[1100, 5100], [1350, 0]]), 500),
    # same strand: never concordant, both mates fall back
    "fallback": (_mk_out(score=[[-5.0, NEG_INF], [-7.0, NEG_INF]],
                         seq_idx=[[0, 0], [0, 0]], strand=[[0, 0], [0, 0]],
                         tstart=[[100, 0], [220, 0]],
                         tend=[[200, 0], [320, 0]]), 500),
    # a span of 900: concordant under maxins 1000, not under 500
    "maxins_near": (_mk_out(score=[[-5.0, NEG_INF], [-7.0, NEG_INF]],
                            seq_idx=[[0, 0], [0, 0]],
                            strand=[[0, 0], [1, 0]],
                            tstart=[[100, 0], [900, 0]],
                            tend=[[200, 0], [1000, 0]]), 1000),
    "maxins_far": (_mk_out(score=[[-5.0, NEG_INF], [-7.0, NEG_INF]],
                           seq_idx=[[0, 0], [0, 0]], strand=[[0, 0], [1, 0]],
                           tstart=[[100, 0], [900, 0]],
                           tend=[[200, 0], [1000, 0]]), 500),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_paired_best_hit_hand_cases(case):
    """tests/test_paired.py's hand cases (GLOBAL): equal to midas_tpu,
    with the behaviour each case was made for."""
    out, maxins = HAND_CASES[case]
    qlens = np.array([100, 100], np.int32)
    (aligned, col, mapq), got = _both_paired(out, qlens, "global", maxins)
    for name, w, g in zip(("aligned", "best_col", "mapq"),
                          (aligned, col, mapq), got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    table = torch.from_numpy(tds.score_min_table(tparams.GLOBAL_SCORING, 128))
    u = [t.numpy() for t in tds.best_hit_device(
        {k: torch.from_numpy(v) for k, v in out.items()},
        torch.from_numpy(qlens), tparams.GLOBAL_SCORING, table)]
    if case == "multimapper":
        assert u[2][0] <= 3 and aligned.all() and (col == 0).all()
        assert mapq[0] == mapq[1] >= 20
    elif case in ("fallback", "maxins_far"):
        for w, g in zip((aligned, col, mapq), u):
            np.testing.assert_array_equal(w, g)
    else:                         # the pair path: one MAPQ for both mates
        assert mapq[0] == mapq[1]


# ---------------------------------------------------------------------------
# one paired genes_update / snps_update batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_profilers(sim_community):
    db = JDatabase(sim_community.db_dir)
    ids = _species_ids(sim_community)
    return dict(genes=JGenesProfiler(db, ids), snps=JSnpsProfiler(db, ids))


def _torch_aligner(jal, scoring):
    return TAligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        scoring, TSeedParams(num_cands=jal.seed_params.num_cands),
        max_read_len=128, device="cpu")


@pytest.mark.parametrize("path", ["genes", "snps"])
def test_paired_update_batch_equal(jax_profilers, paired_files, path):
    """One paired batch (600 mates, the last 50 pairs as padding) through
    genes_update (LOCAL) or snps_update (GLOBAL): the state equals
    midas_tpu's, and differs from the unpaired step's."""
    jprof = jax_profilers[path]
    jal = jprof.aligner
    sc = tparams.LOCAL_SCORING if path == "genes" else tparams.GLOBAL_SCORING
    tal = _torch_aligner(jal, sc)
    fq1, fq2, _ = paired_files["natural"]
    b = next(iter(tbatch.load_paired_batches(fq1, fq2, batch_size=1024,
                                             max_len=128)))
    n_reads = b.n_reads - 100
    arrays = [b.codes, b.quals, b.lengths, b.mean_qual]
    jarr = [jnp.asarray(a) for a in arrays]
    tarr = [torch.from_numpy(a) for a in arrays]
    kw = dict(mapid=94.0, readq=20.0, aln_cov=0.75)
    table = torch.from_numpy(tds.score_min_table(sc, 128))
    if path == "genes":
        G = jprof.pack.num_seqs
        kw.update(min_mapq=0)
        want = jds.genes_state_host(jds.genes_update(
            jds.genes_init(G), jal.index_arrays, jal.pack_arrays, G, *jarr,
            jnp.int32(n_reads), scoring=jal.scoring,
            seed_params=jal.seed_params, max_len=128, paired=True, **kw))

        def port(paired):
            st = tds.genes_init(G, "cpu")
            tds.genes_update(st, tal.index_arrays, tal.pack_arrays, G,
                             *tarr, n_reads, scoring=sc,
                             seed_params=tal.seed_params, max_len=128,
                             smin_table=table, paired=paired, **kw)
            return tds.genes_state_host(st)
    else:
        G, S = jprof.pack.total_len, len(jprof.species_ids)
        kw.update(min_mapq=20, baseq=30)
        want = jds.snps_state_host(jds.snps_update(
            jds.snps_init(G, S, 2048, 128), jal.index_arrays,
            jal.pack_arrays, jnp.asarray(jprof.contig_species), *jarr,
            jnp.int32(n_reads), scoring=jal.scoring,
            seed_params=jal.seed_params, max_len=128, paired=True, **kw))
        want["counts"] = jds.resolve_counts(want["counts"])
        contig_species = torch.from_numpy(
            jprof.contig_species.astype(np.int64))

        def port(paired):
            st = tds.snps_init(G, S, 2048, 128, "cpu")
            tds.snps_update(st, tal.index_arrays, tal.pack_arrays,
                            contig_species, *tarr, n_reads, scoring=sc,
                            seed_params=tal.seed_params, max_len=128,
                            smin_table=table, paired=paired, **kw)
            return tds.snps_state_host(st)
    got = port(True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    assert got["mapped_reads"][:-1].sum() > 200
    assert got["aligned_reads"][-1] >= 100          # padding rows
    unpaired = port(False)
    assert not np.array_equal(unpaired["mapped_reads"], got["mapped_reads"])


# ---------------------------------------------------------------------------
# run_genes and run_snps over mate pairs
# ---------------------------------------------------------------------------

def _outputs(outdir, program, species_ids):
    """summary.txt and every decompressed per-species output (the gzip
    header holds a time stamp)."""
    files = {}
    with open(os.path.join(outdir, program, "summary.txt"), "rb") as f:
        files["summary.txt"] = f.read()
    for sid in species_ids:
        with gzip.open(os.path.join(outdir, program,
                                    f"output/{sid}.{program}.gz"), "rb") as f:
            files[sid] = f.read()
    return files


RUNS = {"genes": ("natural", "local", "cov", j_run_genes),
        "snps": ("q40", "global", "call", j_run_snps)}


@pytest.fixture(scope="module")
def paired_runs(sim_community, paired_files, tmp_path_factory):
    """Per program: midas_tpu's run over -1/-2, and the port's CLI on the
    CPU over -1/-2, over --interleaved and over -1 alone (unpaired),
    every species selected. Snps reads are at Q40, where the two
    packages' gapped-read oracles agree."""
    root = tmp_path_factory.mktemp("paired_runs")
    db = sim_community.db_dir
    ids = _species_ids(sim_community)
    runs = {}
    for program, (quality, mode, last, j_run) in RUNS.items():
        fq1, fq2, inter = paired_files[quality]
        jout = str(root / f"jax_{program}")
        j_run(dict(outdir=jout, db=db, m1=fq1, m2=fq2, build_db=True,
                   align=True, mode=mode, species_id=ids, **{last: True}))
        base = [program, None, "-d", db, "-m", mode, "--species_id",
                ",".join(ids), "--device", "cpu"]
        outs = {"jax": jout}
        for name, reads in (("mates", ["-1", fq1, "-2", fq2]),
                            ("interleaved", ["-1", inter, "--interleaved"]),
                            ("unpaired", ["-1", fq1])):
            base[1] = outs[name] = str(root / f"torch_{program}_{name}")
            t_run_midas(base + reads)
        runs[program] = outs
    return runs


@pytest.mark.parametrize("program", sorted(RUNS))
def test_run_paired_byte_identical(paired_runs, sim_community, program):
    """run_genes / run_snps over -1/-2: every output byte-identical to
    midas_tpu's and the saved state equal; --interleaved equal to
    -1/-2; the unpaired run of mate 1 alone differs."""
    outs = paired_runs[program]
    ids = _species_ids(sim_community)
    want = _outputs(outs["jax"], program, ids)
    for name in ("mates", "interleaved"):
        got = _outputs(outs[name], program, ids)
        assert set(got) == set(want)
        for f in want:
            assert got[f] == want[f], (name, f)
    zj = np.load(os.path.join(outs["jax"], program, "temp/state.npz"))
    zt = np.load(os.path.join(outs["mates"], program, "temp/state.npz"))
    keys = sorted(k for k in zj.files if k != "__meta__")
    assert keys == sorted(k for k in zt.files if k != "__meta__")
    for k in keys:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert zt["mapped_reads"][:-1].sum() > 300
    unpaired = _outputs(outs["unpaired"], program, ids)
    assert unpaired["summary.txt"] != want["summary.txt"]


def test_paired_checkpoint_fingerprint(paired_runs, sim_community,
                                       paired_files, tmp_path):
    """The saved genes state records the pairing: a run resumes only the
    state of the same pairing, and --call_genes alone consumes a paired
    state."""
    import shutil

    from midas_tpu_torch.profile import checkpoint as ckpt
    from midas_tpu_torch.profile.genes import GenesProfiler

    outs = paired_runs["genes"]
    ids = _species_ids(sim_community)
    fq1, fq2, inter = paired_files["natural"]
    # the CLI's filter values (--readq is an integer there)
    prof = GenesProfiler(TDatabase(sim_community.db_dir), ids, readq=20,
                         device="cpu")
    fps = dict(unpaired=prof._fingerprint([fq1], None, 0, 8192),
               mates=prof._fingerprint([fq1, fq2], None, 0, 8192,
                                       paired=True),
               interleaved=prof._fingerprint([inter], None, 0, 8192,
                                             paired=True, interleaved=True))
    for run in fps:
        state = os.path.join(outs[run], "genes/temp/state.npz")
        for fp_of, fp in fps.items():
            assert (ckpt.load(state, fp) is not None) == (fp_of == run)
    staged = str(tmp_path / "staged")
    for f in ("species.txt", "temp/state.npz"):
        os.makedirs(os.path.dirname(os.path.join(staged, "genes", f)),
                    exist_ok=True)
        shutil.copy(os.path.join(outs["mates"], "genes", f),
                    os.path.join(staged, "genes", f))
    t_run_midas(["genes", staged, "-1", fq1, "-2", fq2, "-d",
                 sim_community.db_dir, "--call_genes", "--device", "cpu"])
    assert _outputs(staged, "genes", ids) == _outputs(outs["mates"], "genes",
                                                      ids)


@pytest.mark.parametrize("program", sorted(RUNS))
def test_read_length_scans_both_mates(sim_community, tmp_path, program):
    """The padded read length covers the longer mate: run_genes /
    run_snps scan -1 and -2, as midas_tpu does (a 150 bp mate 2 beside
    a 100 bp mate 1 takes the 160 bucket, not 128)."""
    from midas_tpu_torch.profile.genes import run_genes as t_run_genes
    from midas_tpu_torch.profile.snps import run_snps as t_run_snps

    seq = sim_community.species[0].contigs[
        sorted(sim_community.species[0].contigs)[0]]
    paths = []
    for mate, n in ((1, 100), (2, 150)):
        paths.append(str(tmp_path / f"m{mate}.fq"))
        with open(paths[-1], "w") as f:
            for i in range(4):
                f.write(f"@p{i}/{mate}\n{seq[i * 200: i * 200 + n]}\n+\n"
                        f"{'I' * n}\n")
    assert jbatch.detect_max_read_len(paths) == 160
    run = t_run_genes if program == "genes" else t_run_snps
    last = "cov" if program == "genes" else "call"
    prof = run(dict(outdir=str(tmp_path / "out"), db=sim_community.db_dir,
                    m1=paths[0], m2=paths[1], build_db=True, align=True,
                    species_id=[sim_community.species[0].species_id],
                    device="cpu", **{last: True}))
    assert prof.aligner.max_read_len == 160


# ---------------------------------------------------------------------------
# the documented divergence from bowtie2's mixed-mode pairing
# ---------------------------------------------------------------------------

def test_discordant_pair_placements_equal(sim_community, tmp_path):
    """test_round5_fixes.py::test_discordant_pair_divergence_quantified's
    chimeric library (mate 2 of one pair in ten swapped to the
    homologous locus of a 3%-divergent related genome): paired and
    per-mate placements equal midas_tpu's, with the divergence that
    paired_best_hit_device documents — pairing puts none of the chimeric
    mates on the related genome, per-mate best hit puts some there."""
    comm = sim_community
    spA, spB = comm.species[0], comm.species[3]   # B = 3% mutant of A
    rng = np.random.default_rng(17)
    n_pairs, chimera_frac, rl = 300, 0.1, 100

    def revcomp(s):
        return s[::-1].translate(str.maketrans("ACGT", "TGCA"))

    seqA = spA.contigs[sorted(spA.contigs)[0]]
    seqB = spB.contigs[sorted(spB.contigs)[0]]
    path = str(tmp_path / "chimeric.fq.gz")
    n_chim = 0
    with gzip.open(path, "wt") as f:
        for i in range(n_pairs):
            flen = int(rng.integers(260, 380))
            pos = int(rng.integers(0, len(seqA) - flen))
            chim = rng.random() < chimera_frac
            n_chim += chim
            src = seqB if chim else seqA
            f.write(f"@p{i}/1\n{seqA[pos: pos + rl]}\n+\n{'I' * rl}\n")
            f.write(f"@p{i}/2\n{revcomp(src[pos + flen - rl: pos + flen])}"
                    f"\n+\n{'I' * rl}\n")
    sel = [spA.species_id, spB.species_id]
    jprof = JSnpsProfiler(JDatabase(comm.db_dir), sel)
    tprof = TSnpsProfiler(TDatabase(comm.db_dir), sel, device="cpu")
    mapped = {}
    for paired in (True, False):
        kw = dict(batch_size=256, paired=paired, interleaved=paired)
        want = jprof.run([path], **kw)
        got = tprof.run([path], **kw)
        for k in ("aligned_reads", "mapped_reads", "counts"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        mapped[paired] = int(got["mapped_reads"][1])
    assert mapped[True] == 0
    assert 0 < mapped[False] <= n_chim


# ---------------------------------------------------------------------------
# the concordant-share bound of chip_smoke.py's paired cells
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py, loaded by file path (it is no package module)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_concordant_share_bound(tmp_path):
    """The measurement behind chip_smoke.PAIRED_MIN_CONCORDANT: 1,024
    pairs of the paired cells' simulator settings from the genes cell's
    database with its genomes cut to 300 kb (gene length kept), through
    pass 1 and the mate-pair pick of both paths on the CPU. The share of
    concordant pairs must reach the bound the card run is held to, and
    on the genes path the pick must change some reads' MAPQ."""
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.testkit.simulate import (simulate_db,
                                                  simulate_paired_reads)

    cs = _chip_smoke()
    comm = simulate_db(str(tmp_path / "db"), **dict(
        cs.GENES_DB, genome_len=300_000, n_extra_genes=200))
    reads = (str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz"))
    simulate_paired_reads(comm, *reads, n_pairs=1024,
                          abundances=cs._first_n_abundances(
                              comm, cs.N_GENES_SPECIES), **cs.PAIRED_SIM)
    ids = [sp.species_id for sp in comm.species[:cs.N_GENES_SPECIES]]
    db = TDatabase(comm.db_dir)
    for path, cls in (("genes", GenesProfiler), ("snps", TSnpsProfiler)):
        dec = cs.pair_decisions(cls(db, ids, device="cpu"), reads,
                                batch_size=2048)
        assert dec["reads"] == 2048
        assert dec["concordant_share"] >= cs.PAIRED_MIN_CONCORDANT[path], \
            (path, dec)
        assert path == "snps" or dec["moved_mapq"] > 0, dec
