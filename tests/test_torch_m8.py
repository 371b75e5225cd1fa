"""The port's species --m8 path against midas_tpu, on the CPU: the full
readback (Aligner.align_batch), the host twins of the best hit and the
read filters (pick_best_hits, keep_read_mask) against midas_tpu's and
against the port's device versions, the host classifier against the
port's device path, and `run_midas species --m8` over -1 and -1/-2 byte
for byte. Exact equality throughout."""

import os

import numpy as np
import pytest
import torch

from midas_tpu.cli.run_midas import main as j_run_midas
from midas_tpu.db import Database as JDatabase
from midas_tpu.io.batch import load_read_batches
from midas_tpu.profile import common as jcommon
from midas_tpu.profile.species import SpeciesProfiler as JProfiler
from midas_tpu.testkit import simulate_paired_reads, simulate_reads
from midas_tpu_torch.align.params import GLOBAL_SCORING, LOCAL_SCORING
from midas_tpu_torch.cli.run_midas import main as t_run_midas
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.profile import common as tcommon
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile.genes import GenesProfiler as TGenesProfiler
from midas_tpu_torch.profile.species import SpeciesProfiler as TProfiler

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

PLANES = ("valid", "score", "seq_idx", "strand", "tstart", "tend", "qstart",
          "qend", "matches", "mismatches", "gap_cols", "gap_opens")
M8_OUTPUTS = ("species/species_profile.txt", "species/temp/read_count.txt",
              "species/temp/alignments.m8")


@pytest.fixture(scope="module")
def noisy_reads(sim_community, tmp_path_factory):
    """tests/test_device_steps.py's noisy reads: 600 reads at a 2% error
    rate, so that many reads tie between related markers."""
    fq = tmp_path_factory.mktemp("m8reads") / "r.fq.gz"
    simulate_reads(sim_community, str(fq), n_reads=600,
                   abundances=[0.4, 0.3, 0.2, 0.1], error_rate=0.02, seed=3)
    return str(fq)


@pytest.fixture(scope="module")
def t_species(sim_community):
    return TProfiler(TDatabase(sim_community.db_dir), device="cpu")


def test_align_batch_equal(sim_community, sim_reads, t_species):
    """align_batch's 12 planes equal midas_tpu's, dtypes included, on the
    marker pack: a batch of 800 reads and 7,392 padding rows, whose
    candidates are all masked."""
    jal = JProfiler(JDatabase(sim_community.db_dir)).aligner
    tal = t_species.aligner
    n = 0
    for b in load_read_batches([sim_reads[0]], batch_size=8192,
                               max_len=128):
        want, got = jal.align_batch(b), tal.align_batch(b)
        assert got.names == want.names and got.n_reads == want.n_reads
        for k in PLANES:
            w, g = getattr(want, k), getattr(got, k)
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        for k in ("aln_cols", "nm", "blast_pid", "aligned_qlen",
                  "bowtie_pid"):
            w, g = getattr(want, k), getattr(got, k)
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        assert not got.valid[b.n_reads:].any()
        assert got.valid[: b.n_reads].any()
        n += 1
    assert n == 1


@pytest.mark.parametrize("mode", ["local", "global"])
def test_best_hit_host_twins(sim_community, noisy_reads, mode):
    """pick_best_hits and keep_read_mask equal midas_tpu's on the same
    AlignmentResult, and the port's best_hit_device and keep_mask_chosen
    equal them on the same alignments (the genes pack, quality-scaled
    scoring), as tests/test_device_steps.py holds midas_tpu's."""
    scoring = LOCAL_SCORING if mode == "local" else GLOBAL_SCORING
    prof = TGenesProfiler(TDatabase(sim_community.db_dir),
                          sim_community.species_ids(), mode=mode,
                          device="cpu")
    al = prof.aligner
    assert al.scoring == scoring and scoring.qual_scaled
    table = torch.from_numpy(tds.score_min_table(scoring, al.max_read_len))
    filters = (prof.mapid, prof.readq, prof.mapq, prof.aln_cov)
    n_aligned = n_kept = 0
    for b in load_read_batches([noisy_reads], batch_size=256,
                               max_len=al.max_read_len):
        res = al.align_batch(b)
        aligned, col, mapq = tcommon.pick_best_hits(res, scoring, b.lengths)
        j_aligned, j_col, j_mapq = jcommon.pick_best_hits(res, scoring,
                                                          b.lengths)
        for g, w in ((aligned, j_aligned), (col, j_col), (mapq, j_mapq)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        keep = tcommon.keep_read_mask(res, col, b, mapq, *filters)
        np.testing.assert_array_equal(
            keep, jcommon.keep_read_mask(res, col, b, mapq, *filters))

        # the device versions on the same batch's [B, C] tensors
        out = al.align_batch_device(
            torch.from_numpy(b.codes), torch.from_numpy(b.lengths),
            quals=torch.from_numpy(b.quals))
        qlens = torch.from_numpy(b.lengths)
        d_aligned, d_col, d_mapq = tds.best_hit_device(out, qlens, scoring,
                                                       table)
        n = b.n_reads
        np.testing.assert_array_equal(d_aligned[:n].numpy(), aligned[:n])
        np.testing.assert_array_equal(d_col[:n].numpy(), col[:n])
        np.testing.assert_array_equal(d_mapq[:n].numpy(), mapq[:n])
        rows = np.arange(len(col))
        full = {k: torch.from_numpy(getattr(res, k)[rows, col])
                for k in ("qstart", "qend", "mismatches", "gap_cols")}
        d_keep = tds.keep_mask_chosen(full, qlens,
                                      torch.from_numpy(b.mean_qual),
                                      torch.from_numpy(mapq), *filters)
        np.testing.assert_array_equal(d_keep[:n].numpy(), keep[:n])
        n_aligned += int(aligned[:n].sum())
        n_kept += int((aligned & keep)[:n].sum())
    assert 0 < n_kept < n_aligned


def test_m8_path_equals_device_path(noisy_reads, t_species, tmp_path):
    """SpeciesProfiler.run with an m8 path (the host classifier over the
    read-back alignments) gives the device path's abundance and stats,
    at a batch size that spreads the ambiguous reads over several
    batches."""
    prof = t_species
    m8 = str(tmp_path / "alignments.m8")
    host = prof.run([noisy_reads], batch_size=128, m8_path=m8)
    host_stats = dict(prof.stats)
    dev = prof.run([noisy_reads], batch_size=128)
    assert prof.stats == host_stats
    assert dev == host
    assert host_stats["total_reads"] == 600
    with open(m8) as f:
        assert len(f.readlines()) > 600
    _, _, amb = prof._run_host([noisy_reads], None, None, 128,
                               str(tmp_path / "again.m8"))
    assert len({o // 128 for *_, o in amb}) >= 3


@pytest.fixture(scope="module")
def mate_files(sim_community, tmp_path_factory):
    root = tmp_path_factory.mktemp("m8pairs")
    fq1, fq2 = str(root / "r1.fq.gz"), str(root / "r2.fq.gz")
    simulate_paired_reads(sim_community, fq1, fq2, n_pairs=300,
                          error_rate=0.01, indel_rate=0.1, seed=12)
    return fq1, fq2


@pytest.mark.parametrize("reads", ["single", "mates"])
def test_run_species_m8_byte_identical(sim_community, sim_reads, mate_files,
                                       tmp_path, reads):
    """run_midas species --m8 over -1 alone and over -1/-2 writes
    midas_tpu's species_profile.txt, read_count.txt and alignments.m8
    byte for byte; neither package writes temp/state.npz."""
    args = (["-1", sim_reads[0]] if reads == "single" else
            ["-1", mate_files[0], "-2", mate_files[1]])
    db = sim_community.db_dir
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_run_midas(["species", jout, *args, "-d", db, "--m8"])
    t_run_midas(["species", tout, *args, "-d", db, "--m8", "--device",
                 "cpu"])
    for f in M8_OUTPUTS:
        with open(os.path.join(jout, f), "rb") as a, \
                open(os.path.join(tout, f), "rb") as b:
            want = a.read()
            assert b.read() == want, f
        assert len(want.splitlines()) > (0 if "read_count" in f else 2), f
    for out in (jout, tout):
        assert not os.path.exists(os.path.join(out, "species/temp/state.npz"))
