"""The port's aligner pipeline (midas_tpu_torch/align/pipeline.py) against
midas_tpu.align.pipeline on the sim_community packs and sim_reads:
quality penalties; one whole seed -> gather -> DP -> postprocess batch
on the marker pack, under the marker scoring and under the
quality-scaled local scoring (the DP's qpen path); and the genes path's
two-pass alignment on the pangenome pack — pass 1
(align_candidates_score, score-only DP over every candidate) and pass 2
(align_chosen_full, full statistics for one chosen candidate per read)
— under the local and the end-to-end scoring. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import params as jparams
from midas_tpu.align import pipeline as jpipe
from midas_tpu.align.seed import SeedParams as JSeedParams
from midas_tpu.db import Database
from midas_tpu.db.index import build_seed_index
from midas_tpu.db.refpack import pack_from_fasta
from midas_tpu.io.batch import load_read_batches
from midas_tpu_torch.align import params as tparams
from midas_tpu_torch.align import pipeline as tpipe
from midas_tpu_torch.align.seed import SeedParams as TSeedParams

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SP = dict(num_cands=8, max_hits=32)


@pytest.fixture(scope="module")
def marker_index(sim_community):
    pack = pack_from_fasta(Database(sim_community.db_dir).marker_fasta())
    return pack, build_seed_index(pack, k=14)


def test_quality_penalties_equal():
    quals = np.arange(0, 64, dtype=np.int8).reshape(4, 16)
    for name in ("GLOBAL_SCORING", "LOCAL_SCORING"):
        want = jpipe.quality_penalties(jnp.asarray(quals),
                                       getattr(jparams, name))
        got = tpipe.quality_penalties(torch.from_numpy(quals),
                                      getattr(tparams, name))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["MARKER_SCORING", "LOCAL_SCORING"])
def test_align_batch_stages_equal(marker_index, sim_reads, name):
    pack, index = marker_index
    jsc, tsc = getattr(jparams, name), getattr(tparams, name)
    jal = jpipe.Aligner(pack, index, jsc, JSeedParams(**SP), max_read_len=128)
    tal = tpipe.Aligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        tsc, TSeedParams(**SP), max_read_len=128, device="cpu")
    b = next(iter(load_read_batches(sim_reads[0], batch_size=256,
                                    max_len=128)))
    quals = b.quals if jsc.qual_scaled else None
    want = jpipe._align_batch_stages(
        jal.index_arrays, jal.pack_arrays, jnp.asarray(b.codes),
        jnp.asarray(b.lengths), jsc, jal.seed_params, 128,
        quals=None if quals is None else jnp.asarray(quals))
    got = tal.align_batch_device(
        torch.from_numpy(b.codes), torch.from_numpy(b.lengths),
        quals=None if quals is None else torch.from_numpy(quals))
    assert set(got) == set(want)
    assert np.asarray(want["valid"]).sum() > 0
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def pangenome_aligners(sim_community):
    """JAX and port aligners over the pangenome pack of every species,
    with the genes path's seed parameters, per scoring."""
    db = Database(sim_community.db_dir)
    pack = pack_from_fasta([db.pangenome_fasta(s.species_id)
                            for s in sim_community.species])
    index = build_seed_index(pack, k=14)
    out = {}
    for name in ("LOCAL_SCORING", "GLOBAL_SCORING"):
        jal = jpipe.Aligner(pack, index, getattr(jparams, name),
                            JSeedParams(num_cands=4), max_read_len=128)
        tal = tpipe.Aligner.from_numpy(
            {k: np.asarray(v) for k, v in jal.index_arrays.items()},
            {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
            getattr(tparams, name), TSeedParams(num_cands=4),
            max_read_len=128, device="cpu")
        out[name] = (jal, tal)
    return out


@pytest.mark.parametrize("name", ["LOCAL_SCORING", "GLOBAL_SCORING"])
def test_two_pass_alignment_equal(pangenome_aligners, sim_reads, name):
    jal, tal = pangenome_aligners[name]
    b = next(iter(load_read_batches(sim_reads[0], batch_size=256,
                                    max_len=128)))
    jargs = (jal.index_arrays, jal.pack_arrays, jnp.asarray(b.codes),
             jnp.asarray(b.lengths), jal.scoring, jal.seed_params, 128)
    targs = (tal.index_arrays, tal.pack_arrays, torch.from_numpy(b.codes),
             torch.from_numpy(b.lengths), tal.scoring, tal.seed_params, 128)
    jout1, jaux = jpipe.align_candidates_score(*jargs,
                                               quals=jnp.asarray(b.quals))
    tout1, taux = tpipe.align_candidates_score(*targs,
                                               quals=torch.from_numpy(b.quals))
    assert set(tout1) == set(jout1) and set(taux) == set(jaux)
    assert np.asarray(jout1["valid"]).sum() > 0
    for k in jout1:
        np.testing.assert_array_equal(tout1[k].numpy(), np.asarray(jout1[k]),
                                      err_msg=k)
    for k in jaux:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)

    # pass 2 over an arbitrary chosen column per read (valid or not)
    col = np.random.default_rng(3).integers(0, 4, size=256)
    jfull = jpipe.align_chosen_full(
        jal.pack_arrays, jaux, jargs[2], jargs[3],
        jnp.asarray(col.astype(np.int32)), jal.scoring, jal.seed_params)
    tfull = tpipe.align_chosen_full(
        tal.pack_arrays, taux, targs[2], targs[3], torch.from_numpy(col),
        tal.scoring, tal.seed_params)
    assert set(tfull) == set(jfull)
    for k in jfull:
        np.testing.assert_array_equal(tfull[k].numpy(), np.asarray(jfull[k]),
                                      err_msg=k)
    # pass 2 of the candidate pass 1 scored agrees with it
    rows = np.arange(256)
    for k in ("score", "qend", "tstart", "tend"):
        np.testing.assert_array_equal(
            tfull[k].numpy()[rows], tout1[k].numpy()[rows, col], err_msg=k)
