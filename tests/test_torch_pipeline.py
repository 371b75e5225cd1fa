"""The port's aligner pipeline (midas_tpu_torch/align/pipeline.py) against
midas_tpu.align.pipeline on the sim_community marker pack and sim_reads:
quality penalties, and one whole seed -> gather -> DP -> postprocess
batch, under the marker scoring and under the quality-scaled local
scoring (the DP's qpen path). Exact equality."""

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
