"""The port's seeding and window gather (midas_tpu_torch/align/seed.py)
against midas_tpu.align.seed on the sim_community marker pack, fed the
same index through Aligner.from_numpy; and the port's copied index and
word-packing builders against the JAX package's. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import seed as jseed
from midas_tpu.align.params import MARKER_SCORING as J_MARKER
from midas_tpu.align.pipeline import Aligner as JAligner
from midas_tpu.db import Database as JDatabase
from midas_tpu.db.index import build_seed_index as j_build_index
from midas_tpu.db.index import fmix32 as np_fmix32
from midas_tpu.db.refpack import pack_from_fasta as j_pack_from_fasta
from midas_tpu.io.batch import load_read_batches
from midas_tpu_torch.align import seed as tseed
from midas_tpu_torch.align.params import MARKER_SCORING as T_MARKER
from midas_tpu_torch.align.pipeline import Aligner as TAligner
from midas_tpu_torch.db.index import build_seed_index as t_build_index
from midas_tpu_torch.db.layout import Database as TDatabase
from midas_tpu_torch.db.refpack import pack_from_fasta as t_pack_from_fasta

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SP = dict(num_cands=8, max_hits=32)


@pytest.fixture(scope="module")
def aligners(sim_community):
    pack = j_pack_from_fasta(JDatabase(sim_community.db_dir).marker_fasta())
    index = j_build_index(pack, k=14)
    jal = JAligner(pack, index, J_MARKER, jseed.SeedParams(**SP),
                   max_read_len=128)
    tal = TAligner.from_numpy(
        {k: np.asarray(v) for k, v in jal.index_arrays.items()},
        {k: np.asarray(v) for k, v in jal.pack_arrays.items()},
        T_MARKER, tseed.SeedParams(**SP), max_read_len=128, device="cpu")
    return pack, jal, tal


@pytest.fixture(scope="module")
def batch(sim_reads):
    return next(iter(load_read_batches(sim_reads[0], batch_size=1024,
                                       max_len=128)))


def test_copied_builders_equal(sim_community, aligners):
    pack, jal, _ = aligners
    tpack = t_pack_from_fasta(
        TDatabase(sim_community.db_dir).marker_fasta())
    np.testing.assert_array_equal(tpack.codes, pack.codes)
    np.testing.assert_array_equal(tpack.offsets, pack.offsets)
    assert tpack.names == pack.names
    tindex = t_build_index(tpack, k=14)
    for k in ("bucket1", "bucket2", "positions2d"):
        np.testing.assert_array_equal(getattr(tindex, k),
                                      np.asarray(jal.index_arrays[k]), k)
    for a, b in zip(tseed.pack_words_host(tpack.codes),
                    jseed.pack_words_host(pack.codes)):
        np.testing.assert_array_equal(a, b)


def test_fmix32_and_reversals_equal(batch):
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        [0, 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    np.testing.assert_array_equal(
        tseed.fmix32(torch.from_numpy(h.astype(np.int64))).numpy(),
        np_fmix32(h).astype(np.int64))
    codes, qlens = batch.codes, batch.lengths
    jc, jl = jnp.asarray(codes), jnp.asarray(qlens)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(qlens)
    np.testing.assert_array_equal(tseed.revcomp_batch(tc, tl).numpy(),
                                  np.asarray(jseed.revcomp_batch(jc, jl)))
    np.testing.assert_array_equal(tseed.reverse_batch(tc, tl, 7).numpy(),
                                  np.asarray(jseed.reverse_batch(jc, jl, 7)))


def test_find_candidates_and_windows_equal(aligners, batch):
    pack, jal, tal = aligners
    codes, qlens = batch.codes, batch.lengths
    jc, jl = jnp.asarray(codes), jnp.asarray(qlens)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(qlens)
    want = jseed.find_candidates(jal.index_arrays, jc, jl,
                                 jseed.SeedParams(**SP), 128)
    got = tseed.find_candidates(tal.index_arrays, tc, tl,
                                tseed.SeedParams(**SP), 128)
    for k in ("diag", "strand", "votes", "valid", "rc"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert np.asarray(want["valid"]).any()

    D, W = 16, 128 + 16 - 1
    jw, js = jseed.gather_windows_packed(
        jal.pack_arrays["words"], jal.pack_arrays["nmask"],
        jal.pack_arrays["offsets"], want["diag"] - D // 2, W,
        center=want["diag"] + jl[:, None] // 2)
    tw, ts = tseed.gather_windows_packed(
        tal.pack_arrays["words"], tal.pack_arrays["nmask"],
        tal.pack_arrays["offsets"], got["diag"] - D // 2, W,
        center=got["diag"] + tl[:, None].long() // 2)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    # windows hanging over both ends of the pack and across sequences
    G = pack.total_len
    starts = np.array([[-40, -1, 0, 7], [G - 20, G + 5, 600, 1190]])
    jw, js = jseed.gather_windows_packed(
        jal.pack_arrays["words"], jal.pack_arrays["nmask"],
        jal.pack_arrays["offsets"], jnp.asarray(starts.astype(np.int32)), W)
    tw, ts = tseed.gather_windows_packed(
        tal.pack_arrays["words"], tal.pack_arrays["nmask"],
        tal.pack_arrays["offsets"], torch.from_numpy(starts), W)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
