"""The port's end-of-stream pileup readback (profile/sparse_counts.py and
the snapshots that read through it) against midas_tpu's, on the CPU: on
the same seeded count tensors, with junk at the dump slot (flat index
G), both routes give midas_tpu's counts and the dense counts with flat
G zeroed, exactly."""

from collections import Counter
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.profile import device_steps as jds
from midas_tpu.profile.sparse_counts import \
    counts_host_sparse as j_counts_host_sparse
from midas_tpu_torch.dist.profilers import (DistributedSnpsProfiler,
                                            StripedSnpsState)
from midas_tpu_torch.profile import device_steps as tds
from midas_tpu_torch.profile import sparse_counts as tsc
from tests.test_sparse_counts import _random_counts

torch.set_num_threads(1)


def _dense(flat: np.ndarray, G: int) -> np.ndarray:
    out = flat.copy()
    out[G] = 0
    return out


def _deeper_than_int16():
    """Sparse coverage with one stretch deeper than 2^15 (int32 depths)."""
    G = 3_000
    c = _random_counts(G, 20, 100, 0.01, seed=5).reshape(4, G + 1)
    c[2, 1000:1100] += 40_000
    return c.reshape(-1), G


def _edges():
    """Runs touching position 0 and G-1, and one impure site."""
    G = 1000
    c = np.zeros((4, G + 1), np.int32)
    c[2, 0] = 7
    c[1, G - 1] = 3
    c[0, 500] = 1
    c[3, 500] = 2
    c[0, G] = 99
    return c.reshape(-1), G


def _single_impure():
    G = 1000
    c = np.zeros((4, G + 1), np.int32)
    c[0, 321] = 4
    c[2, 321] = 1
    c[0, G] = 7
    return c.reshape(-1), G


def _impure_heavy():
    """Every site of a small genome impure and covered."""
    G = 1000
    c = np.zeros((4, G + 1), np.int32)
    c[0, :G] = 2
    c[1, :G] = 1
    c[0, G] = 500
    return c.reshape(-1), G


def _random(G, n_reads, err, boost=1):
    return lambda: (_random_counts(G, n_reads, 100, err, seed=G,
                                   depth_boost=boost), G)


# few distinct G: each is one compile of midas_tpu's phase A
CASES = {
    # name: (() -> (flat counts, G), the route counts_host_sparse takes)
    "sparse": (_random(50_000, 40, 0.01), "sparse"),       # ~8% covered
    "mixed_3x": (_random(20_000, 600, 0.05), "whole"),     # mixed purity
    "deep_int16": (_random(3_000, 1200, 0.02, boost=8), "whole"),  # > 255
    "deeper_int32": (_deeper_than_int16, "whole"),
    "empty": (_random(3_000, 0, 0.0), "empty"),
    "g0": (lambda: (np.array([12345, 0, 0, 0], np.int32), 0), "empty"),
    "edges": (_edges, "sparse"),
    "single_impure": (_single_impure, "sparse"),
    "impure_heavy": (_impure_heavy, "whole"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_counts_host_sparse_equals_midas_tpu_and_dense(name):
    make, route = CASES[name]
    flat, G = make()
    want = _dense(flat, G)
    np.testing.assert_array_equal(
        j_counts_host_sparse(jnp.asarray(flat), G), want)
    counts = torch.from_numpy(flat.copy())
    tsc.ROUTES.clear()
    got = tsc.counts_host_sparse(counts, G)
    assert tsc.ROUTES == Counter({route: 1})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if G:
        # both routes directly, whichever the statistics pick
        pa, stats = tsc._phase_a(counts, G)
        np.testing.assert_array_equal(tsc._whole_host(counts, G), want)
        np.testing.assert_array_equal(tsc._sparse_host(pa, stats, G), want)
        if route != "empty":
            sparse_s, whole_s = tsc.route_seconds(G, stats)
            assert (route == "whole") == (sparse_s >= whole_s)
    # the device tensor is not written
    np.testing.assert_array_equal(counts.numpy(), flat)


@pytest.mark.parametrize("name", ["sparse", "deep_int16", "empty"])
def test_snps_state_host_equals_midas_tpu(name):
    """The snapshot, counts on each route, equals midas_tpu's field by
    field and reads the counts once."""
    flat, G = CASES[name][0]()
    S, cap, L = 2, 64, 128
    st = tds.snps_init(G, S, cap, L, "cpu")
    st.counts.copy_(torch.from_numpy(flat))
    tsc.ROUTES.clear()
    got = tds.snps_state_host(st)
    assert tsc.ROUTES == Counter({CASES[name][1]: 1})
    jst = jds.snps_init(G, S, cap, L)
    jst = jds.SnpsState(**dict(vars(jst), counts=jnp.asarray(flat)))
    want = jds.snps_state_host(jst)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    assert got["counts"].dtype == np.int32


@pytest.mark.parametrize("second", ["sparse", "empty"])
def test_striped_state_host_reads_each_stripe_once(second):
    """A tp snapshot reads back each stripe, and nothing else, through
    counts_host_sparse, and reassembles the genome's counts."""
    first, SL = CASES["sparse"][0]()
    other = (_random_counts(SL, 40, 100, 0.01, seed=7) if second == "sparse"
             else np.zeros_like(first))
    other[SL] = 777   # each stripe's dump slot holds junk
    stripes = [first, other]
    prof = object.__new__(DistributedSnpsProfiler)
    prof.tp, prof.stripe_len = 2, SL
    prof.pack = SimpleNamespace(total_len=2 * SL)
    prof.stripe_real, prof.shard_base = [SL, SL], [0, SL]
    base = tds.snps_init(0, 2, 64, 128, "cpu")
    st = StripedSnpsState(**vars(base),
                          stripes=[torch.from_numpy(s) for s in stripes])
    tsc.ROUTES.clear()
    got = prof._state_host(st)
    assert tsc.ROUTES == Counter(["sparse", second])
    want = np.zeros((4, 2 * SL + 1), np.int32)
    for j, s in enumerate(stripes):
        want[:, j * SL:(j + 1) * SL] = s.reshape(4, SL + 1)[:, :SL]
    np.testing.assert_array_equal(got["counts"], want.reshape(-1))
    for k in ("aligned_reads", "mapped_reads", "gap_n") + tds.GAP_FIELDS:
        assert k in got, k
