"""The end-of-stream counts readback (profile/sparse_counts.py) on the
card: both routes give the CPU readback's counts, counts_host_sparse
takes the CPU's route, and the device tensor is not written. Needs an
NVIDIA card; skips without one. Run on the card with:
python -m pytest --noconftest tests/test_torch_cuda_readback.py -q
(the repo's conftest imports JAX, which the card's machine lacks)."""

from collections import Counter

import numpy as np
import pytest
import torch

from midas_tpu_torch.profile import sparse_counts as sc

G = 200_003


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _counts(n_reads, depth_boost=1, err=0.01, seed=0):
    """Flat [4 x (G+1)] int32 pileup of n_reads x 100 bp error-prone
    reads (depth_boost times over), junk at flat G."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G)
    c = np.zeros((4, G + 1), np.int64)
    starts = rng.integers(0, G - 100, n_reads * depth_boost)
    pos = (starts[:, None] + np.arange(100)).reshape(-1)
    base = genome[pos]
    flip = rng.random(pos.shape[0]) < err
    base[flip] = rng.integers(0, 4, int(flip.sum()))
    np.add.at(c, (base, pos), 1)
    c[0, G] = 1 << 20
    return c.astype(np.int32).reshape(-1)


CASES = {"sparse": (lambda: _counts(200), "sparse"),           # ~10%
         "whole": (lambda: _counts(2000, depth_boost=8, err=0.1), "whole"),
         "empty": (lambda: _counts(0), "empty")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_card_readback_equals_cpu(card, name):
    make, route = CASES[name]
    flat = make()
    want = flat.copy()
    want[G] = 0
    sc.ROUTES.clear()
    np.testing.assert_array_equal(
        sc.counts_host_sparse(torch.from_numpy(flat), G), want)
    assert sc.ROUTES == Counter({route: 1})
    counts = torch.from_numpy(flat).to(card)
    got = sc.counts_host_sparse(counts, G)
    assert sc.ROUTES == Counter({route: 2})
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    pa, stats = sc._phase_a(counts, G)
    np.testing.assert_array_equal(sc._sparse_host(pa, stats, G), want)
    np.testing.assert_array_equal(sc._whole_host(counts, G), want)
    np.testing.assert_array_equal(counts.cpu().numpy(), flat)
