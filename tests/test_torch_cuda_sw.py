"""The hand-written banded-DP kernel (csrc/banded_sw.cu) against its plain
PyTorch version on the card: every variant (full statistics or score
only, flat or quality-scaled mismatch) under all three scorings, equal
field by field. Needs an NVIDIA card; skips without one. Run on the card
with: python -m pytest --noconftest tests/test_torch_cuda_sw.py -q
(the repo's conftest imports JAX, which the card's machine lacks)."""

import numpy as np
import pytest
import torch

from midas_tpu_torch.align import cuda_sw
from midas_tpu_torch.align.banded import banded_align_plain
from midas_tpu_torch.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                          MARKER_SCORING)
from midas_tpu_torch.align.pipeline import dispatch_banded_align

from torch_cases import dp_case, qpen_case

SCORINGS = {"global": GLOBAL_SCORING, "marker": MARKER_SCORING,
            "local": LOCAL_SCORING}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(seed, P, L, scoring, with_qpen):
    q, qlens, ref = dp_case(seed, P=P, L=L, indel=True)
    rng = np.random.default_rng(seed + 1)
    ref[rng.random(ref.shape) < 0.01] = 4          # reference Ns
    qlens[:3] = (0, 1, L)                          # empty, 1 bp, full
    qpen = None
    if with_qpen:
        qpen, q = qpen_case(seed + 2, q, scoring)
    return q, qlens, ref, qpen


@pytest.mark.cuda
@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("with_qpen", [False, True])
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_kernel_equals_plain(card, name, with_qpen, score_only):
    scoring = SCORINGS[name]
    q, qlens, ref, qpen = _inputs(3, P=1001, L=128, scoring=scoring,
                                  with_qpen=with_qpen)
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref)]
    tq = None if qpen is None else torch.from_numpy(qpen).to(card)
    key = cuda_sw.variant_key(1 if score_only else 6, with_qpen)
    n0 = sum(cuda_sw.LAUNCHES.values())
    k0 = cuda_sw.LAUNCHES[key]
    got = dispatch_banded_align(*t, scoring, 16, score_only=score_only,
                                qpen_pair=tq)
    assert sum(cuda_sw.LAUNCHES.values()) == n0 + 1
    assert cuda_sw.LAUNCHES[key] == k0 + 1
    want = banded_align_plain(*t, scoring, qpen=tq, score_only=score_only)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(), err_msg=k)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    q, qlens, ref, _ = _inputs(0, P=32, L=64, scoring=MARKER_SCORING,
                               with_qpen=False)
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref)]
    with pytest.raises(ValueError):
        cuda_sw.banded_align_cuda(t[0], t[1].long(), t[2], MARKER_SCORING)
    with pytest.raises(ValueError):
        cuda_sw.banded_align_cuda(t[0], t[1], t[2][:, :-1], MARKER_SCORING)
    with pytest.raises(ValueError):
        cuda_sw.banded_align_cuda(t[0], t[1], t[2], MARKER_SCORING,
                                  band_width=8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["global", "local"])
def test_k3_qpen_equals_k2_on_shared_fields(card, name):
    """Pass 1 (K3 with qpen, score only) and pass 2 (K2) of the two-pass
    alignment agree on the fields both compute."""
    scoring = SCORINGS[name]
    q, qlens, ref, qpen = _inputs(5, P=2048, L=128, scoring=scoring,
                                  with_qpen=True)
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref, qpen)]
    k3 = cuda_sw.banded_align_cuda(*t[:3], scoring, qpen=t[3],
                                   score_only=True)
    k2 = cuda_sw.banded_align_cuda(*t[:3], scoring, qpen=t[3])
    torch.cuda.synchronize()
    assert set(k3) == {"score", "qend", "wstart", "wend"}
    for k in k3:
        np.testing.assert_array_equal(k3[k].cpu().numpy(),
                                      k2[k].cpu().numpy(), err_msg=k)


@pytest.mark.cuda
def test_launches_counted_per_variant(card):
    q, qlens, ref, qpen = _inputs(7, P=64, L=64, scoring=LOCAL_SCORING,
                                  with_qpen=True)
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref, qpen)]
    launches = cuda_sw.LAUNCHES
    launches.clear()
    cuda_sw.banded_align_cuda(*t[:3], MARKER_SCORING)
    for _ in range(2):
        cuda_sw.banded_align_cuda(*t[:3], LOCAL_SCORING, qpen=t[3])
    for _ in range(3):
        cuda_sw.banded_align_cuda(*t[:3], LOCAL_SCORING, qpen=t[3],
                                  score_only=True)
    cuda_sw.banded_align_cuda(*t[:3], LOCAL_SCORING, score_only=True)
    # an empty batch launches nothing and counts nothing
    cuda_sw.banded_align_cuda(t[0][:0], t[1][:0], t[2][:0], LOCAL_SCORING)
    torch.cuda.synchronize()
    assert dict(launches) == {"K1": 1, "K2": 2, "K3_qpen": 3, "K3": 1}
