"""The hand-written banded-DP kernels (csrc/banded_sw.cu) against their
plain PyTorch version on the card: every variant (full statistics or
score only, flat or quality-scaled mismatch) under all three scorings,
equal field by field, and K1's packed kernel on repeat-rich windows full
of ties, a ragged pair count, a 250 bp bucket, rows that are not 4-byte
aligned and, above its row limit, the template kernel. Needs an NVIDIA
card; skips without one. Run on the card with:
python -m pytest --noconftest tests/test_torch_cuda_sw.py -q
(the repo's conftest imports JAX, which the card's machine lacks)."""

import os

import numpy as np
import pytest
import torch

from midas_tpu_torch._build import build_dir
from midas_tpu_torch.align import cuda_sw
from midas_tpu_torch.align.banded import banded_align_plain
from midas_tpu_torch.align.params import (GLOBAL_SCORING, LOCAL_SCORING,
                                          MARKER_SCORING)
from midas_tpu_torch.align.pipeline import dispatch_banded_align

from torch_cases import dp_case, qpen_case, tie_case

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


def _assert_k1_equals_plain(card, scoring, q, qlens, ref):
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref)]
    k0 = cuda_sw.LAUNCHES["K1"]
    got = dispatch_banded_align(*t, scoring, 16)
    assert cuda_sw.LAUNCHES["K1"] == k0 + 1
    want = banded_align_plain(*t, scoring)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_k1_ties_equal_plain(card, name):
    """Homopolymer and repeat windows: ties in the row argmax (within a
    lane and across lanes) and in the deletion scan's keys."""
    _assert_k1_equals_plain(card, SCORINGS[name],
                            *tie_case(9, P=4096, L=128))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["global", "marker"])
def test_k1_ragged_pair_count(card, name):
    """P = 4,099 is no multiple of the pairs a block or a warp holds."""
    q, qlens, ref, _ = _inputs(13, P=4099, L=128, scoring=SCORINGS[name],
                               with_qpen=False)
    _assert_k1_equals_plain(card, SCORINGS[name], q, qlens, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["global", "marker"])
def test_k1_250bp_bucket(card, name):
    q, qlens, ref, _ = _inputs(17, P=1024, L=256, scoring=SCORINGS[name],
                               with_qpen=False)
    _assert_k1_equals_plain(card, SCORINGS[name], q, qlens, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["global", "marker"])
def test_k1_unaligned_rows(card, name):
    """L = 150: query rows are not 4-byte aligned, so the packed kernel
    reads them a byte at a time."""
    q, qlens, ref, _ = _inputs(23, P=1000, L=150, scoring=SCORINGS[name],
                               with_qpen=False)
    _assert_k1_equals_plain(card, SCORINGS[name], q, qlens, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["global", "marker"])
def test_k1_above_packing_limit(card, name):
    """Rows longer than the packed kernel takes go to the template
    kernel, still counted as K1. Reads stay short so the plain version's
    row loop is short; the bucket L is what routes the launch."""
    L = cuda_sw.k1_layout()["packed_max_l"] + 16
    q0, qlens, ref0, _ = _inputs(19, P=48, L=256, scoring=SCORINGS[name],
                                 with_qpen=False)
    rng = np.random.default_rng(20)
    q = np.full((48, L), 4, dtype=np.int8)
    q[:, :256] = q0
    ref = rng.integers(0, 4, size=(48, L + 15)).astype(np.int8)
    ref[:, :256 + 15] = ref0
    _assert_k1_equals_plain(card, SCORINGS[name], q, qlens, ref)


@pytest.mark.cuda
def test_k1_layout(card):
    """The build holds the packed kernel in both modes at the layout the
    wrapper reports, which covers the band; the packing limit of
    csrc/banded_sw.cu keeps every field below 2^16."""
    lay = cuda_sw.k1_layout()
    assert lay["offsets_per_lane"] * lay["lanes_per_pair"] == cuda_sw.BAND
    assert 2 * lay["packed_max_l"] + 31 < 2 ** 16
    with open(os.path.join(build_dir(), "banded_sw.ptxas.txt")) as f:
        names = {r["function"] for r in cuda_sw.ptxas_report(f.read())}
    opl = lay["offsets_per_lane"]
    assert {f"k1_packed_kernel<1,{opl}>", f"k1_packed_kernel<0,{opl}>"} <= names
