"""The hand-written banded-DP kernels (csrc/banded_sw.cu) against their
plain PyTorch version on the card: every variant (full statistics or
score only, flat or quality-scaled mismatch) under all three scorings,
equal field by field, and the path variants K1, K2 and K3 with qpen on
repeat-rich windows full of ties, a ragged pair count, a 250 bp bucket,
rows that are not 4-byte aligned, a qpen view at a 1-byte offset and,
above the packed kernel's row limit, the template kernel (full
statistics) or still the packed kernel (score only). Needs an NVIDIA
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

from torch_cases import dp_case, long_bucket_case, qpen_case, tie_case

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


# the path variants, each under its paths' scorings
PATH_CASES = [("K1", "global"), ("K1", "marker"), ("K2", "global"),
              ("K2", "local"), ("K3_qpen", "global"), ("K3_qpen", "local")]


def _assert_equals_plain(card, key, scoring, q, qlens, ref, qpen=None):
    """One launch of variant `key` through the pipeline's dispatch, counted
    under its key, equal to the plain version field by field."""
    t = [torch.from_numpy(x).to(card) for x in (q, qlens, ref)]
    if qpen is not None and not isinstance(qpen, torch.Tensor):
        qpen = torch.from_numpy(qpen).to(card)
    score_only = key.startswith("K3")
    k0 = cuda_sw.LAUNCHES[key]
    got = dispatch_banded_align(*t, scoring, 16, score_only=score_only,
                                qpen_pair=qpen)
    assert cuda_sw.LAUNCHES[key] == k0 + 1
    want = banded_align_plain(*t, scoring, qpen=qpen, score_only=score_only)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", PATH_CASES + [("K1", "local")])
def test_path_ties_equal_plain(card, key, name):
    """Homopolymer and repeat windows: ties in the row argmax (within a
    lane and across lanes) and in the deletion scan's keys; with qpen,
    penalties and read Ns on top."""
    q, qlens, ref = tie_case(9, P=4096, L=128)
    qpen = None
    if key != "K1":   # quality penalties and read Ns on top
        qpen, q = qpen_case(10, q, SCORINGS[name])
    _assert_equals_plain(card, key, SCORINGS[name], q, qlens, ref, qpen)


def _case(key, seed, P, L, name):
    """(q, qlens, ref, qpen) of _inputs for variant `key`."""
    return _inputs(seed, P=P, L=L, scoring=SCORINGS[name],
                   with_qpen=key != "K1")


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", PATH_CASES)
def test_path_ragged_pair_count(card, key, name):
    """P = 4,099 is no multiple of the pairs a block or a warp holds."""
    _assert_equals_plain(card, key, SCORINGS[name],
                         *_case(key, 13, 4099, 128, name))


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", PATH_CASES)
def test_path_250bp_bucket(card, key, name):
    _assert_equals_plain(card, key, SCORINGS[name],
                         *_case(key, 17, 1024, 256, name))


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", PATH_CASES)
def test_path_unaligned_rows(card, key, name):
    """L = 150: query and qpen rows are not 4-byte aligned, so the packed
    kernel reads them a byte at a time."""
    _assert_equals_plain(card, key, SCORINGS[name],
                         *_case(key, 23, 1000, 150, name))


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", [c for c in PATH_CASES
                                      if c[0] != "K1"])
def test_path_qpen_unaligned_view(card, key, name):
    """qpen is a contiguous view at a 1-byte offset while the query rows
    are aligned: the qpen load takes its own alignment test."""
    q, qlens, ref, qpen = _case(key, 29, 1000, 128, name)
    buf = torch.empty(qpen.size + 1, dtype=torch.int8, device=card)
    view = buf[1:].view(qpen.shape)
    view.copy_(torch.from_numpy(qpen))
    assert view.is_contiguous() and view.data_ptr() % 4 == 1
    _assert_equals_plain(card, key, SCORINGS[name], q, qlens, ref, view)


@pytest.mark.cuda
@pytest.mark.parametrize("key,name", PATH_CASES)
def test_path_above_packing_limit(card, key, name):
    """Full-statistics rows longer than the packed kernel takes go to the
    template kernel, still counted as K1 / K2; score-only rows of any
    length stay on the packed kernel."""
    L = cuda_sw.packed_layout()["packed_max_l"] + 16
    q, qlens, ref, qpen = long_bucket_case(19, L, SCORINGS[name])
    _assert_equals_plain(card, key, SCORINGS[name], q, qlens, ref,
                         None if key == "K1" else qpen)


@pytest.mark.cuda
def test_packed_layout(card):
    """The build holds every packed instantiation the layout names, in
    both modes; each layout covers the band; the packing limit of
    csrc/banded_sw.cu keeps every 16-bit field below 2^16."""
    lay = cuda_sw.packed_layout()
    for key in ("K1", "K2", "K3", "K3_qpen"):
        v = lay[key]
        assert v["offsets_per_lane"] * v["lanes_per_pair"] == cuda_sw.BAND
    assert 2 * lay["packed_max_l"] + 31 < 2 ** 16
    with open(os.path.join(build_dir(), "banded_sw.ptxas.txt")) as f:
        names = {r["function"] for r in cuda_sw.ptxas_report(f.read())}
    def opl(ns, qp):
        return lay[cuda_sw.variant_key(ns, qp)]["offsets_per_lane"]

    packed = {f"packed_sw_kernel<{local},{ns},{int(qp)},{opl(ns, qp)}>"
              for ns in (6, 1) for qp in (False, True) for local in (1, 0)}
    assert len(packed) == 8
    assert packed <= names
    # the template kernel keeps no score-only instantiation
    assert {"banded_sw_kernel<1,1>", "banded_sw_kernel<0,1>",
            "banded_sw_kernel<1,0>", "banded_sw_kernel<0,0>"} == {
        n for n in names if n.startswith("banded_sw_kernel")}
