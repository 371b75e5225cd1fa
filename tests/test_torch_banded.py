"""The port's plain banded DP (midas_tpu_torch/align/banded.py) against
the JAX package's: the jnp banded_align and the Pallas kernel in
interpret mode, on the cases of tests/test_pallas_sw.py. Tolerance:
exact equality (scores are integer-valued float32, statistics ints).
Also: the port's wrapper never falls back from the card to the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midas_tpu.align import params as jparams
from midas_tpu.align.banded import banded_align
from midas_tpu.align.pallas_sw import pallas_banded_align
from midas_tpu_torch.align import cuda_sw
from midas_tpu_torch.align import params as tparams
from midas_tpu_torch.align.banded import banded_align_plain
from midas_tpu_torch.align.pipeline import dispatch_banded_align

from torch_cases import dp_case, qpen_case, tie_case

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SCORINGS = ["GLOBAL_SCORING", "MARKER_SCORING", "LOCAL_SCORING"]
# the cases of test_pallas_sw.py, and "<scoring>-ties": tie_case's
# homopolymer and repeat windows, where many band offsets score alike
CASES = SCORINGS + [f"{n}-ties" for n in SCORINGS]


def _inputs(name, with_qpen):
    name, _, kind = name.partition("-")
    if kind == "ties":
        q, qlens, ref = tie_case(4, P=128, L=64)
    else:
        q, qlens, ref = dp_case(0, indel=True)
    qlens[[5, 77]] = 0                     # pairs without a read (padding)
    qpen = None
    if with_qpen:
        qpen, q = qpen_case(1, q, getattr(jparams, name))
    return q, qlens, ref, qpen


@pytest.mark.parametrize("name", SCORINGS)
def test_scoring_params_copied(name):
    assert (dataclasses.asdict(getattr(tparams, name))
            == dataclasses.asdict(getattr(jparams, name)))


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("with_qpen", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_plain_equals_jax(name, with_qpen, score_only):
    q, qlens, ref, qpen = _inputs(name, with_qpen)
    name = name.partition("-")[0]
    jp, tp = getattr(jparams, name), getattr(tparams, name)
    jq = None if qpen is None else jnp.asarray(qpen)
    jnp_out = banded_align(jnp.asarray(q), jnp.asarray(qlens),
                           jnp.asarray(ref), jp, band_width=16, qpen=jq)
    pallas_out = pallas_banded_align(
        jnp.asarray(q), jnp.asarray(qlens), jnp.asarray(ref), jp,
        band_width=16, interpret=True, score_only=score_only, qpen=jq)
    got = banded_align_plain(
        torch.from_numpy(q), torch.from_numpy(qlens), torch.from_numpy(ref),
        tp, band_width=16,
        qpen=None if qpen is None else torch.from_numpy(qpen),
        score_only=score_only)
    assert set(got) == set(pallas_out)
    assert got["score"].dtype == torch.float32
    for k in got:
        g = got[k].numpy()
        np.testing.assert_array_equal(g, np.asarray(pallas_out[k]), err_msg=k)
        np.testing.assert_array_equal(g, np.asarray(jnp_out[k]), err_msg=k)


def test_dispatch_uses_plain_on_cpu_only():
    q, qlens, ref, _ = _inputs("MARKER_SCORING", False)
    t = [torch.from_numpy(x) for x in (q, qlens, ref)]
    n0 = dict(cuda_sw.LAUNCHES)
    out = dispatch_banded_align(*t, tparams.MARKER_SCORING, 16)
    want = banded_align_plain(*t, tparams.MARKER_SCORING)
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert dict(cuda_sw.LAUNCHES) == n0


def test_no_fallback_from_the_card():
    """The kernel wrapper refuses non-CUDA tensors, the dispatch refuses
    devices it has no DP for, and a CUDA device without a card is an
    error — never a silent run of the plain version."""
    from midas_tpu_torch.align.pipeline import resolve_device

    q, qlens, ref, _ = _inputs("MARKER_SCORING", False)
    t = [torch.from_numpy(x) for x in (q, qlens, ref)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_sw.banded_align_cuda(*t, tparams.MARKER_SCORING)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="no implementation"):
        dispatch_banded_align(*meta, tparams.MARKER_SCORING, 16)
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve_device("cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            # a CUDA tensor cannot even be made without a card
            torch.from_numpy(q).to("cuda")


PTXAS_CASES = [
    ("_ZN12_GLOBAL__N_116k1_packed_kernelILb1ELi2EEEvPKaPKiS3_PfS5_iiffff",
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
     56, dict(function="k1_packed_kernel<1,2>", registers=56, stack_frame=0,
              spill_stores=0, spill_loads=0)),
    ("_ZN12_GLOBAL__N_116banded_sw_kernelILb0ELi6ELb1EEEvPKaPKiS3_S3_PfS5_"
     "iifffff",
     "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
     63, dict(function="banded_sw_kernel<0,6,1>", registers=63,
              stack_frame=8, spill_stores=4, spill_loads=8)),
    ("_ZN45_GLOBAL__N__1d25c07f_12_banded_sw_cu_4a233c2d16packed_sw_kernel"
     "ILb1ELi1ELb1ELi8EEEvPKaPKiS2_S2_PfPiiifffff",
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
     72, dict(function="packed_sw_kernel<1,1,1,8>", registers=72,
              stack_frame=0, spill_stores=0, spill_loads=0)),
]


@pytest.mark.parametrize("mangled,frame,regs,want", PTXAS_CASES,
                         ids=["k1_packed", "template", "packed_sw"])
def test_ptxas_report(mangled, frame, regs, want):
    """Registers and spills per kernel function, from nvcc -Xptxas -v,
    for each kernel name the source has carried; a block before it must
    not leak into its record."""
    text = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112other_"
        "kernelILb0EEEvPKa' for 'sm_90a'\n"
        "ptxas info    : Used 9 registers, used 0 barriers\n"
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
        f"{frame}\n"
        f"ptxas info    : Used {regs} registers, used 0 barriers\n")
    first, got = cuda_sw.ptxas_report(text)
    assert first["function"] == "other_kernel<0>"
    assert first["registers"] == 9 and first["spill_stores"] is None
    assert got == want
