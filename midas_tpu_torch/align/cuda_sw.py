"""Wrapper of the hand-written banded-DP kernel (csrc/banded_sw.cu).

`banded_align_cuda` launches the kernel on CUDA tensors and raises on
anything else; the pipeline's dispatch_banded_align sends CPU tensors to
the plain version (align/banded.py) instead — there is no fallback from
the card to the plain version.

The kernel is compiled on first use with nvcc for sm_90a into the
checkout's build/ directory and loaded with ctypes (plain C interface,
no PyTorch headers, so the build takes seconds). Nothing is built or
imported from CUDA when this module is imported.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import threading
from typing import Dict, List, Optional

import torch

from midas_tpu_torch import tracing
from midas_tpu_torch._build import PACKAGE_DIR, build_dir
from midas_tpu_torch.align.banded import FULL_FIELDS, SCORE_ONLY_FIELDS
from midas_tpu_torch.align.params import ScoringParams

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "banded_sw.cu")
BAND = 16   # the kernel's compiled band width
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# launches of the kernel per variant (variant_key), reported by every
# tracing recording as rec.kept["launches"]
LAUNCHES: collections.Counter = collections.Counter()
tracing.keep("launches", LAUNCHES)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("banded_sw: no CUDA toolkit found (nvcc); the "
                           "kernel cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> str:
    """Compile csrc/banded_sw.cu into build/libbanded_sw.so unless an
    up-to-date build is there. nvcc's register / spill report goes to
    build/banded_sw.ptxas.txt. Raises if the build fails."""
    so = os.path.join(build_dir(), "libbanded_sw.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(SOURCE):
        return so
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"banded_sw: nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    # ranks that start together on a fresh checkout each build to files
    # of their own pid and rename them into place: whole files only
    report = os.path.join(build_dir(), "banded_sw.ptxas.txt")
    with open(f"{report}.tmp.{os.getpid()}", "w") as f:
        f.write(proc.stderr)
    os.replace(f"{report}.tmp.{os.getpid()}", report)
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """Build (once) and dlopen the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            lib.banded_sw_launch.restype = ctypes.c_int
            lib.banded_sw_launch.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 5 + [ctypes.c_void_p])
            lib.banded_sw_offsets_per_lane.restype = ctypes.c_int
            lib.banded_sw_offsets_per_lane.argtypes = [ctypes.c_int] * 2
            lib.banded_sw_packed_max_l.restype = ctypes.c_int
            lib.banded_sw_packed_max_l.argtypes = []
            _LIB = lib
        return _LIB


def packed_layout() -> Dict:
    """The layout of the packed kernel, constants of csrc/banded_sw.cu:
    per variant key (variant_key), band offsets a lane and lanes a pair;
    and packed_max_l, the longest row the full-statistics variants take
    on it (longer K1 / K2 rows run the template kernel, still counted as
    K1 / K2; score-only rows of any length run packed)."""
    lib = load_library()
    out: Dict = {}
    for n_stats in (6, 1):
        for qual_pen in (False, True):
            opl = lib.banded_sw_offsets_per_lane(n_stats, int(qual_pen))
            out[variant_key(n_stats, qual_pen)] = dict(
                offsets_per_lane=opl, lanes_per_pair=BAND // opl)
    out["packed_max_l"] = lib.banded_sw_packed_max_l()
    return out


def ptxas_report(text: str) -> List[Dict]:
    """Registers and spills per kernel function from nvcc's -Xptxas -v
    output (build/banded_sw.ptxas.txt): name with its template arguments
    (packed_sw_kernel<LOCAL,NS,QP,OPL>, banded_sw_kernel<LOCAL,QP>),
    registers a thread, spill store and load bytes, stack frame bytes."""
    out = []
    for block in text.split("Compiling entry function ")[1:]:
        mangled = block.split("'", 2)[1]
        # the kernel's source name is the length-prefixed identifier
        # ending in _kernel before its template arguments (I...E)
        m = next((m for m in re.finditer(
            r"(?=(\d+)(\w+?_kernel)I(\w*?)EEv)", mangled)
            if int(m.group(1)) == len(m.group(2))), None)
        args = re.findall(r"L[bi](\d+)", m.group(3)) if m else []
        name = f"{m.group(2)}<{','.join(args)}>" if m else mangled
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        out.append(dict(
            function=name, registers=int(regs.group(1)) if regs else None,
            stack_frame=int(frame.group(1)) if frame else None,
            spill_stores=int(frame.group(2)) if frame else None,
            spill_loads=int(frame.group(3)) if frame else None))
    return out


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"banded_sw: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise ValueError(f"banded_sw: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"banded_sw: {name} has shape {tuple(t.shape)}, "
                         f"not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"banded_sw: {name} is not contiguous")


def banded_align_cuda(
    query: torch.Tensor,    # [P, L] int8, CUDA
    qlens: torch.Tensor,    # [P] int32
    ref_win: torch.Tensor,  # [P, L + 15] int8
    params: ScoringParams,
    band_width: int = BAND,
    qpen: Optional[torch.Tensor] = None,   # [P, L] int8
    score_only: bool = False,
) -> Dict[str, torch.Tensor]:
    """Launch the kernel on the current stream of the inputs' card.
    Same contract and same results, bit for bit, as banded_align_plain.
    Counts its launches per variant in LAUNCHES, keyed by
    variant_key(n_stats, qual_pen)."""
    device = query.device
    if device.type != "cuda":
        raise ValueError(f"banded_sw: kernel inputs must be CUDA tensors, "
                         f"got {device}")
    if band_width != BAND:
        raise ValueError(f"banded_sw: the kernel is built for band width "
                         f"{BAND}, got {band_width}")
    if query.dim() != 2 or query.shape[1] == 0:
        raise ValueError("banded_sw: query must be [P, L] with L > 0")
    P, L = query.shape
    _check(query, "query", torch.int8, (P, L), device)
    _check(qlens, "qlens", torch.int32, (P,), device)
    _check(ref_win, "ref_win", torch.int8, (P, L + BAND - 1), device)
    if qpen is not None:
        _check(qpen, "qpen", torch.int8, (P, L), device)
    fields = SCORE_ONLY_FIELDS if score_only else FULL_FIELDS
    score = torch.empty(P, dtype=torch.float32, device=device)
    stats = torch.empty((len(fields) - 1, P), dtype=torch.int32,
                        device=device)
    if P:
        lib = load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.banded_sw_launch(
                query.data_ptr(), qlens.data_ptr(), ref_win.data_ptr(),
                None if qpen is None else qpen.data_ptr(),
                score.data_ptr(), stats.data_ptr(), P, L,
                int(params.mode == "local"), 1 if score_only else 6,
                float(params.match), float(params.mismatch),
                float(params.gap_open), float(params.gap_extend),
                float(params.n_pen), stream)
        if rc != 0:
            raise RuntimeError(f"banded_sw: launch failed with CUDA error "
                               f"{rc}")
        LAUNCHES[variant_key(1 if score_only else 6, qpen is not None)] += 1
    out = {"score": score}
    out.update(zip(fields[1:], stats.unbind(0)))
    return out


def variant_key(n_stats: int, qual_pen: bool) -> str:
    """The name a launch is counted under: the Pallas kernel's variants
    (midas_tpu/align/pallas_sw.py) K1 (full statistics, flat mismatch),
    K2 (full statistics, quality-scaled mismatch) and K3 (score only),
    with K3's quality-scaled form told apart as K3_qpen."""
    if n_stats == 1:
        return "K3_qpen" if qual_pen else "K3"
    return "K2" if qual_pen else "K1"


