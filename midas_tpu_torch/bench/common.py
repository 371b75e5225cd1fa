"""Helpers shared by the benches: CUDA-event and wall-clock timing, the
card's identity, and the bytes a set of tensors holds."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def cuda_ms(fn, reps):
    """(mean milliseconds of fn() on the card by CUDA events, after one
    warm-up call; fn's last result)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def synchronize(device) -> None:
    """Wait for the work queued on device (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same(a, b) -> bool:
    """Whether two results (dicts, lists, tuples, arrays, tensors and
    scalars, nested) are equal: same keys, dtypes, shapes and values."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))


def best_of(fn, device, reps=3):
    """(the least wall seconds of `reps` calls of fn, each ending on a
    synchronize of device; the first call's result). Raises unless every
    call's result equals the first's, so a bench is also a determinism
    check."""
    best, first = float("inf"), None
    for rep in range(reps):
        t0 = time.perf_counter()
        got = fn()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
        if rep == 0:
            first = got
        elif not same(got, first):
            raise RuntimeError(f"rep {rep} gave another result than rep 0")
    return best, first


def smi_line(index: int = 0) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[index]


def platform(device) -> str:
    """The device a result was measured on: the card's name from torch,
    then nvidia-smi's name and power limit; "cpu" on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return f"{torch.cuda.get_device_name(index)} ({smi_line(index)})"


def tensor_bytes(tree) -> int:
    """Bytes held by the tensors (or arrays) of a dict, list or tuple,
    nested."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)
