"""The comparison that decides `correct`: every output file of every
sample of the window against the plain reference's bytes, line by line,
and (snps) the end-of-stream checkpoint's state against the reference's
state, entry by entry. Both comparisons are exact, so each limit is 0.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional

import numpy as np

# number compared -> its limit
LIMITS = {"lines_differing": 0, "state_entries_differing": 0}


def _read(path: str) -> Optional[bytes]:
    if not os.path.isfile(path):
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def lines_differing(got: Optional[bytes], want: bytes) -> int:
    """Lines of want that got does not hold at the same place, plus the
    lines got has beyond want's; every line of want if got is absent."""
    w = want.split(b"\n")
    if got is None:
        return len(w)
    if got == want:
        return 0
    g = got.split(b"\n")
    n = min(len(g), len(w))
    return sum(1 for i in range(n) if g[i] != w[i]) + abs(len(g) - len(w))


def state_entries_differing(path: str, want: Dict[str, np.ndarray]) -> int:
    """Entries of the checkpoint's arrays that differ from want's (every
    entry of an array that is missing or has another shape). A 1-D
    array one entry longer than want's ends in the program's dump slot
    (the reads of padding rows and reads not counted, which depend on
    the batch size), which is left out."""
    if not os.path.isfile(path):
        return sum(int(np.asarray(v).size) for v in want.values())
    n = 0
    with np.load(path, allow_pickle=False) as z:
        for k, v in want.items():
            v = np.asarray(v)
            if k not in z.files:
                n += v.size
                continue
            g = z[k]
            if g.ndim == 1 and v.ndim == 1 and g.size == v.size + 1:
                g = g[:-1]   # the program's dump slot, which counts padding
            if g.shape != v.shape:
                n += max(g.size, v.size)
            else:
                n += int(np.count_nonzero(g != v))
    return n


def judge(out: str, files: Dict[str, bytes],
          state: Optional[Dict[str, np.ndarray]] = None,
          state_path: str = "") -> Dict[str, int]:
    """The numbers compared for one sample's output directory."""
    got = {"lines_differing": sum(
        lines_differing(_read(os.path.join(out, rel)), want)
        for rel, want in files.items())}
    if state is not None:
        got["state_entries_differing"] = state_entries_differing(
            os.path.join(out, state_path), state)
    return got
