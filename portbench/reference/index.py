"""The reference's k-mer index: every k-mer of the packed reference with
its positions in ascending order, built with one sort on the device the
pack is put on, and looked up by binary search.

It answers what the port's bucketed hash table (midas_tpu_torch
db/index.py) answers, by another structure: for a query k-mer, where its
positions start in one flat array, and how many there are. The port
stores at most 256 positions a k-mer; seeding never reads more than
SeedParams.max_hits of them, so the cap is left out here (max_hits must
not pass it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

ROW = 8          # positions a row of the seeding's hit budget
MAX_OCC = 256    # positions the port keeps a k-mer; max_hits stays under it
_POS_BITS = 31


def build_index(codes: np.ndarray, offsets: np.ndarray, k: int,
                device) -> Dict[str, torch.Tensor]:
    """Index every k-mer that lies wholly inside one sequence and holds
    no sentinel base. codes: the pack's int8 codes (at least
    offsets[-1] of them); offsets [S+1]. Returns uniq (sorted k-mers),
    first (start of each k-mer's run in pos), count, pos (positions
    sorted by k-mer, then position), all int64 on `device`."""
    if not 4 <= k <= 15:
        raise ValueError("k must be in [4, 15]")
    total = int(offsets[-1])
    n = total - k + 1
    c = torch.from_numpy(np.ascontiguousarray(codes[:total])).to(device)
    km = torch.zeros(n, dtype=torch.int64, device=device)
    ok = torch.ones(n, dtype=torch.bool, device=device)
    for i in range(k):
        ci = c[i: i + n].to(torch.int64)
        km = (km << 2) | (ci & 3)
        ok &= ci < 4
    del c
    pos = torch.arange(n, dtype=torch.int64, device=device)
    off = torch.from_numpy(np.asarray(offsets, np.int64)).to(device)
    seq = torch.searchsorted(off, pos, right=True) - 1
    ok &= pos + k <= off[1:][seq.clamp(max=off.shape[0] - 2)]
    del seq
    key = torch.sort((km[ok] << _POS_BITS) | pos[ok]).values
    del km, pos, ok
    kmers = key >> _POS_BITS
    uniq, count = torch.unique_consecutive(kmers, return_counts=True)
    first = torch.cumsum(count, 0) - count
    return dict(uniq=uniq, first=first, count=count,
                pos=key & ((1 << _POS_BITS) - 1))


def lookup(index: Dict[str, torch.Tensor], kmers: torch.Tensor):
    """(start in index["pos"], count) of each query k-mer, int64, count 0
    where the k-mer is absent."""
    uniq = index["uniq"]
    i = torch.searchsorted(uniq, kmers.contiguous()).clamp(
        max=uniq.shape[0] - 1)
    hit = uniq[i] == kmers
    zero = torch.zeros((), dtype=torch.int64, device=kmers.device)
    return (torch.where(hit, index["first"][i], zero),
            torch.where(hit, index["count"][i], zero))
