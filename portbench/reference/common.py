"""Pieces the reference's three paths share: the device-side pack and
index of a set of sequences, and the walk over a sample in large
chunks."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from portbench.reference.index import MAX_OCC, build_index
from portbench.reference.refpack import ReferencePack
from portbench.reference.seed import SeedParams, pack_words_host


def device_arrays(pack: ReferencePack, sp: SeedParams, device
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(index arrays, pack arrays) of a pack on `device`: the
    reference's sorted k-mer index, and the 2-bit words, sentinel masks
    and offsets the window gather reads."""
    if sp.max_hits > MAX_OCC:
        raise ValueError(f"max_hits {sp.max_hits} passes {MAX_OCC}")
    index = build_index(pack.codes, pack.offsets, sp.k, device)
    words, nmask = pack_words_host(pack.codes)

    def put(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    return index, dict(words=put(words), nmask=put(nmask),
                       offsets=put(pack.offsets))


def chunks(reads: Dict[str, np.ndarray], size: int, device,
           fields=("codes", "quals", "lengths", "mean_qual")
           ) -> Iterator[Tuple[int, int, Tuple[torch.Tensor, ...]]]:
    """(first read, real reads, tensors on device) of each chunk of
    `size` rows, the last one padded as the port pads its last batch
    (codes 4, quals 0, length 0, mean 0)."""
    n = reads["n_reads"]
    pad = {"codes": 4, "quals": 0, "lengths": 0, "mean_qual": 0}
    for lo in range(0, n, size):
        hi = min(lo + size, n)
        out = []
        for f in fields:
            a = reads[f][lo:hi]
            if hi - lo < size:
                full = np.full((size,) + a.shape[1:], pad[f], dtype=a.dtype)
                full[: hi - lo] = a
                a = full
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
        yield lo, hi - lo, tuple(out)


def drop_tail(reads: Dict[str, np.ndarray], n_drop: int
              ) -> Dict[str, np.ndarray]:
    """The sample without its last n_drop reads: the control's broken
    guarantee (every read of the sample is counted)."""
    if n_drop <= 0:
        return reads
    n = max(reads["n_reads"] - n_drop, 0)
    out = {k: (v[:n] if isinstance(v, np.ndarray) else v)
           for k, v in reads.items()}
    out["n_reads"] = n
    return out
