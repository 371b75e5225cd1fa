"""The reference's FASTQ reader: whole 4-line FASTQ files (plain or
gzipped) into padded read arrays in one pass of numpy, independent of
the port's native and Python readers.

Rows hold codes (A0 C1 G2 T3, anything else 4, padding 4), phred
qualities (byte - 33, padding 0), lengths and the mean phred of each
read (float64 mean, stored as float32), read up to the padded length
the port picks: the smallest of 128, 160, 256, 384, 512 that covers the
longest read.
"""

from __future__ import annotations

import gzip
from typing import Dict, List

import numpy as np

BUCKETS = (128, 160, 256, 384, 512)
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i   # lower case


def _records(path: str) -> List[bytes]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise ValueError(f"{path}: not a 4-line FASTQ ({len(lines)} lines)")
    heads, plus = lines[0::4], lines[2::4]
    if not all(h[:1] == b"@" for h in heads) or \
            not all(p[:1] == b"+" for p in plus):
        raise ValueError(f"{path}: a record is not @name / seq / + / qual")
    return lines


def _padded(rows: List[bytes], L: int, fill: int) -> np.ndarray:
    """[N, L] uint8 of the rows, cut at L, padded with fill."""
    n = len(rows)
    lens = np.fromiter(map(len, rows), dtype=np.int64, count=n)
    flat = np.frombuffer(b"".join(rows), dtype=np.uint8)
    if n and (lens == lens[0]).all() and lens[0] <= L:
        out = np.full((n, L), fill, dtype=np.uint8)
        out[:, : lens[0]] = flat.reshape(n, int(lens[0]))
        return out
    out = np.full((n, L), fill, dtype=np.uint8)
    starts = np.cumsum(lens) - lens
    for i in range(n):   # mixed lengths: the general, slower path
        m = min(int(lens[i]), L)
        out[i, :m] = flat[starts[i]: starts[i] + m]
    return out


def read_fastq(paths, paired: bool = False) -> Dict[str, np.ndarray]:
    """Reads of one file, of files one after another, or (paired) of
    two mate files with mate 1 of pair i at row 2i and mate 2 at 2i+1.
    Returns codes [N, L] int8, quals [N, L] int8, lengths [N] int32,
    mean_qual [N] float32, n_reads and L."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    per_file = [_records(p) for p in paths]
    if paired:
        if len(per_file) != 2 or len(per_file[0]) != len(per_file[1]):
            raise ValueError("paired reads need two files of equal counts")
        lines = [None] * (len(per_file[0]) * 2)
        a, b = per_file
        for j in range(4):
            # records alternate: mate 1 of pair i, then its mate 2
            lines[j::8] = a[j::4]
            lines[4 + j::8] = b[j::4]
    else:
        lines = [x for f in per_file for x in f]
    seqs, quals = lines[1::4], lines[3::4]
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    longest = int(lens.max()) if len(lens) else 0
    L = next((b for b in BUCKETS if longest <= b), -(-longest // 64) * 64)
    raw = _padded(seqs, L, ord("N"))
    codes = _CODE[raw]
    q = _padded(quals, L, 33).astype(np.int16) - 33
    n_eff = np.minimum(lens, L)
    inside = np.arange(L)[None, :] < n_eff[:, None]
    q = np.where(inside, q, 0).astype(np.int8)
    mean = (q.astype(np.float64).sum(axis=1)
            / np.maximum(n_eff, 1)).astype(np.float32)
    mean[n_eff == 0] = 0.0
    return dict(codes=codes, quals=q, lengths=n_eff.astype(np.int32),
                mean_qual=mean, n_reads=len(seqs), L=L)
