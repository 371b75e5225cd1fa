"""Fixed-shape read batches for device upload.

The reference streams reads through unix pipes into aligner processes
(species.py:29-49, genes.py:116-145). On TPU everything under jit is
compiled for static shapes, so reads are packed into rectangular
batches: codes [B, L] int8 padded with the sentinel code 4, plus
per-read lengths, per-base phred qualities, and per-read mean quality
(used by the reference's `readq` filter, midas/run/genes.py:160).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from midas_tpu_torch.io.seqio import PAD_CODE, encode_seq, qual_to_phred, stream_reads


@dataclasses.dataclass
class ReadBatch:
    """One rectangular batch of reads (host numpy; upload via io.prefetch)."""

    names: List[str]          # len B' (actual reads, B' <= B)
    codes: np.ndarray         # [B, L] int8, pad rows/tails = 4
    lengths: np.ndarray       # [B] int32, 0 for pad rows
    quals: np.ndarray         # [B, L] int8 phred, 0 on padding
    mean_qual: np.ndarray     # [B] float32, mean phred over the read
    n_reads: int              # B' = number of real reads in this batch

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def read_len(self) -> int:
        return self.codes.shape[1]


def batch_reads(
    reads: Sequence[Tuple[str, str, Optional[str]]],
    batch_size: int,
    max_len: int = 128,
) -> ReadBatch:
    """Pack (name, seq, qual) tuples into one fixed-shape ReadBatch.

    Reads longer than max_len are truncated (callers pick max_len as the
    padded read length for the run); shorter reads are sentinel-padded.
    """
    B, L = batch_size, max_len
    codes = np.full((B, L), PAD_CODE, dtype=np.int8)
    quals = np.zeros((B, L), dtype=np.int8)
    lengths = np.zeros(B, dtype=np.int32)
    mean_qual = np.zeros(B, dtype=np.float32)
    names: List[str] = []
    for i, (name, seq, qual) in enumerate(reads):
        n = min(len(seq), L)
        codes[i, :n] = encode_seq(seq[:n])
        q = qual_to_phred(qual[:n] if qual is not None else None, n)
        quals[i, :n] = q
        lengths[i] = n
        # Reference readq filter uses np.mean over the *aligned read's*
        # qualities (genes.py:160); we use the full-read mean, identical
        # for untrimmed alignments of these end-to-end batches.
        mean_qual[i] = float(q.astype(np.float64).mean()) if n else 0.0
        names.append(name)
    return ReadBatch(names, codes, lengths, quals, mean_qual, len(names))


# padded kernel read lengths: the banded-DP kernel compiles per static
# L, so runs pick the smallest bucket covering their reads (plus slack
# between buckets for mixed-length libraries)
READ_LEN_BUCKETS = (128, 160, 256, 384, 512)


def detect_max_read_len(paths, read_length: Optional[int] = None,
                        sample_n: int = 4096, default: int = 128) -> int:
    """Pick the padded read length for a run: the smallest bucket
    covering the longest read. The reference aligns FULL-length reads
    (midas/run/stream_seqs.py:43-65 trims only on --read_length); a
    fixed 128 here silently truncated 150/250 bp Illumina data. With an
    explicit read_length the bucket covers exactly that (the stream
    trims to it anyway).

    Detection scans the ENTIRE file through the native reader
    (mio_max_read_len, millions of reads/s) so length-sorted or
    mixed-length libraries whose long reads appear late cannot pick a
    too-small bucket; without the native reader it falls back to the
    first sample_n reads (later longer reads are then counted and
    warned about — load_read_batches truncation warning)."""
    if read_length:
        longest = int(read_length)
    else:
        path_list = ([str(paths)] if isinstance(paths, (str, os.PathLike))
                     else [str(p) for p in paths])
        longest = 0
        scannable = [p for p in path_list if not p.endswith(".bz2")]
        if scannable == path_list:
            from midas_tpu_torch.io.native import native_max_read_len

            got = native_max_read_len(path_list)
            if got is not None:
                longest = got
        if longest == 0:
            from midas_tpu_torch.io.seqio import stream_reads

            for i, (_name, seq, _q) in enumerate(stream_reads(path_list)):
                longest = max(longest, len(seq))
                if i + 1 >= sample_n:
                    break
        if longest == 0:
            longest = default
    for b in READ_LEN_BUCKETS:
        if longest <= b:
            return b
    return -(-longest // 64) * 64   # beyond the last bucket: ceil to 64


def _warn_truncated(n: int, max_len: int) -> None:
    import sys

    print(f"Warning: {n} reads longer than the padded read length "
          f"{max_len} were truncated; pass a longer --read_length or "
          "report this if lengths were auto-detected", file=sys.stderr)


def load_read_batches(
    paths,
    batch_size: int = 1024,
    max_len: int = 128,
    read_length: Optional[int] = None,
    max_reads: Optional[int] = None,
) -> Iterator[ReadBatch]:
    """Stream FASTA/FASTQ file(s) into fixed-shape batches.

    Applies the reference trim/cap semantics (stream_seqs.py:43-65),
    then rectangularizes. The final batch is zero-padded to the same
    static shape so jit traces once.

    Parsing runs through the native C++ reader (io/native.py) when it
    is available — the pure-Python readfq path below tops out around
    50k reads/s, an order of magnitude under the device's consumption
    rate — with identical record semantics (tested against each other).
    """
    import os as _os

    path_list = ([str(paths)] if isinstance(paths, (str, _os.PathLike))
                 else [str(p) for p in paths])
    if not any(p.endswith(".bz2") for p in path_list):
        from midas_tpu_torch.io.native import NativeBatcher, load_native

        lib = load_native()
        if lib is not None:
            nb = NativeBatcher(
                lib, path_list, batch_size, max_len, read_length, max_reads)
            for names, codes, lengths, quals, mean_qual, n in nb:
                yield ReadBatch(names, codes, lengths, quals, mean_qual, n)
            if nb.truncated:
                _warn_truncated(nb.truncated, max_len)
            return
    buf: List[Tuple[str, str, Optional[str]]] = []
    truncated = 0
    for rec in stream_reads(path_list, read_length=read_length,
                            max_reads=max_reads):
        if len(rec[1]) > max_len:
            truncated += 1
        buf.append(rec)
        if len(buf) == batch_size:
            yield batch_reads(buf, batch_size, max_len)
            buf = []
    if buf:
        yield batch_reads(buf, batch_size, max_len)
    if truncated:
        _warn_truncated(truncated, max_len)
