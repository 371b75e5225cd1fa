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
from itertools import zip_longest
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


def _check_interleaved_pairs(b: ReadBatch) -> None:
    """When interleaved read names carry bowtie2-style /1 and /2 mate
    suffixes, verify rows 2i/2i+1 really are mates of the same fragment
    (batch sizes are even, so pairs never straddle batches).

    Sampled — first, last, and every 16th pair per batch — so the check
    stays off the hot parsing path (a full per-pair Python loop runs at
    a rate comparable to the native parser itself). A frame shift from
    a truncated record mispairs EVERY subsequent pair, so sampling
    still catches it within one batch; the odd-total check in
    load_paired_batches covers the terminal case."""
    n_pairs = b.n_reads // 2
    if n_pairs == 0:
        return
    probe = set(range(0, n_pairs, 16))
    probe.add(n_pairs - 1)
    for p in probe:
        a, c = b.names[2 * p], b.names[2 * p + 1]
        a_sfx = a[-2:] in ("/1", "/2")
        c_sfx = c[-2:] in ("/1", "/2")
        if not (a_sfx or c_sfx):
            continue
        if not (a.endswith("/1") and c.endswith("/2") and a[:-2] == c[:-2]):
            raise ValueError(
                f"--interleaved mate pairing broken at reads {a!r} / {c!r}:"
                " expected name/1 followed by name/2")


def load_paired_batches(
    m1: str,
    m2: Optional[str] = None,
    batch_size: int = 1024,
    max_len: int = 128,
    read_length: Optional[int] = None,
    max_reads: Optional[int] = None,
    interleaved: bool = False,
) -> Iterator[ReadBatch]:
    """Mate-paired batches: mate 1 of pair i at row 2i, mate 2 at row
    2i+1 (the layout device_steps.paired_best_hit_device expects).

    Two input shapes, mirroring bowtie2's (reference call sites
    midas/run/genes.py:127-132, snps.py:109-114):
    - `-1 f1 -2 f2`: two lock-step files; implemented by interleaving
      rows of two half-size single-file batch streams, so the native
      C++ reader keeps doing the parsing.
    - `--interleaved f`: one file with mates already alternating; an
      even batch_size keeps pairs intact, so this IS plain batching.

    max_reads counts PAIRS here (bowtie2 -u semantics for paired input).
    Raises on mate-count mismatch between -1 and -2."""
    if batch_size % 2:
        batch_size += 1
    if interleaved or m2 is None:
        total = 0
        for b in load_read_batches(
                [m1], batch_size=batch_size, max_len=max_len,
                read_length=read_length,
                max_reads=2 * max_reads if max_reads else None):
            if interleaved:
                _check_interleaved_pairs(b)
            total += b.n_reads
            yield b
        if interleaved and total % 2:
            raise ValueError(
                f"--interleaved input has an odd read count ({total}): "
                "a truncated file would silently shift every subsequent "
                "mate pairing")
        return
    half = batch_size // 2
    it1 = load_read_batches([m1], batch_size=half, max_len=max_len,
                            read_length=read_length, max_reads=max_reads)
    it2 = load_read_batches([m2], batch_size=half, max_len=max_len,
                            read_length=read_length, max_reads=max_reads)
    sentinel = object()
    for b1, b2 in zip_longest(it1, it2, fillvalue=sentinel):
        if b1 is sentinel or b2 is sentinel or b1.n_reads != b2.n_reads:
            raise ValueError(
                "paired input files have different read counts "
                "(-1 and -2 must have matching mates)")
        B, L = batch_size, max_len
        codes = np.full((B, L), PAD_CODE, dtype=np.int8)
        quals = np.zeros((B, L), dtype=np.int8)
        lengths = np.zeros(B, dtype=np.int32)
        mean_qual = np.zeros(B, dtype=np.float32)
        codes[0::2], codes[1::2] = b1.codes, b2.codes
        quals[0::2], quals[1::2] = b1.quals, b2.quals
        lengths[0::2], lengths[1::2] = b1.lengths, b2.lengths
        mean_qual[0::2], mean_qual[1::2] = b1.mean_qual, b2.mean_qual
        names: List[str] = []
        for a, b in zip(b1.names, b2.names):
            names.extend((a, b))
        # real pairs land contiguously at rows 0..2*n_reads-1 (both
        # source batches are front-packed), so no compaction needed
        yield ReadBatch(names, codes, lengths, quals, mean_qual,
                        2 * b1.n_reads)
