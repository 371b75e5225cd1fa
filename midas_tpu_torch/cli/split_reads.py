"""Split FASTQ/FASTA input into per-rank shard files.

Under several ranks (dist/driver.py) every rank parses the WHOLE read
stream and keeps its own stride of batches (driver.stride_batches).
Past a few ranks the inputs should instead be split into one file per
rank and passed rank-locally. This utility does that, record-exact:

    python -m midas_tpu_torch.cli.split_reads reads.fq.gz -n 16 -o shards/

writes shards/reads.part00.fq.gz ... part15.fq.gz with records dealt
round-robin (record i -> shard i % n, matching stride_batches' batch
round-robin at batch_size 1 — the species stream-order merge keys on
the GLOBAL index either way, so sharded runs stay byte-identical).
Paired runs must split -1 and -2 with the same -n so mates stay
aligned; --paired splits an interleaved file by PAIRS.

A shard's suffix is the format of the input's first record (.fq for
'@', .fa for '>'), plus .gz when the input is gzipped; midas_tpu's copy
picks .fq.gz whenever the path contains '.fq' or ends in '.gz', so a
gzipped FASTA got FASTQ-named shards."""

from __future__ import annotations

import argparse
import gzip
import itertools
import os
import sys
from typing import IO, List


def _opener(path: str, mode: str) -> IO:
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def _records(fp: IO):
    """Raw record blocks (header line + body lines), byte-preserving:
    FASTQ 4-line records or FASTA multi-line records."""
    first = fp.readline()
    if not first:
        return
    if first.startswith("@"):
        while first:
            lines = [first, fp.readline(), fp.readline(), fp.readline()]
            if not lines[3]:
                raise ValueError("truncated FASTQ record at end of file")
            yield "".join(lines)
            first = fp.readline()
    elif first.startswith(">"):
        header, body = first, []
        for line in fp:
            if line.startswith(">"):
                yield header + "".join(body)
                header, body = line, []
            else:
                body.append(line)
        yield header + "".join(body)
    else:
        raise ValueError("input is neither FASTQ (@) nor FASTA (>)")


def split_reads(path: str, n: int, outdir: str,
                paired: bool = False) -> List[str]:
    os.makedirs(outdir, exist_ok=True)
    base = os.path.basename(path)
    for ext in (".gz", ".fq", ".fastq", ".fa", ".fasta"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    group = 2 if paired else 1
    with _opener(path, "r") as fp:
        records = _records(fp)
        first = next(records, None)
        fmt = ".fa" if first is not None and first.startswith(">") else ".fq"
        suffix = fmt + (".gz" if path.endswith(".gz") else "")
        outs = [os.path.join(outdir, f"{base}.part{i:02d}{suffix}")
                for i in range(n)]
        sinks = [_opener(p, "w") for p in outs]
        try:
            if first is not None:
                records = itertools.chain([first], records)
            for i, rec in enumerate(records):
                sinks[(i // group) % n].write(rec)
        finally:
            for s in sinks:
                s.close()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="split_reads",
        description="Split FASTQ/FASTA into per-rank shards (round-robin "
                    "records) for runs under more ranks than batch "
                    "striding serves well.")
    ap.add_argument("input", help="FASTQ/FASTA file, optionally .gz")
    ap.add_argument("-n", type=int, required=True, help="number of shards")
    ap.add_argument("-o", "--outdir", default=".", help="output directory")
    ap.add_argument("--paired", action="store_true",
                    help="input is interleaved; keep mate pairs together")
    args = ap.parse_args(argv)
    outs = split_reads(args.input, args.n, args.outdir, paired=args.paired)
    for p in outs:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
