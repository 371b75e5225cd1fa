"""The port's split_reads (midas_tpu_torch/cli/split_reads.py) against
midas_tpu's, on the same inputs: shard contents equal record for record
and byte for byte (decompressed), single-end and --paired, FASTQ and
multi-line FASTA. Shard names equal midas_tpu's except where the port
repairs its suffix rule (fault j): midas_tpu names shards .fq.gz (and
gzips them) whenever the input path contains '.fq' or ends in '.gz';
the port takes the format from the first record and adds .gz only for a
gzipped input."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from midas_tpu.cli.split_reads import split_reads as j_split_reads
from midas_tpu_torch.cli.split_reads import main as t_main
from midas_tpu_torch.cli.split_reads import split_reads as t_split_reads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_reads(path, fmt, n=23, seed=0):
    """n records (FASTQ, or FASTA with bodies wrapped over 1-3 lines)
    named r<i>/1 and r<i>/2 in turn, so that --paired has mates."""
    rng = np.random.default_rng(seed)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        for i in range(n):
            seq = "".join("ACGTN"[b] for b in rng.integers(0, 5, int(
                rng.integers(1, 151))))
            name = f"r{i // 2}/{i % 2 + 1}"
            if fmt == "fq":
                qual = "".join(chr(33 + q) for q in rng.integers(2, 41, len(seq)))
                f.write(f"@{name}\n{seq}\n+\n{qual}\n")
            else:
                w = int(rng.integers(20, 80))
                body = "".join(seq[j:j + w] + "\n" for j in range(0, len(seq), w))
                f.write(f">{name} len={len(seq)}\n{body}")


def _read(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def _names(text, fmt):
    """The record names of a FASTQ (every fourth line) or FASTA text."""
    lines = text.splitlines()
    heads = lines[::4] if fmt == "fq" else [
        ln for ln in lines if ln.startswith(b">")]
    return [h[1:].split()[0] for h in heads]


# (input path relative to tmp_path, its format, --paired,
#  the port's shard suffix, midas_tpu's shard suffix)
CASES = {
    "fq_gz": ("reads.fq.gz", "fq", False, ".fq.gz", ".fq.gz"),
    "fq_gz_paired": ("reads.fq.gz", "fq", True, ".fq.gz", ".fq.gz"),
    "fa": ("reads.fa", "fa", False, ".fa", ".fa"),
    "fa_paired": ("reads.fasta", "fa", True, ".fa", ".fa"),
    # fault j: the suffixes differ
    "fa_gz": ("reads.fa.gz", "fa", False, ".fa.gz", ".fq.gz"),
    "fa_in_fq_dir": ("lane1.fq.d/reads.fa", "fa", False, ".fa", ".fq.gz"),
    "fq_plain": ("reads.fq", "fq", False, ".fq", ".fq.gz"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_reads_equals_midas_tpu(tmp_path, case):
    rel, fmt, paired, t_suffix, j_suffix = CASES[case]
    src = str(tmp_path / rel)
    os.makedirs(os.path.dirname(src), exist_ok=True)
    _write_reads(src, fmt, seed=len(case))
    want = j_split_reads(src, 3, str(tmp_path / "jax"), paired=paired)
    got = t_split_reads(src, 3, str(tmp_path / "torch"), paired=paired)
    assert [os.path.basename(p) for p in got] == \
        [f"reads.part{i:02d}{t_suffix}" for i in range(3)]
    assert [os.path.basename(p) for p in want] == \
        [f"reads.part{i:02d}{j_suffix}" for i in range(3)]
    for g, w in zip(got, want):
        assert _read(g) == _read(w)
        # a .gz suffix means a gzip file, and only then
        with open(g, "rb") as f:
            assert (f.read(2) == b"\x1f\x8b") == g.endswith(".gz")
    # every record once, dealt round-robin (mate pairs together)
    group = 2 if paired else 1
    names = _names(_read(src), fmt)
    assert [_names(_read(g), fmt) for g in got] == [
        [x for k, x in enumerate(names) if (k // group) % 3 == i]
        for i in range(3)]


def test_split_reads_cli(tmp_path, capsys):
    """main(argv) and `python -m midas_tpu_torch.cli.split_reads` print
    the shard paths and write what split_reads writes."""
    src = str(tmp_path / "reads.fq.gz")
    _write_reads(src, "fq", n=11, seed=3)
    want = j_split_reads(src, 4, str(tmp_path / "jax"))
    assert t_main([src, "-n", "4", "-o", str(tmp_path / "main")]) == 0
    printed = capsys.readouterr().out.split()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.split_reads", src,
         "-n", "4", "-o", str(tmp_path / "module")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for outs in (printed, proc.stdout.split()):
        assert [os.path.basename(p) for p in outs] == \
            [os.path.basename(p) for p in want]
        assert [_read(p) for p in outs] == [_read(p) for p in want]
