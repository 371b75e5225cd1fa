"""The native snps site writer (io.native.write_sites_gz, the C function
mio_write_sites) against the Python path's rows (profile.snps._site_rows):
the decompressed file byte for byte, one gzip member with its CRC and
ISIZE, the same compressed bytes at any thread count; and
SnpsProfiler.write_sites with and without the native library."""

import gzip
import struct
import types
import zlib

import numpy as np
import pytest

from midas_tpu_torch import tracing
from midas_tpu_torch.io import native
from midas_tpu_torch.profile import snps
from midas_tpu_torch.profile.snps import SnpsProfiler, _site_rows

SITES_PER_CHUNK = 1 << 15   # mio_write_sites's chunk, in sites
HEADER = "\t".join(["ref_id", "ref_pos", "ref_allele", "depth", "count_a",
                    "count_c", "count_g", "count_t"]) + "\n"


@pytest.fixture(scope="module")
def lib():
    lib = native.load_native()
    if lib is None:
        pytest.fail("the native library did not build")
    return lib


def _pack(lengths, seed, dtype=np.int32):
    """codes, depth and [4, G] counts over contigs of the given lengths
    laid end to end; code 4 (N) sites and counts of 5+ digits included."""
    rng = np.random.default_rng(seed)
    G = int(sum(lengths))
    codes = rng.integers(0, 5, G).astype(np.int8)
    counts = rng.poisson(3.0, (4, G)).astype(dtype)
    big = rng.random(G) < 0.01
    counts[:, big] = rng.integers(10_000, 2_000_000, (4, int(big.sum())))
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return codes, counts.sum(axis=0), counts, offsets


def _python_text(contigs, codes, depth, counts):
    return HEADER + "".join(
        _site_rows(name, codes[lo:hi], depth[lo:hi], counts[:, lo:hi])
        for name, lo, hi in contigs if hi > lo)


def _write(lib, path, contigs, codes, depth, counts, threads):
    st = native.write_sites_gz(lib, str(path), HEADER, contigs, codes, depth,
                               counts, threads)
    with open(path, "rb") as f:
        return f.read(), st


CASES = {
    # contig 0 ends exactly at the first chunk's end; the second chunk
    # boundary falls inside contig 2; contig 1 is empty
    "chunk_edges": [SITES_PER_CHUNK, 0, SITES_PER_CHUNK + 5_000, 17, 2_000],
    "single_site": [1],
    "no_sites": [0, 0],
    "under_one_chunk": [300, 0, 1_200],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_rows_equal_python_rows(lib, tmp_path, case):
    lengths = CASES[case]
    codes, depth, counts, off = _pack(lengths, seed=len(lengths))
    contigs = [(f"contig_{j}", int(off[j]), int(off[j + 1]))
               for j in range(len(lengths))]
    want = _python_text(contigs, codes, depth, counts).encode()
    assert b"\tN\t" in want or sum(lengths) < 5
    gz1, st = _write(lib, tmp_path / "one.snps.gz", contigs, codes, depth,
                     counts, threads=1)
    n_sites = sum(lengths)
    assert st == dict(sites=n_sites,
                      chunks=max(1, -(-n_sites // SITES_PER_CHUNK)),
                      threads=1, text_bytes=len(want), gz_bytes=len(gz1))
    d = zlib.decompressobj(31)   # gzip wrapper: header, trailer checked
    assert d.decompress(gz1) == want
    assert d.eof and d.unused_data == b""   # one gzip member
    crc, isize = struct.unpack("<II", gz1[-8:])
    assert crc == zlib.crc32(want) and isize == len(want) % 2 ** 32
    assert gzip.decompress(gz1) == want
    for threads in (2, 8, 64):
        gzn, stn = _write(lib, tmp_path / f"{threads}.snps.gz", contigs,
                          codes, depth, counts, threads)
        assert gzn == gz1
        assert stn["threads"] == min(threads, st["chunks"])


def test_native_size_near_serial_level9(lib, tmp_path):
    """Chunks primed with the previous 32 KiB cost next to nothing
    against one serial level-9 deflate of the same rows."""
    codes, depth, counts, off = _pack([3 * SITES_PER_CHUNK], seed=7)
    contigs = [("c", 0, int(off[1]))]
    want = _python_text(contigs, codes, depth, counts).encode()
    gz, st = _write(lib, tmp_path / "s.snps.gz", contigs, codes, depth,
                    counts, threads=4)
    assert st["chunks"] == 3
    serial = len(gzip.compress(want, compresslevel=9, mtime=0))
    assert len(gz) <= serial * 1.005


@pytest.mark.parametrize("dtype", [np.int64, np.uint16])
def test_native_counts_dtypes(lib, tmp_path, dtype):
    """int64 counts are read in place, others through an int64 copy; a
    strided view of the rows too."""
    codes, depth, counts, off = _pack([500, 700], seed=3, dtype=np.int64)
    counts = counts.astype(dtype)
    contigs = [("a", 0, 500), ("b", 500, 1200)]
    want = _python_text(contigs, codes, depth, counts).encode()
    gz, _ = _write(lib, tmp_path / "d.snps.gz", contigs, codes, depth,
                   counts, threads=2)
    assert gzip.decompress(gz) == want
    wide = np.zeros((4, 2 * 1200), dtype=dtype)
    wide[:, ::2] = counts
    gz, _ = _write(lib, tmp_path / "v.snps.gz", contigs, codes, depth,
                   wide[:, ::2], threads=2)
    assert gzip.decompress(gz) == want


def test_native_rejects_bad_input(lib, tmp_path):
    codes, depth, counts, _ = _pack([10], seed=1)
    codes[3] = 7
    with pytest.raises(ValueError):
        native.write_sites_gz(lib, str(tmp_path / "x.gz"), HEADER,
                              [("a", 0, 10)], codes, depth, counts, 1)
    with pytest.raises(ValueError):
        native.write_sites_gz(lib, str(tmp_path / "y.gz"), HEADER,
                              [("a", 0, 11)], codes, depth, counts, 1)


def _stub_profiler(lengths, species_of):
    """A SnpsProfiler holding only what write_sites reads."""
    codes, depth, counts, off = _pack(lengths, seed=11)
    prof = SnpsProfiler.__new__(SnpsProfiler)
    prof.pack = types.SimpleNamespace(
        names=[f"ctg{j:02d}" for j in range(len(lengths))][::-1],
        offsets=off, codes=codes)
    prof.contig_species = np.array(species_of)
    prof.species_ids = ["sp_a", "sp_b"]
    prof.counts = counts
    return prof, depth


def test_write_sites_native_and_fallback(tmp_path, monkeypatch):
    """write_sites writes the same decompressed file through the native
    writer and, without the library, through the Python path; the span
    says which path ran and the counters count the native one."""
    prof, depth = _stub_profiler([40_000, 0, 900, 30_000], [0, 0, 1, 0])
    with tracing.recording() as rec:
        path = prof.write_sites(str(tmp_path / "native"), 0, depth)
    with gzip.open(path, "rb") as f:
        native_text = f.read()
    (sp,) = rec.named("write.sites")
    assert sp["attrs"]["writer"] == "native"
    assert sp["attrs"]["sites"] == 70_000
    assert rec.counters["write.native_sites"] == 70_000
    assert rec.counters["write.chunks"] == 3
    assert rec.counters["write.text_bytes"] == len(native_text)
    assert rec.counters["write.gz_bytes"] == len(open(path, "rb").read())
    assert 1 <= rec.counters["write.threads"] <= 3

    monkeypatch.setattr(snps, "load_native", lambda: None)
    with tracing.recording() as rec:
        path = prof.write_sites(str(tmp_path / "python"), 0, depth)
    with gzip.open(path, "rb") as f:
        assert f.read() == native_text
    (sp,) = rec.named("write.sites")
    assert sp["attrs"]["writer"] == "python"
    assert sp["attrs"]["sites"] == 70_000
    assert "write.native_sites" not in rec.counters
    contigs = [(prof.pack.names[ci], int(prof.pack.offsets[ci]),
                int(prof.pack.offsets[ci + 1])) for ci in prof._contigs(0)]
    assert native_text == _python_text(contigs, prof.pack.codes, depth,
                                       prof.counts).encode()
