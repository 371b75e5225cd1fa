"""The generator: deterministic in the seed, and the traffic shapes the
cells' whys state (marker share, fragment lengths, strain alleles)."""

import hashlib

import numpy as np
import pytest

from portbench import gen

SMALL = {"n_species": 4, "genome_len": 60000, "gene_len": 900,
         "n_extra_genes": 5, "related_pairs": 1, "divergence": 0.03}
CLEAN = {"read_len": 100, "error_rate": 0.0, "indel_rate": 0.0}


def _digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(__import__("gzip").decompress(f.read()))
    return h.hexdigest()


def _fastq(path):
    import gzip
    with gzip.open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return lines[1::4], lines[3::4]


def _revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


@pytest.mark.parametrize("paired", [False, True])
def test_same_seed_same_inputs(tmp_path, paired):
    t = dict(CLEAN, reads=500, paired=paired, frag_range=[220, 420],
             error_rate=0.005, indel_rate=0.01,
             sources=[{"species": "first:2", "share": 1.0}])
    digests = []
    for run, seed in ((0, 2**31 + 7), (1, 2**31 + 7), (2, 2**31 + 8)):
        d = tmp_path / str(run)
        sp = gen.make_db(str(d / "db"), SMALL, seed)
        s = gen.make_sample(str(d / "s"), sp, [], t, seed)
        digests.append(_digest(s["paths"]))
    assert digests[0] == digests[1] != digests[2]


def test_marker_share_near_a_gut_sample(tmp_path):
    """20 species, each read from a 3 Mb genome that holds the species'
    15 marker genes: ~15 x 900 / 3e6 = 0.45% of reads lie on a marker."""
    db = {"n_species": 20, "genome_len": 30000, "gene_len": 900,
          "n_extra_genes": 2, "related_pairs": 0, "divergence": 0.03}
    sp = gen.make_db(str(tmp_path / "db"), db, 11)
    n = 200_000
    t = dict(CLEAN, reads=n, sources=[{"species": "first:20", "share": 1.0,
                                        "genome_len": 3_000_000}])
    s = gen.make_sample(str(tmp_path / "s"), sp, [], t, 11)
    k = 32
    kmers = set()
    for x in sp:
        seqs = {g["gene_id"]: g["seq"] for g in x.genes}
        for gid in x.markers.values():
            m = seqs[gid]
            for i in range(0, len(m) - k + 1):
                kmers.add(m[i: i + k])
                kmers.add(_revcomp(m[i: i + k]))
    seqs, _q = _fastq(s["paths"][0])
    # a read on a marker: one of its ends lies in the gene (an overlap
    # of 32 bp or more): 15 x (900 + 100 - 63) / 3e6 = 0.47% expected
    on = sum(1 for r in seqs[:n] if r[:k] in kmers or r[-k:] in kmers)
    assert 0.0038 < on / n < 0.0056, on / n


def test_pair_fragments_within_range(tmp_path):
    sp = gen.make_db(str(tmp_path / "db"), SMALL, 5)
    t = dict(CLEAN, reads=2000, paired=True, frag_range=[220, 420],
             sources=[{"species": "first:1", "share": 1.0}])
    s = gen.make_sample(str(tmp_path / "s"), sp, [], t, 5)
    genome = s["sources"][0][1].tobytes()
    m1, _ = _fastq(s["paths"][0])
    m2, _ = _fastq(s["paths"][1])
    spans = []
    for a, b in zip(m1[:2000], m2[:2000]):
        fa, fb = genome.find(a), genome.find(_revcomp(b))
        if fa >= 0 and fb >= 0:          # fragment on the plus strand
            spans.append(fb + len(b) - fa)
        else:                             # on the minus strand
            ra, rb = genome.find(_revcomp(a)), genome.find(b)
            assert ra >= 0 and rb >= 0
            spans.append(ra + len(a) - rb)
    spans = np.array(spans)
    assert spans.min() >= 220 and spans.max() <= 420
    assert spans.max() - spans.min() > 150


def test_strain_alleles_fixed_per_site(tmp_path):
    """The snps cell's strain: 1% of sites carry one other allele, and
    every read of the strain carries it (error-free reads are exact
    substrings of the strain genome)."""
    sp = gen.make_db(str(tmp_path / "db"), SMALL, 3)
    t = dict(CLEAN, reads=3000, sources=[
        {"species": "selected", "share": 1.0, "strain_snp_rate": 0.01}])
    s = gen.make_sample(str(tmp_path / "s"), sp, ["test_species_2"], t, 3)
    sid, strain = s["sources"][0]
    rep = np.concatenate(sp[1].contigs)
    assert sid == "test_species_2"
    assert int((strain != rep).sum()) == round(0.01 * len(rep))
    g = strain.tobytes()
    seqs, _q = _fastq(s["paths"][0])
    assert all(r in g or _revcomp(r) in g for r in seqs[:3000])
