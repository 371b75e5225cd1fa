"""The port's database builder (midas_tpu_torch/dbbuild/, cli/build_db.py)
against midas_tpu's, on the CPU: greedy_cluster / cluster_levels on
tests/test_dbbuild.py's inputs, the k-mer sets and the containment
identity; a small HMMER3 file written here (the stock phyeco.hmm is not
in the repo) through parse_hmm_file, viterbi_score, evalue and
search_proteins; run_build in marker-map mode (plain, --compress,
--max_species) and with the HMMs, every file of the two trees equal
(gzipped files decompressed: gzip headers carry the time); the port's
run_midas species over the port-built database against midas_tpu's
run_species over its own; and `python -m midas_tpu_torch.cli.build_db`.
Exact equality throughout."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from midas_tpu.dbbuild import build_db as j_build
from midas_tpu.dbbuild import cluster as j_cluster
from midas_tpu.dbbuild import hmm as j_hmm
from midas_tpu.io.seqio import encode_seq
from midas_tpu.profile.species import run_species as j_run_species
from midas_tpu.testkit import simulate_db, simulate_reads
from midas_tpu.testkit.simulate import _mutate, write_genome_inputs
from midas_tpu_torch.cli.run_midas import main as t_run_midas
from midas_tpu_torch.dbbuild import build_db as t_build
from midas_tpu_torch.dbbuild import cluster as t_cluster
from midas_tpu_torch.dbbuild import hmm as t_hmm
from midas_tpu_torch.utils import CODON_TABLE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _tree(root):
    """{path relative to root, without .gz: decompressed bytes}."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            op = gzip.open if name.endswith(".gz") else open
            with op(path, "rb") as f:
                rel = os.path.relpath(path, root)
                out[rel[:-3] if rel.endswith(".gz") else rel] = f.read()
    return out


def _cluster_inputs():
    """tests/test_dbbuild.py's three clustering cases: (names, seqs,
    identity or None for cluster_levels)."""
    rng = np.random.default_rng(0)
    base1, base2 = _rand_seq(rng, 900), _rand_seq(rng, 900)
    names = ["a1", "a2", "a3", "b1", "b2", "c1"]
    seqs = [base1, _mutate(rng, base1, 0.002), _mutate(rng, base1, 0.005),
            base2, _mutate(rng, base2, 0.003), _rand_seq(rng, 900)]
    seqs2 = [base1, _mutate(rng, base1, 0.03), _rand_seq(rng, 900)]
    rng = np.random.default_rng(1)
    base = _rand_seq(rng, 600)
    seqs3 = [base, _mutate(rng, base, 0.002), _mutate(rng, base, 0.04),
             _rand_seq(rng, 600), _rand_seq(rng, 600)]
    return {"identity99": (names, seqs, 0.99),
            "identity90": (["x", "y", "z"], seqs2, 0.90),
            "levels": ([f"g{i}" for i in range(5)], seqs3, None)}


@pytest.mark.parametrize("case", ["identity99", "identity90", "levels"])
def test_clustering_equals_midas_tpu(case):
    names, seqs, identity = _cluster_inputs()[case]
    if identity is None:
        want = j_cluster.cluster_levels(names, seqs)
        got = t_cluster.cluster_levels(names, seqs)
        assert sorted(want) == [75, 80, 85, 90, 95, 99]
    else:
        want = j_cluster.greedy_cluster(names, seqs, identity=identity)
        got = t_cluster.greedy_cluster(names, seqs, identity=identity)
    assert got == want
    assert len(set((want[99] if identity is None else want).values())) >= 2


@pytest.mark.parametrize("k", [8, 12, 15])
def test_kmer_set_and_containment_identity(k):
    rng = np.random.default_rng(k)
    a = _rand_seq(rng, 700)
    b = _mutate(rng, a, 0.03)
    ka, kb = (t_cluster._kmer_set(encode_seq(s), k) for s in (a, b))
    for s, got in ((a, ka), (b, kb)):
        want = j_cluster._kmer_set(encode_seq(s), k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    cs = [0.0, -0.5, 1.0, 1.5, len(np.intersect1d(ka, kb)) / len(ka),
          *np.linspace(0.01, 0.99, 25)]
    assert [t_cluster._ani_from_containment(c, k) for c in cs] == \
        [j_cluster._ani_from_containment(c, k) for c in cs]


# --- profile HMMs --------------------------------------------------------

AMINO = "ACDEFGHIKLMNPQRSTVWY"


def _nlp(p):
    return "*" if p <= 0 else f"{-np.log(p):.5f}"


def write_hmm_file(path, lengths=(34, 57, 41), seed=0):
    """A HMMER3 ASCII file of len(lengths) models with seeded emission
    and transition probabilities (as -ln p, '*' for 0), the
    STATS LOCAL VITERBI line, COMPO on every other model, and the last
    node's M->D and D->D set to '*'. Returns each model's consensus
    protein (the most likely residue a match state)."""
    rng = np.random.default_rng(seed)
    consensus = []
    with open(path, "w") as f:
        for m, M in enumerate(lengths):
            f.write("HMMER3/f [3.1b2 | February 2015]\n")
            f.write(f"NAME  fam{m:02d}\nACC   PF{m:05d}.1\nLENG  {M}\n")
            f.write("ALPH  amino\nRF    no\nMM    no\nCONS  yes\n")
            f.write(f"STATS LOCAL MSV       {-9.5 - m:.4f}  0.70{m}\n")
            f.write(f"STATS LOCAL VITERBI   {-10.0 - m:.4f}  0.71{m}\n")
            f.write(f"STATS LOCAL FORWARD   {-4.0 - m:.4f}  0.72{m}\n")
            f.write("HMM          " + "        ".join(AMINO) + "\n")
            f.write("            m->m     m->i     m->d     i->m     i->i"
                    "     d->m     d->d\n")
            if m % 2 == 0:
                f.write("  COMPO   " + " ".join(
                    _nlp(p) for p in rng.dirichlet(np.ones(20))) + "\n")
            f.write("          " + " ".join(
                _nlp(p) for p in rng.dirichlet(np.ones(20))) + "\n")
            f.write("          " + " ".join(
                _nlp(p) for p in (0.95, 0.03, 0.02, 0.6, 0.4, 1.0, 0.0))
                    + "\n")
            cons = []
            for node in range(1, M + 1):
                match = rng.dirichlet(np.full(20, 0.3))
                cons.append(AMINO[int(np.argmax(match))])
                f.write(f"{node:7d}   " + " ".join(_nlp(p) for p in match)
                        + f" {node} - - -\n")
                f.write("          " + " ".join(
                    _nlp(p) for p in rng.dirichlet(np.ones(20))) + "\n")
                mi, md = rng.uniform(0.005, 0.05, 2)
                im = rng.uniform(0.3, 0.9)
                dm = rng.uniform(0.3, 0.9)
                if node == M:
                    tr = (1 - mi, mi, 0.0, im, 1 - im, 1.0, 0.0)
                else:
                    tr = (1 - mi - md, mi, md, im, 1 - im, dm, 1 - dm)
                f.write("          " + " ".join(_nlp(p) for p in tr) + "\n")
            f.write("//\n")
            consensus.append("".join(cons))
    return consensus


@pytest.fixture(scope="module")
def hmm_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hmm") / "families.hmm")
    return path, write_hmm_file(path)


def _proteins(consensus, seed=3):
    """{protein id: sequence}: each model's consensus, a mutated copy, a
    truncated copy and a fragment with X, plus random proteins, an empty
    one and a non-amino string."""
    rng = np.random.default_rng(seed)
    out = {}
    for m, cons in enumerate(consensus):
        mut = "".join(AMINO[rng.integers(20)] if rng.random() < 0.2 else a
                      for a in cons)
        out[f"cons{m}"] = cons
        out[f"mut{m}"] = mut
        out[f"trunc{m}"] = cons[5:-7]
        out[f"x{m}"] = "MX" + cons[:20] + "XX" + cons[20:]
    for i in range(4):
        out[f"rand{i}"] = "".join(AMINO[j] for j in rng.integers(0, 20, 60))
    out["empty"], out["junk"] = "", "BZJO*"
    return out


def test_parse_hmm_file_equals_midas_tpu(hmm_file):
    path, consensus = hmm_file
    want, got = j_hmm.parse_hmm_file(path), t_hmm.parse_hmm_file(path)
    assert len(want) == len(got) == len(consensus)
    for w, g in zip(want, got):
        assert (g.name, g.length, g.viterbi_mu, g.viterbi_lambda) == \
            (w.name, w.length, w.viterbi_mu, w.viterbi_lambda)
        for field in ("match_logodds", "tr"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.isneginf(g.tr).any()


def test_viterbi_and_evalue_equal_midas_tpu(hmm_file):
    path, consensus = hmm_file
    proteins = _proteins(consensus)
    jm, tm = j_hmm.parse_hmm_file(path), t_hmm.parse_hmm_file(path)
    for w, g in zip(jm, tm):
        for pid, seq in proteins.items():
            s = t_hmm.viterbi_score(g, seq)
            assert s == j_hmm.viterbi_score(w, seq), (g.name, pid)
            if np.isfinite(s):
                assert t_hmm.evalue(g, s, len(proteins)) == \
                    j_hmm.evalue(w, s, len(proteins))
    assert t_hmm.viterbi_score(tm[0], consensus[0]) > 40
    # the crude fallback without STATS
    g, w = tm[1], jm[1]
    g.viterbi_mu = w.viterbi_mu = None
    assert t_hmm.evalue(g, 12.5, 9) == j_hmm.evalue(w, 12.5, 9)


@pytest.mark.parametrize("max_evalue", [1e-5, 1e-12, 10.0])
def test_search_proteins_equals_midas_tpu(hmm_file, max_evalue):
    path, consensus = hmm_file
    proteins = _proteins(consensus)
    want = j_hmm.search_proteins(j_hmm.parse_hmm_file(path), proteins,
                                 max_evalue=max_evalue)
    got = t_hmm.search_proteins(t_hmm.parse_hmm_file(path), proteins,
                                max_evalue=max_evalue)
    assert got == want
    if max_evalue == 1e-5:
        assert {f: h[0] for f, h in got.items()} == {
            f"fam{m:02d}": f"cons{m}" for m in range(len(consensus))}


# --- run_build ------------------------------------------------------------

@pytest.fixture(scope="module")
def build_inputs(tmp_path_factory):
    """tests/test_dbbuild.py's built_db inputs: (community, genomes dir,
    mapfile, marker map)."""
    root = tmp_path_factory.mktemp("torch_dbbuild")
    comm = simulate_db(str(root / "truth_db"), n_species=2, genome_len=9000,
                       gene_len=600, n_extra_genes=2, related_pairs=1,
                       divergence=0.03, seed=5)
    indir = str(root / "genomes")
    mapfile = write_genome_inputs(comm, indir)
    marker_map = str(root / "markers.tsv")
    with open(marker_map, "w") as f:
        for sp in comm.species:
            for marker_id, gene_id in sp.marker_gene_ids.items():
                f.write(f"{gene_id}\t{marker_id}\n")
    return comm, indir, mapfile, marker_map


BUILD_OPTIONS = {"plain": {}, "compress": dict(compress=True),
                 "max_species": dict(max_species=2, max_genomes=1)}


@pytest.mark.parametrize("option", sorted(BUILD_OPTIONS))
def test_run_build_marker_map_equals_midas_tpu(build_inputs, tmp_path,
                                               option):
    _, indir, mapfile, marker_map = build_inputs
    trees = []
    for name, build in (("jax", j_build), ("torch", t_build)):
        out = str(tmp_path / name)
        build.run_build(dict(indir=indir, mapfile=mapfile, outdir=out,
                             marker_map=marker_map, **BUILD_OPTIONS[option]))
        trees.append(_tree(out))
    assert trees[1] == trees[0]
    want = {"species_info.txt", "genome_info.txt", "marker_genes/phyeco.fa",
            "marker_genes/phyeco.map", "kegg/cpd_to_enzyme.txt"}
    assert want <= set(trees[0])
    assert sum(k.endswith("centroids.ffn") for k in trees[0]) == \
        (2 if option == "max_species" else 3)


@pytest.fixture(scope="module")
def hmm_genomes(hmm_file, tmp_path_factory):
    """Two genomes of one species carrying reverse-translated consensus
    genes of the test's HMMs (mutated in the second), one non-marker gene
    each: (indir, mapfile)."""
    path, consensus = hmm_file
    aa_to_codon = {}
    for codon, aa in sorted(CODON_TABLE.items()):
        aa_to_codon.setdefault(aa, codon)
    rng = np.random.default_rng(2)
    root = tmp_path_factory.mktemp("hmm_genomes")
    for g, div in (("gX", 0.0), ("gY", 0.1)):
        genes = {}
        for j, cons in enumerate(consensus):
            prot = "".join(AMINO[rng.integers(20)] if rng.random() < div
                           else a for a in cons)
            genes[f"{g}.peg.{j + 1}"] = (
                "".join(aa_to_codon[a] for a in prot), prot)
        genes[f"{g}.peg.99"] = (_rand_seq(rng, 300), "M" * 100)
        gdir = root / g
        gdir.mkdir()
        contig = "".join(seq for seq, _p in genes.values())
        (gdir / f"{g}.fna").write_text(f">{g}_ctg1\n{contig}\n")
        (gdir / f"{g}.ffn").write_text(
            "".join(f">{n}\n{s}\n" for n, (s, _p) in genes.items()))
        (gdir / f"{g}.faa").write_text(
            "".join(f">{n}\n{p}\n" for n, (_s, p) in genes.items()))
    mapfile = root / "map.tsv"
    mapfile.write_text("genome_id\tspecies_id\trep_genome\n"
                       "gX\tspX\t0\ngY\tspX\t1\n")
    return str(root), str(mapfile)


def test_run_build_hmms_equals_midas_tpu(hmm_file, hmm_genomes, tmp_path):
    indir, mapfile = hmm_genomes
    trees = []
    for name, build in (("jax", j_build), ("torch", t_build)):
        out = str(tmp_path / name)
        build.run_build(dict(indir=indir, mapfile=mapfile, outdir=out,
                             hmms=hmm_file[0]))
        trees.append(_tree(out))
    assert trees[1] == trees[0]
    rows = trees[0]["marker_genes/phyeco.map"].decode().splitlines()[1:]
    assert {r.split("\t")[4] for r in rows} == {"fam00", "fam01", "fam02"}


def test_species_over_port_built_db(build_inputs, tmp_path):
    """run_midas species on the CPU over the port-built database: the
    species_profile.txt of midas_tpu's run_species over its own."""
    comm, indir, mapfile, marker_map = build_inputs
    fq = str(tmp_path / "r.fq.gz")
    simulate_reads(comm, fq, n_reads=400, abundances=[0.6, 0.3, 0.1], seed=9)
    profiles = []
    for name, build in (("jax", j_build), ("torch", t_build)):
        db = str(tmp_path / f"{name}_db")
        build.run_build(dict(indir=indir, mapfile=mapfile, outdir=db,
                             marker_map=marker_map))
        out = str(tmp_path / f"{name}_out")
        if name == "jax":
            j_run_species(dict(outdir=out, db=db, m1=fq, m2=None))
        else:
            assert t_run_midas(["species", out, "-1", fq, "-d", db,
                                "--device", "cpu"]) == 0
        with open(os.path.join(out, "species/species_profile.txt"),
                  "rb") as f:
            profiles.append(f.read())
    assert profiles[1] == profiles[0]
    top = profiles[0].splitlines()[1].split(b"\t")
    assert top[0].decode() == comm.species_ids()[0] and int(top[1]) > 100


def test_build_db_cli(build_inputs, tmp_path):
    """`python -m midas_tpu_torch.cli.build_db ... --marker_map --compress`
    builds midas_tpu's tree."""
    _, indir, mapfile, marker_map = build_inputs
    j_build.run_build(dict(indir=indir, mapfile=mapfile,
                           outdir=str(tmp_path / "jax"),
                           marker_map=marker_map, compress=True))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.build_db", indir,
         mapfile, str(tmp_path / "torch"), "--marker_map", marker_map,
         "--compress"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _tree(str(tmp_path / "torch")) == _tree(str(tmp_path / "jax"))
    missing = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.build_db",
         str(tmp_path / "none"), mapfile, str(tmp_path / "x")],
        env=env, capture_output=True, text=True, timeout=300)
    assert missing.returncode != 0 and "not found" in missing.stderr
