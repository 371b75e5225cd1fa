"""The port's analysis tools (midas_tpu_torch/analyze/, cli/analysis.py)
against midas_tpu's, on the CPU, over the same merged inputs: three small
samples (conftest's three_samples mixtures and seeds, 500 reads each)
through the port's run_species / run_genes / run_snps on the CPU, then
the port's merge_midas snps with all-sites filters and merge_midas
genes. Each tool runs in both packages on those files, with `random` and
`np.random` seeded alike before each call; their outputs must be equal
byte for byte (the random paths included), and the SnpMatrix readers
site by site. query_by_compound runs on a copy of the database (the
session's is shared) with each package's packaged KEGG table, and the
two tables are the same file."""

import gzip
import os
import random
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from midas_tpu.analyze import compare_genes as j_cg
from midas_tpu.analyze import consensus as j_cons
from midas_tpu.analyze import diversity as j_div
from midas_tpu.analyze import parse_snps as j_ps
from midas_tpu.analyze import query_compound as j_qc
from midas_tpu.analyze import track_strains as j_ts
from midas_tpu.cli import analysis as j_cli
from midas_tpu.testkit import simulate_reads
from midas_tpu_torch.analyze import compare_genes as t_cg
from midas_tpu_torch.analyze import consensus as t_cons
from midas_tpu_torch.analyze import diversity as t_div
from midas_tpu_torch.analyze import parse_snps as t_ps
from midas_tpu_torch.analyze import query_compound as t_qc
from midas_tpu_torch.analyze import track_strains as t_ts
from midas_tpu_torch.cli import analysis as t_cli
from midas_tpu_torch.merge import genes as t_merge_genes
from midas_tpu_torch.merge import snps as t_merge_snps
from midas_tpu_torch.profile.genes import run_genes
from midas_tpu_torch.profile.snps import run_snps
from midas_tpu_torch.profile.species import run_species

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ([0.5, 0.3, 0.15, 0.05], [0.2, 0.5, 0.2, 0.1], [0.4, 0.4, 0.1, 0.1])


@pytest.fixture(scope="module")
def cohort(sim_community, tmp_path_factory):
    """The port's per-sample runs (device="cpu") of three_samples'
    mixtures, merged by the port: snps with all-sites filters (as
    merged_all_sites) and genes at 95% (as test_analyze.py)."""
    root = tmp_path_factory.mktemp("torch_analyze")
    dirs = []
    for i, mix in enumerate(MIXES):
        fq = str(root / f"reads{i}.fq.gz")
        simulate_reads(sim_community, fq, n_reads=500, abundances=mix,
                       variant_rate=0.02 if i == 2 else 0.0,
                       error_rate=0.005 if i == 2 else 0.0, seed=10 + i)
        base = dict(outdir=str(root / f"sample{i}"), db=sim_community.db_dir,
                    m1=fq, m2=None, device="cpu")
        run_species(dict(base))
        run_genes(dict(base, build_db=True, align=True, cov=True,
                       species_cov=0.1))
        run_snps(dict(base, build_db=True, align=True, call=True,
                      species_cov=0.1))
        dirs.append(base["outdir"])
    snps, genes = str(root / "merged_snps"), str(root / "merged_genes")
    t_merge_snps.run_pipeline(dict(
        indirs=dirs, outdir=snps, db=sim_community.db_dir,
        sample_depth=0.0, fract_cov=0.0, min_samples=1, snp_type=["any"],
        allele_freq=0.01, site_depth=0, site_ratio=float("inf"),
        site_prev=0.0))
    t_merge_genes.run_pipeline(dict(
        indirs=dirs, outdir=genes, db=sim_community.db_dir,
        sample_depth=0.0, min_samples=1, cluster_pid="95", min_copy=0.35))
    sp0 = sim_community.species[0].species_id
    return types.SimpleNamespace(dirs=dirs, sp0=sp0,
                                 snps=os.path.join(snps, sp0),
                                 genes=os.path.join(genes, sp0))


def _seed():
    random.seed(11)
    np.random.seed(11)


def _both(tmp_path, j_fn, t_fn, *args, **kw):
    """Run midas_tpu's and the port's function, each seeded alike and
    writing its own output file (the second positional argument); return
    (midas_tpu's file bytes, the port's, midas_tpu's result, the
    port's)."""
    outs, results = [], []
    for name, fn in (("jax", j_fn), ("torch", t_fn)):
        out = str(tmp_path / f"{name}.txt")
        _seed()
        results.append(fn(args[0], out, *args[1:], **kw))
        with open(out, "rb") as f:
            outs.append(f.read())
    return outs[0], outs[1], results[0], results[1]


def _site_fields(site):
    return (site.id, site.ref_allele, site.major_allele, site.minor_allele,
            site.gene_id, site.locus_type, site.site_type,
            [(s.id, s.freq, s.depth) for s in site.samples.values()])


@pytest.mark.parametrize("select", [
    {}, {"mean_depth": 1.0}, {"keep_samples": ["sample0", "sample2"]},
    {"exclude_samples": ["sample1"]}, {"max_samples": 2},
    {"rand_samples": 2}], ids=["all", "depth", "keep", "exclude", "max",
                               "rand"])
def test_snp_matrix_site_by_site(cohort, select):
    """SnpMatrix / fetch_samples / fetch_sites: the same samples (ids,
    index, depth, coverage) and, site by site, the same site fields and
    per-sample frequencies and depths, through flagging and pooling."""
    got = {}
    for name, ps in (("jax", j_ps), ("torch", t_ps)):
        species = ps.SnpMatrix(cohort.snps)
        _seed()
        samples = ps.fetch_samples(species, **select)
        rows = []
        for site in ps.fetch_sites(species, samples):
            site.flag_samples(2, float("inf"), 0.5)
            site.summary_stats(weight=len(rows) % 2 == 1)
            site.filter(0.0, 0.0, None, None)
            rows.append((_site_fields(site), site.keep, site.prevalence,
                         site.pooled_maf,
                         [s.keep for s in site.samples.values()]))
        got[name] = (species.id, species.sample_ids,
                     [(s.id, s.index, s.mean_depth, s.fract_cov)
                      for s in samples.values()], rows)
    assert got["torch"] == got["jax"]
    assert len(got["jax"][3]) > 10000


CONSENSUS_ARGS = {
    "defaults": {},
    "depth1": dict(site_depth=1, max_sites=5000),
    "cds": dict(site_depth=1, locus_type="CDS", site_maf=0.01),
    "site_list": dict(site_depth=1),
}


@pytest.mark.parametrize("case", sorted(CONSENSUS_ARGS))
def test_call_consensus(cohort, tmp_path, case):
    """call_consensus: the FASTA file and the returned sequences."""
    kw = dict(CONSENSUS_ARGS[case])
    if case == "site_list":
        kw["site_list"] = str(tmp_path / "sites.txt")
        with open(kw["site_list"], "w") as f:
            f.write("".join(f"{i}\n" for i in range(1, 12000, 7)))
    want, got, rw, rg = _both(tmp_path, j_cons.call_consensus,
                              t_cons.call_consensus, cohort.snps, **kw)
    assert got == want and rg == rw
    assert got.count(b">") == 3 and len(next(iter(rw.values()))) > 0


DIVERSITY_ARGS = {
    "per_sample": dict(site_depth=1),
    "pooled": dict(sample_type="pooled-samples", site_depth=1),
    "pooled_weighted": dict(sample_type="pooled-samples",
                            weight_by_depth=True, site_depth=1),
    "per_gene_cds": dict(genomic_type="per-gene", locus_type="CDS",
                         site_depth=1),
    "pooled_per_gene": dict(genomic_type="per-gene",
                            sample_type="pooled-samples", site_depth=1),
    "rand_sites": dict(rand_sites=0.5, site_depth=1),
    "rand_reads": dict(rand_reads=5, site_depth=1),
    "rand_reads_replace": dict(rand_reads=5, replace_reads=True,
                               sample_type="pooled-samples", site_depth=1),
    "rand_samples_consensus": dict(rand_samples=2, consensus=True,
                                   site_depth=1),
}


@pytest.mark.parametrize("case", sorted(DIVERSITY_ARGS))
def test_snp_diversity(cohort, tmp_path, case):
    """snp_diversity: the pi table, on every sample / genomic type and on
    the random paths (sites, reads, samples), seeded alike."""
    want, got, _, _ = _both(tmp_path, j_div.snp_diversity,
                            t_div.snp_diversity, cohort.snps,
                            **DIVERSITY_ARGS[case])
    assert got == want
    assert len(want.splitlines()) >= 2


def test_strain_tracking(cohort, tmp_path):
    """id_markers, then track_markers over its markers file."""
    want, got, nw, ng = _both(tmp_path, j_ts.id_markers, t_ts.id_markers,
                              cohort.snps, min_freq=0.1, min_reads=1)
    assert got == want and ng == nw
    markers = str(tmp_path / "markers.txt")
    with open(markers, "wb") as f:
        f.write(want)
    want, got, _, _ = _both(tmp_path, j_ts.track_markers,
                            t_ts.track_markers, cohort.snps, markers,
                            min_freq=0.1, min_reads=1)
    assert got == want and len(want.splitlines()) == 4


@pytest.mark.parametrize("dtype,distance", [
    ("presabs", "jaccard"), ("copynum", "euclidean"),
    ("copynum", "manhattan")])
def test_compare_genes(cohort, tmp_path, dtype, distance):
    want, got, _, _ = _both(tmp_path, j_cg.compare_genes, t_cg.compare_genes,
                            cohort.genes, dtype=dtype, distance=distance)
    assert got == want and len(want.splitlines()) == 4


def test_packaged_kegg_table_is_midas_tpus():
    path = t_qc.packaged_cpd_to_enzyme()
    assert path and path != j_qc.packaged_cpd_to_enzyme()
    with open(path, "rb") as f, open(j_qc.packaged_cpd_to_enzyme(), "rb") as g:
        assert f.read() == g.read()
    assert t_qc.load_cpd_to_enzyme(path) == j_qc.load_cpd_to_enzyme(path)


@pytest.fixture(scope="module")
def compound_db(cohort, sim_community, tmp_path_factory):
    """A copy of the database whose first species' centroid_functions
    name two of its genes with the enzymes of one compound of the
    packaged KEGG table (which the copy does not override). Returns
    (db, compound)."""
    db = str(tmp_path_factory.mktemp("kegg") / "db")
    shutil.copytree(sim_community.db_dir, db)
    shutil.rmtree(os.path.join(db, "kegg"), ignore_errors=True)
    table = t_qc.load_cpd_to_enzyme(t_qc.packaged_cpd_to_enzyme())
    compound = next(c for c, e in sorted(table.items()) if len(e) >= 2)
    genes = [g["gene_id"] for g in sim_community.species[0].genes[:2]]
    with gzip.open(os.path.join(db, "pan_genomes", cohort.sp0,
                                "centroid_functions.txt.gz"), "wt") as f:
        f.write("gene_id\tfunction_id\tontology\n")
        for g, e in zip(genes, table[compound]):
            f.write(f"{g}\t{e}\tec\n")
    return db, compound


def test_query_by_compound(cohort, compound_db, tmp_path):
    db, compound = compound_db
    want, got, nw, ng = _both(
        tmp_path, lambda dirs, out: j_qc.query_by_compound(
            dirs, db, compound, out),
        lambda dirs, out: t_qc.query_by_compound(dirs, db, compound, out),
        cohort.dirs)
    assert got == want and ng == nw and nw > 0


def _cli_cases(cohort, compound_db, tmp_path):
    """{case: (tool, argv without --out / -o)} for every analysis CLI."""
    db, compound = compound_db
    markers = str(tmp_path / "markers.txt")
    j_ts.id_markers(cohort.snps, markers, min_freq=0.1, min_reads=1)
    return {
        "call_consensus": ("call_consensus",
                           [cohort.snps, "--site_depth", "1",
                            "--exclude_samples", "sample1,"]),
        "snp_diversity": ("snp_diversity",
                          [cohort.snps, "--sample_type", "pooled-samples",
                           "--genomic_type", "per-gene", "--site_depth", "1"]),
        "compare_genes": ("compare_genes",
                          [cohort.genes, "--dtype", "presabs"]),
        "id_markers": ("strain_tracking",
                       ["id_markers", cohort.snps, "--min_reads", "1",
                        "--samples", "sample0,sample2"]),
        "track_markers": ("strain_tracking",
                          ["track_markers", cohort.snps, "--markers",
                           markers, "--min_reads", "1"]),
        "query_by_compound": ("query_by_compound",
                              ["-i", ",".join(cohort.dirs), "-t", "list",
                               "-d", db, "-c", compound]),
    }


def _out_flag(tool, out):
    return ["-o", out] if tool == "query_by_compound" else ["--out", out]


CLI_CASES = ["call_consensus", "snp_diversity", "compare_genes",
             "id_markers", "track_markers", "query_by_compound"]


@pytest.mark.parametrize("case", CLI_CASES)
def test_analysis_cli(cohort, compound_db, tmp_path, case):
    """Each *_main(argv) of the port, through the dispatch
    (cli.analysis.main), against midas_tpu.cli.analysis's function on the
    same arguments: the output files equal."""
    tool, argv = _cli_cases(cohort, compound_db, tmp_path)[case]
    j_main = getattr(j_cli, f"{tool}_main")
    outs = {}
    for name, run in (("jax", j_main),
                      ("torch", lambda a: t_cli.main([tool, *a]))):
        out = str(tmp_path / f"{name}.txt")
        _seed()
        assert run([*argv, *_out_flag(tool, out)]) == 0
        with open(out, "rb") as f:
            outs[name] = f.read()
    assert outs["torch"] == outs["jax"]
    assert outs["jax"].count(b"\n") >= 2


def test_analysis_module_dispatch(cohort, compound_db, tmp_path):
    """`python -m midas_tpu_torch.cli.analysis <tool>` runs the tool (its
    file equals midas_tpu's) and an unknown tool exits with the usage."""
    tool, argv = _cli_cases(cohort, compound_db, tmp_path)["call_consensus"]
    want = str(tmp_path / "jax.fa")
    assert j_cli.call_consensus_main([*argv, "--out", want]) == 0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    got = str(tmp_path / "torch.fa")
    proc = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.analysis", tool, *argv,
         "--out", got], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    bad = subprocess.run(
        [sys.executable, "-m", "midas_tpu_torch.cli.analysis", "nope"],
        env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and "call_consensus" in bad.stderr
