"""The port's merge_midas (species, genes, snps) against midas_tpu's, on
the CPU, over the same per-sample directories (the shared fixture
three_samples: three run_midas species + genes + snps outputs). Every
file of the two merged trees must be equal byte for byte: the species
merge at two --sample_depth values, the genes merge at two
--cluster_pid values, the four snps presets, the spooled snps path
(MIDAS_TPU_MAX_OPEN=1, one open sample file at a time) and the three
input types (-t list, dir, file)."""

import os

import pytest

from midas_tpu.cli.merge_midas import main as j_merge_midas
from midas_tpu_torch.cli.merge_midas import main as t_merge_midas


def _tree(root):
    """{path relative to root: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _merge_both(tmp_path, program, inputs, flags, db):
    """Run both packages' merge_midas with the same arguments into
    directories of their own; return the two trees."""
    trees = []
    for name, main in (("jax", j_merge_midas), ("torch", t_merge_midas)):
        out = str(tmp_path / name)
        assert main([program, out, *inputs, "-d", db, *flags]) == 0
        trees.append(_tree(out))
    return trees


def _as_list(dirs):
    return ["-i", ",".join(dirs), "-t", "list"]


def _data_rows(tree, suffix):
    """Rows after the header, over every file of tree ending in suffix."""
    return sum(len(v.splitlines()) - 1 for k, v in tree.items()
               if k.endswith(suffix))


@pytest.mark.parametrize("flags", [[], ["--sample_depth", "0"]],
                         ids=["default", "sample_depth_0"])
def test_merge_species_byte_identical(three_samples, sim_community, tmp_path,
                                      flags):
    want, got = _merge_both(tmp_path, "species", _as_list(three_samples),
                            flags, sim_community.db_dir)
    assert got == want
    assert {"relative_abundance.txt", "coverage.txt", "count_reads.txt",
            "species_prevalence.txt", "readme.txt"} <= set(want)
    assert _data_rows(want, "count_reads.txt") == 4


@pytest.mark.parametrize("cluster_pid", ["95", "99"])
def test_merge_genes_byte_identical(three_samples, sim_community, tmp_path,
                                    cluster_pid):
    want, got = _merge_both(
        tmp_path, "genes", _as_list(three_samples),
        ["--cluster_pid", cluster_pid, "--min_copy", "0.35"],
        sim_community.db_dir)
    assert got == want
    assert _data_rows(want, "genes_copynum.txt") > 0
    assert _data_rows(want, "genes_summary.txt") > 0


SNPS_PRESETS = ["--core_snps", "--core_sites", "--all_snps", "--all_sites"]


@pytest.mark.parametrize("preset", SNPS_PRESETS)
def test_merge_snps_byte_identical(three_samples, sim_community, tmp_path,
                                   preset):
    want, got = _merge_both(tmp_path, "snps", _as_list(three_samples),
                            [preset, "--all_samples"], sim_community.db_dir)
    assert got == want
    assert _data_rows(want, "snps_summary.txt") > 0
    assert any(k.endswith("snps_freq.txt") for k in want)
    if preset == "--all_sites":
        assert _data_rows(want, "snps_freq.txt") > 0


def test_merge_snps_spooled_equals_direct(three_samples, sim_community,
                                          tmp_path, monkeypatch):
    """With one open sample file allowed (MIDAS_TPU_MAX_OPEN=1) the port
    spools each sample's counts (_SpooledChunks) and still writes the
    direct path's files, which are midas_tpu's."""
    flags = [*_as_list(three_samples), "-d", sim_community.db_dir,
             "--all_sites", "--all_samples"]
    direct, spooled = str(tmp_path / "direct"), str(tmp_path / "spooled")
    j_merge_midas(["snps", str(tmp_path / "jax"), *flags])
    t_merge_midas(["snps", direct, *flags])
    monkeypatch.setenv("MIDAS_TPU_MAX_OPEN", "1")
    from midas_tpu_torch.merge import snps as merge_snps

    made = []
    real = merge_snps._SpooledChunks

    def spy(*a, **k):
        made.append(len(a[1]))
        return real(*a, **k)

    monkeypatch.setattr(merge_snps, "_SpooledChunks", spy)
    t_merge_midas(["snps", spooled, *flags])
    assert made and all(n == 3 for n in made)   # three one-sample batches
    want = _tree(str(tmp_path / "jax"))
    assert _tree(direct) == want
    assert _tree(spooled) == want
    assert _data_rows(want, "snps_freq.txt") > 0


@pytest.mark.parametrize("intype", ["list", "dir", "file"])
def test_merge_cli_input_types(three_samples, sim_community, tmp_path,
                               intype):
    """merge_midas -t list / dir / file give both packages the same
    samples, in the same order, and the same merged species files."""
    if intype == "list":
        inputs = _as_list(three_samples)
    elif intype == "dir":
        root = tmp_path / "samples"
        root.mkdir()
        for d in three_samples:
            os.symlink(d, root / os.path.basename(d))
        inputs = ["-i", str(root), "-t", "dir"]
    else:
        listing = tmp_path / "samples.txt"
        listing.write_text("".join(d + "/\n" for d in three_samples))
        inputs = ["-i", str(listing), "-t", "file"]
    want, got = _merge_both(tmp_path, "species", inputs, [],
                            sim_community.db_dir)
    assert got == want
    header = want["count_reads.txt"].splitlines()[0].split(b"\t")
    assert header == [b"species_id", b"sample0", b"sample1", b"sample2"]
