"""`correct` on the CPU at tiny sizes: the plain reference agrees with
midas_tpu_torch on every cell's outputs, and runs with the timed path
broken underneath come out not correct — a step that returns its state
unchanged, half of each batch left out, an answer altered where it is
produced (and, for snps, the checkpointed state altered). The cells run
on one device and exchange nothing between chips, so that fault has no
case. The control (control.py) reads above every limit."""

import gzip
import os

import numpy as np
import pytest

from portbench import compare, control
from portbench.run import run_cell
from portbench.tests.tiny import write_tiny

CELLS = {"species-gut-1M": "species", "genes-10sp-paired": "genes",
         "snps-1sp-single": "snps"}
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    here = str(tmp_path_factory.mktemp("tiny"))
    return here, write_tiny(here)


def _run(tiny, cell):
    here, bench = tiny
    return run_cell(cell, SEED, 0.0, trace=False, device="cpu", bench=bench,
                    here=here)


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_agrees_with_the_port(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert ("state_entries_differing" in r["checks"]) == (cell == "snps-1sp-single")


def _profiler_class(path):
    from midas_tpu_torch.profile.genes import GenesProfiler
    from midas_tpu_torch.profile.snps import SnpsProfiler
    from midas_tpu_torch.profile.species import SpeciesProfiler

    return {"species": SpeciesProfiler, "genes": GenesProfiler,
            "snps": SnpsProfiler}[path]


# position of n_reads among each step's arguments (after self)
N_READS_ARG = {"species": 5, "genes": 5, "snps": 6}


def _fault_unchanged(mp, path, cls):
    mp.setattr(cls, f"_{path}_step", lambda self, *a, **kw: None)


def _fault_half(mp, path, cls):
    step = getattr(cls, f"_{path}_step")

    def half(self, *a, **kw):
        a = list(a)
        a[N_READS_ARG[path]] //= 2
        return step(self, *a, **kw)
    mp.setattr(cls, f"_{path}_step", half)


def _fault_altered(mp, path, cls):
    name = "assign_and_normalize" if path == "species" else "_finalize"
    fin = getattr(cls, name)

    def altered(self, *a, **kw):
        out = fin(self, *a, **kw)
        if path == "species":
            out[next(iter(out))]["count"] += 1
        elif path == "genes":
            out["mapped_reads"][0] += 1
        else:
            out["counts"][0, 0] += 1
        return out
    mp.setattr(cls, name, altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    path = CELLS[cell]
    globals()[f"_fault_{fault}"](monkeypatch, path, _profiler_class(path))
    r = _run(tiny, cell)
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_altered_checkpoint_state_is_not_correct(tiny, monkeypatch):
    from midas_tpu_torch.profile import checkpoint

    save = checkpoint.save

    def altered(path, arrays, meta):
        arrays = dict(arrays)
        c = arrays["counts"].copy()
        c[0] += 1
        arrays["counts"] = c
        return save(path, arrays, meta)
    monkeypatch.setattr(checkpoint, "save", altered)
    r = _run(tiny, "snps-1sp-single")
    assert not r["correct"]
    assert r["checks"]["state_entries_differing"]["value"] >= 1
    assert r["checks"]["lines_differing"]["value"] == 0


def test_one_count_corrupted_fails_the_comparison(tmp_path):
    want = {"genes/output/a.genes.gz": b"gene_id\tcount_reads\ng1\t5\ng2\t0\n",
            "genes/summary.txt": b"species_id\tx\na\t1\n"}
    control.write_outputs(str(tmp_path), want, None, "")
    assert compare.judge(str(tmp_path), want) == {"lines_differing": 0}
    p = tmp_path / "genes/output/a.genes.gz"
    with gzip.open(p, "wb") as f:
        f.write(b"gene_id\tcount_reads\ng1\t6\ng2\t0\n")
    assert compare.judge(str(tmp_path), want) == {"lines_differing": 1}
    os.remove(tmp_path / "genes/summary.txt")
    assert compare.judge(str(tmp_path), want)["lines_differing"] == 1 + 3


def test_state_dump_slot_is_left_out(tmp_path):
    want = {"mapped_reads": np.array([4, 2], np.int32)}
    p = str(tmp_path / "s.npz")
    np.savez(p, mapped_reads=np.array([4, 2, 999], np.int32))
    assert compare.state_entries_differing(p, want) == 0
    np.savez(p, mapped_reads=np.array([4, 3, 999], np.int32))
    assert compare.state_entries_differing(p, want) == 1


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_reads_above_the_limits(tiny, cell):
    here, bench = tiny
    got = control.control_numbers(cell, SEED, "cpu", bench=bench, here=here)
    assert any(v > compare.LIMITS[k] for k, v in got.items()), got


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 5])
def test_species_assignment_and_writer_agree_with_the_port(tmp_path, seed):
    """The reference's read-by-read assignment and writer against the
    port's vectorised ones, on ambiguous reads of every kind: repeated
    species in one read, reads whose weights are all 0, reads out of
    stream order, species with no marker length."""
    from types import SimpleNamespace

    from midas_tpu_torch.profile.species import (SpeciesProfiler,
                                                 write_abundance)
    from portbench.reference import species as ref

    rng = np.random.default_rng(seed)
    S = 40
    order = [f"sp{i}" for i in range(S)]
    uc = rng.integers(0, 4, S) * (rng.random(S) < 0.6)
    ub = uc * rng.integers(60, 101, S)
    gl = rng.integers(0, 3, S) * 900.0
    amb = []
    for rank in rng.permutation(300):
        w = int(rng.integers(2, 6))
        seq = rng.choice(15 * S, w, replace=False)
        sp = seq // 15 if rng.random() < 0.7 else rng.integers(0, S, w)
        amb.append((int(rank), seq, sp, rng.integers(60, 101, w)))
    want = tmp_path / "port.txt"
    port = SpeciesProfiler.assign_and_normalize(
        SimpleNamespace(seed=seed % 1000, total_gene_length=gl,
                        species_order=order),
        uc.astype(np.int64), ub.astype(np.float64),
        [(s, p, c.astype(np.float64), r) for r, s, p, c in amb])
    write_abundance(str(want), port)
    count, bp = ref.assign_reads(uc, ub, amb, seed % 1000)
    assert ref.abundance_text(order, count, bp, gl) == want.read_bytes()
