"""The harness: it finds a cell's parts by name (a new traffic file and
entry make a new cell), loads no module of JAX or the JAX package, and
its reference loads nothing of the program."""

import copy
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import cells
from portbench.run import forbidden_modules, run_cell
from portbench.tests.tiny import write_tiny

ROOT = cells.ROOT


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert "midas_tpu_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "midas_tpu.align", types.ModuleType("y"))
    assert forbidden_modules() == ["jax", "midas_tpu"]


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "import portbench.reference, portbench.reference.species, "
        "portbench.reference.genes, portbench.reference.snps, "
        "portbench.reference.fastq, portbench.control")
    assert not mods & {"jax", "jaxlib", "flax", "midas_tpu",
                       "midas_tpu_torch"}


def test_a_run_loads_no_jax(tmp_path):
    mods = _modules_after(
        "import tempfile\n"
        "from portbench.tests.tiny import write_tiny\n"
        "from portbench.run import run_cell\n"
        f"here = {str(tmp_path)!r}\n"
        "r = run_cell('species-gut-1M', 5, 0.0, trace=True, device='cpu',"
        " bench=write_tiny(here), here=here)\n"
        "assert r['correct'], r")
    assert "midas_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "midas_tpu"}


def test_a_new_workload_file_adds_a_cell(tmp_path):
    here = str(tmp_path)
    bench = copy.deepcopy(write_tiny(here))
    with open(os.path.join(here, "workloads", "species-gut-1M.json")) as f:
        t = json.load(f)
    t.update(reads=1024, why="a smaller sample of the same mix")
    with open(os.path.join(here, "workloads", "species-small.json"), "w") as f:
        json.dump(t, f)
    bench["workloads"].append(dict(name="species-small",
                                   config="species-phyeco15",
                                   traffic="species-small", chips=1,
                                   why="a test cell"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "species-gut-1M" in m["workloads"]:
            m["workloads"].append("species-small")
    cell = cells.resolve("species-small", bench, here)
    assert cell["traffic"]["reads"] == 1024
    r = run_cell("species-small", 3, 0.0, trace=False, device="cpu",
                 bench=bench, here=here)
    assert r["correct"]
    assert set(r["metrics"]) == {"species_reads_per_s", "peak_device_mib",
                                 "setup_s"}


def test_benchmark_names_every_part():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.resolve(w["name"], bench)
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert cells.reader(m["name"]) is not None, m["name"]
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tmp_path):
    """On the card: every tiny cell runs correct, traced and not."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    here = str(tmp_path)
    bench = write_tiny(here)
    for w in bench["workloads"]:
        for trace in (False, True):
            r = run_cell(w["name"], 17, 0.0, trace=trace, device="cuda",
                         bench=bench, here=here)
            assert r["correct"], (w["name"], trace, r)


def test_trace_sums_device_time_by_label(tmp_path):
    """read_trace ties each kernel, copy and set to its launch by
    correlation id and sums them under the label whose range on the
    launching thread holds the launch; launches elsewhere, or on another
    thread in the same span of time, count for no label."""
    from portbench import trace

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                 pid=1)
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [
        x("user_annotation", "portbench.step", 0, 1000),
        x("user_annotation", trace.SEED, 10, 100),
        x("user_annotation", trace.SEED, 20, 30),          # nested: merged
        x("cuda_runtime", "cudaLaunchKernel", 15, 2, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 105, 2, corr=2),
        x("cuda_runtime", "cudaMemcpyAsync", 50, 2, tid=2, corr=3),
        x("user_annotation", trace.PAIR_PICK, 300, 50),
        x("cuda_runtime", "cudaLaunchKernel", 320, 2, corr=4),
        x("cuda_runtime", "cudaLaunchKernel", 400, 2, corr=5),
        x("kernel", "k1", 200, 40, tid=7, corr=1),
        x("kernel", "k2", 240, 10, tid=7, corr=2),
        x("gpu_memcpy", "Memcpy HtoD", 250, 5, tid=8, corr=3),
        x("kernel", "k3", 330, 20, tid=7, corr=4),
        x("kernel", "k4", 420, 7, tid=7, corr=5),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    r = trace.read_trace(str(p))
    assert r["by_label"] == pytest.approx({trace.SEED: 50e-6,
                                           trace.PAIR_PICK: 20e-6})
    assert r["busy_s"] == pytest.approx((55 + 20 + 7) * 1e-6)
