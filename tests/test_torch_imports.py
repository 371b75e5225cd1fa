"""Guard: the port (every midas_tpu_torch module, chip_smoke.py and
dp_batch_sweep.py) imports neither JAX nor anything of the JAX package,
and importing it touches no card."""

import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import midas_tpu_torch
names = ["midas_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(midas_tpu_torch.__path__,
                                          "midas_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import dp_batch_sweep
import torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "midas_tpu" or m.startswith("midas_tpu."))
print(json.dumps(dict(modules=names, bad=bad,
                      cuda_initialized=torch.cuda.is_initialized())))
"""


def test_port_imports_no_jax_and_no_midas_tpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for m in ("profile.species", "profile.genes", "profile.snps",
              "profile.common", "profile.device_steps", "align.pipeline",
              "align.cuda_sw", "align.oracle", "merge", "merge.core",
              "merge.species", "merge.genes", "merge.snps", "utils",
              "cli.run_midas", "cli.merge_midas", "dist", "dist.driver",
              "dist.sharded", "dist.species", "dist.profilers",
              "analyze", "analyze.parse_snps", "analyze.consensus",
              "analyze.diversity", "analyze.track_strains",
              "analyze.compare_genes", "analyze.query_compound",
              "cli.analysis", "cli.split_reads", "dbbuild",
              "dbbuild.build_db", "dbbuild.cluster", "dbbuild.hmm",
              "cli.build_db", "profile.sparse_counts"):
        assert f"midas_tpu_torch.{m}" in got["modules"]
    assert got["bad"] == []
    assert not got["cuda_initialized"]


@pytest.mark.parametrize("package", ["io", "db", "testkit"])
def test_port_packages_reexport_midas_tpu_names(package):
    """Every public name a midas_tpu package re-exports from its modules
    is re-exported by the port's package of the same name, from the
    port's own modules."""
    jmod = importlib.import_module(f"midas_tpu.{package}")
    tmod = importlib.import_module(f"midas_tpu_torch.{package}")
    names = [n for n, v in vars(jmod).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    assert names
    for n in names:
        assert hasattr(tmod, n), f"midas_tpu_torch.{package}.{n}"
        v = getattr(tmod, n)
        if inspect.isclass(v) or inspect.isfunction(v):
            assert v.__module__.startswith(f"midas_tpu_torch.{package}."), n
