"""Where a cell's parts are found, by the names in BENCHMARK.json: the
configuration in configs/<config>.json, the traffic mix in
workloads/<traffic>.json, and each per-layer metric's reader in
metrics/<metric>.py, or metrics/<name before the first dot>.py for a
metric whose name ends in its path's suffix."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(name: str, bench: Dict, here: str = HERE) -> Dict:
    """The cell named `name`: its BENCHMARK.json entry, configuration and
    traffic, and the metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(os.path.join(here, "configs", f"{entry['config']}.json"))
    traffic = load_json(os.path.join(here, "workloads",
                                     f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return dict(name=name, entry=entry, config=cfg, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def reader(metric: str, here: str = HERE):
    """The read(ctx) function of a per-layer metric, or None."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(here, "metrics", f"{stem}.py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


def selected_species(cfg: Dict, species) -> List[str]:
    """The ids the configuration selects ("first:N" or a list), or []."""
    spec: Optional[object] = cfg.get("selected_species")
    if not spec:
        return []
    if isinstance(spec, list):
        return list(spec)
    if spec.startswith("first:"):
        return [s.species_id for s in species[: int(spec.split(":")[1])]]
    raise ValueError(f"unknown selection {spec!r}")
