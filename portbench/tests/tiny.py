"""Tiny copies of the benchmark's cells, for runs on the CPU: the same
paths, settings and traffic shapes as BENCHMARK.json's cells, at sizes a
test can hold (small databases, a few thousand reads, 512-read batches)."""

from __future__ import annotations

import copy
import json
import os

from portbench import cells

DB = {"n_species": 4, "genome_len": 60000, "gene_len": 900,
      "n_extra_genes": 20, "related_pairs": 1, "divergence": 0.03}
SIZES = {
    "species-phyeco15": dict(database={"n_species": 20, "genome_len": 30000,
                                       "gene_len": 900, "n_extra_genes": 2,
                                       "related_pairs": 3,
                                       "divergence": 0.03}),
    "pangenome-10sp": dict(database=DB, selected_species="first:3"),
    "repgenome-1sp": dict(database=DB),
}
TRAFFIC = {
    "species-gut-1M": dict(reads=2048, sources=[
        {"species": "first:5", "share": 1.0, "genome_len": 100000}]),
    "genes-10sp-paired": dict(reads=1024),
    "snps-1sp-single": dict(reads=2048),
}
BATCH = 512


def write_tiny(here: str) -> dict:
    """Write tiny configs/ and workloads/ under `here`; returns the
    benchmark (BENCHMARK.json's, unchanged but for its files)."""
    bench = cells.benchmark()
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(here, sub), exist_ok=True)
    for c in bench["configs"]:
        cfg = copy.deepcopy(cells.load_json(os.path.join(
            cells.HERE, "configs", f"{c['name']}.json")))
        cfg.update(SIZES[c["name"]])
        cfg["settings"]["batch_size"] = BATCH
        with open(os.path.join(here, "configs", f"{c['name']}.json"), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        t = cells.load_json(os.path.join(cells.HERE, "workloads",
                                         f"{w['traffic']}.json"))
        t.update(TRAFFIC[w["traffic"]])
        with open(os.path.join(here, "workloads", f"{w['traffic']}.json"),
                  "w") as f:
            json.dump(t, f)
    return bench
