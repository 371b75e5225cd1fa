"""The control of `correct`: the plain reference put in the program's
place with one guarantee of the configuration broken (every read of the
sample is aligned and counted once: the sample's last batch of reads,
or of pairs, is left out), its outputs written as the program writes
them, and judged by compare.py against the sound reference. Each number
it reads is an upper reading of that number's limit; a sound run reads
0. Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <name> --seed <n> [--seed <n> ...]

prints one JSON line per seed with the numbers compared.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def write_outputs(out: str, files, state, state_path: str) -> None:
    """Files as the program writes them (.gz gzipped) and the state as a
    checkpoint's arrays."""
    for rel, data in files.items():
        p = os.path.join(out, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "wb") as f:
            f.write(data)
    if state is not None:
        p = os.path.join(out, state_path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            np.savez_compressed(f, **state)


def control_numbers(name: str, seed: int, device, bench=None, here=None):
    """The numbers compared when the control takes the program's place
    in one run of the cell at this seed."""
    from portbench import cells, compare, gen
    from portbench.reference import expected

    cell = cells.resolve(name, bench or cells.benchmark(), here or HERE)
    cfg, traffic = cell["config"], cell["traffic"]
    work = tempfile.mkdtemp(prefix=f"portbench-control-{name}-")
    try:
        db = os.path.join(work, "db")
        species = gen.make_db(db, cfg["database"], seed,
                              parts=gen.DB_PARTS[cfg["path"]])
        selected = cells.selected_species(cfg, species)
        sample = gen.make_sample(os.path.join(work, "sample"), species,
                                 selected, traffic, seed)
        sample.pop("sources")
        want, state, sp = expected(cfg["path"], db, sample, cfg["settings"],
                                   selected, device)
        got, gstate, _ = expected(cfg["path"], db, sample, cfg["settings"],
                                  selected, device,
                                  drop_reads=cfg["settings"]["batch_size"])
        out = os.path.join(work, "control")
        write_outputs(out, got, gstate, sp)
        return compare.judge(out, want, state, sp)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seed:
        got = control_numbers(args.workload, seed, "cuda")
        print(json.dumps(dict(workload=args.workload, seed=seed, **got)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
