"""The benchmark of midas_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's database and sample from the seed (the sample's
FASTQ written once, into the run's temporary directory), builds the
port's profiler (its index: set-up) and warms it on the sample's first
batches. The window then runs whole samples back to back, one at a
time, each into a fresh output directory, until --seconds have passed;
a sample started before then is finished and counted. Rates are all
reads of all samples (each mate a read) over the window's start to the
last sample's end. After the window the program's state is freed, the
plain reference (reference/) works out the expected outputs once, and
every sample's outputs are compared with them (compare.py). Set-up ends
with os.sync(), so no fsync of the window waits on set-up's writes; the
log line after the window gives each sample's seconds.

With --trace 1 the window's first sample runs under torch.profiler with
the instruments of trace.py, and the run reports the cell's per-layer
metrics (metrics/) instead of its end-to-end ones.

The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, [breakdown], checks). It exits
non-zero and prints no result without a CUDA card, when the program
is missing, or when jax, jaxlib, flax or midas_tpu is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "midas_tpu")
WARM_BATCHES = 2    # batches of the warm-up run: every shape of a sample


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, by the program's smi_line."""
    from midas_tpu_torch.bench.common import smi_line

    try:
        return smi_line()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def short_name(kernel: str) -> str:
    """A kernel's name without its parameter list, and without its
    template arguments too where they would pass 120 characters."""
    if kernel.startswith(("Memcpy", "Memset")):
        return kernel
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    if len(name) > 120:
        out, depth = [], 0
        for ch in name:
            depth += (ch == "<") - (ch == ">")
            if depth == 0 and ch != ">":
                out.append(ch)
        name = "".join(out)
    return name[:120] or kernel[:120]


def end_to_end(path: str, n_reads: int, window_s: float, peak: int,
               setup_s: float):
    return {f"{path}_reads_per_s": n_reads / window_s,
            "peak_device_mib": peak / 2 ** 20, "setup_s": setup_s}


def per_layer(cell, ctx):
    """The cell's per-layer metrics that their readers find."""
    from portbench import cells

    out = {}
    for m in cell["per_layer"]:
        read = cells.reader(m["name"])
        value = read(ctx) if read is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench=None, here=None, t0=None):
    """One run of one cell; returns the result object."""
    import torch

    from portbench import cells, compare, gen
    from portbench import trace as tr
    from portbench.reference import expected
    from portbench.system import PATHS

    t0 = T0 if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cell = cells.resolve(name, bench or cells.benchmark(), here or HERE)
    cfg, traffic = cell["config"], cell["traffic"]
    path = cfg["path"]
    work = tempfile.mkdtemp(prefix=f"portbench-{name}-")
    try:
        stages = [("start", t0)]
        db_dir = os.path.join(work, "db")
        species = gen.make_db(db_dir, cfg["database"], seed,
                              parts=gen.DB_PARTS[path])
        stages.append(("database", time.perf_counter()))
        selected = cells.selected_species(cfg, species)
        sample = gen.make_sample(os.path.join(work, "sample"), species,
                                 selected, traffic, seed)
        del species
        sample.pop("sources")
        stages.append(("sample", time.perf_counter()))
        system = PATHS[path](db_dir, cfg, sample, selected, device)
        system.build()
        stages.append(("profiler", time.perf_counter()))
        warm = os.path.join(work, "warm")
        system.run(warm, max_reads=WARM_BATCHES
                   * cfg["settings"]["batch_size"], write=False)
        shutil.rmtree(warm)
        _sync(device)
        stages.append(("warm-up", time.perf_counter()))
        # the database, sample and warm-up files reach the disk before
        # the window, so no sample's checkpoint fsync waits on them
        os.sync()
        stages.append(("sync", time.perf_counter()))
        setup_s = stages[-1][1] - t0
        log(f"set-up {setup_s:.3f} s: " + ", ".join(
            f"{n} {b - a:.3f}" for (_m, a), (n, b) in zip(stages, stages[1:])))
        log(f"window of {seconds} s")

        outs, traced, ends = [], None, []
        start = time.perf_counter()
        while not outs or time.perf_counter() - start < seconds:
            out = os.path.join(work, f"out{len(outs)}")
            if trace and not outs:
                spans = tr.Spans(path, device)
                with tr.profiled(work, cuda) as prof, \
                        spans.installed(system.profiler):
                    system.run(out)
                    _sync(device)
                    s1 = time.perf_counter()
                traced = (spans.summary(s1), tr.read_trace(prof["path"]))
                os.remove(prof["path"])
            else:
                system.run(out)
                _sync(device)
            outs.append(out)
            ends.append(time.perf_counter())
        window_s = ends[-1] - start
        per_sample = sample["reads"] * (2 if sample["paired"] else 1)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"{len(outs)} samples in {window_s:.3f} s: " + " ".join(
            f"{b - a:.3f}" for a, b in zip([start] + ends, ends)))

        system.profiler = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        r0 = time.perf_counter()
        files, state, state_path = expected(path, db_dir, sample,
                                            cfg["settings"], selected, device)
        checks = {k: 0 for k in compare.LIMITS
                  if state is not None or k != "state_entries_differing"}
        failed = 0
        for out in outs:
            got = compare.judge(out, files, state, state_path)
            failed += any(v > compare.LIMITS[k] for k, v in got.items())
            for k, v in got.items():
                checks[k] += v
            shutil.rmtree(out)
        log(f"reference and comparison {time.perf_counter() - r0:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = dict(correct=failed == 0 and bool(outs), attempted=len(outs),
                  failed=failed)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    if trace:
        summary, reading = traced
        ctx = dict(path=path, spans=summary, trace=reading)
        result["metrics"] = per_layer(cell, ctx)
        dev.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        merged = {}
        for n, s in reading["by_name"].items():
            merged[short_name(n)] = merged.get(short_name(n), 0.0) + s
        ops = sorted(merged.items(), key=lambda kv: -kv[1])
        result["breakdown"] = dict(device_ops=[list(o) for o in ops[:10]],
                                   idle_gaps=[list(g) for g in
                                              reading["gaps"][:10]])
    else:
        values = end_to_end(path, per_sample * len(outs), window_s, peak,
                            setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell["end_to_end"]}
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from portbench import cells

    chips = next((w["chips"] for w in cells.benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); this benchmark runs on "
            "the card only")
        return 3
    try:
        import midas_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program midas_tpu_torch is not in this checkout ({e})")
        return 4
    card = card_line()
    print(f"card: {card}", flush=True)
    log(f"card: {card}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 5
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
