"""The port's spans and counters (midas_tpu_torch/tracing.py), on the CPU:
the names, nesting and parents of a profiler run's spans, the producer
thread's spans under the sample's root, one sample id a run, the
counters against truths computed beside them, outputs equal with a
recording open and without, nothing done while tracing is off, the
clock against torch.profiler's chrome trace, bench/budget.py's host rows
and the CLI's --profile exporter."""

import collections
import gzip
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from midas_tpu_torch import tracing
from midas_tpu_torch.align import pipeline
from midas_tpu_torch.db.layout import Database
from midas_tpu_torch.profile import device_steps
from midas_tpu_torch.profile.genes import GenesProfiler
from midas_tpu_torch.profile.snps import SnpsProfiler
from midas_tpu_torch.profile.species import SpeciesProfiler, write_abundance
from midas_tpu_torch.testkit import (simulate_db, simulate_paired_reads,
                                     simulate_reads)

# the suite runs files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the cores
torch.set_num_threads(1)

BATCH = 128
N_READS, N_PAIRS = 600, 300


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 3-species database, 600 single-end reads with indels (so the
    snps pileup spills gapped reads) and 300 mate pairs."""
    root = tmp_path_factory.mktemp("trace")
    comm = simulate_db(str(root / "db"), n_species=3, genome_len=12000,
                       gene_len=600, n_extra_genes=4, related_pairs=1,
                       divergence=0.03, seed=0)
    fq = str(root / "reads.fq.gz")
    simulate_reads(comm, fq, n_reads=N_READS, abundances=[0.5, 0.3, 0.2, 0.0],
                   error_rate=0.01, indel_rate=0.05, seed=3)
    r1, r2 = str(root / "r1.fq.gz"), str(root / "r2.fq.gz")
    simulate_paired_reads(comm, r1, r2, n_pairs=N_PAIRS,
                          abundances=[0.5, 0.3, 0.2, 0.0], seed=4)
    db = Database(comm.db_dir)
    ids = [s.species_id for s in comm.species][:3]
    return dict(root=root, db_dir=comm.db_dir, fq=fq, pairs=[r1, r2],
                species=SpeciesProfiler(db, device="cpu"),
                genes=GenesProfiler(db, ids, device="cpu"),
                snps=SnpsProfiler(db, ids, device="cpu"))


def _run(data, path, out):
    """One sample of a path into out, checkpoint and outputs written,
    as run_midas writes them."""
    prof = data[path]
    os.makedirs(os.path.join(out, path, "temp"), exist_ok=True)
    ckpt = os.path.join(out, path, "temp", "state.npz")
    if path == "species":
        ab = prof.run([data["fq"]], batch_size=BATCH, checkpoint_path=ckpt)
        write_abundance(os.path.join(out, "species", "profile.txt"), ab)
        return
    paired = path == "genes"
    prof.run(data["pairs"] if paired else [data["fq"]], batch_size=BATCH,
             checkpoint_path=ckpt, paired=paired)
    prof.write_results(out)


@pytest.fixture(scope="module")
def recorded(data, tmp_path_factory):
    """Each path run once with tracing off and once inside a recording;
    path -> (output dir off, output dir on, the recording)."""
    root = tmp_path_factory.mktemp("runs")
    got = {}
    for path in ("species", "genes", "snps"):
        off, on = str(root / f"{path}-off"), str(root / f"{path}-on")
        _run(data, path, off)
        with tracing.recording() as rec:
            _run(data, path, on)
        got[path] = (off, on, rec)
    return got


def _by_id(rec):
    return {s["id"]: s for s in rec.spans}


SPANS = {
    "species": {"profile.sample", "io.parse", "io.upload", "io.wait",
                "profile.step", "align.seed", "align.dp", "profile.drain",
                "profile.readback", "checkpoint.save", "checkpoint.compress",
                "checkpoint.fsync", "profile.finalize", "write.results"},
    "genes": {"profile.sample", "io.parse", "io.upload", "io.wait",
              "profile.step", "align.seed", "align.dp", "steps.pair_pick",
              "profile.readback", "checkpoint.save", "checkpoint.compress",
              "checkpoint.fsync", "profile.finalize", "write.results"},
    "snps": {"profile.sample", "io.parse", "io.upload", "io.wait",
             "profile.step", "align.seed", "align.dp", "profile.drain",
             "profile.readback", "checkpoint.save", "checkpoint.compress",
             "checkpoint.fsync", "profile.finalize", "snps.oracle",
             "write.results", "write.sites"},
}

PARENT = {   # span -> the name of its parent span
    "io.wait": "profile.sample", "profile.step": "profile.sample",
    "align.seed": "profile.step", "align.dp": "profile.step",
    "steps.pair_pick": "profile.step", "checkpoint.save": "profile.sample",
    "checkpoint.compress": "checkpoint.save",
    "checkpoint.fsync": "checkpoint.save", "profile.finalize":
    "profile.sample", "snps.oracle": "profile.finalize",
    "write.sites": "write.results", "io.parse": "profile.sample",
    "io.upload": "profile.sample", "io.put_wait": "profile.sample",
}


@pytest.mark.parametrize("path", ["species", "genes", "snps"])
def test_span_names_nesting_and_parents(recorded, path):
    rec = recorded[path][2]
    ids = _by_id(rec)
    # io.put_wait only where the producer found the queue full
    assert {s["name"] for s in rec.spans} - {"io.put_wait"} == SPANS[path]
    (root,) = rec.named("profile.sample")
    assert root["parent"] is None and root["attrs"]["path"] == path
    assert root["attrs"]["reads"] == (2 * N_PAIRS if path == "genes"
                                      else N_READS)
    for s in rec.spans:
        assert s["start_ns"] <= s["end_ns"]
        assert s["cpu_start_ns"] <= s["cpu_end_ns"]
        want = PARENT.get(s["name"])
        if want is not None:
            up = ids[s["parent"]]
            assert up["name"] == want, s
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    steps = rec.named("profile.step")
    assert [s["attrs"]["batch"] for s in steps] == list(range(len(steps)))
    dp = rec.named("align.dp")
    want_variants = {"species": {"K1"}, "genes": {"K3_qpen", "K2"},
                     "snps": {"K3_qpen", "K2"}}[path]
    assert {s["attrs"]["variant"] for s in dp} == want_variants
    # the writers after run: no parent, the run's sample
    (w,) = rec.named("write.results")
    assert w["parent"] is None and w["sample"] == root["sample"]


@pytest.mark.parametrize("path", ["species", "genes", "snps"])
def test_producer_spans_on_their_own_thread_under_the_root(recorded, path):
    rec = recorded[path][2]
    (root,) = rec.named("profile.sample")
    for name in ("io.parse", "io.upload", "io.put_wait"):
        spans = rec.named(name)
        assert spans or name == "io.put_wait"
        for s in spans:
            assert s["thread"] != root["thread"]
            assert s["parent"] == root["id"]
            assert s["sample"] == root["sample"]
    for s in rec.named("io.wait") + rec.named("profile.step"):
        assert s["thread"] == root["thread"]
    n_batches = rec.counters["io.batches"]
    assert len(rec.named("io.upload")) == n_batches
    assert len(rec.named("io.parse")) == n_batches + 1   # and the end
    assert len(rec.named("io.wait")) == n_batches + 1    # and END


def test_one_sample_id_a_run(data, tmp_path):
    with tracing.recording() as rec:
        _run(data, "species", str(tmp_path / "a"))
        _run(data, "species", str(tmp_path / "b"))
    roots = rec.named("profile.sample")
    assert [r["sample"] for r in roots] == [1, 2]
    for r in roots:
        inside = [s for s in rec.spans if s["start_ns"] >= r["start_ns"]
                  and s["end_ns"] <= r["end_ns"]]
        assert {s["sample"] for s in inside} == {r["sample"]}
    writers = rec.named("write.results")
    assert [w["sample"] for w in writers] == [1, 2]


def _truth(monkeypatch):
    """Patch seeding, the plain DP and the pair pick to count, beside
    the program, what its counters should read: seed.candidates,
    dp.pairs, dp.real_pairs (portbench/trace.py::_count_real's rule:
    pass-1 launches by the candidates' valid flags, pass-2 launches by
    whether the read has any valid candidate, a pair with an empty query
    never), pair.pairs and pair.concordant."""
    t = dict.fromkeys(("seed.candidates", "dp.pairs", "dp.real_pairs",
                       "pair.pairs", "pair.concordant"), 0)
    last = {}
    fc, dp, cp = (pipeline.find_candidates, pipeline.banded_align_plain,
                  device_steps.concordant_pairs)

    def find(*a, **kw):
        out = fc(*a, **kw)
        last["valid"] = out["valid"]
        t["seed.candidates"] += int(out["valid"].sum())
        return out

    def plain(query, qlens, *a, **kw):
        P = query.shape[0]
        v = last["valid"]
        real = v.reshape(-1) if P == v.numel() else v.any(dim=1)
        t["dp.pairs"] += P
        t["dp.real_pairs"] += int((real & (qlens > 0)).sum())
        return dp(query, qlens, *a, **kw)

    def pairs(out, qlens, *a, **kw):
        got = cp(out, qlens, *a, **kw)
        t["pair.pairs"] += int((qlens[0::2] > 0).sum())
        t["pair.concordant"] += int(got[0].sum())
        return got

    monkeypatch.setattr(pipeline, "find_candidates", find)
    monkeypatch.setattr(pipeline, "banded_align_plain", plain)
    monkeypatch.setattr(device_steps, "concordant_pairs", pairs)
    return t


@pytest.mark.parametrize("path", ["species", "genes", "snps"])
def test_counters_equal_host_truths(data, path, tmp_path, monkeypatch):
    truth = _truth(monkeypatch)
    out = str(tmp_path / "out")
    with tracing.recording() as rec:
        _run(data, path, out)
    c = rec.counters
    for k, v in truth.items():
        assert c.get(k, 0) == v, k
    assert truth["dp.real_pairs"] < truth["dp.pairs"]
    reads = 2 * N_PAIRS if path == "genes" else N_READS
    assert c["io.reads"] == reads
    assert c["io.batches"] == -(-reads // BATCH)
    if path == "genes":
        assert truth["pair.pairs"] == N_PAIRS
        assert 0 < truth["pair.concordant"] <= N_PAIRS
    ck = os.path.join(out, path, "temp", "state.npz")
    assert c["checkpoint.bytes"] == os.path.getsize(ck)
    assert rec.kept["launches"] == {}   # the plain DP on the CPU
    if path == "snps":
        assert c["snps.gap_rows"] == data["snps"].stats["n_gapped"] > 0
        (rb,) = rec.named("profile.readback")
        assert rec.kept["routes"] == {rb["attrs"]["route"]: 1}
        drains = rec.named("profile.drain")
        assert sum(d["attrs"]["rows"] for d in drains) == c["snps.gap_rows"]


def _tree(out):
    """Every output file under out: plain files as bytes, .gz files
    decompressed, checkpoints as their arrays (a zip entry carries the
    time it was written)."""
    got = {}
    for d, _dirs, files in os.walk(out):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, out)
            if f.endswith(".npz"):
                with np.load(p) as z:
                    got[rel] = {k: z[k].tobytes() for k in z.files}
            else:
                with (gzip.open if f.endswith(".gz") else open)(p, "rb") as h:
                    got[rel] = h.read()
    return got


@pytest.mark.parametrize("path", ["species", "genes", "snps"])
def test_outputs_equal_with_a_recording_open(recorded, path):
    off, on, _rec = recorded[path]
    a, b = _tree(off), _tree(on)
    assert any(k.endswith("state.npz") for k in a)
    assert a == b


class _Ops(torch.overrides.TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


def test_off_does_nothing(data, tmp_path, monkeypatch):
    """With no recording open: span() hands out the shared no-op, no
    torch.profiler range is entered and no tensor op runs, in the
    module's functions and over a whole paired genes run, whose counter
    calls all carry host ints (the device sums are not computed)."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: entered.append(a))
    t = torch.ones(3, dtype=torch.bool)
    with _Ops() as ops:
        assert tracing.span("x", a=1) is tracing.NO_SPAN
        with tracing.span("x") as sp:
            sp.set(rows=1)
        assert tracing.current() is None
        assert tracing.under(object()) is tracing.NO_SPAN
        tracing.count("x", t.sum())
        tracing.annotate(route="whole")
        assert not tracing.enabled()
    assert [f for f in ops.calls if f is not torch.Tensor.sum] == []
    counted = []
    monkeypatch.setattr(tracing, "count",
                        lambda name, n: counted.append((name, n)))
    _run(data, "genes", str(tmp_path / "genes"))
    assert entered == []
    assert counted and all(isinstance(n, int) for _name, n in counted)


def test_clock_matches_the_chrome_trace(data, tmp_path):
    """Under torch.profiler (every thread profiled), every recorded span
    lands on the user_annotation event of its name in the exported
    chrome trace. The span's clocks are read just before its range opens
    and just after it closes, and the profiler reads its own inside
    those calls, so with one timebase each event lies inside its span,
    within 50 us, and for most spans within 50 us of both ends. The
    calls may take longer where the profiler first meets a thread, or
    where a range's call returns to wait on the interpreter lock."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every_thread) as prof:
        with tracing.recording() as rec:
            _run(data, "species", str(tmp_path / "out"))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert len(rec.spans) == sum(map(len, events.values()))
    lead, lag = [], []
    for s in rec.spans:
        t0 = (s["start_ns"] - base) / 1e3
        t1 = (s["end_ns"] - base) / 1e3
        a, b = min(events[s["name"]], key=lambda ev: abs(ev[0] - t0))
        assert t0 - 50 <= a and b <= t1 + 50, (s["name"], a - t0, t1 - b)
        lead.append(a - t0)
        lag.append(t1 - b)
    assert np.median(lead) <= 50 and np.median(lag) <= 50, (lead, lag)


def test_counters_and_spans_from_many_threads():
    """Counts and spans from more threads than cores, with a short
    switch interval: no update is lost."""
    n_threads, n = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(n):
                    with tracing.span("w"):
                        tracing.count("c", 1)
                        tracing.count("d", torch.tensor(2))
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"c": n_threads * n, "d": 2 * n_threads * n}
    assert len(rec.named("w")) == n_threads * n


def test_records_as_json_lines(recorded, tmp_path):
    rec = recorded["snps"][2]
    p = str(tmp_path / "spans.jsonl")
    rec.write_jsonl(p)
    with open(p) as f:
        lines = [json.loads(x) for x in f]
    assert lines[0]["kind"] == "clock"
    kinds = [x["kind"] for x in lines]
    assert kinds.count("span") == len(rec.spans)
    assert {x["name"]: x["value"] for x in lines
            if x["kind"] == "counter"} == rec.counters
    assert kinds[-2:] == ["launches", "routes"]


def test_one_recording_at_a_time():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert not tracing.enabled()


def test_budget_host_rows_on_the_cpu(data):
    from midas_tpu_torch.bench.budget import HOST_SPANS, host_rows

    rows = host_rows(data["species"], data["fq"], batch_size=BATCH)
    assert set(rows) == {k for k, _ in HOST_SPANS}
    assert all(v >= 0 for v in rows.values())
    assert rows["end_to_end_ms"] >= rows["wait_ms"]


def test_cli_profile_writes_spans_beside_the_trace(data, tmp_path):
    """run_midas --profile writes spans.jsonl beside torch_trace.json,
    and every span in it, the producer thread's io.parse and io.upload
    included, has its user_annotation event in the trace."""
    from midas_tpu_torch.cli.run_midas import main

    out = str(tmp_path / "out")
    assert main(["species", out, "-1", data["fq"], "-d", data["db_dir"],
                 "--device", "cpu", "--profile"]) == 0
    with open(os.path.join(out, "species", "torch_trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(out, "species", "spans.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert lines[0]["kind"] == "clock"
    spans = [x for x in lines if x["kind"] == "span"]
    names = {x["name"] for x in spans}
    assert {"profile.sample", "io.parse", "io.upload", "align.dp",
            "write.results"} <= names
    base = trace.get("baseTimeNanoseconds", 0)
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            events[e["name"]].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert {k: len(v) for k, v in events.items()} == dict(
        collections.Counter(x["name"] for x in spans))
    for s in spans:   # each event inside its span, as in the clock test
        t0 = (s["start_ns"] - base) / 1e3
        t1 = (s["end_ns"] - base) / 1e3
        a, b = min(events[s["name"]], key=lambda ev: abs(ev[0] - t0))
        assert t0 - 50 <= a and b <= t1 + 50, (s["name"], a - t0, t1 - b)
