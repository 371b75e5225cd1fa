"""The traced run's instruments, all from outside the program: wrappers
around named functions of midas_tpu_torch that record host spans
(time.perf_counter), CUDA events around device calls, counts of the
DP pairs that hold a real candidate, and torch.profiler labels
(record_function) so the trace says what the host was doing. They are
installed for one sample and removed after it.

What each wrapper feeds:
- the profiler's per-batch step (_species_step / _genes_step /
  _snps_step): the batches and the time of its last return (host_tail_s);
- profile.checkpoint.save: seconds inside it (checkpoint_s);
- the batch iterator the sample reads (species: load_read_batches;
  genes, snps: select_batches): producer-thread ms inside each next()
  (parse_ms);
- align.pipeline's find_candidates and gather_windows_packed: the span
  between CUDA events recorded on the stream around each call
  (seed_span_ms), the label portbench.seed, whose launches' device time
  the trace gives (seed_device_ms), and the candidates that are real
  (valid) for the DP count;
- profile.device_steps.paired_best_hit_device: the same span
  (pair_pick_span_ms) and label, portbench.pair_pick
  (pair_pick_device_ms);
- align.cuda_sw.banded_align_cuda: the pairs of each launch that hold a
  real candidate and their rows (dp_roofline_pct's least time), and
  CUDA events around the launch (the kernel's time where the profiler
  records no kernels).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

# torch.profiler labels whose launches' device time read_trace sums
SEED = "portbench.seed"
PAIR_PICK = "portbench.pair_pick"
LABELS = (SEED, PAIR_PICK)


class _Patch:
    """Attribute replacements on modules and instances, undone in
    reverse order (an instance's own attribute is deleted again, so its
    class's method shows through)."""

    def __init__(self):
        self._undo = []

    def set(self, owner, name, value):
        own = vars(owner)
        self._undo.append((owner, name, own[name] if name in own else None,
                           name in own))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, old, had in reversed(self._undo):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()


class Spans:
    """The records of one traced sample."""

    def __init__(self, path: str, device):
        self.path = path
        self.cuda = torch.device(device).type == "cuda"
        self.batches = 0
        self.last_step_end: Optional[float] = None
        self.checkpoint_s = 0.0
        self.parse_s: List[float] = []
        self.seed_events: List = []
        self.pick_events: List = []
        self.dp_events: List = []
        # (n_stats, local, qual_pen) -> [rows, pairs] as device tensors
        self.dp_real: Dict = {}
        self._valid = None

    # -- helpers ---------------------------------------------------------
    def _events(self, store, fn, label=None):
        """fn with CUDA events recorded on the stream before and after
        each call (kept in store) and, given a label, inside a
        torch.profiler range of that name."""
        def wrapped(*a, **kw):
            with (torch.profiler.record_function(label) if label
                  else contextlib.nullcontext()):
                if not self.cuda:
                    return fn(*a, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
            store.append((start, end))
            return out
        return wrapped

    def _labelled(self, label, fn, after=None):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                out = fn(*a, **kw)
            if after is not None:
                after()
            return out
        return wrapped

    def _timed_iter(self, make):
        spans = self

        def wrapped(*a, **kw):
            it = iter(make(*a, **kw))

            def gen():
                while True:
                    t0 = time.perf_counter()
                    with torch.profiler.record_function("portbench.parse"):
                        try:
                            b = next(it)
                        except StopIteration:
                            return
                    spans.parse_s.append(time.perf_counter() - t0)
                    yield b
            return gen()
        return wrapped

    @contextlib.contextmanager
    def installed(self, profiler):
        """Wrap the program's functions for the duration of a sample."""
        from midas_tpu_torch.align import cuda_sw, pipeline
        from midas_tpu_torch.profile import checkpoint, device_steps
        from midas_tpu_torch.profile import genes as genes_mod
        from midas_tpu_torch.profile import snps as snps_mod
        from midas_tpu_torch.profile import species as species_mod

        p = _Patch()
        step_name = f"_{self.path}_step"
        step = getattr(profiler, step_name)

        def on_step_end():
            self.batches += 1
            self.last_step_end = time.perf_counter()
        p.set(profiler, step_name,
              self._labelled("portbench.step", step, on_step_end))
        save = checkpoint.save

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.checkpoint_save"):
                out = save(*a, **kw)
            self.checkpoint_s += time.perf_counter() - t0
            return out
        p.set(checkpoint, "save", timed_save)
        p.set(species_mod, "load_read_batches",
              self._timed_iter(species_mod.load_read_batches))
        for mod in (genes_mod, snps_mod):
            p.set(mod, "select_batches", self._timed_iter(mod.select_batches))
        fc = pipeline.find_candidates

        def find(*a, **kw):
            out = fc(*a, **kw)
            self._valid = out["valid"]
            return out
        p.set(pipeline, "find_candidates",
              self._events(self.seed_events, find, SEED))
        p.set(pipeline, "gather_windows_packed",
              self._events(self.seed_events, pipeline.gather_windows_packed,
                           SEED))
        p.set(device_steps, "paired_best_hit_device",
              self._events(self.pick_events,
                           device_steps.paired_best_hit_device, PAIR_PICK))
        launch = cuda_sw.banded_align_cuda

        def dp(query, qlens, ref_win, params, band_width=16, qpen=None,
               score_only=False):
            self._count_real(query, qlens, params, qpen, score_only)
            return launch(query, qlens, ref_win, params, band_width,
                          qpen=qpen, score_only=score_only)
        p.set(cuda_sw, "banded_align_cuda", self._events(self.dp_events, dp))
        for name in ("_finalize", "assign_and_normalize", "write_results"):
            if hasattr(profiler, name):
                p.set(profiler, name, self._labelled(
                    f"portbench.{name.strip('_')}", getattr(profiler, name)))
        try:
            yield self
        finally:
            p.undo()

    def _count_real(self, query, qlens, params, qpen, score_only):
        """Rows and pairs of a launch that hold a real candidate: pass-1
        launches (every candidate of a batch) by the candidates' valid
        flags, pass-2 launches (one row a read) by whether the read has
        any real candidate."""
        P, L = query.shape
        v = self._valid
        if v is not None and P == v.numel():
            real = v.reshape(-1)
        elif v is not None and P == v.shape[0]:
            real = v.any(dim=1)
        else:
            real = torch.ones(P, dtype=torch.bool, device=query.device)
        rows = torch.where(real, qlens.to(torch.int64).clamp(0, L), 0)
        key = (1 if score_only else 6, params.mode == "local",
               qpen is not None)
        acc = self.dp_real.setdefault(key, [0, 0])
        acc[0] = acc[0] + rows.sum()
        acc[1] = acc[1] + (rows > 0).sum()

    # -- readings --------------------------------------------------------
    @staticmethod
    def _ms(pairs) -> float:
        return sum(s.elapsed_time(e) for s, e in pairs)

    def summary(self, sample_end: float) -> Dict:
        if self.cuda:
            torch.cuda.synchronize()
        return dict(
            batches=self.batches,
            host_tail_s=(sample_end - self.last_step_end
                         if self.last_step_end is not None else None),
            checkpoint_s=self.checkpoint_s,
            parse_ms=[1e3 * s for s in self.parse_s],
            seed_span_ms=self._ms(self.seed_events) if self.cuda else None,
            pair_pick_span_ms=(self._ms(self.pick_events)
                               if self.cuda and self.pick_events else None),
            dp_event_ms=self._ms(self.dp_events) if self.cuda else None,
            dp_real={k: (int(v[0]), int(v[1])) for k, v in self.dp_real.items()},
        )


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def read_trace(path: str) -> Dict:
    """The device activity of a chrome trace written by torch.profiler:
    busy seconds (the union of kernel, copy and set intervals), the
    window (the first to the last event of any kind), the kernels' summed
    seconds by name, the device seconds of what was launched inside each
    of LABELS (by_label), and the longest idle gaps labelled with the
    innermost host event of the main thread that covers each gap's
    middle."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host, launches = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, end, e.get("name", ""), corr))
        elif cat in LAUNCH_CATS:
            launches.append((ts, e.get("tid"), corr))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((ts, end, e.get("name", ""), e.get("tid")))
    if not dev:
        return dict(busy_s=0.0, window_s=0.0, by_name={}, by_label={},
                    gaps=[])
    starts = [d[0] for d in dev] + [h[0] for h in host]
    ends = [d[1] for d in dev] + [h[1] for h in host]
    t0, t1 = min(starts), max(ends)
    dev.sort()
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > t0:
        gaps.append((t0, cur_s))
    for s, e, _n, _c in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))
    by_name = collections.Counter()
    for s, e, n, _c in dev:
        by_name[n] += (e - s) * 1e-6
    main_tid = _main_tid(host)
    main = sorted((h for h in host if h[3] == main_tid), key=lambda h: h[0])
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in gaps[:10]:
        mid = 0.5 * (s + e)
        cover = [h for h in main if h[0] <= mid <= h[1]]
        label = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                 else "host outside any torch op")
        labelled.append((label, (e - s) * 1e-6))
    return dict(busy_s=busy * 1e-6, window_s=(t1 - t0) * 1e-6,
                by_name=dict(by_name), by_label=_by_label(dev, host, launches),
                gaps=labelled)


def _by_label(dev, host, launches) -> Dict[str, float]:
    """Device seconds of the kernels, copies and sets whose launch (a
    runtime or driver call, tied to its device activity by correlation
    id) lies inside a range of one of LABELS on the launching thread."""
    owner = {}
    for label in LABELS:
        ranges = []     # (thread, start, end), nested and touching merged
        for r in sorted((str(h[3]), h[0], h[1]) for h in host
                        if h[2] == label):
            if ranges and ranges[-1][0] == r[0] and r[1] <= ranges[-1][2]:
                ranges[-1] = (r[0], ranges[-1][1], max(ranges[-1][2], r[2]))
            else:
                ranges.append(r)
        if not ranges:
            continue
        for ts, tid, corr in launches:
            i = bisect.bisect_right(ranges, (str(tid), ts, float("inf"))) - 1
            if corr is not None and i >= 0 and ranges[i][0] == str(tid) \
                    and ranges[i][1] <= ts <= ranges[i][2]:
                owner[corr] = label
    out = {}
    for s, e, _n, corr in dev:
        label = owner.get(corr)
        if label is not None:
            out[label] = out.get(label, 0.0) + (e - s) * 1e-6
    return out


def _main_tid(host):
    """The thread whose events say portbench.step (the consumer)."""
    for h in host:
        if h[2] == "portbench.step":
            return h[3]
    return host[0][3] if host else None


@contextlib.contextmanager
def profiled(out_dir: str, cuda: bool):
    """torch.profiler over the block (host ops, and device activity on
    the card); yields a dict that holds the chrome trace's path after."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    res = {}
    with profile(activities=acts) as prof:
        yield res
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    res["path"] = path
