"""Spans and counters inside midas_tpu_torch, on the clock of
torch.profiler's chrome trace.

Tracing is off unless a recording is open:

    from midas_tpu_torch import tracing

    with tracing.recording() as rec:
        profiler.run(paths)
    rec.write_jsonl("spans.jsonl")

Off, span() returns one shared no-op context (no clock read, no
torch.profiler range, no device operation) and count() returns at once;
call sites guard any device work a counter needs behind enabled().

On, a span records its name, its start and end in wall time and in the
thread's CPU time (time.thread_time_ns), its thread, its parent (the
innermost span open on the thread) and its sample, with its attrs; it
also opens a torch.profiler.record_function range of the same name, so
a running torch.profiler shows the span on its own timeline. A span
named profile.sample (each profiler's run) opens a sample: the spans
under it take its id, and a span opened under no sample takes the id of
the last sample opened (a writer called after run). A thread the work
hands off to takes its parent explicitly (under()).

Counters take host ints, or 0-dim tensors that are summed on their
device and read once, when the recording ends: a counter never
synchronises a batch. A module that keeps a collections.Counter of its
own (the DP kernel's launches, the readback routes) hands it to keep();
a recording reports each kept counter's change over it, under the name
it was kept by.

One clock: spans are timed by time.perf_counter_ns and reported in
nanoseconds since the Unix epoch, through the offset between the two
clocks taken once when the recording opens. That is the timebase of
torch.profiler's host events: a chrome trace it exports gives each
event's start in microseconds after its baseTimeNanoseconds, so
(start_ns - baseTimeNanoseconds) / 1e3 puts a span on the trace's
timeline, device activity included.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import torch

SAMPLE = "profile.sample"   # the root span of a profiler's run

_REC: Optional["Recording"] = None   # the open recording, if any
_LOCAL = threading.local()           # .stack: this thread's open spans
_KEPT: Dict[str, collections.Counter] = {}   # name -> a module's counter


def keep(name: str, counter: collections.Counter) -> None:
    """Report counter's change over every recording, as rec.kept[name]:
    a module's own tally, read where it is kept and not copied."""
    _KEPT[name] = counter


def enabled() -> bool:
    """Whether a recording is open."""
    return _REC is not None


class _NoSpan:
    """The span a closed recording hands out: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


def _stack() -> List:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "sample", "thread",
                 "t0", "t1", "c0", "c1", "_range")

    def __init__(self, rec: "Recording", name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec, stack = self.rec, _stack()
        up = stack[-1] if stack else None
        self.id = next(rec._ids)
        self.parent = up.id if up is not None else None
        if self.name == SAMPLE:
            self.sample = rec.last_sample = next(rec._samples)
        else:
            self.sample = up.sample if up is not None else rec.last_sample
        self.thread = threading.get_native_id()
        stack.append(self)
        # the clocks are read just before the torch.profiler range opens
        # and just after it closes: torch.profiler reads its own near the
        # start of the one call and the end of the other
        self._range = torch.profiler.record_function(self.name)
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        self.c1 = time.thread_time_ns()
        self._range = None
        _stack().remove(self)
        self.rec._spans.append(self)
        return False

    def set(self, **attrs) -> None:
        """Add attrs known only inside the span."""
        self.attrs.update(attrs)


class _Under:
    """This thread's spans nest under a span of another thread."""

    __slots__ = ("parent",)

    def __init__(self, parent: _Span):
        self.parent = parent

    def __enter__(self):
        _stack().append(self.parent)
        return self

    def __exit__(self, *exc):
        _stack().remove(self.parent)
        return False


def span(name: str, **attrs):
    """A context manager over one span (see the module's docstring)."""
    rec = _REC
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, attrs)


def traced(name: str, **attrs):
    """A decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with span(name, **attrs):
                return fn(*a, **kw)
        return inner
    return wrap


def current():
    """The innermost span open on this thread, or None (always None
    when no recording is open): what a thread the work hands off to
    takes as its parent."""
    if _REC is None:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def under(parent):
    """A context manager in which this thread's spans nest under parent,
    a span of another thread (from current()), and take its sample."""
    if _REC is None or parent is None:
        return NO_SPAN
    return _Under(parent)


def annotate(**attrs) -> None:
    """Add attrs to the innermost span open on this thread, if any."""
    if _REC is None:
        return
    stack = _stack()
    if stack:
        stack[-1].attrs.update(attrs)


def count(name: str, n) -> None:
    """Add n (a host int, or a 0-dim tensor summed on its device and
    read when the recording ends) to the counter name."""
    rec = _REC
    if rec is not None:
        rec._count(name, n)


class Recording:
    """What one recording() holds. While it is open, spans and counters
    accumulate; when it closes, spans (a list of dicts, by start),
    counters (name -> int, device sums read once), kept (name -> the
    change of each kept counter over the recording) and clock are
    filled in."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._samples = itertools.count(1)
        self.last_sample: Optional[int] = None
        self._spans: List[_Span] = []
        self._lock = threading.Lock()
        self._host: Dict[str, int] = collections.Counter()
        self._device: Dict = {}     # (name, device) -> 0-dim int64 tensor
        self._kept0 = {k: c.copy() for k, c in _KEPT.items()}
        # the smallest-gap pair of readings of the two clocks
        pairs = []
        for _ in range(5):
            a = time.perf_counter_ns()
            w = time.time_ns()
            b = time.perf_counter_ns()
            pairs.append((b - a, w - (a + b) // 2))
        self.offset_ns = min(pairs)[1]
        self.spans: List[Dict] = []
        self.counters: Dict[str, int] = {}
        self.kept: Dict[str, Dict[str, int]] = {}
        self.clock: Dict = {}

    def _count(self, name: str, n) -> None:
        with self._lock:
            if isinstance(n, torch.Tensor):
                key = (name, n.device)
                n = n.to(torch.int64)
                acc = self._device.get(key)
                self._device[key] = n if acc is None else acc + n
            else:
                self._host[name] += int(n)

    def _close(self) -> None:
        counters = collections.Counter(self._host)
        for (name, _dev), t in self._device.items():
            counters[name] += int(t)
        self.counters = dict(counters)
        # a module imported while the recording was open kept from zero
        self.kept = {k: dict(c - self._kept0.get(k, collections.Counter()))
                     for k, c in sorted(_KEPT.items())}
        off = self.offset_ns
        reads = collections.Counter()
        for s in self._spans:
            if s.name == "profile.step" and "reads" in s.attrs:
                reads[s.sample] += s.attrs["reads"]
        out = []
        for s in sorted(self._spans, key=lambda s: s.t0):
            attrs = dict(s.attrs)
            if s.name == SAMPLE:
                attrs.setdefault("reads", reads[s.sample])
            out.append(dict(name=s.name, id=s.id, parent=s.parent,
                            sample=s.sample, thread=s.thread,
                            start_ns=s.t0 + off, end_ns=s.t1 + off,
                            cpu_start_ns=s.c0, cpu_end_ns=s.c1,
                            attrs=attrs))
        self.spans = out
        self.clock = dict(unit="ns", epoch="unix", offset_ns=off,
                          note="start_ns and end_ns share torch.profiler's "
                               "host timebase: chrome-trace ts = (start_ns "
                               "- baseTimeNanoseconds) / 1e3 us")
        self._spans, self._device = [], {}

    # -- readings --------------------------------------------------------
    def named(self, name: str) -> List[Dict]:
        """The recorded spans of one name, by start."""
        return [s for s in self.spans if s["name"] == name]

    def seconds(self, name: str) -> float:
        """Summed wall seconds of the spans of one name."""
        return 1e-9 * sum(s["end_ns"] - s["start_ns"]
                          for s in self.named(name))

    def write_jsonl(self, path: str) -> None:
        """The records as JSON lines: the clock, each span, each counter,
        and each kept counter's change (kind: the name it was kept by)."""
        lines = ([dict(kind="clock", **self.clock)]
                 + [dict(kind="span", **s) for s in self.spans]
                 + [dict(kind="counter", name=k, value=v)
                    for k, v in sorted(self.counters.items())]
                 + [dict(kind=k, counts=c) for k, c in self.kept.items()])
        with open(path, "w") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")


@contextlib.contextmanager
def recording():
    """Open a recording (one at a time) and yield it; its records are
    filled in when the block ends."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a tracing recording is already open")
    rec = Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec._close()
