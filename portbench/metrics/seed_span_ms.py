"""Milliseconds a batch between CUDA events recorded on the stream just
before and after find_candidates and gather_windows_packed (both
passes' gathers): how long seeding holds the stream. On a card the host
starves, this is the host's dispatch of seeding's kernels, not their
device time, which seed_device_ms reads."""


def read(ctx):
    s = ctx["spans"]
    if s["seed_span_ms"] is None or not s["batches"]:
        return None
    return s["seed_span_ms"] / s["batches"]
