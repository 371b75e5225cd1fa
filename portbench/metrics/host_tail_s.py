"""Seconds of a sample from the last return of the profiler's per-batch
step to the sample's outputs written: the end-of-stream readback, the
final save, the host finalize and the writers."""


def read(ctx):
    return ctx["spans"]["host_tail_s"]
