"""Milliseconds a batch between CUDA events recorded on the stream just
before and after paired_best_hit_device (the mate-pair pick): how long
the pick holds the stream, which on a card the host starves is the
host's dispatch of its kernels (pair_pick_device_ms reads their device
time); nothing for single-end samples."""


def read(ctx):
    s = ctx["spans"]
    if s["pair_pick_span_ms"] is None or not s["batches"]:
        return None
    return s["pair_pick_span_ms"] / s["batches"]
