"""Share of the traced sample with no kernel, copy or set on the card,
from torch.profiler's device activity (the union of their intervals)."""


def read(ctx):
    t = ctx["trace"]
    if not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
