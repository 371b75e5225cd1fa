"""Device milliseconds a batch of the kernels, copies and sets launched
inside find_candidates and gather_windows_packed (the label
portbench.seed), from torch.profiler's trace: each launch is tied to its
device activity by its correlation id."""

from portbench.trace import SEED


def read(ctx):
    s = ctx["trace"]["by_label"].get(SEED)
    if not s or not ctx["spans"]["batches"]:
        return None
    return 1e3 * s / ctx["spans"]["batches"]
