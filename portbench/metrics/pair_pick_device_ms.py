"""Device milliseconds a batch of the kernels, copies and sets launched
inside paired_best_hit_device (the label portbench.pair_pick), from
torch.profiler's trace by correlation id; nothing for single-end
samples."""

from portbench.trace import PAIR_PICK


def read(ctx):
    s = ctx["trace"]["by_label"].get(PAIR_PICK)
    if not s or not ctx["spans"]["batches"]:
        return None
    return 1e3 * s / ctx["spans"]["batches"]
