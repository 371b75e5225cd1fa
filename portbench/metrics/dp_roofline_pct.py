"""The banded-DP kernel's share of its roofline over a sample: the least
time its launches need for the pairs that hold a real candidate
(peaks.dp_least_seconds, against the H100's published float32 and HBM
peaks) over the kernel's device time in the profiler's trace; where the
trace holds no kernels, over the time between CUDA events around the
launches."""

from portbench.peaks import dp_least_seconds

KERNELS = ("packed_sw_kernel", "banded_sw_kernel")


def read(ctx):
    real = ctx["spans"]["dp_real"]
    if not real:
        return None
    least = sum(dp_least_seconds(rows, pairs, n_stats, local, qpen)
                for (n_stats, local, qpen), (rows, pairs) in real.items())
    kernel_s = sum(s for name, s in ctx["trace"]["by_name"].items()
                   if any(k in name for k in KERNELS))
    if not kernel_s:
        ev = ctx["spans"]["dp_event_ms"]
        kernel_s = ev / 1e3 if ev else 0.0
    return 100.0 * least / kernel_s if kernel_s else None
