"""K1's share of its roofline: the sum over the window's sampler launches
of each launch's bound (the larger of its FLOP over the bf16 peak and its
bytes over the HBM bandwidth, ``benchmark/flops``) over the device time
of the kernel ``wavernn_sample_kernel`` in the traced window."""
from benchmark import flops
from benchmark.harness import trace


def read(run):
    if (run.trace is None or run.cfg["family"] != "sv2tts"
            or run.cfg["vocoder"]["arch"] != "wavernn"):
        return None
    t = trace.kernel_seconds(run.trace, "wavernn_sample_kernel")
    if t <= 0:
        return None
    bound = sum(flops.k1(run.cfg["vocoder"], lab.shape[0], lab.shape[1])[2]
                for c in run.calls for _, lab in c.launches)
    return 100.0 * bound / t
