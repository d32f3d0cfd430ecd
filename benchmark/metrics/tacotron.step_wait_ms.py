"""Milliseconds a decoder step holds the host blocked on the device: the
program's ``tacotron.step_wait`` spans (the stop rule's read of the stop
flags, ``mockingbird_tpu_torch/tracing.py``), recorded under the traced
run's profiler session, summed inside the window over the window's
``tacotron.step`` spans."""


def read(run):
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    found = tracing.within(tracing.spans(), window[0][3], window[0][4])
    steps = sum(1 for s in found if s.name == "tacotron.step")
    if not steps:
        return None
    wait = sum(s.duration_ns for s in found if s.name == "tacotron.step_wait")
    return wait / steps / 1e6
