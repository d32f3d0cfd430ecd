"""The share of the window's decoder steps replayed from a captured CUDA
graph, in %: the ``graphed`` over the ``steps_run`` attributes of the
program's ``tacotron.decode`` spans (``mockingbird_tpu_torch/tracing.py``),
each summed over the decodes inside the window, recorded under the traced
run's profiler session. None where a decode span has no ``graphed`` (a
program that does not count it)."""


def read(run):
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    attrs = [s.attrs or {} for s in tracing.within(tracing.spans(), window[0][3], window[0][4])
             if s.name == "tacotron.decode"]
    steps = sum(a.get("steps_run", 0) for a in attrs)
    if not steps or any("graphed" not in a for a in attrs):
        return None
    return 100.0 * sum(a["graphed"] for a in attrs) / steps
