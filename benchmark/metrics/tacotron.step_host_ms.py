"""Milliseconds of host time a decoder step, its wait on the device left
out: the mean self time of the program's ``tacotron.step`` spans (the step
less its ``tacotron.step_wait``, ``mockingbird_tpu_torch/tracing.py``),
recorded under the traced run's profiler session, over the steps inside
the window. The steps the spans count must equal the ``steps_run`` of the
window's ``tacotron.decode`` spans (else None: spans were lost)."""


def read(run):
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    found = tracing.within(tracing.spans(), window[0][3], window[0][4])
    steps = [s for s in found if s.name == "tacotron.step"]
    steps_run = sum((s.attrs or {}).get("steps_run", 0)
                    for s in found if s.name == "tacotron.decode")
    if not steps or len(steps) != steps_run:
        return None
    own = tracing.self_ns(found)
    return sum(own[s.id] for s in steps) / len(steps) / 1e6
