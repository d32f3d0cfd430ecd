"""Milliseconds of host output stage a K1 launch: the program's
``wavernn.finalize`` spans (crossfade, mu-law, de-emphasis and fade of a
launch's utterances, ``mockingbird_tpu_torch/tracing.py``), recorded under
the traced run's profiler session, summed inside the window over the
window's ``k1.launch`` spans."""


def read(run):
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    found = tracing.within(tracing.spans(), window[0][3], window[0][4])
    launches = sum(1 for s in found if s.name == "k1.launch")
    if not launches:
        return None
    host = sum(s.duration_ns for s in found if s.name == "wavernn.finalize")
    return host / launches / 1e6
