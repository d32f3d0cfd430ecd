"""Milliseconds of ``tts_batch``'s own host work a VITS call: the
program's ``pipeline.embed``, ``vits.text`` and ``pipeline.unpack`` spans
(``mockingbird_tpu_torch/tracing.py``), recorded under the traced run's
profiler session, summed inside the window over the window's
``tts_batch`` spans. None in a port without the ``vits.text`` span."""

HOST = ("pipeline.embed", "vits.text", "pipeline.unpack")


def read(run):
    if run.cfg.get("family") != "vits":
        return None
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    found = tracing.within(tracing.spans(), window[0][3], window[0][4])
    calls = sum(1 for s in found if s.name == "tts_batch")
    if not calls or not any(s.name == "vits.text" for s in found):
        return None
    host = sum(s.duration_ns for s in found if s.name in HOST)
    return host / calls / 1e6
