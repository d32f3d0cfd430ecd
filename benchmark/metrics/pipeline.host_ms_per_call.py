"""Milliseconds of ``tts_batch``'s own host work a call: the program's
``pipeline.embed``, ``tacotron.text``, ``tacotron.to_host`` and
``pipeline.unpack`` spans (``mockingbird_tpu_torch/tracing.py``), recorded
under the traced run's profiler session, summed inside the window over the
window's ``tts_batch`` spans."""

HOST = ("pipeline.embed", "tacotron.text", "tacotron.to_host", "pipeline.unpack")


def read(run):
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    found = tracing.within(tracing.spans(), window[0][3], window[0][4])
    calls = sum(1 for s in found if s.name == "tts_batch")
    if not calls:
        return None
    host = sum(s.duration_ns for s in found if s.name in HOST)
    return host / calls / 1e6
