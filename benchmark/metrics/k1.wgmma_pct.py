"""The share of K1 launches whose products ran on the tensor cores
(``wgmma`` through the shared-memory ring), in %: the ``tensor_core``
attributes over the number of the program's ``k1.launch`` spans
(``mockingbird_tpu_torch/tracing.py``) inside the window, recorded under the
traced run's profiler session. None outside an sv2tts cell with a WaveRNN
vocoder, and where a launch span lacks the attribute (a program that does
not record it)."""


def read(run):
    if run.cfg["family"] != "sv2tts" or run.cfg["vocoder"]["arch"] != "wavernn":
        return None
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    attrs = [s.attrs or {} for s in tracing.within(tracing.spans(), window[0][3], window[0][4])
             if s.name == "k1.launch"]
    if not attrs or any("tensor_core" not in a for a in attrs):
        return None
    return 100.0 * sum(a["tensor_core"] for a in attrs) / len(attrs)
