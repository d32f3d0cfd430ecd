"""The share of the HiFi-GAN generator's convolutions followed by the
port's hand-written epilogue (``ops/conv_epilogue.py``), in %: the
``fused_convs`` over the ``convs`` attributes of the program's
``hifigan.vocode`` spans (``mockingbird_tpu_torch/tracing.py``), each
summed over the window's calls, recorded under the traced run's profiler
session. None outside an sv2tts cell with a HiFi-GAN vocoder, and where a
vocode span lacks the attributes (a program that does not count them)."""


def read(run):
    if run.cfg["family"] != "sv2tts" or run.cfg["vocoder"]["arch"] != "hifigan":
        return None
    try:
        from mockingbird_tpu_torch import tracing
    except ImportError:
        return None
    window = [s for s in run.spans if s[0] == "window"]
    if not window:
        return None
    attrs = [s.attrs or {} for s in tracing.within(tracing.spans(), window[0][3], window[0][4])
             if s.name == "hifigan.vocode"]
    if not attrs or any("convs" not in a or "fused_convs" not in a for a in attrs):
        return None
    convs = sum(a["convs"] for a in attrs)
    return 100.0 * sum(a["fused_convs"] for a in attrs) / convs if convs else None
