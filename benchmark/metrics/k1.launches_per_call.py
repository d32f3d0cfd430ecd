"""Sampler launches per call, from the port's counter
``wavernn_sample.launches`` read before and after the window (the sv2tts
family's ``k1_launches`` counter)."""


def read(run):
    if run.cfg["family"] != "sv2tts" or run.cfg["vocoder"]["arch"] != "wavernn":
        return None
    launches = run.counters.get("k1_launches")
    return launches / len(run.calls) if launches else None
