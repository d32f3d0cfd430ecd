"""Milliseconds a call in VITS's text encoder, duration predictor and
flows: the benchmark's ``front`` spans (each ended by a synchronise) over
the window's calls."""


def read(run):
    if run.cfg.get("family") != "vits":
        return None
    t = run.span_s("front")
    return 1e3 * t / len(run.calls) if t > 0 and run.calls else None
