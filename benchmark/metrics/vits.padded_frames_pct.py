"""The share of the frames VITS decoded that no text returned, in %:
100 · (decoded − returned) / decoded, from the port's counters
``frames_decoded`` (``max_frames`` a text) and ``frames_returned``
(Σ ``y_lengths``) of ``models/vits/inference.py``, read before and after
the window (the vits family's ``vits_frames_*`` counters). None in a port
without them."""


def read(run):
    if run.cfg.get("family") != "vits":
        return None
    decoded = run.counters.get("vits_frames_decoded")
    returned = run.counters.get("vits_frames_returned")
    if not decoded or returned is None:
        return None
    return 100.0 * (decoded - returned) / decoded
