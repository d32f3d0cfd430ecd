"""Sampler launches per call, from the port's counter
``wavernn_sample.launches`` read before and after the window."""


def read(run):
    if run.cfg["vocoder"]["arch"] != "wavernn" or not run.k1_launches:
        return None
    return run.k1_launches / len(run.calls)
