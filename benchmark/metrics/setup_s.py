"""Seconds from the process's start to the first measured call."""


def read(run):
    return run.setup_s
