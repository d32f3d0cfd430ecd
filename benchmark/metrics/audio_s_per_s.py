"""Seconds of audio per wall second: the samples of every array
``tts_batch`` returned in the window over the sample rate, divided by the
window (the start of the first call to the end of the last)."""


def read(run):
    return run.audio_s / run.window_s
