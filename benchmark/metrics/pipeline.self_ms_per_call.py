"""Milliseconds per call spent in ``tts_batch`` outside its synthesizer
and vocoder calls (text chunks, embedding lookup and tiling, the copy to
the host, trimming, 16-bit conversion), from the traced run's spans."""


def read(run):
    if not run.spans or run.cfg["family"] != "sv2tts":
        return None
    own = run.span_s("call") - run.span_s("tacotron") - run.span_s("vocoder")
    return 1e3 * own / len(run.calls)
