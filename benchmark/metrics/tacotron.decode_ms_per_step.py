"""Milliseconds per decoder step: the spans of the synthesizer calls
(``synthesize_mels_device`` or ``synthesize_spectrograms``, each ended by
a synchronise) over their decoder steps (frames / r)."""


def read(run):
    if run.cfg["family"] != "sv2tts":
        return None
    t = run.span_s("tacotron")
    return 1e3 * t / run.decode_steps() if t > 0 else None
