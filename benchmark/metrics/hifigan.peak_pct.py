"""The HiFi-GAN generator's convolution FLOP for the window's calls over
the spans of its ``vocode_device`` calls (each ended by a synchronise), as
a share of the card's bf16 dense peak."""
from benchmark import flops
from benchmark.harness import check


def read(run):
    if run.cfg["family"] != "sv2tts":
        return None
    voc = run.cfg["vocoder"]
    t = run.span_s("vocoder")
    if voc["arch"] != "hifigan" or t <= 0:
        return None
    frames = check.bucket(run.mix["tts_batch"]["steps"], 200)
    work = sum(flops.hifigan(voc, len(c.texts), frames) for c in run.calls)
    return 100.0 * work / t / flops.PEAK_BF16_FLOPS
