"""The VITS decoder's convolution FLOP for the window's calls
(``benchmark/flops/vits.py`` ``decoder``) over the benchmark's spans of
its calls (each ended by a synchronise), as a share of the card's bf16
dense peak: the yardstick of ``hifigan.peak_pct``, though the decoder runs
in float32 (TF32 convolutions)."""
from benchmark import flops


def read(run):
    if run.cfg.get("family") != "vits":
        return None
    t = run.span_s("decoder")
    if t <= 0:
        return None
    return 100.0 * run.family.decoder_flops(run) / t / flops.PEAK_BF16_FLOPS
