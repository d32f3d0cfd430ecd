"""The model FLOP of every call in the window (``benchmark/flops``:
Tacotron's encoder and decoder steps, and the HiFi-GAN generator's
convolutions or WaveRNN's upsampler and sampler) over the window's time,
as a share of the card's bf16 dense peak. Float32 work is counted against
the same peak."""
from benchmark import flops


def read(run):
    return 100.0 * run.model_flops() / run.window_s / flops.PEAK_BF16_FLOPS
