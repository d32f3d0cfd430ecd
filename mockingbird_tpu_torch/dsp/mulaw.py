"""Mu-law decoding + label dequantisation (numpy), as the WaveRNN vocoder's
host-side finalisation uses them. Port of the numpy branch of
``mockingbird_tpu/dsp/mulaw.py``."""
from __future__ import annotations

import numpy as np


def decode_mu_law(y, mu: int, from_labels: bool = True):
    """Inverse companding; ``from_labels`` maps class index back to [-1,1]."""
    mu = mu - 1
    if from_labels:
        y = label_2_float(y, int(np.log2(mu + 1)))
    return np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)


def label_2_float(x, bits: int):
    return 2 * x / (2**bits - 1.0) - 1.0
