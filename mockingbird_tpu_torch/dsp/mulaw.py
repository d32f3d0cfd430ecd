"""Mu-law companding and label quantisation, in numpy and in torch.

Port of ``mockingbird_tpu/dsp/mulaw.py``: the numpy helpers the WaveRNN
vocoder's host-side finalisation uses, the 8-bit mu-law encoding the GAN
vocoder applies on the device (``encode_mulaw8_device``, one byte per sample
across the device-to-host copy) and its host-side lookup-table decode.
"""
from __future__ import annotations

import numpy as np
import torch


def encode_mu_law(x, mu: int):
    """x in [-1, 1] → integer class in [0, mu); a torch tensor stays on its
    device, anything else goes through numpy."""
    mu = mu - 1
    if isinstance(x, torch.Tensor):
        fx = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / float(np.log1p(mu))
        return torch.floor((fx + 1) / 2 * mu + 0.5).to(torch.int32)
    fx = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.floor((fx + 1) / 2 * mu + 0.5).astype(np.int32)


def decode_mu_law(y, mu: int, from_labels: bool = True):
    """Inverse companding; ``from_labels`` maps class index back to [-1,1]."""
    mu = mu - 1
    if from_labels:
        y = label_2_float(y, int(np.log2(mu + 1)))
    return np.sign(y) / mu * ((1 + mu) ** np.abs(y) - 1)


def label_2_float(x, bits: int):
    return 2 * x / (2**bits - 1.0) - 1.0


def float_2_label(x, bits: int):
    x = np.clip(x, -1.0, 1.0)
    return (x + 1.0) * (2**bits - 1) / 2


def encode_mulaw8_device(wav: torch.Tensor) -> torch.Tensor:
    """float wav in [-1, 1] → 8-bit mu-law bytes (uint8) on the wav's
    device: one byte per sample instead of int16's two across the
    device-to-host copy. Standard 256-level mu-law companding; decode on the
    host with ``decode_mulaw8_to_int16``."""
    return encode_mu_law(torch.clamp(wav, -1.0, 1.0), 256).to(torch.uint8)


_MULAW8_LUT = None


def decode_mulaw8_to_int16(u8: np.ndarray) -> np.ndarray:
    """Host-side inverse of ``encode_mulaw8_device``: uint8 labels → int16
    PCM through a cached 256-entry lookup table."""
    global _MULAW8_LUT
    if _MULAW8_LUT is None:
        labels = np.arange(256, dtype=np.int32)
        _MULAW8_LUT = np.round(
            np.clip(decode_mu_law(labels, 256), -1.0, 1.0) * 32767.0).astype(np.int16)
    return _MULAW8_LUT[np.asarray(u8, np.uint8)]
