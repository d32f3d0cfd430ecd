"""Fre-GAN generator and the Haar DWT.

Port of the generator half of ``mockingbird_tpu/models/vocoder/fregan.py``:
a HiFi-GAN-style generator with ``top_k`` mel-conditioning levels (from
``cond_level = len(rates) - top_k`` on, a transposed conv of the running mel
branch is added to x) and a nearest-upsample residual pyramid of 1×1 convs
(``res_output_*``) whose running ``output`` feeds the last layer.
Channels-first inside, (B, T, 80) → (B, T·hop) at the boundary. The DWT
discriminators come with Fre-GAN's trainer, which is not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import Config
from ..layers import ConvTranspose1d
from .hifigan import LRELU_SLOPE, ResBlock1, upsample_valid, wn_conv

_SQRT2 = math.sqrt(2.0)


def fregan_config() -> Config:
    return Config(
        resblock="1",
        upsample_rates=[5, 5, 2, 2, 2],
        upsample_kernel_sizes=[10, 10, 4, 4, 4],
        upsample_initial_channel=512,
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5, 7], [1, 3, 5, 7], [1, 3, 5, 7]],
        num_mels=80,
        segment_size=6400,
        n_fft=1024,
        hop_size=200,
        win_size=800,
        sample_rate=16000,
        fmin=0.0,
        fmax=7600.0,
        fmax_for_loss=None,
        learning_rate=2e-4,
        adam_b1=0.8,
        adam_b2=0.99,
        lr_decay=0.999,
        batch_size=16,
        disc_start_step=0,
        top_k=4,
        use_stft_loss=False,
        lambda_aux=45.0,
    )


def dwt_haar(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level Haar DWT over the last axis: (..., T) → (low, high), each
    (..., T//2); an odd last sample is dropped."""
    t = x.shape[-1] - x.shape[-1] % 2
    pairs = x[..., :t].reshape(*x.shape[:-1], t // 2, 2)
    return ((pairs[..., 0] + pairs[..., 1]) / _SQRT2,
            (pairs[..., 0] - pairs[..., 1]) / _SQRT2)


class FreGanResBlock(ResBlock1):
    """ResBlock1 with four dilations."""

    def __init__(self, channels: int, kernel: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5, 7)):
        super().__init__(channels, kernel, dilations)


class FreGanGenerator(nn.Module):
    """mel (B, T, 80) → wav (B, T·prod(rates)) in [-1, 1]."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        rates, kernels = list(c.upsample_rates), list(c.upsample_kernel_sizes)
        self.cond_level = len(rates) - c.top_k
        ch0 = c.upsample_initial_channel
        self.conv_pre = wn_conv(c.num_mels, ch0, 7)
        mel_ch = c.num_mels
        for i, (u, k) in enumerate(zip(rates, kernels)):
            ch_in, ch = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            n = i - self.cond_level
            if n >= 0:
                # the mel branch upsampled by the previous level's rate
                self.add_module(f"cond_up_{n}", ConvTranspose1d(mel_ch, ch_in, kernels[i - 1],
                                                                rates[i - 1]))
                mel_ch = ch_in
            if n > 0:
                self.add_module(f"res_output_{n - 1}", wn_conv(ch_in, ch, 1))
            self.add_module(f"ups_{i}", ConvTranspose1d(ch_in, ch, k, u))
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", FreGanResBlock(ch, rk, tuple(rd)))
        self.conv_post = wn_conv(ch0 // 2 ** len(rates), 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        rates = list(c.upsample_rates)
        n_k = len(c.resblock_kernel_sizes)
        mel = mel.transpose(1, 2)                                   # (B, M, T)
        x = self.conv_pre(mel)
        output = None
        for i, u in enumerate(rates):
            n = i - self.cond_level
            if n >= 0:
                mel = upsample_valid(getattr(self, f"cond_up_{n}"), mel, rates[i - 1])
                x = x + mel
            if n > 0:
                src = x if output is None else output
                output = getattr(self, f"res_output_{n - 1}")(src.repeat_interleave(u, dim=-1))
            x = upsample_valid(getattr(self, f"ups_{i}"), F.leaky_relu(x, LRELU_SLOPE), u)
            xs = None
            for j in range(n_k):
                y = getattr(self, f"resblock_{i}_{j}")(x)
                xs = y if xs is None else xs + y
            x = xs / n_k
            if output is not None:
                output = output + x
        # flax's default slope (0.01), as in HiFi-GAN's last layer
        x = self.conv_post(F.leaky_relu(output))
        return torch.tanh(x)[:, 0]
