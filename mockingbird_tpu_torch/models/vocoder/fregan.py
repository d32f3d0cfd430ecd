"""Fre-GAN generator and the Haar DWT.

Port of the generator half of ``mockingbird_tpu/models/vocoder/fregan.py``:
a HiFi-GAN-style generator with ``top_k`` mel-conditioning levels (from
``cond_level = len(rates) - top_k`` on, a transposed conv of the running mel
branch is added to x) and a nearest-upsample residual pyramid of 1×1 convs
(``res_output_*``) whose running ``output`` feeds the last layer.
Channels-first inside, (B, T, 80) → (B, T·hop) at the boundary.

Then the ResWise discriminators that ``gan_train`` trains with Fre-GAN:
period and scale discriminators into which Haar-DWT views of the wav are
injected, concatenated along time (flax's NHWC/NLC axis 1, dim 2 here).
Their convolutions carry flax's automatic names (``Conv_<i>``, in the
order the JAX modules create them) as ``flax_name``, so ``weights.py``
finds their leaves.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import Config
from ..layers import Conv2d, ConvTranspose1d
from .hifigan import (LRELU_SLOPE, DiscriminatorS, ResBlock1, collect,
                      real_and_generated, upsample_valid, wn_conv)

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


def flax_named(conv: nn.Module, name: str) -> nn.Module:
    """``conv`` tagged with the automatic name flax gives it."""
    conv.flax_name = name
    return conv


def _stack_dwt(conv: nn.Module, bands) -> torch.Tensor:
    """A 1×1 conv over the DWT bands stacked as channels → (B, T')."""
    return conv(torch.stack(bands, 1))[:, 0]


def _dwt_levels(x: torch.Tensor):
    """(level-1 bands [lo, hi], level-2 bands [lo·lo, lo·hi, hi·lo, hi·hi])."""
    lo1, hi1 = dwt_haar(x)
    return [lo1, hi1], [*dwt_haar(lo1), *dwt_haar(hi1)]


class FreGanDiscriminatorP(nn.Module):
    """Period discriminator; three DWT levels of the wav, each mixed by a
    1×1 conv, folded like the wav and projected, are concatenated after the
    first three convs."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = ((2, 2), (0, 0))
        for i, n in enumerate((2, 4, 8)):
            self.add_module(f"dwt_conv{i + 1}", flax_named(wn_conv(n, 1, 1), f"Conv_{i}"))
        for i, ch in enumerate((32, 128, 512)):
            self.add_module(f"dwt_proj{i + 1}", flax_named(
                Conv2d(1, ch, (kernel_size, 1), (stride, 1), pad), f"Conv_{i + 3}"))
        chs = [(1, 32, stride), (32, 128, stride), (128, 512, stride), (512, 1024, stride),
               (1024, 1024, 1)]
        for i, (c_in, c_out, st) in enumerate(chs):
            self.add_module(f"convs_{i}", flax_named(
                Conv2d(c_in, c_out, (kernel_size, 1), (st, 1), pad), f"Conv_{i + 6}"))
        self.conv_post = flax_named(Conv2d(1024, 1, (3, 1), (1, 1), ((1, 1), (0, 0))),
                                    "Conv_11")

    def _fold(self, sig: torch.Tensor) -> torch.Tensor:
        """(B, T) reflect-padded to a multiple of the period → (B, 1, T/p, p)."""
        b, t = sig.shape
        p = self.period
        if t % p:
            sig = F.pad(sig[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = sig.shape[1]
        return sig.reshape(b, 1, t // p, p)

    def forward(self, x):
        lvl1, lvl2 = _dwt_levels(x)
        lvl3 = [band for s in lvl2 for band in dwt_haar(s)]
        inject = [getattr(self, f"dwt_proj{i + 1}")(
                      self._fold(_stack_dwt(getattr(self, f"dwt_conv{i + 1}"), bands)))
                  for i, bands in enumerate((lvl1, lvl2, lvl3))]
        xx = self._fold(x)
        fmap = []
        for i in range(5):
            xx = F.leaky_relu(getattr(self, f"convs_{i}")(xx), LRELU_SLOPE)
            fmap.append(xx)
            if i < 3:
                xx = torch.cat([xx, inject[i]], dim=2)
        xx = self.conv_post(xx)
        fmap.append(xx)
        return xx.reshape(x.shape[0], -1), fmap


class FreGanDiscriminatorS(DiscriminatorS):
    """Scale discriminator; the DWT levels of the wav, each through a conv
    of 128 channels (the second strided by 2), are concatenated after the
    first two convs."""

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__(use_spectral_norm)
        self.dwt_conv1 = flax_named(wn_conv(2, 128, 15), "Conv_0")
        self.dwt_conv2 = flax_named(wn_conv(4, 128, 41, stride=2), "Conv_1")
        for i in range(len(self.SPEC)):
            conv = getattr(self, f"convs_{i}")
            flax_named(conv.layer if use_spectral_norm else conv, f"Conv_{i + 2}")
        flax_named(self.conv_post.layer if use_spectral_norm else self.conv_post, "Conv_9")

    def forward(self, x, train: bool = False):
        lvl1, lvl2 = _dwt_levels(x)
        inject = [self.dwt_conv1(torch.stack(lvl1, 1)), self.dwt_conv2(torch.stack(lvl2, 1))]
        xx = x[:, None]
        fmap = []
        for i in range(len(self.SPEC)):
            xx = F.leaky_relu(self.layer(f"convs_{i}", xx, train), LRELU_SLOPE)
            fmap.append(xx)
            if i < 2:
                xx = torch.cat([xx, inject[i]], dim=2)
        xx = self.layer("conv_post", xx, train)
        fmap.append(xx)
        return xx.reshape(x.shape[0], -1), fmap


class ResWiseMultiPeriodDiscriminator(nn.Module):
    periods = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        for p in self.periods:
            self.add_module(f"disc_{p}", FreGanDiscriminatorP(p))

    def forward(self, y, y_hat):
        return collect(real_and_generated(getattr(self, f"disc_{p}"), y, y_hat)
                       for p in self.periods)


class ResWiseMultiScaleDiscriminator(nn.Module):
    """Three scale discriminators, the first spectral-normed; the second and
    third see the wav's DWT levels 1 and 2 mixed down by 1×1 convs, one
    pair of convs shared by the real and the generated wav."""

    def __init__(self):
        super().__init__()
        self.dwt_conv1 = flax_named(wn_conv(2, 1, 1), "Conv_0")
        self.dwt_conv2 = flax_named(wn_conv(4, 1, 1), "Conv_1")
        for i in range(3):
            self.add_module(f"disc_{i}", FreGanDiscriminatorS(use_spectral_norm=i == 0))

    def forward(self, y, y_hat, train: bool = False):
        b = y.shape[0]
        both = torch.cat([y, y_hat.to(y.dtype)])
        lvl1, lvl2 = _dwt_levels(both)
        scales = (both, _stack_dwt(self.dwt_conv1, lvl1), _stack_dwt(self.dwt_conv2, lvl2))
        return collect(real_and_generated(getattr(self, f"disc_{i}"), s[:b], s[b:], train)
                       for i, s in enumerate(scales))


class FreGanDiscriminators(nn.Module):
    """ResWise MPD + MSD in one call: ``(y, y_hat, train)`` → (mpd, msd)."""

    def __init__(self):
        super().__init__()
        self.mpd = ResWiseMultiPeriodDiscriminator()
        self.msd = ResWiseMultiScaleDiscriminator()

    def forward(self, y, y_hat, train: bool = False):
        return self.mpd(y, y_hat), self.msd(y, y_hat, train)
