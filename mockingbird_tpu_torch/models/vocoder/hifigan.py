"""HiFi-GAN pieces that VITS uses: residual blocks and the period/scale
discriminators.

Port of the parts of ``mockingbird_tpu/models/vocoder/hifigan.py`` the VITS
decoder and discriminator are built from. They run channels-first (B, C, T)
inside; a weight-normed conv is ``layers.Conv1d(weight_norm=True)`` with the
flax layout's ``<name>_conv`` kernel and ``<name>`` gain. The HiFi-GAN
``Generator`` and ``GanVocoder`` come with their own slice.
"""
from __future__ import annotations

from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv1d, Conv2d

LRELU_SLOPE = 0.1


def wn_conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> Conv1d:
    """Weight-normed flax ``nn.Conv`` with SAME padding, channels-first."""
    return Conv1d(in_ch, out_ch, kernel, stride=stride, dilation=dilation, groups=groups,
                  weight_norm=True, time_major=False)


class ResBlock1(nn.Module):
    """MRF block: 3×(dilated conv + plain conv) with residuals."""

    def __init__(self, channels: int, kernel: int = 3, dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", wn_conv(channels, channels, kernel, dilation=d))
            self.add_module(f"convs2_{i}", wn_conv(channels, channels, kernel))

    def forward(self, x):
        for i in range(self.n):
            xt = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            xt = getattr(self, f"convs2_{i}")(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel: int = 3, dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs_{i}", wn_conv(channels, channels, kernel, dilation=d))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"convs_{i}")(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class DiscriminatorP(nn.Module):
    """Period discriminator: the wav reflect-padded to a multiple of the
    period and folded into (T/p, p), then 2D convs. flax runs NHWC, this
    NCHW: feature maps are (B, C, T/p, p), the score is flattened in the
    same (T/p, p) order."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = ((2, 2), (0, 0))
        chs = [1, 32, 128, 512, 1024]
        for i in range(4):
            self.add_module(f"convs_{i}", Conv2d(chs[i], chs[i + 1], (kernel_size, 1),
                                                 (stride, 1), pad))
        self.convs_4 = Conv2d(1024, 1024, (kernel_size, 1), (1, 1), pad)
        self.conv_post = Conv2d(1024, 1, (3, 1), (1, 1), ((1, 1), (0, 0)))

    def forward(self, x):
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[1]
        x = x.reshape(b, 1, t // p, p)
        fmap = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided 1D convs (flax SAME padding,
    which with a stride pads ``(ceil(T/s)-1)·s + k - T``, the low half
    first — not torch's symmetric padding)."""

    SPEC = [(128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
            (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1)]

    def __init__(self):
        super().__init__()
        in_ch = 1
        for i, (ch, k, s, g) in enumerate(self.SPEC):
            self.add_module(f"convs_{i}", wn_conv(in_ch, ch, k, stride=s, groups=g))
            in_ch = ch
        self.conv_post = wn_conv(in_ch, 1, 3)

    def forward(self, x):
        b = x.shape[0]
        x = x[:, None]                                   # (B, 1, T)
        fmap = []
        for i in range(len(self.SPEC)):
            x = F.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap
