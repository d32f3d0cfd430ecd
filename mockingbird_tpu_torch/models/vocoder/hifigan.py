"""HiFi-GAN: the generator, its residual blocks and the period/scale
discriminators.

Port of ``mockingbird_tpu/models/vocoder/hifigan.py``. The generator
runs channels-last, (B, T, C) memory from ``conv_pre`` to ``conv_post``,
with one ``ops.conv_epilogue`` after each conv (the hand-written kernel on
a card with gradients off, its plain version elsewhere); the residual
blocks' own ``forward`` and the discriminators run channels-first
(B, C, T). A weight-normed conv is ``layers.Conv1d(weight_norm=True)``
with the flax layout's ``<name>_conv`` kernel and ``<name>`` gain.
``Generator`` takes and returns the JAX package's layout at its boundary:
mel (B, T, 80) → wav (B, T·hop). The discriminators take wavs (B, T);
their feature maps are channels-first.
``HifiganDiscriminators`` (MPD + MSD) is what ``gan_train`` trains;
VITS trains ``DiscriminatorS`` and ``DiscriminatorP`` under its own names.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import seeded
from ...config import Config
from ...ops.conv_epilogue import conv_epilogue
from ..layers import Conv1d, Conv2d, ConvTranspose1d, SpectralNorm

LRELU_SLOPE = 0.1
# flax's default slope, which the generators' last leaky ReLU takes
LAST_SLOPE = 0.01


def hifigan_config() -> Config:
    """16 kHz config (``config_16k_.json``). The trained export's sidecar
    (``saved_models/gan_run/vocoder_hifigan.json``) replaces it with rates
    (8, 8, 4), kernels (16, 16, 8) and hop 256."""
    return Config(
        use_interpolation=False,   # True = the 24 kHz variant
        resblock="1",
        upsample_rates=[5, 5, 4, 2],
        upsample_kernel_sizes=[10, 10, 8, 4],
        upsample_initial_channel=512,
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
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
    )


def wn_conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> Conv1d:
    """Weight-normed flax ``nn.Conv`` with SAME padding, channels-first."""
    return Conv1d(in_ch, out_ch, kernel, stride=stride, dilation=dilation, groups=groups,
                  weight_norm=True, time_major=False)


def residual_units(block: nn.Module) -> List[List[nn.Module]]:
    """A residual block's units in the order it runs them: its convs grouped
    by the index their names end in (``ResBlock1``'s ``convs1_i`` and
    ``convs2_i``, ``ResBlock2``'s ``convs_i``). A module without convs has
    none: it passes its input through."""
    units: Dict[str, List[nn.Module]] = {}
    for name, conv in block.named_children():
        units.setdefault(name.rsplit("_", 1)[-1], []).append(conv)
    return list(units.values())


def fused_residuals(units, x: torch.Tensor, a: torch.Tensor, **tail) -> torch.Tensor:
    """A residual block on channels-last memory: for each unit (a list of
    convs), the convs in turn from ``a`` = leaky_relu(``x``), the last one's
    output added to ``x``. One ``conv_epilogue`` after each conv: its bias,
    then the next conv's leaky ReLU, or the residual add and both the new
    ``x`` and its leaky ReLU; after the last unit the residual add and
    ``tail`` (the block sum, its division, the next activation). No units:
    ``x`` itself, with ``tail``."""
    if not units:
        return conv_epilogue(x.clone(), **tail)
    for i, convs in enumerate(units):
        for conv in convs[:-1]:
            a = conv_epilogue(conv.product(a), conv.bias, slope=LRELU_SLOPE)
        last = convs[-1]
        if i == len(units) - 1:
            return conv_epilogue(last.product(a), last.bias, residual=x, **tail)
        x, a = conv_epilogue(last.product(a), last.bias, residual=x, slope=LRELU_SLOPE,
                             keep_x=True)


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


def upsample_valid(conv: ConvTranspose1d, x: torch.Tensor, u: int) -> torch.Tensor:
    """flax's VALID transposed conv (length (T-1)·u + k) sliced to T·u
    frames at ``u//2 + u%2``, as torch's ``ConvTranspose1d`` with that
    padding and ``output_padding=u%2`` gives them."""
    t_in = x.shape[-1]
    off = u // 2 + u % 2
    return conv(x)[..., off:off + t_in * u]


def upsample_product(conv: ConvTranspose1d, x: torch.Tensor, u: int) -> torch.Tensor:
    """``upsample_valid`` on channels-last ``x`` (B, T, C), without the
    bias: the window as the transposed conv's own ``padding`` and
    ``output_padding`` where the kernel allows them (k = 2u does), else the
    whole output sliced."""
    t_in, k = x.shape[1], conv.weight.shape[-1]
    off = u // 2 + u % 2
    out_pad = u + 2 * off - k
    if 0 <= out_pad < u and off + u <= k:
        return conv.product(x, off, out_pad)
    return conv.product(x)[:, off:off + t_in * u].contiguous()


def fused_stages(gen: nn.Module, a: torch.Tensor) -> torch.Tensor:
    """A generator's upsampling stages on channels-last memory, from ``a``
    = leaky_relu(x) (B, T, C) to leaky_relu(x, ``LAST_SLOPE``) before
    ``conv_post``: each stage's transposed conv ``gen.ups_{i}`` (the 24 kHz
    variant's repeat and VALID conv where ``gen.interp``), then its
    resblocks ``gen.resblock_{i}_{j}``, summed and averaged inside their
    last epilogues."""
    c = gen.cfg
    n_k, n_up = len(c.resblock_kernel_sizes), len(c.upsample_rates)
    for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
        ups = getattr(gen, f"ups_{i}")
        if getattr(gen, "interp", False):
            p = (k - 1) // 2
            y = ups.product(F.pad(a.repeat_interleave(u, dim=1), (0, 0, p, p)))
        else:
            y = upsample_product(ups, a, u)
        x, a = conv_epilogue(y, ups.bias, slope=LRELU_SLOPE, keep_x=True)
        xs = None
        for j in range(n_k):
            tail = {}
            if j == n_k - 1:
                tail = dict(n_blocks=n_k, slope=LRELU_SLOPE if i < n_up - 1 else LAST_SLOPE)
            xs = fused_residuals(residual_units(getattr(gen, f"resblock_{i}_{j}")), x, a,
                                 block_sum=xs, **tail)
        a = xs
    return a


class Generator(nn.Module):
    """mel (B, T, 80) → wav (B, T·prod(rates)) in [-1, 1], channels-last
    throughout: each conv's product (``layers.Conv1d.product``,
    ``ConvTranspose1d.product``) followed by one ``conv_epilogue``, with
    flax's arithmetic and rounding."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        ch0 = c.upsample_initial_channel
        # the 24 kHz variant: a nearest-neighbour repeat and a VALID conv in
        # place of each transposed conv
        self.interp = bool(c.get("use_interpolation", False)
                           or c.get("sample_rate", 16000) == 24000)
        self.conv_pre = wn_conv(c.num_mels, ch0, 7)
        res_cls = ResBlock1 if c.resblock == "1" else ResBlock2
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch_in, ch = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            self.add_module(f"ups_{i}", Conv1d(ch_in, ch, k, weight_norm=True, time_major=False,
                                               padding="VALID") if self.interp
                            else ConvTranspose1d(ch_in, ch, k, u))
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", res_cls(ch, rk, tuple(rd)))
        self.conv_post = wn_conv(ch0 // 2 ** len(c.upsample_rates), 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        a = conv_epilogue(self.conv_pre.product(mel), self.conv_pre.bias, slope=LRELU_SLOPE)
        a = fused_stages(self, a)
        return conv_epilogue(self.conv_post.product(a), self.conv_post.bias, tanh=True)[..., 0]


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
    first — not torch's symmetric padding). Weight-normed convs, or, with
    ``use_spectral_norm``, plain convs inside ``SpectralNorm`` whose
    statistics move when ``train`` is set."""

    SPEC = [(128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
            (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1)]

    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        in_ch = 1
        for i, (ch, k, s, g) in enumerate(self.SPEC):
            self.add_module(f"convs_{i}", self._conv(in_ch, ch, k, s, g))
            in_ch = ch
        self.conv_post = self._conv(in_ch, 1, 3)

    def _conv(self, in_ch, out_ch, k, stride=1, groups=1) -> nn.Module:
        if self.use_spectral_norm:
            return SpectralNorm(Conv1d(in_ch, out_ch, k, stride=stride, groups=groups,
                                       time_major=False))
        return wn_conv(in_ch, out_ch, k, stride=stride, groups=groups)

    def layer(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        conv = getattr(self, name)
        return conv(x, train) if self.use_spectral_norm else conv(x)

    def forward(self, x, train: bool = False):
        b = x.shape[0]
        x = x[:, None]                                   # (B, 1, T)
        fmap = []
        for i in range(len(self.SPEC)):
            x = F.leaky_relu(self.layer(f"convs_{i}", x, train), LRELU_SLOPE)
            fmap.append(x)
        x = self.layer("conv_post", x, train)
        fmap.append(x)
        return x.reshape(b, -1), fmap


def real_and_generated(disc: nn.Module, y: torch.Tensor, y_hat: torch.Tensor,
                       train: bool = False):
    """One discriminator on real ``y`` and generated ``y_hat`` → (score
    real, score generated, feature maps real, feature maps generated). The
    two go through as one batch, except through a spectral-normed
    discriminator that updates its statistics: there flax's second call
    starts from the ``u`` the first one stored, so it runs twice, real
    first."""
    if getattr(disc, "use_spectral_norm", False) and train:
        (r, fr), (g, fg) = disc(y, True), disc(y_hat, True)
        return r, g, fr, fg
    b = y.shape[0]
    score, fmap = disc(torch.cat([y, y_hat.to(y.dtype)]))
    return score[:b], score[b:], [f[:b] for f in fmap], [f[b:] for f in fmap]


def collect(pairs):
    """[(r, g, fr, fg), ...] per discriminator → (rs, gs, frs, fgs), the
    JAX package's output of a multi-discriminator."""
    return tuple(list(x) for x in zip(*pairs))


class MultiPeriodDiscriminator(nn.Module):
    """Periods 2, 3, 5, 7, 11 → (scores real, scores generated, feature
    maps real, feature maps generated)."""
    periods = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        for p in self.periods:
            self.add_module(f"disc_{p}", DiscriminatorP(p))

    def forward(self, y, y_hat):
        return collect(real_and_generated(getattr(self, f"disc_{p}"), y, y_hat)
                       for p in self.periods)


def avg_pool1d(x: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """torch ``AvgPool1d`` over (B, T), the zero padding counted."""
    return F.avg_pool1d(x[:, None], kernel, stride, pad, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators, the first spectral-normed, with ×2
    average pooling between them."""

    def __init__(self):
        super().__init__()
        for i in range(3):
            self.add_module(f"disc_{i}", DiscriminatorS(use_spectral_norm=i == 0))

    def forward(self, y, y_hat, train: bool = False):
        out = []
        for i in range(3):
            if i:
                y, y_hat = avg_pool1d(y, 4, 2, 2), avg_pool1d(y_hat, 4, 2, 2)
            out.append(real_and_generated(getattr(self, f"disc_{i}"), y, y_hat, train))
        return collect(out)


class HifiganDiscriminators(nn.Module):
    """MPD + MSD in one call: ``(y, y_hat, train)`` → (mpd, msd) outputs."""

    def __init__(self):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator()
        self.msd = MultiScaleDiscriminator()

    def forward(self, y, y_hat, train: bool = False):
        return self.mpd(y, y_hat), self.msd(y, y_hat, train)


def init_generator(seed: int = 0, cfg=None) -> Generator:
    """A ``Generator`` at ``cfg`` (default ``hifigan_config()``) with
    weights made from ``seed``, on the CPU."""
    with seeded(seed):
        return Generator(cfg or hifigan_config())


def init_discriminators(seed: int = 0) -> HifiganDiscriminators:
    with seeded(seed):
        return HifiganDiscriminators()
