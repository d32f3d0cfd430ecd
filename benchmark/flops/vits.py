"""Operations of VITS inference (``benchmark/reference/vits.py``), from
shapes alone, counted as ``benchmark/flops`` counts: two per multiply-add;
convolutions by output elements times taps × inputs per group, transposed
convolutions by input elements times taps × outputs; matrix products in ×
out per row; attention's two products per head; element-wise work, the
splines, softmaxes and the expansion of the prior to frames not counted.
Work done once per text (the speaker's 1×1 projections, the emotion
projection) is counted once per text.
"""
from __future__ import annotations

from . import hifigan


def decoder(c: dict, batch: int, frames: int) -> float:
    """The decoder's convolutions over ``frames`` frames: HiFi-GAN's
    generator with ``conv_pre`` taking the ``inter_channels`` latent, plus
    the speaker's 1×1 ``cond`` once a text."""
    gen = dict(c, num_mels=c["inter_channels"])
    return hifigan(gen, batch, frames) + 2.0 * batch * c["gin_channels"] * c["upsample_initial_channel"]


def text_encoder(c: dict, batch: int, t_text: int) -> float:
    h, f, k = c["hidden_channels"], c["filter_channels"], c["kernel_size"]
    per_layer = 4 * h * h + 2 * t_text * h + 2 * k * h * f     # q, k, v, o; QK, PV; the FFN
    per_symbol = c["n_layers"] * per_layer + h * 2 * c["inter_channels"]
    return 2.0 * batch * (t_text * per_symbol + c["emotion_channels"] * h)


def _dds(h: int, k: int, layers: int) -> int:
    return layers * (k * h + h * h)


def duration(c: dict, batch: int, t_text: int, flows: int = 3) -> float:
    """The stochastic duration predictor backwards: ``flows`` spline
    flows (four, less the one the published reverse drops)."""
    h, k = c["hidden_channels"], c["kernel_size"]
    per_symbol = 2 * h * h + _dds(h, k, 3) + flows * (h + _dds(h, k, 3) + h * 29)
    return 2.0 * batch * (t_text * per_symbol + c["gin_channels"] * h)


def flows(c: dict, batch: int, frames: int, n_flows: int = 4, layers: int = 4,
          taps: int = 5) -> float:
    """The mean-only coupling flows backwards over ``frames`` frames."""
    h, half = c["hidden_channels"], c["inter_channels"] // 2
    wn = layers * taps * h * 2 * h + (layers - 1) * h * 2 * h + h * h
    per_frame = n_flows * (half * h + wn + h * half)
    return 2.0 * batch * (frames * per_frame + n_flows * c["gin_channels"] * 2 * h * layers)


def call(c: dict, batch: int, t_text: int, frames: int) -> float:
    return (text_encoder(c, batch, t_text) + duration(c, batch, t_text)
            + flows(c, batch, frames) + decoder(c, batch, frames))
