"""VITS end-to-end synthesizer in PyTorch.

Port of ``mockingbird_tpu/models/vits/model.py``: TextEncoder (windowed
relative-position transformer + emotion projection) → prior (m_p, logs_p);
PosteriorEncoder (WN) on linear spectrograms; ResidualCoupling flow;
stochastic or deterministic duration predictor; HiFi-GAN-style decoder with
speaker conditioning; the training alignment through monotonic alignment
search (``ops/monotonic_align.py``, the Hopper kernel on the card).

Layout: time-major (B, T, C), masks (B, T, 1), as in the JAX package.
Masks and noise are float32 as there, so under a bf16 policy every layer
past the first mask computes in float32, as flax's promotion has it.

Random draws: every one can be handed in as a tensor (the posterior noise
``eps``, the duration posterior's ``e_q``, the decoder window ``ids_slice``,
and in ``infer`` the duration noise and the prior noise); otherwise it is
drawn from ``generator``. Dropout is on in ``forward(train=True)`` and draws
from the same generator.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import seeded
from ...config import Config
from ...ops.monotonic_align import maximum_path
from ...parallel import multihost
from ...text import symbols as _symbols
from ..layers import Conv1d, ConvTranspose1d, Dense, LayerNorm, dropout
from ..vocoder.hifigan import LRELU_SLOPE, ResBlock1, ResBlock2, upsample_valid
from .modules import (
    ConvFlow, DDSConv, ElementwiseAffine, Flip, Log, ResidualCouplingLayer,
    TransformerEncoder, WN, generate_path, rand_slice_segments, sequence_mask,
)


def vits_config() -> Config:
    """Standard 16 kHz VITS dims (upstream configs; hop 256)."""
    return Config(
        n_vocab=len(_symbols), spec_channels=513, segment_size=8192, inter_channels=192,
        hidden_channels=192, filter_channels=768, n_heads=2, n_layers=6, kernel_size=3,
        p_dropout=0.1, resblock="1", resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        upsample_rates=[8, 8, 2, 2], upsample_initial_channel=512,
        upsample_kernel_sizes=[16, 16, 4, 4], n_speakers=200, gin_channels=256,
        use_sdp=True, use_emotion=True, emotion_channels=1024, hop_size=256,
        sample_rate=16000, n_fft=1024, win_size=1024, num_mels=80, fmin=0.0, fmax=None,
    )


class TextEncoder(nn.Module):
    """tokens + emotion → hidden sequence and prior statistics."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        self.emb = nn.Embedding(c.n_vocab, c.hidden_channels)
        nn.init.normal_(self.emb.weight, std=c.hidden_channels ** -0.5)
        if c.use_emotion:
            self.emo_proj = Dense(c.emotion_channels, c.hidden_channels)
        self.encoder = TransformerEncoder(c.hidden_channels, c.filter_channels, c.n_heads,
                                          c.n_layers, c.kernel_size, c.p_dropout)
        self.proj = Conv1d(c.hidden_channels, 2 * c.inter_channels, 1)

    def forward(self, x, x_lengths, emo=None, gen=None):
        c = self.cfg
        h = self.emb(x)
        # JAX gives a Python scalar the array's dtype (weak typing), so a bf16
        # table is scaled by sqrt(hidden) rounded to bf16; jitted XLA keeps
        # the product in f32, since f32 ops (the emotion term, the mask)
        # consume it
        h = h.float() * torch.tensor(math.sqrt(c.hidden_channels), dtype=h.dtype).float()
        if c.use_emotion and emo is not None:
            h = h + self.emo_proj(emo)[:, None, :]
        x_mask = sequence_mask(x_lengths, x.shape[1])[..., None]
        h = self.encoder(h * x_mask, x_mask, gen)
        stats = self.proj(h) * x_mask
        return h, stats[..., :c.inter_channels], stats[..., c.inter_channels:], x_mask


class PosteriorEncoder(nn.Module):
    """linear spectrogram → posterior z (``eps`` the standard-normal draw,
    none for the posterior mean)."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        self.pre = Conv1d(c.spec_channels, c.hidden_channels, 1)
        self.enc = WN(c.hidden_channels, 5, 1, 16, c.gin_channels)
        self.proj = Conv1d(c.hidden_channels, 2 * c.inter_channels, 1)

    def forward(self, y, y_lengths, g=None, eps=None, gen=None):
        c = self.cfg
        y_mask = sequence_mask(y_lengths, y.shape[1])[..., None]
        h = self.pre(y) * y_mask
        h = self.enc(h, y_mask, g=g, gen=gen)
        stats = self.proj(h) * y_mask
        m, logs = stats[..., :c.inter_channels], stats[..., c.inter_channels:]
        z = (m + eps * torch.exp(logs)) * y_mask if eps is not None else m * y_mask
        return z, m, logs, y_mask


class ResidualCouplingBlock(nn.Module):
    """4× (coupling + flip)."""

    def __init__(self, cfg: Any, n_flows: int = 4):
        super().__init__()
        c = cfg
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"coupling_{i}", ResidualCouplingLayer(
                c.inter_channels, c.hidden_channels, 5, 1, 4, gin_channels=c.gin_channels,
                mean_only=True))
            self.add_module(f"flip_{i}", Flip())

    def _flows(self):
        for i in range(self.n_flows):
            yield getattr(self, f"coupling_{i}")
            yield getattr(self, f"flip_{i}")

    def forward(self, x, x_mask, g=None, reverse=False, gen=None):
        if not reverse:
            for flow in self._flows():
                x, _ = flow(x, x_mask, g=g, reverse=False, gen=gen)
            return x
        for flow in reversed(list(self._flows())):
            x = flow(x, x_mask, g=g, reverse=True, gen=gen)
        return x


class VitsGenerator(nn.Module):
    """HiFi-GAN decoder with gin conditioning: z (B, T, C) → wav (B, T·hop).
    Channels-first inside; each transposed conv is ``upsample_valid``'s."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        ch0 = c.upsample_initial_channel
        self.conv_pre = Conv1d(c.inter_channels, ch0, 7)
        if c.gin_channels:
            self.cond = Conv1d(c.gin_channels, ch0, 1)
        res_cls = ResBlock1 if c.resblock == "1" else ResBlock2
        ch = ch0
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", ConvTranspose1d(ch, ch // 2, k, u))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", res_cls(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, bias=False, time_major=False)

    def forward(self, x, g=None):
        c = self.cfg
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        x = x.transpose(1, 2)                               # (B, C, T)
        n_k = len(c.resblock_kernel_sizes)
        for i, u in enumerate(c.upsample_rates):
            x = upsample_valid(getattr(self, f"ups_{i}"), F.leaky_relu(x, LRELU_SLOPE), u)
            xs = None
            for j in range(n_k):
                y = getattr(self, f"resblock_{i}_{j}")(x)
                xs = y if xs is None else xs + y
            x = xs / n_k
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0]


class DurationPredictor(nn.Module):
    """Deterministic log-duration head."""

    def __init__(self, cfg: Any, filter_channels: int = 256):
        super().__init__()
        c = cfg
        if c.gin_channels:
            self.cond = Conv1d(c.gin_channels, c.hidden_channels, 1)
        self.conv_1 = Conv1d(c.hidden_channels, filter_channels, c.kernel_size)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, c.kernel_size)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask, g=None, gen=None):
        x = x.detach()
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.norm_1(torch.relu(self.conv_1(x * x_mask)))
        x = dropout(x, 0.5, gen)
        x = self.norm_2(torch.relu(self.conv_2(x * x_mask)))
        x = dropout(x, 0.5, gen)
        return self.proj(x * x_mask) * x_mask


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model."""

    def __init__(self, cfg: Any, n_flows: int = 4):
        super().__init__()
        c = cfg
        fc = c.hidden_channels  # the reference overrides filter_channels = in_channels
        self.n_flows = n_flows
        self.pre = Conv1d(c.hidden_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, c.kernel_size, 3, 0.5)
        if c.gin_channels:
            self.cond = Conv1d(c.gin_channels, fc, 1)
        self.log_flow = Log()
        self.flow_affine = ElementwiseAffine(2)
        for i in range(n_flows):
            self.add_module(f"flow_conv_{i}", ConvFlow(2, fc, c.kernel_size, 3))
            self.add_module(f"flow_flip_{i}", Flip())
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, c.kernel_size, 3, 0.5)
        self.post_affine = ElementwiseAffine(2)
        for i in range(4):
            self.add_module(f"post_conv_{i}", ConvFlow(2, fc, c.kernel_size, 3))
            self.add_module(f"post_flip_{i}", Flip())

    def _chain(self, prefix: str, affine: nn.Module, n: int):
        out = [affine]
        for i in range(n):
            out += [getattr(self, f"{prefix}_conv_{i}"), getattr(self, f"{prefix}_flip_{i}")]
        return out

    def forward(self, x, x_mask, w=None, g=None, reverse=False, noise_scale=1.0,
                noise=None, gen=None, generator=None):
        """Forward (``reverse=False``): the duration NLL (B,) of ``w``;
        ``noise`` is the posterior draw e_q (B, T, 2), standard normal.
        Reverse: logw (B, T, 1); ``noise`` is the (B, T, 2) standard-normal
        draw that ``noise_scale`` scales."""
        x = self.pre(x.detach())
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.convs(x, x_mask, gen=gen)
        x = self.proj(x) * x_mask
        if noise is None:
            noise = multihost.randn((x.shape[0], x.shape[1], 2), generator, x.device)

        if not reverse:
            h_w = self.post_pre(w)
            h_w = self.post_convs(h_w, x_mask, gen=gen)
            h_w = self.post_proj(h_w) * x_mask
            e_q = noise * x_mask
            z_q = e_q
            logdet_tot_q = 0.0
            for flow in self._chain("post", self.post_affine, 4):
                z_q, logdet_q = flow(z_q, x_mask, g=x + h_w, gen=gen)
                logdet_tot_q = logdet_tot_q + logdet_q
            z_u, z1 = z_q[..., :1], z_q[..., 1:]
            u = torch.sigmoid(z_u) * x_mask
            z0 = (w - u) * x_mask
            logdet_tot_q = logdet_tot_q + torch.sum(
                (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
            logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * x_mask,
                             dim=(1, 2)) - logdet_tot_q
            z0, logdet_tot = self.log_flow(z0, x_mask)
            z = torch.cat([z0, z1], dim=-1)
            for flow in self._chain("flow", self.flow_affine, self.n_flows):
                z, logdet = flow(z, x_mask, g=x, gen=gen)
                logdet_tot = logdet_tot + logdet
            nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * x_mask,
                            dim=(1, 2)) - logdet_tot
            return nll + logq

        flows = list(reversed(self._chain("flow", self.flow_affine, self.n_flows)))
        flows = flows[:-2] + [flows[-1]]   # the reference drops one flow here
        z = noise * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True, gen=gen)
        return z[..., :1]


def neg_cent(z_p, m_p, logs_p):
    """Negative cross-entropy alignment scores (B, T_y, T_x) of the
    frame-rate z_p (B, T_y, D) under the text-rate prior (B, T_x, D)."""
    s_p_sq_r = torch.exp(-2 * logs_p)
    nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=2)[:, None, :]
    nc2 = torch.einsum("byd,bxd->byx", -0.5 * z_p ** 2, s_p_sq_r)
    nc3 = torch.einsum("byd,bxd->byx", z_p, m_p * s_p_sq_r)
    nc4 = torch.sum(-0.5 * m_p ** 2 * s_p_sq_r, dim=2)[:, None, :]
    return nc1 + nc2 + nc3 + nc4


class Vits(nn.Module):
    """Full model."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        self.enc_p = TextEncoder(c)
        self.dec = VitsGenerator(c)
        self.enc_q = PosteriorEncoder(c)
        self.flow = ResidualCouplingBlock(c)
        self.dp = StochasticDurationPredictor(c) if c.use_sdp else DurationPredictor(c)
        if c.n_speakers > 1:
            self.emb_g = nn.Embedding(c.n_speakers, c.gin_channels)

    def _speaker(self, sid):
        if self.cfg.n_speakers > 1 and sid is not None:
            return self.emb_g(sid)[:, None, :]               # (B, 1, gin)
        return None

    def forward(self, x, x_lengths, y, y_lengths, sid=None, emo=None, train: bool = True,
                generator: Optional[torch.Generator] = None, eps=None, e_q=None,
                ids_slice=None, attn=None):
        """Training forward. x (B, Tx) int; y (B, Ty, spec) linear spec.
        ``attn`` (B, Ty, Tx) may be handed in in place of the search."""
        c = self.cfg
        gen = generator if train else None
        hx, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, emo, gen)
        g = self._speaker(sid)
        if eps is None:
            eps = multihost.randn((y.shape[0], y.shape[1], c.inter_channels), generator,
                                  y.device)
        z, m_q, logs_q, y_mask = self.enc_q(y, y_lengths, g=g, eps=eps, gen=gen)
        z_p = self.flow(z, y_mask, g=g, gen=gen)

        if attn is None:
            with torch.no_grad():
                attn_mask = y_mask * x_mask.transpose(1, 2)          # (B, Ty, Tx)
                attn = maximum_path(neg_cent(z_p, m_p, logs_p), attn_mask)

        w = torch.sum(attn, dim=1)[..., None]                        # (B, Tx, 1)
        if c.use_sdp:
            l_length = self.dp(hx, x_mask, w, g=g, noise=e_q, gen=gen, generator=generator)
            l_length = l_length / multihost.global_count(torch.sum(x_mask))
        else:
            logw_ = torch.log(w + 1e-6) * x_mask
            logw = self.dp(hx, x_mask, g=g, gen=gen)
            l_length = (torch.sum((logw - logw_) ** 2, dim=(1, 2))
                        / multihost.global_count(torch.sum(x_mask)))

        m_p = torch.einsum("byx,bxd->byd", attn, m_p)
        logs_p = torch.einsum("byx,bxd->byd", attn, logs_p)
        seg_frames = c.segment_size // c.hop_size
        z_slice, ids_slice = rand_slice_segments(z, y_lengths, seg_frames, generator, ids_slice)
        o = self.dec(z_slice, g=g)
        return o, l_length, attn, ids_slice, x_mask, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q)

    def reconstruct(self, y, y_lengths, sid=None):
        """Posterior-mean reconstruction: linear spec → enc_q → dec → wav."""
        g = self._speaker(sid)
        _, m_q, _, y_mask = self.enc_q(y, y_lengths, g=g)
        return self.dec(m_q * y_mask, g=g)

    def infer(self, x, x_lengths, sid=None, emo=None, noise_scale=1.0, length_scale=1.0,
              noise_scale_w=1.0, max_len=None, generator=None, dur_noise=None,
              prior_noise=None):
        """text → (wav (B, T_y·hop), attn, y_mask, y_lengths), T_y =
        ``max_len`` (default 20 frames per text position)."""
        hx, m_p, logs_p, x_mask = self.enc_p(x, x_lengths, emo)
        g = self._speaker(sid)
        if self.cfg.use_sdp:
            logw = self.dp(hx, x_mask, g=g, reverse=True, noise_scale=noise_scale_w,
                           noise=dur_noise, generator=generator)
        else:
            logw = self.dp(hx, x_mask, g=g)
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        t_y = max_len if max_len is not None else x.shape[1] * 20
        return self.infer_from_durations(w_ceil, m_p, logs_p, x_mask, g, noise_scale, t_y,
                                         generator, prior_noise)

    def infer_from_durations(self, w_ceil, m_p, logs_p, x_mask, g, noise_scale, t_y: int,
                             generator=None, prior_noise=None):
        """The part of ``infer`` after the durations (B, T_x, 1): expand the
        prior to frames, sample it, run the flow backwards and decode."""
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), 1, t_y).to(torch.int32)
        y_mask = sequence_mask(y_lengths, t_y)[..., None]
        attn_mask = y_mask * x_mask.transpose(1, 2)
        attn = generate_path(w_ceil.transpose(1, 2), attn_mask[:, None])[:, 0]
        m_p = torch.einsum("byx,bxd->byd", attn, m_p)
        logs_p = torch.einsum("byx,bxd->byd", attn, logs_p)
        if prior_noise is None:
            prior_noise = torch.randn(m_p.shape, generator=generator, device=m_p.device)
        z_p = m_p + prior_noise * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        o = self.dec(z * y_mask, g=g)
        return o, attn, y_mask, y_lengths


def init_vits(seed: int = 0, cfg=None) -> Vits:
    """A ``Vits`` with weights made from ``seed`` (flax's init where it
    matters: zero-initialised flow outputs, unit weight-norm gains)."""
    cfg = Config(cfg) if cfg is not None else vits_config()
    with seeded(seed):
        return Vits(cfg)
