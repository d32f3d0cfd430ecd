"""VITS building blocks in PyTorch, time-major (B, T, C) as in the JAX package.

Port of ``mockingbird_tpu/models/vits/modules.py``: LayerNorm, DDSConv, WN
gated dilated convs, the normalizing flows, the piecewise rational-quadratic
spline and the windowed relative-position transformer. Plain tensor code, no
kernel. Submodules carry the flax names, so ``weights.load_flax`` maps a
flax tree onto them leaf by leaf.

Dropout is active when a ``torch.Generator`` is passed as ``gen`` (the JAX
modules' ``train=True``); it draws from that generator.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv1d, LayerNorm, dropout, promote


def sequence_mask(lengths: torch.Tensor, max_length: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) → (B, T) mask."""
    return (torch.arange(max_length, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def fused_add_tanh_sigmoid_multiply(a, b, n_channels: int):
    in_act = a + b
    return torch.tanh(in_act[..., :n_channels]) * torch.sigmoid(in_act[..., n_channels:])


def _add(module: nn.Module, name: str, child: nn.Module) -> nn.Module:
    module.add_module(name, child)
    return child


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels."""

    def __init__(self, channels: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(channels)

    def forward(self, x):
        return self.LayerNorm_0(x)


class DDSConv(nn.Module):
    """Dilated depth-separable convs."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        for i in range(n_layers):
            _add(self, f"convs_sep_{i}", Conv1d(channels, channels, kernel_size,
                                                dilation=kernel_size ** i, groups=channels))
            _add(self, f"norm1_{i}", LayerNorm(channels))
            _add(self, f"convs_1x1_{i}", Conv1d(channels, channels, 1))
            _add(self, f"norm2_{i}", LayerNorm(channels))

    def forward(self, x, x_mask, g=None, gen=None):
        if g is not None:
            x = x + g
        for i in range(self.n_layers):
            y = getattr(self, f"convs_sep_{i}")(x * x_mask)
            y = F.gelu(getattr(self, f"norm1_{i}")(y))
            y = getattr(self, f"convs_1x1_{i}")(y)
            y = F.gelu(getattr(self, f"norm2_{i}")(y))
            x = x + dropout(y, self.p_dropout, gen)
        return x * x_mask


class WN(nn.Module):
    """WaveNet-style gated dilated conv stack, weight-normed convs."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        h = self.hidden = hidden_channels
        self.n_layers, self.p_dropout = n_layers, p_dropout
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1, weight_norm=True)
        for i in range(n_layers):
            _add(self, f"in_layers_{i}", Conv1d(h, 2 * h, kernel_size,
                                                dilation=dilation_rate ** i, weight_norm=True))
            out_ch = 2 * h if i < n_layers - 1 else h
            _add(self, f"res_skip_layers_{i}", Conv1d(h, out_ch, 1, weight_norm=True))

    def forward(self, x, x_mask, g=None, gen=None):
        h = self.hidden
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i in range(self.n_layers):
            x_in = dropout(getattr(self, f"in_layers_{i}")(x), self.p_dropout, gen)
            g_l = g_all[..., i * 2 * h:(i + 1) * 2 * h] if g_all is not None else 0.0
            acts = fused_add_tanh_sigmoid_multiply(x_in, g_l, h)
            res_skip = getattr(self, f"res_skip_layers_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask


# ---------------------------------------------------------------------------
# Flows
# ---------------------------------------------------------------------------

class Log(nn.Module):
    """y = log(x)."""

    def forward(self, x, x_mask, reverse=False, **kw):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class Flip(nn.Module):
    """Channel flip."""

    def forward(self, x, x_mask=None, g=None, reverse=False, **kw):
        x = torch.flip(x, dims=[-1])
        if not reverse:
            return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return x


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs)·x per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    def forward(self, x, x_mask, g=None, reverse=False, **kw):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs[None, None, :] * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ResidualCouplingLayer(nn.Module):
    """Affine (mean-only) coupling with a WN conditioner."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, self.half * (1 if mean_only else 2), 1,
                           zero_init=True)

    def forward(self, x, x_mask, g=None, reverse=False, gen=None):
        half = self.half
        x0, x1 = x[..., :half], x[..., half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g, gen=gen)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[..., :half], stats[..., half:]
        if not reverse:
            x1 = (m + x1 * torch.exp(logs)) * x_mask
            return torch.cat([x0, x1], dim=-1), torch.sum(logs * x_mask, dim=(1, 2))
        x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=-1)


class ConvFlow(nn.Module):
    """Spline coupling flow."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half, self.filter_channels = in_channels // 2, filter_channels
        self.num_bins, self.tail_bound = num_bins, tail_bound
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1, zero_init=True)

    def forward(self, x, x_mask, g=None, reverse=False, gen=None):
        half, nb = self.half, self.num_bins
        x0, x1 = x[..., :half], x[..., half:]
        h = self.pre(x0)
        h = self.convs(h, x_mask, g=g, gen=gen)
        h = self.proj(h) * x_mask
        b, t, _ = x0.shape
        h = h.reshape(b, t, half, 3 * nb - 1)
        denom = math.sqrt(self.filter_channels)
        uw = h[..., :nb] / denom
        uh = h[..., nb:2 * nb] / denom
        ud = h[..., 2 * nb:]
        x1_new, logabsdet = rational_quadratic_spline(x1, uw, uh, ud, inverse=reverse,
                                                      tail_bound=self.tail_bound)
        x_out = torch.cat([x0, x1_new], dim=-1) * x_mask
        if not reverse:
            return x_out, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return x_out


def _knots(unnormalized, min_bin, tail_bound):
    """Softmax bin sizes → (knot positions (..., n+1) from -B to B, sizes)."""
    n = unnormalized.shape[-1]
    sizes = min_bin + (1 - min_bin * n) * torch.softmax(unnormalized, dim=-1)
    cum = (2 * tail_bound) * torch.cumsum(sizes, dim=-1) - tail_bound
    lo = torch.full_like(cum[..., :1], -tail_bound)
    hi = torch.full_like(cum[..., :1], tail_bound)
    cum = torch.cat([lo, cum[..., :-1], hi], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                              unnormalized_derivatives, inverse=False, tail_bound=5.0,
                              min_bin_width=1e-3, min_bin_height=1e-3, min_derivative=1e-3):
    """Unconstrained (linear-tailed) monotonic rational-quadratic spline
    (Durkan et al. 2019). inputs (...,), params (..., num_bins[*3-1]).
    Identity outside [-tail_bound, tail_bound]; the bin of x is the number of
    left knots at or below it, less one, clipped to the bins."""
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = float(np.log(np.exp(1 - min_derivative) - 1))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, tail_bound)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    x_in = torch.clamp(inputs, -tail_bound, tail_bound)
    bins = cumheights if inverse else cumwidths
    bin_idx = torch.clamp((x_in[..., None] >= bins[..., :-1]).sum(dim=-1) - 1,
                          0, num_bins - 1)[..., None]

    def take(t):
        return torch.gather(t, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_heights = take(heights)
    input_delta = take(heights / widths)
    input_d = take(derivatives[..., :-1])
    input_d_plus = take(derivatives[..., 1:])
    slope_sum = input_d + input_d_plus - 2 * input_delta

    if inverse:
        a = (x_in - input_cumheights) * slope_sum + input_heights * (input_delta - input_d)
        b = input_heights * input_d - (x_in - input_cumheights) * slope_sum
        c = -input_delta * (x_in - input_cumheights)
        disc = b ** 2 - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)) - 1e-12)
        outputs = root * input_bin_widths + input_cumwidths
        theta_one_minus_theta = root * (1 - root)
        denom = input_delta + slope_sum * theta_one_minus_theta
        dnum = input_delta ** 2 * (input_d_plus * root ** 2
                                   + 2 * input_delta * theta_one_minus_theta
                                   + input_d * (1 - root) ** 2)
        logabsdet = -(torch.log(torch.clamp(dnum, min=1e-12))
                      - 2 * torch.log(torch.clamp(denom, min=1e-12)))
    else:
        theta = (x_in - input_cumwidths) / torch.clamp(input_bin_widths, min=1e-12)
        theta_one_minus_theta = theta * (1 - theta)
        numerator = input_heights * (input_delta * theta ** 2
                                     + input_d * theta_one_minus_theta)
        denom = input_delta + slope_sum * theta_one_minus_theta
        outputs = input_cumheights + numerator / torch.clamp(denom, min=1e-12)
        dnum = input_delta ** 2 * (input_d_plus * theta ** 2
                                   + 2 * input_delta * theta_one_minus_theta
                                   + input_d * (1 - theta) ** 2)
        logabsdet = (torch.log(torch.clamp(dnum, min=1e-12))
                     - 2 * torch.log(torch.clamp(denom, min=1e-12)))

    outputs = torch.where(inside, outputs, inputs)       # identity on the tails
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet


# ---------------------------------------------------------------------------
# Windowed relative-position transformer
# ---------------------------------------------------------------------------

class RelativeMultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int, p_dropout: float = 0.0,
                 window_size: Optional[int] = 4):
        super().__init__()
        self.channels, self.n_heads = channels, n_heads
        self.p_dropout, self.window_size = p_dropout, window_size
        k_ch = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)

    def forward(self, x, attn_mask=None, gen=None):
        k_ch = self.channels // self.n_heads
        b, t, _ = x.shape

        def split(u):  # (B, T, C) → (B, H, T, d)
            return u.reshape(b, t, self.n_heads, k_ch).transpose(1, 2)

        q, k, v = split(self.conv_q(x)), split(self.conv_k(x)), split(self.conv_v(x))
        q = q / math.sqrt(k_ch)
        scores = torch.einsum("bhtd,bhsd->bhts", q, k)
        if self.window_size is not None:
            rel_logits = torch.einsum("bhtd,gmd->bhtm", *promote(
                q, _relative_embeddings(self.emb_rel_k, t, self.window_size)))
            scores = scores + _relative_to_absolute(rel_logits)
        if attn_mask is not None:
            scores = torch.where(attn_mask == 0, torch.full_like(scores, -1e4), scores)
        p_attn = dropout(torch.softmax(scores, dim=-1), self.p_dropout, gen)
        out = torch.einsum("bhts,bhsd->bhtd", p_attn, v)
        if self.window_size is not None:
            rel_weights = _absolute_to_relative(p_attn)
            out = out + torch.einsum("bhtm,gmd->bhtd", *promote(
                rel_weights, _relative_embeddings(self.emb_rel_v, t, self.window_size)))
        out = out.transpose(1, 2).reshape(b, t, self.channels)
        return self.conv_o(out)


def _relative_embeddings(emb, length: int, window: int):
    """Pad/slice the (1, 2w+1, d) table to (1, 2*length-1, d)."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


def _relative_to_absolute(x):
    """(B, H, T, 2T-1) → (B, H, T, T)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, t * 2 * t), (0, t - 1))
    return x_flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _absolute_to_relative(x):
    """(B, H, T, T) → (B, H, T, 2T-1)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x_flat = F.pad(x.reshape(b, h, t * (2 * t - 1)), (t, 0))
    return x_flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


class FFN(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, out_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def forward(self, x, x_mask, gen=None):
        y = torch.relu(self.conv_1(x * x_mask))
        y = dropout(y, self.p_dropout, gen)
        return self.conv_2(y * x_mask) * x_mask


class TransformerEncoder(nn.Module):
    """Stack of windowed-relative-attention blocks."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 window_size: int = 4):
        super().__init__()
        self.n_layers, self.p_dropout = n_layers, p_dropout
        for i in range(n_layers):
            _add(self, f"attn_{i}", RelativeMultiHeadAttention(
                hidden_channels, hidden_channels, n_heads, p_dropout, window_size))
            _add(self, f"norm1_{i}", LayerNorm(hidden_channels))
            _add(self, f"ffn_{i}", FFN(hidden_channels, filter_channels, hidden_channels,
                                       kernel_size, p_dropout))
            _add(self, f"norm2_{i}", LayerNorm(hidden_channels))

    def forward(self, x, x_mask, gen=None):
        m = x_mask[..., 0]
        attn_mask = m[:, None, None, :] * m[:, None, :, None]
        x = x * x_mask
        for i in range(self.n_layers):
            y = getattr(self, f"attn_{i}")(x, attn_mask, gen)
            x = getattr(self, f"norm1_{i}")(x + dropout(y, self.p_dropout, gen))
            y = getattr(self, f"ffn_{i}")(x, x_mask, gen)
            x = getattr(self, f"norm2_{i}")(x + dropout(y, self.p_dropout, gen))
        return x * x_mask


# ---------------------------------------------------------------------------
# Segment utilities
# ---------------------------------------------------------------------------

def slice_segments(x, ids_str, segment_size: int):
    """x (B, T, C) or (B, T); gather [ids_str : ids_str+segment_size) per row."""
    idx = ids_str.long()[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    if x.ndim == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def rand_slice_segments(x, x_lengths, segment_size: int, generator=None, ids_str=None):
    """Random windows of ``segment_size`` frames; ``ids_str`` (B,) int32 may
    be handed in, else drawn uniformly from ``generator``."""
    if ids_str is None:
        max_start = torch.clamp(x_lengths - segment_size + 1, min=1)
        u = torch.rand(x.shape[0], generator=generator, device=x.device)
        ids_str = (u * max_start).to(torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


def generate_path(duration, mask):
    """duration (B, 1, T_x); mask (B, 1, T_y, T_x) → path (B, 1, T_y, T_x)."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=-1)                         # (B, 1, T_x)
    ys = torch.arange(t_y, device=duration.device)[None, None, :, None]
    path = (ys < cum[:, :, None, :]).to(mask.dtype)
    path_prev = F.pad(path, (1, 0))[..., :-1]
    return (path - path_prev) * mask
