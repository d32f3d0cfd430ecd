"""Recurrent layers with the JAX package's numerics and parameter layout.

flax's ``GRUCell`` and ``LSTMCell`` differ from PyTorch's in where the biases
sit: a flax GRU has biases on the three input gates and on ``hn`` only, a
flax LSTM on the four hidden gates only. The formulas are otherwise PyTorch's
(GRU gates r, z, n with n = tanh(W_in·x + b_in + r·(W_hn·h + b_hn)); LSTM
gates i, f, g, o). The recurrent layers here therefore make PyTorch's fused
GRU/LSTM calls with the biases flax lacks as zero buffers (not parameters,
so training cannot move them), and ``weights.py`` fills the rest from a
flax tree.

Below them, the flax layers the VITS and HiFi-GAN modules are built from:
``Dense``, ``LayerNorm``, convolutions with flax's padding, and flax's
``WeightNorm`` kept as a parametrization (direction and gain), because
training runs through it, and flax's ``SpectralNorm``.

A convolution that flax names automatically (``Conv_3``, as Fre-GAN's
discriminators leave theirs) carries that name as ``flax_name``; without
one, a normed conv ``<n>`` keeps its kernel under ``<n>_conv``, as the
JAX package names it.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import multihost


class FusedGRUCell(nn.Module):
    """One GRU step as two matmuls: ``wi`` = [ir|iz|in] (+ input biases),
    ``wh`` = [hr|hz|hn] (no bias), ``bn`` the ``hn`` bias. Port of
    ``models/tacotron/model.py:FusedGRUCell`` (also flax ``nn.GRUCell``);
    computes in the promoted dtype of its inputs and parameters.
    ``sequence`` runs the same parameters over a whole sequence, as flax's
    ``nn.RNN`` of the cell does, through the fused GRU call; its hidden
    r/z biases, which flax does not have, are the zero buffer
    ``bias_hh_rz``."""

    def __init__(self, in_dims: int, features: int):
        super().__init__()
        self.features = features
        self.wi = Dense(in_dims, 3 * features)
        self.wh = Dense(features, 3 * features, bias=False)
        self.bn = nn.Parameter(torch.zeros(features))
        self.register_buffer("bias_hh_rz", torch.zeros(2 * features), persistent=False)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = self.wi(x).chunk(3, dim=-1)
        hr, hz, hn = self.wh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self.bn))
        return (1.0 - z) * n + z * h

    def sequence(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """(B, T, D) from a zero state → (B, T, features), as ``GRULayer``.
        ``remat``: the backward recomputes the recurrence instead of keeping
        its activations (``torch.utils.checkpoint``; the weights are handed
        in, so a recompute sees the ones the forward saw)."""
        args = (x, self.wi.weight, self.wi.bias, self.wh.weight, self.bias_hh_rz, self.bn,
                False, self.training)
        if remat:
            return checkpoint(gru_sequence, *args, use_reentrant=False)
        return gru_sequence(*args)


def gru_sequence(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor, w_hh: torch.Tensor,
                 b_hh_rz: torch.Tensor, b_hn: torch.Tensor, reverse: bool = False,
                 training: bool = False) -> torch.Tensor:
    """flax ``nn.RNN(nn.GRUCell)`` over (B, T, D) from a zero state through
    ``torch.gru``; ``reverse=True`` runs right to left and keeps the output
    order. The recurrence runs in float32 at least, whatever the input:
    flax's carry is float32, which promotes every gate; a bf16 input's
    input gates are bf16 products, as flax's Denses make them (float64
    runs in float64)."""
    cdt = torch.promote_types(torch.promote_types(x.dtype, w_ih.dtype), torch.float32)
    w_ih_f, b_ih_f = w_ih.to(cdt), b_ih.to(cdt)
    if torch.promote_types(x.dtype, w_ih.dtype).itemsize < 4:
        # flax's input gates are Denses of the bf16 input: their output
        # is rounded to bf16 before the float32 hidden gates are added
        x = with_bias(F.linear, *promote(x, w_ih, b_ih), channel_dim=-1)
        w_ih_f = torch.eye(x.shape[-1], device=x.device, dtype=cdt)
        b_ih_f = torch.zeros_like(b_ih_f)
    x = x.to(cdt)
    if reverse:
        x = x.flip(1)
    b_hh = torch.cat([b_hh_rz.to(cdt), b_hn.to(cdt)])
    h0 = x.new_zeros(1, x.shape[0], b_hn.shape[0])
    weights = [w_ih_f, w_hh.to(cdt), b_ih_f, b_hh]
    y = torch.gru(x, h0, weights, True, 1, 0.0, training, False, True)[0]
    return y.flip(1) if reverse else y


# The recurrent layers below hold flax's parameters and no more. PyTorch's
# fused GRU and LSTM calls take biases flax does not have (the GRU's hidden
# r/z biases, the LSTM's input biases); those are zero buffers handed to the
# call, so no optimizer can move them and ``parameters()`` are flax's leaves.
# The calls are the ones ``nn.GRU``/``nn.LSTM``/``nn.LSTMCell`` make
# (``torch.gru``/``torch.lstm`` run cuDNN on a card, which packs the
# weights per call since they are not one flattened buffer).

class GRULayer(nn.Module):
    """flax ``nn.RNN(nn.GRUCell)`` over (B, T, D) from a zero state;
    ``reverse=True`` runs right to left and keeps the output order.
    Parameters: ``weight_ih_l0`` / ``bias_ih_l0`` (r, z, n input gates),
    ``weight_hh_l0`` (hidden gates), ``bias_hn``; the r/z hidden biases are
    the zero buffer ``bias_hh_rz``. Runs ``gru_sequence``."""

    def __init__(self, in_dims: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        gru = nn.GRU(in_dims, hidden, batch_first=True)
        self.weight_ih_l0, self.weight_hh_l0 = gru.weight_ih_l0, gru.weight_hh_l0
        self.bias_ih_l0 = gru.bias_ih_l0
        self.bias_hn = nn.Parameter(gru.bias_hh_l0.detach()[2 * hidden:].clone())
        self.register_buffer("bias_hh_rz", torch.zeros(2 * hidden), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gru_sequence(x, self.weight_ih_l0, self.bias_ih_l0, self.weight_hh_l0,
                            self.bias_hh_rz, self.bias_hn, self.reverse, self.training)


class FusedLSTMLayer(nn.Module):
    """One LSTM layer over (B, T, D) from a zero state. Port of
    ``models/encoder/model.py:FusedLSTMLayer``: the input projection for all
    steps is one matmul and only the recurrence runs per step, which is what
    the fused LSTM call does. Parameters ``weight_ih_l0``, ``weight_hh_l0``,
    ``bias_hh_l0``; the input biases are the zero buffer ``bias_ih_l0``.
    ``remat``: the backward recomputes the layer instead of keeping its
    activations (``torch.utils.checkpoint``; the weights are handed in, so a
    recompute sees the ones the forward saw, cast or not)."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        lstm = nn.LSTM(in_dims, hidden, batch_first=True)
        self.weight_ih_l0, self.weight_hh_l0 = lstm.weight_ih_l0, lstm.weight_hh_l0
        self.bias_hh_l0 = lstm.bias_hh_l0
        self.register_buffer("bias_ih_l0", torch.zeros(4 * hidden), persistent=False)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        args = (x, self.weight_ih_l0, self.weight_hh_l0, self.bias_ih_l0, self.bias_hh_l0,
                self.training)
        if remat:
            return checkpoint(lstm_sequence, *args, use_reentrant=False)
        return lstm_sequence(*args)


def lstm_sequence(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                  b_hh: torch.Tensor, training: bool = False) -> torch.Tensor:
    """A one-layer LSTM over (B, T, D) from a zero state through
    ``torch.lstm``, in the promoted dtype of the input and the weights."""
    x, w_ih, w_hh, b_hh = promote(x, w_ih, w_hh, b_hh)
    h0 = x.new_zeros(1, x.shape[0], b_hh.shape[0] // 4)
    weights = [w_ih, w_hh, b_ih.to(x.dtype), b_hh]
    return torch.lstm(x, (h0, h0), weights, True, 1, 0.0, training, False, True)[0]


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: carry (c, h) → (c', h'), in the promoted
    dtype of the carry, the input and the parameters. Parameters
    ``weight_ih``, ``weight_hh``, ``bias_hh``; the input biases are the
    zero buffer ``bias_ih``."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        cell = nn.LSTMCell(in_dims, hidden)
        self.weight_ih, self.weight_hh, self.bias_hh = cell.weight_ih, cell.weight_hh, cell.bias_hh
        self.register_buffer("bias_ih", torch.zeros(4 * hidden), persistent=False)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c, h = carry
        x, c, h, w_ih, w_hh, b_hh = promote(x, c, h, self.weight_ih, self.weight_hh,
                                            self.bias_hh)
        h, c = torch.lstm_cell(x, (h, c), w_ih, w_hh, self.bias_ih.to(x.dtype), b_hh)
        return c, h


def dropout(x: torch.Tensor, p: float, generator=None,
            keep: Optional[torch.Tensor] = None, batch_dim: int = 0) -> torch.Tensor:
    """Dropout drawn from an explicit ``torch.Generator`` (the port's stand-in
    for a ``jax.random`` key), or with the keep mask ``keep`` handed in;
    flax semantics: keep with 1-p and scale by 1/(1-p). Active whenever a
    generator or a mask is passed. In a data-parallel step the mask is drawn
    at the global batch's shape along ``batch_dim`` (``multihost.rand``)."""
    if p == 0.0 or (generator is None and keep is None):
        return x
    if keep is None:
        keep = multihost.rand(x.shape, generator, x.device, batch_dim=batch_dim) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dropout(nn.Module):
    """``dropout`` as a module."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator=None,
                keep: Optional[torch.Tensor] = None, batch_dim: int = 0) -> torch.Tensor:
        return dropout(x, self.p, generator, keep, batch_dim)


# ---------------------------------------------------------------------------
# flax layers. Each computes in the promoted dtype of its input and its
# parameters, as flax's ``promote_dtype`` does: under a bf16 policy a layer
# whose input an f32 mask or noise has touched runs in f32.
# ---------------------------------------------------------------------------

def promote(x: torch.Tensor, *params):
    """``x`` and the parameters (``None`` passes through) in their common dtype."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return (x.to(dt),) + tuple(p if p is None else p.to(dt) for p in params)


def with_bias(op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *args,
              channel_dim: int = 1) -> torch.Tensor:
    """``op(x, w, b, *args)`` as flax computes it: flax adds the bias after
    the product, as an op of its own, so below f32 the product is rounded
    to the compute dtype before the bias is added. In f32 the bias is
    fused, which differs only in the last bit."""
    if b is None or x.dtype == torch.float32:
        return op(x, w, b, *args)
    y = op(x, w, None, *args)
    shape = [1] * y.ndim
    shape[channel_dim] = -1
    return y + b.reshape(shape)


class Dense(nn.Linear):
    """flax ``nn.Dense``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return with_bias(F.linear, *promote(x, self.weight, self.bias), channel_dim=-1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=eps)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class BatchNorm(nn.BatchNorm1d):
    """flax ``nn.BatchNorm`` (epsilon 1e-5) over the last axis of (B, T, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over axis 1 of
    (B, C, ...), in eval and in training mode.

    Eval mode normalises with the running statistics. Training mode
    normalises with the batch's mean and biased variance, both in float32
    (float64 for float64 inputs)
    (flax's E[x²] − E[x]², clipped at 0), and sets each running statistic to
    0.9·running + 0.1·batch, with the *biased* variance (PyTorch's
    BatchNorm would take the unbiased one). The update reads the running
    statistics rounded to the parameters' dtype, as the JAX step under a
    bf16 policy casts its ``batch_stats``, multiplies them by 0.9 in that
    dtype, and writes the float32 result back into the buffers. The output is in the promoted dtype of the input
    and the parameters. In a data-parallel step (``multihost.sharded``) the
    mean and E[x²] are those of the global batch, all-reduced over the ranks
    with their gradient, as under the JAX package's mesh."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.ndim - 2)
        out_dt = promote(x, self.weight, self.bias)[0].dtype
        cdt = torch.promote_types(out_dt, torch.float32)
        xf = x.to(cdt)
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            # in a data-parallel step, the statistics of the global batch
            mean = multihost.all_reduce_mean(xf.mean(dims))
            var = torch.clamp(multihost.all_reduce_mean((xf * xf).mean(dims)) - mean * mean,
                              min=0.0)
            # the momentum in the parameters' dtype (bf16: 0.8984375), as
            # JAX casts the Python scalar that multiplies the rounded stats
            momentum = torch.tensor(0.9, dtype=self.weight.dtype)
            with torch.no_grad():
                for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                    buf.copy_((momentum * buf.to(self.weight.dtype)).to(cdt) + (1 - 0.9) * stat)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(cdt)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.to(cdt).view(shape)
        return y.to(out_dt)


def weight_norm(v: torch.Tensor, scale: torch.Tensor, out_dim: int) -> torch.Tensor:
    """flax ``nn.WeightNorm`` of a kernel: ``v · rsqrt(Σv² + 1e-12) · scale``
    in flax's order, the sum over every axis but the output-feature axis
    ``out_dim``. Returned in f32 (f64 for f64 parameters), for the caller
    to cast to the dtype its conv runs in. With bf16 parameters it rounds
    where jitted XLA does: the
    sum (``jnp.sum`` accumulates in f32 and rounds its result), the rsqrt
    and the normalised direction, but not the product with ``scale``, which
    stays in the fusion that feeds the conv."""
    dims = [d for d in range(v.ndim) if d != out_dim]
    shape = [1] * v.ndim
    shape[out_dim] = -1
    wdt = v.dtype
    cdt = torch.promote_types(wdt, torch.float32)

    def rnd(a):
        return a.to(wdt).to(cdt)

    v = v.to(cdt)
    inv = rnd(torch.rsqrt(rnd((v * v).sum(dim=dims, keepdim=True)) + 1e-12))
    return rnd(v * inv) * scale.to(cdt).reshape(shape)


def same_padding(t: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax ``padding="SAME"``: (low, high) pads for length ``t``; with a
    stride the total is ``(ceil(t/s) - 1)·s + k_eff - t``, low gets half."""
    k_eff = (k - 1) * dilation + 1
    total = max((-(-t // stride) - 1) * stride + k_eff - t, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over one axis with ``padding="SAME"``, ``"VALID"`` or
    explicit ``(low, high)`` pads, optionally wrapped in flax ``nn.WeightNorm``. ``weight`` is
    in torch's (out, in/groups, k) layout; a weight-normed conv keeps it as
    the direction and ``scale`` (out,) as the gain, initialised to 1 as flax
    does. Takes (B, T, C) when ``time_major``, else (B, C, T)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False,
                 time_major: bool = True, zero_init: bool = False,
                 padding: Union[str, Tuple[int, int]] = "SAME"):
        super().__init__()
        conv = nn.Conv1d(in_ch, out_ch, k, stride=stride, dilation=dilation, groups=groups,
                         bias=bias)
        self.weight, self.bias = conv.weight, conv.bias
        if zero_init:
            with torch.no_grad():
                self.weight.zero_()
                if bias:
                    self.bias.zero_()
        self.scale = nn.Parameter(torch.ones(out_ch)) if weight_norm else None
        self.weight_norm = weight_norm
        self.k, self.stride, self.dilation, self.groups = k, stride, dilation, groups
        self.time_major = time_major
        self.padding = padding

    def kernel(self) -> torch.Tensor:
        if self.weight_norm:
            return weight_norm(self.weight, self.scale, 0)
        return self.weight

    def forward(self, x: torch.Tensor, kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``kernel`` (``weight``'s layout) replaces the conv's own, as
        ``SpectralNorm`` hands in its normalised one."""
        x, _, b = promote(x, self.weight, self.bias)
        w = (self.kernel() if kernel is None else kernel).to(x.dtype)
        if self.time_major:
            x = x.transpose(1, 2)
        if self.padding == "SAME":
            pad = same_padding(x.shape[-1], self.k, self.stride, self.dilation)
        else:
            pad = (0, 0) if self.padding == "VALID" else tuple(self.padding)
        if pad != (0, 0):
            x = F.pad(x, pad)
        y = with_bias(F.conv1d, x, w, b, self.stride, 0, self.dilation, self.groups)
        return y.transpose(1, 2) if self.time_major else y


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose`` with ``padding="VALID"`` (output length
    (T-1)·stride + k) inside ``nn.WeightNorm``, on (B, C, T). flax does not
    flip the kernel, torch's ``conv_transpose1d`` (the adjoint of a conv)
    does: ``weight`` (in, out, k) holds the flax kernel flipped along k."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int):
        super().__init__()
        conv = nn.ConvTranspose1d(in_ch, out_ch, k, stride=stride)
        self.weight, self.bias = conv.weight, conv.bias
        self.scale = nn.Parameter(torch.ones(out_ch))
        self.weight_norm = True
        self.stride = stride

    def kernel(self) -> torch.Tensor:
        return weight_norm(self.weight, self.scale, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _, b = promote(x, self.weight, self.bias)
        w = self.kernel().to(x.dtype)
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            # oneDNN's bf16 strided conv, which computes this layer's input
            # gradient, returns wrong sums at some shapes (16 → 32 channels,
            # kernel 8, stride 4: relative error ~1.2 against float64);
            # float32 rounded once is what the card's bf16 conv gives
            y = F.conv_transpose1d(x.float(), w.float(), None, self.stride).to(x.dtype)
            return y if b is None else y + b.reshape(1, -1, 1)
        return with_bias(F.conv_transpose1d, x, w, b, self.stride)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over two axes with explicit ((lo, hi), (lo, hi))
    padding inside ``nn.WeightNorm``, on (B, C, H, W)."""

    def __init__(self, in_ch: int, out_ch: int, k: Tuple[int, int], stride: Tuple[int, int],
                 padding: Tuple[Tuple[int, int], Tuple[int, int]]):
        super().__init__()
        conv = nn.Conv2d(in_ch, out_ch, k, stride=stride)
        self.weight, self.bias = conv.weight, conv.bias
        self.scale = nn.Parameter(torch.ones(out_ch))
        self.weight_norm = True
        self.stride = stride
        (h0, h1), (w0, w1) = padding
        self.pad = (w0, w1, h0, h1)

    def kernel(self) -> torch.Tensor:
        return weight_norm(self.weight, self.scale, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, _, b = promote(x, self.weight, self.bias)
        w = self.kernel().to(x.dtype)
        return with_bias(F.conv2d, F.pad(x, self.pad), w, b, self.stride)


class SpectralNorm(nn.Module):
    """flax ``nn.SpectralNorm`` (flax 0.12, ``n_steps`` 1, ``eps`` 1e-12)
    around a ``Conv1d`` without weight norm: the conv runs with its kernel
    divided by the kernel's largest singular value, estimated by one power
    iteration from the stored ``u``.

    flax's semantics, which ``torch.nn.utils.spectral_norm`` does not have:
      * the kernel is the matrix (-1, out) of flax's (k, in/g, out) layout,
        ``u`` is (1, out) (the iteration does not depend on the order of
        the rows, so torch's (out, in/g, k) is read as it lies);
      * the iteration runs on every call, eval included, from the stored
        ``u``; ``update_stats`` decides only whether the new ``u`` and
        ``sigma`` are stored, so a second call after an update starts from
        the first call's ``u``. The stored ``sigma`` is never divided by;
      * ``u`` and ``v`` carry no gradient; ``sigma = v·W·uᵀ`` does, through
        the kernel;
      * below float32 the iteration runs in the kernel's dtype, ``u`` read
        rounded to it (the JAX step casts its ``batch_stats``), each
        product, sum and root rounded where jitted XLA rounds them, and the
        stored results are those rounded values in float32 (float64 runs
        in float64 throughout).

    ``u`` is drawn N(0, 1) at construction (flax's initialiser, from the
    torch generator instead of a JAX key); ``sigma`` starts at 1."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer
        out = layer.weight.shape[0]
        self.register_buffer("u", torch.randn(1, out))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_kernel(self, update_stats: bool = False) -> torch.Tensor:
        w = self.layer.weight
        wdt = w.dtype
        cdt = torch.promote_types(wdt, torch.float32)

        def rnd(a):
            return a.to(wdt).to(cdt)

        def l2_normalize(a):
            return rnd(a * rnd(torch.rsqrt(rnd(rnd(a * a).sum()) + 1e-12)))

        mat = w.to(cdt).reshape(w.shape[0], -1)              # (out, rows)
        with torch.no_grad():
            u = rnd(self.u.to(cdt))
            v = l2_normalize(rnd(u @ mat))                   # (1, rows)
            u = l2_normalize(rnd(v @ mat.T))                 # (1, out)
        sigma = rnd(rnd(v @ mat.T) @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return rnd(w.to(cdt) / torch.where(sigma != 0, sigma, torch.ones_like(sigma)))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return self.layer(x, kernel=self.normalized_kernel(update_stats))
