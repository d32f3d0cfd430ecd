"""The few operations the reference networks are written in, at a stated
precision.

``Prec("float32")`` is the reference itself: float32 throughout, with
TF32 turned off for matrix products and convolutions (``no_tf32``).
``Prec("bfloat16")`` computes every weight, activation and state in
bfloat16. ``Prec("float8")`` rounds both operands of every product
(matrix product or convolution) to float8 e4m3 with one scale per tensor,
as float8 inference does, and accumulates in float32. The two lower ones
are the controls: the reference put in the program's place one step below
the precision the configuration states.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude maps to 448), returned in float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """One of "float32", "bfloat16", "float8" (see the module docstring).
    Weights are cast (or rounded) once and kept."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
        self._weights: dict = {}

    def __repr__(self) -> str:
        return f"Prec({self.name!r})"

    def t(self, x: torch.Tensor) -> torch.Tensor:
        """An input or state in the compute dtype."""
        return x.to(self.dtype) if x.is_floating_point() else x

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as a product's operand."""
        return round_e4m3(x) if self.name == "float8" else self.t(x)

    def weight(self, w: torch.Tensor, product: bool = True) -> torch.Tensor:
        """A weight (a product's operand, or a bias or a statistic when not
        ``product``) in the compute dtype, cast once."""
        key = (id(w), product)
        if key not in self._weights:
            self._weights[key] = (w, self.operand(w) if product else self.t(w))
        return self._weights[key][1]


def fused(w: dict, key: str, parts, what: str = "kernel") -> torch.Tensor:
    """The leaves ``key/<part>/<what>`` side by side on the last axis (made
    once and kept in ``w``)."""
    name = f"{key}/[{'|'.join(parts)}]/{what}"
    if name not in w:
        w[name] = torch.cat([w[f"{key}/{g}/{what}"] for g in parts], dim=-1)
    return w[name]


def linear(p: Prec, x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ kernel (in, out) (+ bias)."""
    y = p.operand(x) @ p.weight(kernel)
    return y if bias is None else y + p.weight(bias, False)


def conv1d(p: Prec, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
           pad: Tuple[int, int] = (0, 0), dilation: int = 1) -> torch.Tensor:
    """Cross-correlation of x (B, C_in, T) with a flax kernel (k, in, out),
    zero-padded by ``pad`` (low, high)."""
    y = F.conv1d(F.pad(p.operand(x), pad), p.weight(kernel).permute(2, 1, 0), None, 1, 0,
                 dilation)
    return y if bias is None else y + p.weight(bias, False)[None, :, None]


def batch_norm(p: Prec, x: torch.Tensor, w: dict, key: str, axis: int = 1) -> torch.Tensor:
    """Eval-mode BatchNorm over axis ``axis`` with flax's ``scale``/``bias``
    and running ``mean``/``var`` (epsilon 1e-5)."""
    shape = [1] * x.ndim
    shape[axis] = -1

    def leaf(name):
        return p.weight(w[name], False).view(shape)
    return ((x - leaf(f"batch_stats/{key}/mean")) * torch.rsqrt(leaf(f"batch_stats/{key}/var") + 1e-5)
            * leaf(f"params/{key}/scale") + leaf(f"params/{key}/bias"))


def gru_cell(p: Prec, w: dict, key: str, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """flax GRUCell: r, z from input and hidden gates (biases on the input
    gates), n = tanh(in·x + b + r·(hn·h + b_hn)), h' = (1 − z)·n + z·h."""
    gi = linear(p, x, fused(w, key, ("ir", "iz", "in")), fused(w, key, ("ir", "iz", "in"), "bias"))
    gh = linear(p, h, fused(w, key, ("hr", "hz", "hn")))
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * (h_n + p.weight(w[f"{key}/hn/bias"], False)))
    return (1.0 - z) * n + z * h


def lstm_cell(p: Prec, w: dict, key: str, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax LSTMCell, gates i, f, g, o with biases on the hidden side;
    state (c, h) → (c', h')."""
    c, h = state
    hidden = ("hi", "hf", "hg", "ho")
    gates = (linear(p, x, fused(w, key, ("ii", "if", "ig", "io")))
             + linear(p, h, fused(w, key, hidden), fused(w, key, hidden, "bias")))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)
