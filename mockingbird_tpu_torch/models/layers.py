"""Recurrent layers with the JAX package's numerics and parameter layout.

flax's ``GRUCell`` and ``LSTMCell`` differ from PyTorch's in where the biases
sit: a flax GRU has biases on the three input gates and on ``hn`` only, a
flax LSTM on the four hidden gates only. The formulas are otherwise PyTorch's
(GRU gates r, z, n with n = tanh(W_in·x + b_in + r·(W_hn·h + b_hn)); LSTM
gates i, f, g, o). The sequence layers here therefore use PyTorch's fused
``nn.GRU`` / ``nn.LSTM`` with the biases flax lacks held at zero, and
``weights.py`` fills the rest from a flax tree.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class FusedGRUCell(nn.Module):
    """One GRU step as two matmuls: ``wi`` = [ir|iz|in] (+ input biases),
    ``wh`` = [hr|hz|hn] (no bias), ``bn`` the ``hn`` bias. Port of
    ``models/tacotron/model.py:FusedGRUCell`` (also flax ``nn.GRUCell``)."""

    def __init__(self, in_dims: int, features: int):
        super().__init__()
        self.features = features
        self.wi = nn.Linear(in_dims, 3 * features)
        self.wh = nn.Linear(features, 3 * features, bias=False)
        self.bn = nn.Parameter(torch.zeros(features))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        xr, xz, xn = self.wi(x).chunk(3, dim=-1)
        hr, hz, hn = self.wh(h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self.bn))
        return (1.0 - z) * n + z * h


class GRULayer(nn.Module):
    """flax ``nn.RNN(nn.GRUCell)`` over (B, T, D) from a zero state;
    ``reverse=True`` runs right to left and keeps the output order."""

    def __init__(self, in_dims: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.gru = nn.GRU(in_dims, hidden, batch_first=True)
        with torch.no_grad():
            self.gru.bias_hh_l0[: 2 * hidden].zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reverse:
            return self.gru(x.flip(1))[0].flip(1)
        return self.gru(x)[0]


class FusedLSTMLayer(nn.Module):
    """One LSTM layer over (B, T, D) from a zero state. Port of
    ``models/encoder/model.py:FusedLSTMLayer``: the input projection for all
    steps is one matmul and only the recurrence runs per step, which is what
    the fused ``nn.LSTM`` kernel does."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        self.lstm = nn.LSTM(in_dims, hidden, batch_first=True)
        with torch.no_grad():
            self.lstm.bias_ih_l0.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: carry (c, h) → (c', h')."""

    def __init__(self, in_dims: int, hidden: int):
        super().__init__()
        self.cell = nn.LSTMCell(in_dims, hidden)
        with torch.no_grad():
            self.cell.bias_ih.zero_()

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c, h = carry
        h, c = self.cell(x, (h, c))
        return c, h


class Dropout(nn.Module):
    """Dropout drawn from an explicit ``torch.Generator`` (the port's
    stand-in for a ``jax.random`` key); flax semantics: keep with 1-p and
    scale by 1/(1-p). Active whenever a generator is passed."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if generator is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))
