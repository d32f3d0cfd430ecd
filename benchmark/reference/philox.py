"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11) and the Gumbel noise WaveRNN's sampler draws from it: 32
bits per (class, fold, step) under the counter (class, fold, step, 0) and
the key (low, high word of the seed); 23 of them as a uniform + 1e-7, then
−log(−log u).

A frozen copy of the port's ``philox4x32_10`` and ``gumbel_noise``
(``mockingbird_tpu_torch/ops/wavernn_sample.py``), on int64 tensors that
hold 32-bit words, exact: products are split into 16-bit halves.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    lo_part = (a & 0xFFFF) * m
    hi_part = (a >> 16) * m
    s = ((hi_part & 0xFFFF) << 16) + lo_part
    return (hi_part >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def gumbel(seed: int, t0: int, t1: int, fold0: int, n_folds: int, n_classes: int,
           device) -> torch.Tensor:
    """(t1 − t0, n_folds, n_classes) float32 noise of steps [t0, t1) for
    folds [fold0, fold0 + n_folds) of a launch seeded with ``seed``."""
    seed = int(seed) & (2 ** 64 - 1)
    i64 = dict(dtype=torch.int64, device=device)
    bits = philox4x32_10(torch.arange(n_classes, **i64)[None, None, :],
                         torch.arange(fold0, fold0 + n_folds, **i64)[None, :, None],
                         torch.arange(t0, t1, **i64)[:, None, None], 0,
                         seed & _MASK32, seed >> 32)[0]
    uni = (bits & 0x7FFFFF).float() * (1.0 / (1 << 23)) + 1e-7
    return -torch.log(-torch.log(uni))
