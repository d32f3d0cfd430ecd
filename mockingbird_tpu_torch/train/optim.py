"""optax's optimizer pieces that the JAX trainers chain, with optax's semantics.

  * ``clip_by_global_norm``: every gradient scaled by ``max_norm / norm`` when
    the global norm is at least ``max_norm`` (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` and clips whenever the norm exceeds ``max_norm``);
  * ``warmup_cosine_decay``: ``optax.warmup_cosine_decay_schedule`` as the
    factor of a ``LambdaLR``. optax evaluates its schedule at the number of
    updates made so far, so the first update takes the schedule's value at
    0; a ``LambdaLR`` stepped once after every ``opt.step()`` does the same;
  * ``adamw``: ``optax.adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4, where ``torch.optim.AdamW`` defaults to 1e-2). optax
    adds ``wd·p`` to the Adam direction before the learning rate scales it;
    ``AdamW`` multiplies ``p`` by ``1 - lr·wd`` first: the same update.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import torch


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float = 1.0) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: scale every gradient by
    max_norm / norm when the global norm is at least ``max_norm``.
    Returns the norm (a tensor; no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def warmup_cosine_decay(warmup_steps: int, decay_steps: int):
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` as the factor of the peak learning rate after ``count``
    updates, for ``LambdaLR``: linear from 0 to 1 over ``warmup_steps``
    updates, then a cosine decay to 0 at ``decay_steps`` updates, the
    warmup included."""
    span = decay_steps - warmup_steps

    def factor(count: int) -> float:
        if count < warmup_steps:
            return count / warmup_steps
        t = min(count - warmup_steps, span)
        return 0.5 * (1.0 + math.cos(math.pi * t / span))

    return factor


def adamw(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)`` with its defaults."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
