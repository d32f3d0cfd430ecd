"""Discretized mixture-of-logistics loss and sampling.

Port of ``mockingbird_tpu/models/vocoder/distribution.py`` (the
r9y9/wavenet_vocoder formulation): 10 logistic mixtures over audio in
[-1, 1] quantised to ``num_classes`` levels, 30 parameters per sample
(mixture logits, means, log scales). Time-major (B, T, C) layout.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LOG_SCALE_MIN = math.log(1e-14)


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN,
                                  reduce: bool = True) -> torch.Tensor:
    """Negative log-likelihood of ``y`` (B, T, 1) in [-1, 1] under the
    mixture ``y_hat`` (B, T, 30): the mean, or (B, T, 1) per element."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:], min=log_scale_min)

    y = y.expand(*y.shape[:-1], nr_mix)
    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_y + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered_y - 1.0 / (num_classes - 1))
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)            # log P(X < first bin edge)
    log_one_minus_cdf_min = -F.softplus(min_in)             # log P(X > last bin edge)
    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                              log_pdf_mid - math.log((num_classes - 1) / 2.0))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    nll = -torch.logsumexp(log_probs, dim=-1)
    return nll.mean() if reduce else nll[..., None]


def sample_from_discretized_mix_logistic(y: torch.Tensor, generator: Optional[torch.Generator] = None,
                                         log_scale_min: float = LOG_SCALE_MIN,
                                         draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                         ) -> torch.Tensor:
    """y (B, T, 30) → samples (B, T) in [-1, 1]: a mixture chosen by
    Gumbel-max over the logits, then a logistic sample of its mean and
    scale. ``draws`` hands in the two draws, Gumbel noise (B, T, 10) and
    uniforms (B, T) in [1e-5, 1 - 1e-5) (the JAX package's, for parity);
    else they come from ``generator``."""
    nr_mix = y.shape[-1] // 3
    if draws is None:
        u_mix = torch.rand(*y.shape[:-1], nr_mix, generator=generator, device=y.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u_mix, min=torch.finfo(u_mix.dtype).tiny)))
        u = 1e-5 + (1.0 - 2e-5) * torch.rand(*y.shape[:-1], generator=generator, device=y.device)
    else:
        gumbel, u = draws
    idx = torch.argmax(y[..., :nr_mix] + gumbel, dim=-1)
    onehot = F.one_hot(idx, nr_mix).to(y.dtype)
    means = torch.sum(y[..., nr_mix:2 * nr_mix] * onehot, dim=-1)
    log_scales = torch.clamp(torch.sum(y[..., 2 * nr_mix:] * onehot, dim=-1), min=log_scale_min)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return torch.clamp(x, -1.0, 1.0)
