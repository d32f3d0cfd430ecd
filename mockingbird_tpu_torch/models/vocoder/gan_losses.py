"""GAN losses (LSGAN + feature matching), Fre-GAN's multi-resolution STFT
loss and the VITS KL.

Port of ``mockingbird_tpu/models/vocoder/gan_losses.py``: feature loss is
2×Σ mean L1 over all feature maps; discriminator loss is Σ (1−D(y))² +
D(ŷ)²; generator adversarial loss is Σ (1−D(ŷ))².
"""
from __future__ import annotations

import torch

from ...dsp.stft import stft
from ...parallel import multihost


def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        gl = torch.mean((1 - dg) ** 2)
        gen_losses.append(gl)
        loss = loss + gl
    return loss, gen_losses


# Fre-GAN's auxiliary loss, (fft_size, hop, win_length) per resolution
DEFAULT_STFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def _stft_mag(x, fft_size, hop, win_length):
    """|STFT| with torch.stft's default centering (reflect padding), the
    power clamped at 1e-7 before the square root."""
    re, im = stft(x, fft_size, hop, win_length, center=True, pad_mode="reflect")
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-7))


def stft_loss(x, y, fft_size, hop, win_length):
    """(spectral convergence, log-magnitude L1) of predicted ``x`` against
    ground truth ``y``, both (B, T), at one resolution."""
    x_mag = _stft_mag(x, fft_size, hop, win_length)
    y_mag = _stft_mag(y, fft_size, hop, win_length)
    num, den = torch.linalg.vector_norm(y_mag - x_mag), torch.linalg.vector_norm(y_mag)
    if multihost.active():   # a data-parallel step: the global batch's norms
        num = torch.sqrt(multihost.all_reduce_sum(num * num))
        den = torch.sqrt(multihost.all_reduce_sum(den * den))
    sc = num / torch.clamp(den, min=1e-7)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(x, y, resolutions=DEFAULT_STFT_RESOLUTIONS):
    """``stft_loss``'s two terms, each averaged over ``resolutions``."""
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win_length in resolutions:
        sc, mag = stft_loss(x, y, fft_size, hop, win_length)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    """VITS prior/posterior KL, in f32 whatever the inputs' dtype."""
    z_p, logs_q, m_p, logs_p = (a.float() for a in (z_p, logs_q, m_p, logs_p))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / multihost.global_count(torch.sum(z_mask))
