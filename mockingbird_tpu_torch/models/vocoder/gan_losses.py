"""GAN losses (LSGAN + feature matching) and the VITS KL.

Port of the parts of ``mockingbird_tpu/models/vocoder/gan_losses.py`` that
the VITS trainer uses: feature loss is 2×Σ mean L1 over all feature maps;
discriminator loss is Σ (1−D(y))² + D(ŷ)²; generator adversarial loss is
Σ (1−D(ŷ))².
"""
from __future__ import annotations

import torch


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


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    """VITS prior/posterior KL, in f32 whatever the inputs' dtype."""
    z_p, logs_q, m_p, logs_p = (a.float() for a in (z_p, logs_q, m_p, logs_p))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / torch.sum(z_mask)
