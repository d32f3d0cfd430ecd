"""LogMMSE speech denoiser (numpy, host-side).

A copy of ``mockingbird_tpu/dsp/logmmse.py`` (the port imports nothing of
the JAX package): ``profile_noise`` and ``denoise``, the Ephraim–Malah (1985)
log-spectral amplitude MMSE estimator with decision-directed a-priori SNR
tracking, as the synthesizer's wav loading uses them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import exp1


@dataclass
class NoiseProfile:
    sample_rate: int
    window_size: int
    len1: int
    len2: int
    win: np.ndarray
    noise_mu2: np.ndarray


def profile_noise(noise: np.ndarray, sampling_rate: int, window_size: int = 0) -> NoiseProfile:
    """Estimate the noise power spectrum from a noise-only clip."""
    win_size = window_size or int(sampling_rate * 0.02)  # 20 ms
    if win_size % 2 == 1:
        win_size += 1
    len1 = win_size // 2  # 50% overlap-add
    len2 = win_size - len1
    win = np.hanning(win_size)
    win = win * len1 / np.sum(win)

    nframes = (len(noise) - win_size) // len1
    if nframes < 1:
        raise ValueError("noise clip too short to profile")
    noise_mu2 = np.zeros(win_size)
    for i in range(nframes):
        seg = noise[i * len1 : i * len1 + win_size] * win
        noise_mu2 += np.abs(np.fft.fft(seg, win_size)) ** 2
    noise_mu2 /= nframes
    return NoiseProfile(sampling_rate, win_size, len1, len2, win, noise_mu2)


def denoise(wav: np.ndarray, profile: NoiseProfile, eta: float = 0.15) -> np.ndarray:
    """Suppress stationary noise in ``wav`` given a noise profile."""
    wav = np.asarray(wav, np.float64)
    w, len1 = profile.window_size, profile.len1
    win, noise_mu2 = profile.win, profile.noise_mu2

    nframes = (len(wav) - w) // len1 + 1
    if nframes < 1:
        return wav.astype(np.float32)
    x_final = np.zeros(nframes * len1 + w)

    aa = 0.98
    ksi_min = 10 ** (-25 / 10)
    x_old = np.zeros(len1)
    xk_prev = np.zeros(w)

    for n in range(nframes):
        seg = wav[n * len1 : n * len1 + w] * win
        spec = np.fft.fft(seg, w)
        sig2 = np.abs(spec) ** 2

        gammak = np.minimum(sig2 / np.maximum(noise_mu2, 1e-12), 40)
        if n == 0:
            ksi = aa + (1 - aa) * np.maximum(gammak - 1, 0)
        else:
            ksi = aa * xk_prev / np.maximum(noise_mu2, 1e-12) + (1 - aa) * np.maximum(gammak - 1, 0)
            ksi = np.maximum(ksi_min, ksi)

        log_sigma_k = gammak * ksi / (1 + ksi) - np.log(1 + ksi)
        vad_decision = np.sum(log_sigma_k) / w
        if vad_decision < eta:  # noise-only frame: update noise spectrum
            noise_mu2 = 0.9 * noise_mu2 + 0.1 * sig2

        vk = ksi * gammak / (1 + ksi)
        ei_vk = 0.5 * exp1(np.maximum(vk, 1e-10))
        hw = ksi / (1 + ksi) * np.exp(ei_vk)
        sig_hat = np.abs(spec) * hw
        xk_prev = sig_hat ** 2

        xi_w = np.real(np.fft.ifft(sig_hat * np.exp(1j * np.angle(spec)), w))
        x_final[n * len1 : n * len1 + len1] = x_old + xi_w[:len1]
        x_old = xi_w[len1:]

    out = x_final[: len(wav)].astype(np.float32)
    return out
