"""Device-side spectrogram ops in PyTorch.

Port of ``mockingbird_tpu/dsp/stft.py`` (the parts on the voice-cloning
path): the STFT is a windowed-frame gather followed by one matmul with a
precomputed real-DFT basis, exactly as the JAX package computes it, so the
two agree to float32 rounding. Spectrograms are **time-major**
``(..., frames, bins)``.

  * ``melspectrogram`` — SV2TTS dialect: preemphasis + dB-norm to ±4
  * ``mel_encoder``    — GE2E dialect: power-2 mel, no log
  * ``spectrogram_vits`` / ``mel_vits`` — torch-STFT dialect of VITS:
    reflect pad (n_fft-hop)/2, log-clamp compression; differentiable, as the
    generator's mel loss runs through it
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filterbank


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: two (n_fft, n_bins) matrices (cos, -sin), with
    the periodic Hann window (centre-padded to n_fft) folded in."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    wcol = window[:, None]
    return (np.cos(angle) * wcol).astype(np.float32), (-np.sin(angle) * wcol).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_basis(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    # transposed: spectra are time-major, the contraction is on the bins axis
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T.copy()


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x`` (..., T) into overlapping frames (..., n_frames, frame_length)."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None,
         center: bool = True, pad_mode: str = "reflect") -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT via a DFT-basis matmul. Returns (real, imag), each (..., frames, bins)."""
    win_length = win_length or n_fft
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode=pad_mode).reshape(*lead, -1)
    frames = frame(x, n_fft, hop)
    cos_b, nsin_b = _dft_basis(n_fft, win_length)
    return frames @ _const(cos_b, frames), frames @ _const(nsin_b, frames)


def stft_magnitude(x, n_fft, hop, win_length=None, center=True, pad_mode="reflect", eps=0.0):
    re, im = stft(x, n_fft, hop, win_length, center, pad_mode)
    return torch.sqrt(re * re + im * im + eps)


def preemphasis(x: torch.Tensor, k: float) -> torch.Tensor:
    """y[n] = x[n] - k*x[n-1]."""
    return torch.cat([x[..., :1], x[..., 1:] - k * x[..., :-1]], dim=-1)


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    min_level = float(np.exp(min_level_db / 20 * np.log(10)))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def normalize_db(S, min_level_db, max_abs_value, symmetric=True, clip=True):
    """dB → normalised mel range."""
    if symmetric:
        out = (2 * max_abs_value) * ((S - min_level_db) / (-min_level_db)) - max_abs_value
        return torch.clamp(out, -max_abs_value, max_abs_value) if clip else out
    out = max_abs_value * ((S - min_level_db) / (-min_level_db))
    return torch.clamp(out, 0, max_abs_value) if clip else out


def melspectrogram(wav: torch.Tensor, cfg) -> torch.Tensor:
    """SV2TTS mel: (..., T) float wav → (..., frames, num_mels) in ±max_abs_value."""
    x = preemphasis(wav, cfg.preemphasis) if cfg.preemphasize else wav
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_size, cfg.win_size)
    melb = _const(_mel_basis(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax), mag)
    S = amp_to_db(mag @ melb, cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        return normalize_db(S, cfg.min_level_db, cfg.max_abs_value,
                            cfg.symmetric_mels, cfg.allow_clipping_in_normalization)
    return S


def mel_encoder(wav: torch.Tensor, cfg) -> torch.Tensor:
    """40-channel power-2 mel, NOT log-scaled (GE2E frontend): reflect-padded
    centred STFT, fmin 0, fmax sr/2. Returns time-major (..., frames, 40)."""
    sr = cfg.sample_rate
    n_fft = int(sr * cfg.mel_window_length_ms / 1000)
    hop = int(sr * cfg.mel_window_step_ms / 1000)
    mag = stft_magnitude(wav, n_fft, hop, n_fft, center=True, pad_mode="reflect")
    melb = _const(_mel_basis(sr, n_fft, cfg.mel_n_channels, 0.0, sr / 2.0), mag)
    return (mag * mag) @ melb


def spectrogram_vits(wav: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Linear magnitude spectrogram, torch dialect: reflect-pad (n_fft-hop)/2
    per side, center=False, +1e-6 under the sqrt. (..., T) → (..., frames, bins)."""
    pad = (n_fft - hop) // 2
    lead = wav.shape[:-1]
    x = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad), mode="reflect")
    return stft_magnitude(x.reshape(*lead, -1), n_fft, hop, win_length, center=False, eps=1e-6)


def spec_to_mel_vits(spec: torch.Tensor, sr, n_fft, num_mels, fmin, fmax) -> torch.Tensor:
    """Mel projection + log-clamp compression at 1e-5."""
    melb = _const(_mel_basis(sr, n_fft, num_mels, fmin, fmax), spec)
    return torch.log(torch.clamp(spec @ melb, min=1e-5))


def mel_vits(wav: torch.Tensor, cfg) -> torch.Tensor:
    """wav → log-mel, torch dialect."""
    spec = spectrogram_vits(wav, cfg.n_fft, cfg.hop_size, cfg.win_size)
    return spec_to_mel_vits(spec, cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
