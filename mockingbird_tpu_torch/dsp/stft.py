"""Device-side spectrogram ops in PyTorch.

Port of ``mockingbird_tpu/dsp/stft.py``: the STFT is a windowed-frame
gather followed by one matmul with a precomputed real-DFT basis, and the
inverse STFT a matmul with the real inverse basis followed by overlap-add,
exactly as the JAX package computes them, so the two agree to float32
rounding. Spectrograms are **time-major** ``(..., frames, bins)``.

  * ``melspectrogram`` / ``linearspectrogram`` — SV2TTS dialect:
    preemphasis + dB-norm to ±4
  * ``inv_mel_spectrogram`` — its inverse through ``griffin_lim`` (or the
    single-pass ``spsi``) and ``inv_preemphasis``; the initial random phase
    comes from a ``torch.Generator``, or is handed in as ``angles``
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
    window = _hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    wcol = window[:, None]
    return (np.cos(angle) * wcol).astype(np.float32), (-np.sin(angle) * wcol).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mel_basis(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    # transposed: spectra are time-major, the contraction is on the bins axis
    return mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T.copy()


def _hann(m: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(m) / m)


@functools.lru_cache(maxsize=None)
def _idft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real inverse-DFT basis of a one-sided spectrum: (bins, n_fft) matrices
    (C, S) with x = re @ C + im @ S."""
    n_bins = 1 + n_fft // 2
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    angle = 2.0 * np.pi * k * n / n_fft
    scale = np.full((n_bins, 1), 2.0)
    scale[0, 0] = 1.0
    if n_fft % 2 == 0:
        scale[-1, 0] = 1.0
    c = scale * np.cos(angle) / n_fft
    s = -scale * np.sin(angle) / n_fft
    return c.astype(np.float32), s.astype(np.float32)


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
        half, n = n_fft // 2, x.shape[-1]
        if pad_mode == "reflect" and half >= n > 1:
            # numpy's reflection, repeated where the pad outgrows the signal
            idx = np.abs(np.arange(-half, n + half)) % (2 * (n - 1))
            x = x[..., torch.from_numpy(np.where(idx >= n, 2 * (n - 1) - idx, idx)).to(x.device)]
        else:
            lead = x.shape[:-1]
            x = F.pad(x.reshape(-1, 1, n), (half, half), mode=pad_mode).reshape(*lead, -1)
    frames = frame(x, n_fft, hop)
    cos_b, nsin_b = _dft_basis(n_fft, win_length)
    return frames @ _const(cos_b, frames), frames @ _const(nsin_b, frames)


def stft_magnitude(x, n_fft, hop, win_length=None, center=True, pad_mode="reflect", eps=0.0):
    re, im = stft(x, n_fft, hop, win_length, center, pad_mode)
    return torch.sqrt(re * re + im * im + eps)


def _overlap_add(frames_t: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (..., F, n_fft) frames at stride ``hop`` → (..., out_len):
    n_fft/hop shifted adds where hop divides n_fft, as the JAX package adds
    them, else one scatter-add."""
    *lead, n_frames, n_fft = frames_t.shape
    if n_fft % hop == 0:
        k = n_fft // hop
        fr = frames_t.reshape(*lead, n_frames, k, hop)
        y = frames_t.new_zeros(*lead, n_frames + k - 1, hop)
        for c in range(k):
            y[..., c:c + n_frames, :] += fr[..., :, c, :]
        return y.reshape(*lead, (n_frames + k - 1) * hop)
    out_len = n_fft + hop * (n_frames - 1)
    idx = torch.from_numpy(np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :])
    flat = frames_t.reshape(-1, n_frames * n_fft)
    y = flat.new_zeros(flat.shape[0], out_len).index_add_(
        1, idx.reshape(-1).to(flat.device), flat)
    return y.reshape(*lead, out_len)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          win_length: Optional[int] = None, center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT (overlap-add with squared-window normalisation) of
    (..., frames, bins) spectra."""
    win_length = win_length or n_fft
    window = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    window[lpad:lpad + win_length] = _hann(win_length)
    cb, sb = _idft_basis(n_fft)
    frames_t = (real @ _const(cb, real) + imag @ _const(sb, imag)) * _const(window, real)
    n_frames = frames_t.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    y = _overlap_add(frames_t, hop)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    wsq = np.zeros(out_len)
    np.add.at(wsq, idx.reshape(-1), np.tile(window ** 2, n_frames))
    y = y / _const(np.maximum(wsq, 1e-10), y)
    if center:
        y = y[..., n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y


def preemphasis(x: torch.Tensor, k: float) -> torch.Tensor:
    """y[n] = x[n] - k*x[n-1]."""
    return torch.cat([x[..., :1], x[..., 1:] - k * x[..., :-1]], dim=-1)


_IIR_BLOCK = 256


def _iir_matrix(a: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n) lower-triangular ``a^(i-j)``: one block of y[n] = x[n] + a·y[n-1]
    from a zero state, as a matmul."""
    d = np.arange(n)[:, None] - np.arange(n)[None, :]
    return _const(np.where(d >= 0, float(a) ** np.maximum(d, 0), 0.0), like)


def _iir(x: torch.Tensor, a: float) -> torch.Tensor:
    """y[n] = x[n] + a·y[n-1] along the last axis of (R, T), from a zero
    state, in blocks: each block from a zero state by one matmul, then each
    block's start corrected by the true end of the block before it, whose
    values obey the same recurrence with a^L over the blocks."""
    r, t = x.shape
    if t <= _IIR_BLOCK:
        return x @ _iir_matrix(a, t, x).T
    nb = -(-t // _IIR_BLOCK)
    xb = F.pad(x, (0, nb * _IIR_BLOCK - t)).reshape(r, nb, _IIR_BLOCK)
    y = xb @ _iir_matrix(a, _IIR_BLOCK, x).T
    ends = _iir(y[..., -1], float(a) ** _IIR_BLOCK)                 # (R, nb)
    prev = F.pad(ends[:, :-1], (1, 0))
    y = y + prev[..., None] * _const(float(a) ** np.arange(1, _IIR_BLOCK + 1), x)
    return y.reshape(r, nb * _IIR_BLOCK)[:, :t]


def inv_preemphasis(y: torch.Tensor, k: float) -> torch.Tensor:
    """Inverse of ``preemphasis``, the IIR x[n] = y[n] + k·x[n-1], on the
    tensor's device (blocked matmuls in place of the JAX package's scan)."""
    return _iir(y.reshape(-1, y.shape[-1]), k).reshape(y.shape)


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    min_level = float(np.exp(min_level_db / 20 * np.log(10)))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(S, min_level_db, max_abs_value, symmetric=True, clip=True):
    """dB → normalised mel range."""
    if symmetric:
        out = (2 * max_abs_value) * ((S - min_level_db) / (-min_level_db)) - max_abs_value
        return torch.clamp(out, -max_abs_value, max_abs_value) if clip else out
    out = max_abs_value * ((S - min_level_db) / (-min_level_db))
    return torch.clamp(out, 0, max_abs_value) if clip else out


def denormalize_db(D, min_level_db, max_abs_value, symmetric=True, clip=True):
    if symmetric:
        D = torch.clamp(D, -max_abs_value, max_abs_value) if clip else D
        return ((D + max_abs_value) * -min_level_db / (2 * max_abs_value)) + min_level_db
    D = torch.clamp(D, 0, max_abs_value) if clip else D
    return (D * -min_level_db / max_abs_value) + min_level_db


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


def linearspectrogram(wav: torch.Tensor, cfg) -> torch.Tensor:
    """SV2TTS linear spectrogram: (..., T) → (..., frames, bins)."""
    x = preemphasis(wav, cfg.preemphasis) if cfg.preemphasize else wav
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_size, cfg.win_size)
    S = amp_to_db(mag, cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        return normalize_db(S, cfg.min_level_db, cfg.max_abs_value,
                            cfg.symmetric_mels, cfg.allow_clipping_in_normalization)
    return S


def inv_mel_spectrogram(mel: torch.Tensor, cfg, generator: Optional[torch.Generator] = None,
                        angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim inversion of an SV2TTS mel (T, M) → waveform: denormalise,
    the mel basis's pseudo-inverse, ``griffin_lim`` (or ``spsi`` with
    ``use_fast_phase``), inverse preemphasis. ``generator``/``angles`` as
    in ``griffin_lim``."""
    if cfg.signal_normalization:
        D = denormalize_db(mel, cfg.min_level_db, cfg.max_abs_value,
                           cfg.symmetric_mels, cfg.allow_clipping_in_normalization)
    else:
        D = mel
    amp = db_to_amp(D + cfg.ref_level_db)
    inv_b = np.linalg.pinv(_mel_basis(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                                      cfg.fmax)).astype(np.float32)
    linear = torch.clamp(amp @ _const(inv_b, amp), min=1e-10)         # (T, bins)
    if cfg.get("use_fast_phase", False):
        y = spsi(linear ** cfg.power, cfg.n_fft, cfg.hop_size, cfg.win_size)
    else:
        y = griffin_lim(linear ** cfg.power, cfg.n_fft, cfg.hop_size, cfg.win_size,
                        n_iters=cfg.griffin_lim_iters, generator=generator, angles=angles)
    if cfg.preemphasize:
        y = inv_preemphasis(y, cfg.preemphasis)
    return y


def spsi(S_mag: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """Single-Pass Spectrogram Inversion (Beauregard et al. 2015) of a
    (frames, bins) magnitude: peaks picked and their fractional bins
    interpolated per frame, each bin locked to its nearest peak's phase, the
    peak phases advanced by their instantaneous frequency. Everything but
    the phase accumulator is computed for all frames at once; the
    accumulator runs frame by frame."""
    n_frames, n_bins = S_mag.shape[-2], S_mag.shape[-1]
    k = torch.arange(n_bins, dtype=S_mag.dtype, device=S_mag.device)
    left = torch.cat([S_mag[:, :1], S_mag[:, :-1]], dim=-1)
    right = torch.cat([S_mag[:, 1:], S_mag[:, -1:]], dim=-1)
    is_peak = (S_mag > left) & (S_mag >= right) & (S_mag > 1e-8)
    denom = left - 2 * S_mag + right
    ok = is_peak & (denom.abs() > 1e-12)
    frac = torch.where(ok, 0.5 * (left - right) / torch.where(denom.abs() > 1e-12, denom, 1.0),
                       0.0).clamp(-0.5, 0.5)
    inf = torch.tensor(float("inf"), dtype=S_mag.dtype, device=S_mag.device)
    last_peak = torch.cummax(torch.where(is_peak, k, -inf), dim=-1).values
    next_peak = -torch.cummax(torch.where(is_peak, k, inf).flip(-1).neg(), dim=-1).values.flip(-1)
    d_last = torch.where(torch.isfinite(last_peak), k - last_peak, inf)
    d_next = torch.where(torch.isfinite(next_peak), next_peak - k, inf)
    assigned = torch.where(d_last <= d_next, last_peak, next_peak)
    has_peak = torch.isfinite(assigned)
    assigned_i = assigned.clamp(0, n_bins - 1).long()
    omega = 2.0 * np.pi * (k + frac) * hop / n_fft
    lock = np.pi * torch.round((k - assigned).abs())
    acc = torch.zeros(n_bins, dtype=S_mag.dtype, device=S_mag.device)
    phases = []
    for f in range(n_frames):
        ph_peak = torch.gather(acc + omega[f], 0, assigned_i[f])
        phase = torch.where(has_peak[f], ph_peak + lock[f], 0.0)
        acc = torch.where(has_peak[f], phase, acc)
        phases.append(phase)
    phases = torch.stack(phases)
    return istft(S_mag * torch.cos(phases), S_mag * torch.sin(phases), n_fft, hop, win_length,
                 length=hop * (n_frames - 1))


def griffin_lim(S_mag: torch.Tensor, n_fft: int, hop: int, win_length: int, n_iters: int = 60,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase recovery of a (frames, bins) magnitude. The initial
    phase is ``angles``, else uniform in [0, 2π) from ``generator`` (the
    port's stand-in for the JAX package's PRNG key: same recipe, different
    numbers)."""
    if angles is None:
        angles = torch.rand(S_mag.shape, generator=generator, device=S_mag.device,
                            dtype=S_mag.dtype) * (2 * np.pi)
    length = hop * (S_mag.shape[-2] - 1)          # the centre-trimmed output length
    y = istft(S_mag * torch.cos(angles), S_mag * torch.sin(angles), n_fft, hop, win_length,
              length=length)
    for _ in range(n_iters):
        r2, i2 = stft(y, n_fft, hop, win_length)
        mag = torch.sqrt(r2 * r2 + i2 * i2 + 1e-12)
        y = istft(S_mag * r2 / mag, S_mag * i2 / mag, n_fft, hop, win_length, length=length)
    return y


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
