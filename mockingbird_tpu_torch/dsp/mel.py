"""Mel filterbank construction (numpy, librosa-compatible).

The reference builds filterbanks with `librosa.filters.mel` (Slaney mel scale,
Slaney area normalisation) in `models/synthesizer/audio.py:169-172`
and `utils/audio_utils.py:45-47`. librosa is not a dependency of
this framework, so the same filterbank is re-derived here from the Slaney (1998)
Auditory Toolbox definitions that librosa implements.
"""
from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3  # linear region slope: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size in log region


def hz_to_mel(frequencies, htk: bool = False):
    f = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    log_t = f >= _MIN_LOG_HZ
    mels = np.where(log_t, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mels)
    return mels


def mel_to_hz(mels, htk: bool = False):
    m = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = m * _F_SP
    log_t = m >= _MIN_LOG_MEL
    freqs = np.where(log_t, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float, htk: bool = False):
    return mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels), htk)


def fft_frequencies(sr: float, n_fft: int):
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank of shape ``(n_mels, 1 + n_fft // 2)``.

    Matches `librosa.filters.mel` defaults (slaney scale + slaney norm) used
    throughout the reference.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]  # (n_mels+2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm!r}")

    return weights.astype(dtype)


def inverse_mel_filterbank(*args, **kwargs) -> np.ndarray:
    """Pseudo-inverse of the filterbank, for mel→linear recovery
    (reference `models/synthesizer/audio.py:162-166`)."""
    return np.linalg.pinv(mel_filterbank(*args, **kwargs).astype(np.float64)).astype(
        kwargs.get("dtype", np.float32)
    )
