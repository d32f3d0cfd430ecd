"""Host-side audio I/O and preprocessing (numpy/scipy only).

The reference leans on librosa / soundfile / webrtcvad
(`models/encoder/audio.py`, `models/synthesizer/audio.py:9-15`);
none of those are dependencies here. Equivalents are built on the stdlib +
scipy: wav I/O via scipy.io.wavfile, resampling via polyphase filtering, and
silence trimming via an energy VAD with the same smoothing/dilation structure
as the reference's webrtcvad pipeline (`models/encoder/audio.py:71-108`).

These functions run on the host in the data pipeline — they are not traced.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
from scipy import signal as sps
from scipy.io import wavfile

int16_max = (2**15) - 1


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

def load_wav(path: Union[str, Path], target_sr: Optional[int] = None) -> tuple[np.ndarray, int]:
    """Load a wav file as float32 in [-1, 1]; optionally resample."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:  # downmix
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav, sr


def save_wav(wav: np.ndarray, path: Union[str, Path], sr: int) -> None:
    """Peak-normalised int16 write (`models/synthesizer/audio.py:12-15`)."""
    wav = np.asarray(wav, dtype=np.float32)
    out = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(str(path), sr, out.astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replacement for librosa.resample)."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(orig_sr, target_sr)
    return sps.resample_poly(wav.astype(np.float64), target_sr // g, orig_sr // g).astype(np.float32)


# ---------------------------------------------------------------------------
# Amplitude utilities
# ---------------------------------------------------------------------------

def normalize_volume(wav: np.ndarray, target_dBFS: float,
                     increase_only=False, decrease_only=False) -> np.ndarray:
    """RMS volume normalisation (`models/encoder/audio.py:111-117`)."""
    if increase_only and decrease_only:
        raise ValueError("Both increase only and decrease only are set")
    rms = np.sqrt(np.mean((wav * int16_max) ** 2))
    dBFS_change = target_dBFS - 20 * np.log10(max(rms, 1e-10) / int16_max)
    if (dBFS_change < 0 and increase_only) or (dBFS_change > 0 and decrease_only):
        return wav
    return wav * (10 ** (dBFS_change / 20))


def rescale_peak(wav: np.ndarray, rescaling_max: float = 0.9) -> np.ndarray:
    """Peak rescale used before mel extraction
    (`models/synthesizer/preprocess_audio.py` rescale step)."""
    return wav / max(np.abs(wav).max(), 1e-8) * rescaling_max


def preemphasis_np(wav: np.ndarray, k: float) -> np.ndarray:
    return sps.lfilter([1, -k], [1], wav).astype(np.float32)


def inv_preemphasis_np(wav: np.ndarray, k: float) -> np.ndarray:
    return sps.lfilter([1], [1, -k], wav).astype(np.float32)


# ---------------------------------------------------------------------------
# Voice activity detection / silence trimming
# ---------------------------------------------------------------------------

def _moving_average(arr: np.ndarray, width: int) -> np.ndarray:
    padded = np.concatenate((np.zeros((width - 1) // 2), arr, np.zeros(width // 2)))
    ret = np.cumsum(padded, dtype=float)
    ret[width:] = ret[width:] - ret[:-width]
    return ret[width - 1:] / width


def _binary_dilation(mask: np.ndarray, width: int) -> np.ndarray:
    if width <= 1:
        return mask
    kernel = np.ones(width)
    return np.convolve(mask.astype(float), kernel, mode="same") > 0


def vad_keep_mask(wav: np.ndarray, cfg) -> np.ndarray:
    """Per-sample bool keep-mask of the energy VAD (same decision chain as
    `trim_long_silences`; exposed so it can be compared against webrtcvad
    golden masks, tests/fixtures/ref_goldens)."""
    samples_per_window = (cfg.vad_window_length_ms * cfg.sample_rate) // 1000
    wav = wav[: len(wav) - (len(wav) % samples_per_window)]
    if len(wav) == 0:
        return np.zeros((0,), bool)
    windows = wav.reshape(-1, samples_per_window)
    rms = np.sqrt(np.mean(windows**2, axis=1))
    noise_floor = np.percentile(rms, 10)
    thresh = max(noise_floor * 4.0, rms.max() / 30.0, 1e-5)
    voice_flags = (rms > thresh).astype(float)

    audio_mask = np.round(_moving_average(voice_flags, cfg.vad_moving_average_width)).astype(bool)
    audio_mask = _binary_dilation(audio_mask, cfg.vad_max_silence_length + 1)
    return np.repeat(audio_mask, samples_per_window)


def trim_long_silences(wav: np.ndarray, cfg) -> np.ndarray:
    """Energy-VAD silence trimming with the reference's smoothing structure
    (`models/encoder/audio.py:71-108`): 30 ms windows, moving-average width 8,
    binary dilation over `vad_max_silence_length + 1` windows.

    webrtcvad (a GMM voice detector) is replaced by an adaptive energy
    threshold: a window is "speech" when its RMS exceeds max(noise floor ×4,
    peak ÷30) — robust for the clean corpus data this pipeline targets.
    """
    samples_per_window = (cfg.vad_window_length_ms * cfg.sample_rate) // 1000
    wav = wav[: len(wav) - (len(wav) % samples_per_window)]
    if len(wav) == 0:
        return wav
    return wav[vad_keep_mask(wav, cfg)]


def preprocess_wav(fpath_or_wav: Union[str, Path, np.ndarray], cfg,
                   source_sr: Optional[int] = None,
                   normalize: bool = True, trim_silence: bool = True) -> np.ndarray:
    """Speaker-encoder wav preprocessing (`models/encoder/audio.py:19-50`):
    load → resample to cfg.sample_rate → volume-norm (increase only) → VAD trim."""
    if isinstance(fpath_or_wav, (str, Path)):
        wav, source_sr = load_wav(fpath_or_wav)
    else:
        wav = np.asarray(fpath_or_wav, dtype=np.float32)
    if source_sr is not None and source_sr != cfg.sample_rate:
        wav = resample(wav, source_sr, cfg.sample_rate)
    if normalize:
        wav = normalize_volume(wav, cfg.audio_norm_target_dBFS, increase_only=True)
    if trim_silence:
        wav = trim_long_silences(wav, cfg)
    return wav
