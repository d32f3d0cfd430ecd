"""Plain audio processing for the reference: the speaker encoder's wav
preprocessing (volume normalisation, energy voice-activity trim) and its
40-channel mel, the Slaney mel filterbank, and WaveRNN's output stage
(equal-power crossfade of the folds, mu-law decode, de-emphasis, trim and
fade-out, 16-bit PCM).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal
from scipy.io import wavfile

INT16_MAX = 2 ** 15 - 1


def read_wav(path) -> np.ndarray:
    sr, data = wavfile.read(str(path))
    if sr != 16000 or data.dtype != np.int16:
        raise ValueError(f"{path}: expected 16 kHz int16, got {sr} Hz {data.dtype}")
    return data.astype(np.float32) / 32768.0


# --- speaker-encoder frontend ----------------------------------------------

def normalize_volume(wav: np.ndarray, target_dbfs: float = -30.0) -> np.ndarray:
    """Raise (never lower) the RMS level to ``target_dbfs``."""
    rms = np.sqrt(np.mean((wav * INT16_MAX) ** 2))
    change = target_dbfs - 20 * np.log10(max(rms, 1e-10) / INT16_MAX)
    return wav if change < 0 else wav * (10 ** (change / 20))


def vad_trim(wav: np.ndarray, sr: int = 16000, window_ms: int = 30, average_width: int = 8,
             max_silence: int = 6) -> np.ndarray:
    """Keep the 30 ms windows whose RMS exceeds max(4 × the 10th-percentile
    RMS, peak RMS / 30, 1e-5), smoothed by a moving average over 8 windows
    (rounded) and dilated over ``max_silence`` + 1 windows."""
    n = sr * window_ms // 1000
    wav = wav[: len(wav) - len(wav) % n]
    if not len(wav):
        return wav
    rms = np.sqrt(np.mean(wav.reshape(-1, n) ** 2, axis=1))
    voiced = (rms > max(np.percentile(rms, 10) * 4.0, rms.max() / 30.0, 1e-5)).astype(float)
    padded = np.concatenate((np.zeros((average_width - 1) // 2), voiced,
                             np.zeros(average_width // 2)))
    acc = np.cumsum(padded, dtype=float)
    acc[average_width:] = acc[average_width:] - acc[:-average_width]
    keep = np.round(acc[average_width - 1:] / average_width).astype(bool)
    keep = np.convolve(keep.astype(float), np.ones(max_silence + 1), mode="same") > 0
    return wav[np.repeat(keep, n)]


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                    lin)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * 200.0 / 3)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters (n_mels, bins)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    ramps = edges[:, None] - freqs[None, :]
    widths = np.diff(edges)
    tri = np.maximum(0.0, np.minimum(-ramps[:-2] / widths[:-1, None], ramps[2:] / widths[1:, None]))
    return (tri * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


def encoder_mel(wav: torch.Tensor, sr: int = 16000, n_mels: int = 40) -> torch.Tensor:
    """(T,) → (frames, 40) power mel: 25 ms periodic-Hann windows every
    10 ms, centred with reflection, |STFT|² through the filterbank."""
    n_fft, hop = sr * 25 // 1000, sr * 10 // 1000
    spec = torch.stft(wav, n_fft, hop, n_fft, torch.hann_window(n_fft, periodic=True,
                                                                device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                       # (bins, frames)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2.0)).to(wav.device)
    return (fb @ power).T


def partial_slices(n_samples: int, sr: int = 16000, n_frames: int = 160,
                   step_ms: int = 10, overlap: float = 0.5, min_coverage: float = 0.75):
    """Start frames of the 160-frame partials (half-overlapping) and the
    samples the wav is padded to."""
    per_frame = sr * step_ms // 1000
    total_frames = int(np.ceil((n_samples + 1) / per_frame))
    step = max(int(np.round(n_frames * (1 - overlap))), 1)
    starts = list(range(0, max(1, total_frames - n_frames + step + 1), step))
    coverage = (n_samples - starts[-1] * per_frame) / (n_frames * per_frame)
    if coverage < min_coverage and len(starts) > 1:
        starts = starts[:-1]
    return starts, (starts[-1] + n_frames) * per_frame


# --- WaveRNN output stage ---------------------------------------------------

def crossfade_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """(folds, target + 2·overlap) → (folds·(target + overlap) + overlap,):
    each fold's ends faded (half the overlap silent, then an equal-power
    ramp) and the folds added at their offsets."""
    folds, length = y.shape
    target = length - 2 * overlap
    silent = overlap // 2
    ramp = np.linspace(-1, 1, overlap - silent, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silent), np.sqrt(0.5 * (1 + ramp))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - ramp)), np.zeros(silent)])
    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(folds * (target + overlap) + overlap)
    for i in range(folds):
        out[i * (target + overlap): i * (target + overlap) + length] += y[i]
    return out


def wavernn_pcm(labels: np.ndarray, overlap: int, bits: int, n_samples: int, hop: int,
                preemphasis: float = 0.97) -> np.ndarray:
    """One utterance's sampled labels (folds, width) → int16 PCM: labels to
    [-1, 1], crossfade, mu-law decode, de-emphasis, trim to ``n_samples``,
    a linear fade over the last 20 hops, round to 16 bits."""
    x = 2.0 * labels.astype(np.float64) / (2 ** bits - 1.0) - 1.0
    x = crossfade_unfold(x, overlap)
    mu = 2 ** bits - 1
    x = np.sign(x) / mu * ((1 + mu) ** np.abs(x) - 1)
    x = signal.lfilter([1], [1, -preemphasis], x).astype(np.float32)[:n_samples]
    fade = min(len(x), 20 * hop)
    x[-fade:] *= np.linspace(1, 0, fade)
    return np.round(np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)
