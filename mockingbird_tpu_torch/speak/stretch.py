"""Duration normalization for timeline rendering — numpy, no ffmpeg.

A copy of ``mockingbird_tpu/speak/stretch.py`` (the port imports nothing of
the JAX package).

The reference renderer shells out to ffmpeg (`render_timeline.py:141-181`:
`apad`+`-t` pad/trim for the cloud backend, chained `atempo` time-stretch for
the local backend). Here both modes are in-process:

- `pad_or_trim`  — exact-length window (zero-pad or cut), like apad+trim.
- `wsola_stretch` — waveform-similarity overlap-add time-stretch (the DSP
  behind atempo): pitch-preserving tempo change with cross-correlation
  alignment of successive analysis frames.
"""
from __future__ import annotations

import numpy as np


def pad_or_trim(wav: np.ndarray, target_len: int) -> np.ndarray:
    wav = np.asarray(wav, dtype=np.float32)
    if len(wav) >= target_len:
        return wav[:target_len]
    return np.pad(wav, (0, target_len - len(wav)))


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def wsola_stretch(wav: np.ndarray, target_len: int, sr: int = 16000,
                  frame_ms: float = 30.0, search_ms: float = 10.0) -> np.ndarray:
    """Stretch/compress `wav` to exactly `target_len` samples, preserving pitch.

    Overlap-add with 50% overlap; each synthesis frame is taken from the
    ideally-scaled input position, refined by a cross-correlation search of
    ±`search_ms` so successive frames join in phase (WSOLA). Extreme ratios
    are handled by construction (no atempo 0.5–100 chaining needed).
    """
    wav = np.asarray(wav, dtype=np.float32)
    if target_len <= 0:
        return np.zeros(0, dtype=np.float32)
    if len(wav) == 0:
        return np.zeros(target_len, dtype=np.float32)
    if len(wav) == target_len:
        return wav.copy()

    frame = max(64, int(sr * frame_ms / 1000) & ~1)
    hop = frame // 2
    search = max(1, int(sr * search_ms / 1000))
    window = _hann(frame).astype(np.float32)

    n_frames = max(2, int(np.ceil(target_len / hop)) + 1)
    # Ideal (real-valued) input read position for each output frame.
    scale = (len(wav) - frame) / max(1, (n_frames - 1) * hop)

    out = np.zeros(n_frames * hop + frame, dtype=np.float32)
    norm = np.zeros_like(out)

    first = wav[:frame] if len(wav) >= frame else np.pad(wav, (0, frame - len(wav)))
    out[:frame] += first * window
    norm[:frame] += window
    prev_pos = 0

    for k in range(1, n_frames):
        ideal = int(round(k * hop * scale))
        # Natural continuation of the previous frame: prev_pos + hop.
        natural = prev_pos + hop
        lo = max(0, min(len(wav) - frame, ideal - search))
        hi = max(lo + 1, min(len(wav) - frame + 1, ideal + search))
        ref = wav[natural:natural + frame] if 0 <= natural <= len(wav) - frame else None
        if ref is not None and hi - lo > 1:
            # Cross-correlate the candidate region against the natural frame.
            region = wav[lo:hi + frame - 1]
            if len(region) >= frame:
                corr = np.correlate(region, ref, mode="valid")
                pos = lo + int(np.argmax(corr[:hi - lo]))
            else:
                pos = max(0, min(len(wav) - frame, ideal))
        else:
            pos = max(0, min(len(wav) - frame, ideal))
        seg = wav[pos:pos + frame]
        if len(seg) < frame:
            seg = np.pad(seg, (0, frame - len(seg)))
        o = k * hop
        out[o:o + frame] += seg * window
        norm[o:o + frame] += window
        prev_pos = pos

    norm[norm < 1e-6] = 1.0
    result = (out / norm)[:target_len]
    if len(result) < target_len:
        result = np.pad(result, (0, target_len - len(result)))
    return result.astype(np.float32)


def normalize_duration(wav: np.ndarray, target_len: int, sr: int,
                       mode: str = "stretch") -> np.ndarray:
    """`mode`: 'stretch' (WSOLA, default — reference's atempo path) or
    'pad_trim' (reference's apad/-t path)."""
    if mode == "pad_trim":
        return pad_or_trim(wav, target_len)
    if mode == "stretch":
        return wsola_stretch(wav, target_len, sr=sr)
    raise ValueError(f"unknown duration mode: {mode!r}")
