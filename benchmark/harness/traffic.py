"""The one traffic generator: a mix's parameters (a JSON file under
``benchmark/traffic/``) and the run's seed → the reference voices and the
texts of every call.

A mix of ``"kind": "tts_closed"`` is a closed loop with one caller: each
call sends ``texts_per_call`` new texts in one voice and waits for the
audio. A text has a number of hanzi drawn uniformly from ``hanzi``, each
drawn from the characters of the frozen pinyin table, with a punctuation
mark from ``punctuation`` after every ``clause`` hanzi (drawn per clause).
Every text has at most ``pad_to_symbols`` symbols and the first text of a
call more than ``pad_to_symbols`` − 32, so every call pads its texts to the
same length and every call is the same work. The voice of a call is one of
``voices`` reference wavs (``voice_seconds`` long, drawn per voice), chosen
uniformly. Call ``i`` depends on (seed, i) alone; warm-up calls draw from a
stream of their own.

A voice is speech-like: syllables of 120-300 ms, each a harmonic tone on a
gliding pitch of 90-260 Hz under two formant peaks and a Hann envelope,
between pauses of 30-150 ms of faint noise, written as 16-bit 16 kHz PCM.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import List

import numpy as np
from scipy.io import wavfile

from ..reference.pinyin_data import CHAR_PINYIN
from ..reference.text import symbol_ids

_CHARS = sorted(CHAR_PINYIN)
SR = 16000


def _text(rng: random.Random, mix: dict) -> str:
    n = rng.randint(*mix["hanzi"])
    out, left = [], rng.randint(*mix["clause"])
    for _ in range(n):
        out.append(rng.choice(_CHARS))
        left -= 1
        if left == 0:
            out.append(rng.choice(mix["punctuation"]))
            left = rng.randint(*mix["clause"])
    return "".join(out)


def texts(mix: dict, seed: int, call: int) -> List[str]:
    """The texts of call ``call`` (negative: warm-up)."""
    rng = random.Random(f"{seed}/{call}")
    top = mix["pad_to_symbols"]
    out: List[str] = []
    while len(out) < mix["texts_per_call"]:
        t = _text(rng, mix)
        n = len(symbol_ids(t))
        if n <= top and (out or n > top - 32):
            out.append(t)
    return out


def voice_of(mix: dict, seed: int, call: int) -> int:
    return random.Random(f"{seed}/{call}/voice").randrange(mix["voices"])


def _voice(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    wav = rng.normal(0.0, 3e-4, n)
    pos = int(rng.uniform(0.05, 0.2) * SR)
    f_lo, f_hi = 90.0, 260.0
    base = rng.uniform(f_lo, f_hi)
    formants = rng.uniform([400.0, 1200.0], [900.0, 2600.0])
    while pos < n:
        length = int(rng.uniform(0.12, 0.30) * SR)
        t = np.arange(min(length, n - pos)) / SR
        f0 = np.clip(base * (1 + rng.uniform(-0.15, 0.15) + rng.uniform(-0.3, 0.3) * t), f_lo, f_hi)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        syl = np.zeros_like(t)
        for h in range(1, 25):
            fh = h * f0.mean()
            if fh > 7000:
                break
            amp = sum(np.exp(-0.5 * ((fh - f) / 250.0) ** 2) for f in formants) + 0.05 / h
            syl += amp * np.sin(h * phase)
        syl *= np.hanning(len(t)) * rng.uniform(0.1, 0.3) / max(np.abs(syl).max(), 1e-6)
        wav[pos:pos + len(t)] += syl
        pos += len(t) + int(rng.uniform(0.03, 0.15) * SR)
    return np.clip(wav, -1.0, 1.0)


def write_voices(mix: dict, seed: int, out_dir: Path) -> List[Path]:
    """The mix's reference wavs, written into ``out_dir``."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 2])
    paths = []
    for i in range(mix["voices"]):
        wav = _voice(rng, rng.uniform(*mix["voice_seconds"]))
        path = Path(out_dir) / f"voice_{i}.wav"
        wavfile.write(str(path), SR, np.round(wav * 32767).astype(np.int16))
        paths.append(path)
    return paths

