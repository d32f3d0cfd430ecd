"""Long-text synthesis helpers.

A copy of ``mockingbird_tpu/text/long_text.py``: number normalisation,
punctuation-based sentence splitting, chunking to a max length, and
per-chunk synthesis joined with silence breaks.
"""
from __future__ import annotations

import re
from typing import Callable, List

import numpy as np

from .mandarin_numbers import normalize_numbers_mandarin
from .pinyin import contains_chinese, romanize

_SPLIT_PUNCT = re.compile(r"[，。！？；,.!?;\n]+")


def normalize_text(text: str) -> str:
    """Numbers → Mandarin pinyin reading; hanzi → pinyin (when available)."""
    text = normalize_numbers_mandarin(text)
    if contains_chinese(text):
        text = romanize(text)
    return text


def split_text(text: str, max_chars: int = 140) -> List[str]:
    """Split on sentence punctuation, then greedily pack into chunks of at
    most ``max_chars``."""
    sentences = [s.strip() for s in _SPLIT_PUNCT.split(text) if s.strip()]
    chunks: List[str] = []
    current = ""
    for s in sentences:
        if len(current) + len(s) + 1 <= max_chars:
            current = (current + " " + s).strip()
        else:
            if current:
                chunks.append(current)
            while len(s) > max_chars:  # pathological unpunctuated run
                chunks.append(s[:max_chars])
                s = s[max_chars:]
            current = s
    if current:
        chunks.append(current)
    return chunks


def synthesize_long_text(text: str, synthesize_fn: Callable[[List[str]], List[np.ndarray]],
                         sample_rate: int = 16000, break_seconds: float = 0.15,
                         max_chars: int = 140) -> np.ndarray:
    """text → one concatenated waveform with silence breaks between chunks."""
    chunks = split_text(normalize_text(text), max_chars)
    if not chunks:
        return np.zeros(0, np.float32)
    wavs = synthesize_fn(chunks)
    silence = np.zeros(int(sample_rate * break_seconds), np.float32)
    out: List[np.ndarray] = []
    for i, w in enumerate(wavs):
        out.append(np.asarray(w, np.float32))
        if i < len(wavs) - 1:
            out.append(silence)
    return np.concatenate(out)
