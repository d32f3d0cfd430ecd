"""Training logs without TensorBoard, and the console helpers.

The port's counterpart of ``mockingbird_tpu/train/logging.py``. Its
``TrainLogger`` has what the trainers call: ``scalars`` append one JSON line
per step to ``scalars.jsonl``, ``audio`` writes a 16-bit wav, ``image`` an
``.npy`` array and ``alignment`` an attention map scaled to [0, 1] as one,
all under ``log_dir``, on rank 0 only. ``ValueWindow``, ``stream``, ``simple_table`` and
``progbar`` are copies.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from ..parallel import multihost


class ValueWindow:
    """Moving average over the last N values."""

    def __init__(self, window_size: int = 100):
        self._window_size = window_size
        self._values: list = []

    def append(self, x):
        self._values = self._values[-(self._window_size - 1):] + [x]

    @property
    def sum(self):
        return sum(self._values)

    @property
    def count(self):
        return len(self._values)

    @property
    def average(self):
        return self.sum / max(1, self.count)

    def reset(self):
        self._values = []


class TrainLogger:
    """Writes under ``log_dir`` on rank 0 only, as the JAX package's logger
    does in a multi-process run; on the other ranks every method does
    nothing."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.enabled = multihost.is_primary()
        if self.enabled:
            self.log_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int, tag: str, suffix: str) -> Path:
        return self.log_dir / f"{tag.replace('/', '_')}_{step:07d}{suffix}"

    def scalars(self, step: int, **kwargs) -> None:
        if not self.enabled:
            return
        with (self.log_dir / "scalars.jsonl").open("a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in kwargs.items()}})
                    + "\n")

    def audio(self, step: int, tag: str, wav: np.ndarray, sr: int = 16000) -> None:
        if not self.enabled:
            return
        peak = max(1e-3, float(np.max(np.abs(wav)))) if len(wav) else 1.0
        pcm = np.round(np.clip(np.asarray(wav, np.float32) / peak, -1, 1) * 32767)
        wavfile.write(self._path(step, tag, ".wav"), sr, pcm.astype(np.int16))

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        """img (H, W) or (H, W, C) in [0, 1]."""
        if not self.enabled:
            return
        np.save(self._path(step, tag, ".npy"), np.asarray(img, np.float32))

    def alignment(self, step: int, tag: str, attn: np.ndarray) -> None:
        a = np.asarray(attn, np.float32)
        self.image(step, tag, a / max(float(a.max()), 1e-6))


def stream(message: str) -> None:
    """In-place console line."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def simple_table(item_tuples) -> None:
    """Boxed key/value table."""
    border_pattern = "+---------------------------------------"
    headings, cells = [], []
    for item in item_tuples:
        heading, cell = str(item[0]), str(item[1])
        pad_head = True
        while len(heading) < len(cell):
            heading += " " if pad_head else ""
            heading = " " + heading if pad_head else heading
            pad_head = not pad_head
        while len(cell) < len(heading):
            cell += " "
        headings.append(" " + heading + " ")
        cells.append(" " + cell + " ")
    border, head, body = "", "", ""
    for h, c in zip(headings, cells):
        border += border_pattern[: len(h) + 1]
        head += "|" + h
        body += "|" + c
    border += "+"
    print(border)
    print(head + "|")
    print(border)
    print(body + "|")
    print(border)


def progbar(i: int, n: int, size: int = 16) -> str:
    done = int(size * i / max(n, 1))
    return "█" * done + "░" * (size - done)
