"""Training logs without TensorBoard.

The port's counterpart of ``mockingbird_tpu/train/logging.py``'s
``TrainLogger``, with what the VITS and Tacotron trainers call: ``scalars``
append one JSON line per step to ``scalars.jsonl``, ``audio`` writes a 16-bit
wav, ``image`` an ``.npy`` array and ``alignment`` an attention map scaled to
[0, 1] as one, all under ``log_dir``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy.io import wavfile


class TrainLogger:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int, tag: str, suffix: str) -> Path:
        return self.log_dir / f"{tag.replace('/', '_')}_{step:07d}{suffix}"

    def scalars(self, step: int, **kwargs) -> None:
        with (self.log_dir / "scalars.jsonl").open("a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in kwargs.items()}})
                    + "\n")

    def audio(self, step: int, tag: str, wav: np.ndarray, sr: int = 16000) -> None:
        peak = max(1e-3, float(np.max(np.abs(wav)))) if len(wav) else 1.0
        pcm = np.round(np.clip(np.asarray(wav, np.float32) / peak, -1, 1) * 32767)
        wavfile.write(self._path(step, tag, ".wav"), sr, pcm.astype(np.int16))

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        """img (H, W) or (H, W, C) in [0, 1]."""
        np.save(self._path(step, tag, ".npy"), np.asarray(img, np.float32))

    def alignment(self, step: int, tag: str, attn: np.ndarray) -> None:
        a = np.asarray(attn, np.float32)
        self.image(step, tag, a / max(float(a.max()), 1e-6))
