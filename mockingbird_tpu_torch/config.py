"""Dot-accessible, nestable, serialisable configuration.

A copy of the parts of ``mockingbird_tpu/config.py`` this port uses
(``Config`` with its ``--hparams`` override string, ``sv2tts_audio_config``,
``encoder_audio_config``): the port imports nothing of the JAX package.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Any, Dict


class Config(dict):
    """A dict with attribute access and deep merge."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in list(args) + [kwargs]:
            if src:
                self.merge(src)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def merge(self, other: Dict[str, Any]) -> "Config":
        """Deep-merge ``other`` into self (nested dicts merge, scalars replace)."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), Config):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self

    def set_path(self, dotted: str, value: Any) -> None:
        """Set ``a.b.c`` style nested key, creating intermediate Configs."""
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            if not isinstance(node.get(p), Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = self._wrap(value)

    def parse(self, override: str) -> "Config":
        """Apply a ``key=value,key2=value2`` override string (dotted keys
        allowed; values parsed as Python literals, else kept as strings)."""
        if not override:
            return self
        for item in _split_top_level(override):
            if not item.strip():
                continue
            key, _, raw = item.partition("=")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw  # plain string
            self.set_path(key.strip(), value)
        return self

    def to_dict(self) -> Dict[str, Any]:
        def conv(v):
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return {k: conv(v) for k, v in self.items()}

    @classmethod
    def from_json(cls, path) -> "Config":
        return cls(json.loads(Path(path).read_text()))

    def clone(self) -> "Config":
        return Config(self.to_dict())


def _split_top_level(s: str):
    """Split on commas not inside brackets/quotes, so `a=[1,2],b=3` works."""
    out, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch in "([{":
            depth += 1
            cur.append(ch)
        elif ch in ")]}":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def sv2tts_audio_config() -> Config:
    """Audio config shared by the synthesizer + WaveRNN path (16 kHz, n_fft
    1024, 80 mel, hop 256, win 1024, fmin 55 / fmax 7600, symmetric mel
    normalisation to ±4 with preemphasis 0.97)."""
    return Config(
        sample_rate=16000,
        n_fft=1024,
        num_mels=80,
        hop_size=256,
        win_size=1024,
        fmin=55.0,
        fmax=7600.0,
        min_level_db=-100.0,
        ref_level_db=20.0,
        max_abs_value=4.0,
        preemphasis=0.97,
        preemphasize=True,
        signal_normalization=True,
        symmetric_mels=True,
        allow_clipping_in_normalization=True,
        power=1.5,
        griffin_lim_iters=60,
        use_fast_phase=False,
        rescale=True,
        rescaling_max=0.9,
        max_mel_frames=900,
        trim_silence=False,
    )


def encoder_audio_config() -> Config:
    """GE2E speaker-encoder frontend config (40-channel non-log mel, 25 ms
    window / 10 ms hop at 16 kHz, VAD + −30 dBFS norm)."""
    return Config(
        sample_rate=16000,
        mel_window_length_ms=25,
        mel_window_step_ms=10,
        mel_n_channels=40,
        partials_n_frames=160,
        inference_n_frames=80,
        vad_window_length_ms=30,
        vad_moving_average_width=8,
        vad_max_silence_length=6,
        audio_norm_target_dBFS=-30.0,
    )
