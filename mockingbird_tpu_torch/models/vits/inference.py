"""VITS inference: text (+ speaker id + emotion) → waveform directly.

Port of ``mockingbird_tpu/models/vits/inference.py``: text buckets of 16,
``romanize`` → ``text_to_sequence``, zero emotion and speaker 0 by default,
a static ``max_frames`` output length, and the int16 quantisation on the
device. The noise of a call is drawn from a ``torch.Generator`` seeded with
``seed``, so a call is repeatable, as the JAX package's ``PRNGKey(seed)``
makes it. An ``.npz`` export's ``.json`` sidecar, where there is one, sets
the widths, as it does for the Tacotron ``Synthesizer``.

Under a profiler session ``vits.text`` spans the host's text work and
``Vits.infer`` spans its stages (``tracing.py``). Two counters add up, where
a call's lengths reach the host, the frames decoded (``max_frames`` a text)
and the frames returned (Σ ``y_lengths``): ``frames_decoded`` and
``frames_returned``, read by ``counts()``.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ... import resolve_device, tracing
from ...config import Config
from ...dsp import spectrogram_vits
from ...text import romanize, text_to_sequence
from ...weights import load_flax, load_npz
from .model import init_vits, vits_config


frames_decoded = 0
frames_returned = 0
_count_lock = threading.Lock()


def _bucket(n: int, size: int) -> int:
    return max(size, ((n + size - 1) // size) * size)


def count_frames(max_frames: int, y_lengths: np.ndarray) -> None:
    """Count one batch whose ``y_lengths`` (host) have come back."""
    global frames_decoded, frames_returned
    returned = int(np.sum(y_lengths))
    with _count_lock:
        frames_decoded += max_frames * len(y_lengths)
        frames_returned += returned


def counts() -> dict:
    """The counters: {"frames_decoded", "frames_returned"}."""
    return {"frames_decoded": frames_decoded, "frames_returned": frames_returned}


class VitsSynthesizer:
    """Weights come from ``variables`` (the flax tree of the generator, see
    ``weights.py``), from an ``.npz`` export at ``model_fpath`` (its ``g``
    subtree, or the whole tree), or else from ``seed``. A ``model_fpath``
    that does not exist raises; its ``.json`` sidecar, if any, is merged
    over ``cfg``."""

    def __init__(self, model_fpath: Optional[Union[str, Path]] = None, cfg=None,
                 verbose: bool = True, seed: int = 0, half: bool = False,
                 variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = Config(vits_config()).merge(cfg or {})
        self.seed = seed
        if model_fpath is not None:
            sidecar = Path(model_fpath).with_suffix(".json")
            if sidecar.exists():
                self.cfg.merge(Config.from_json(sidecar))
            tree = load_npz(model_fpath)
            variables = tree.get("g", tree.get("params", tree))
            if verbose:
                print(f"Loaded VITS from {model_fpath}")
        elif variables is None and verbose:
            print("VITS: weights made from seed", seed)
        model = init_vits(seed, self.cfg)
        if variables is not None:
            load_flax(model, variables)
        # half=True casts the weights to bf16; the inputs stay f32, as the
        # JAX package hands them in, and each layer computes in the promoted
        # dtype of its input and weights (``layers.promote``), as flax does.
        # In the JAX package it measured SLOWER on a TPU (the flow/duration
        # stack's many small mixed-dtype ops became convert-bound), so f32
        # stays the default; on the card it is not measured.
        self.half = half
        self.model = model.to(self.device, torch.bfloat16 if half else torch.float32).eval()

    def _texts(self, texts: List[str]):
        seqs = [np.asarray(text_to_sequence(romanize(t)), np.int64) for t in texts]
        t_text = _bucket(max(len(s) for s in seqs), 16)
        x = np.zeros((len(seqs), t_text), np.int64)
        for i, s in enumerate(seqs):
            x[i, :len(s)] = s
        return x, np.asarray([len(s) for s in seqs], np.int64)

    @torch.no_grad()
    def synthesize_device(self, texts: List[str], sids: Optional[np.ndarray] = None,
                          emos: Optional[np.ndarray] = None, noise_scale: float = 0.667,
                          length_scale: float = 1.0, noise_scale_w: float = 0.8,
                          max_frames: int = 1000, pcm16: bool = False):
        """Like ``synthesize`` but returns the device tensors (o (B, max_frames
        · hop), y_lengths (B,)) without fetching them."""
        dev = self.device
        with tracing.span("vits.text"):
            x, xl = self._texts(texts)
            b = len(texts)
            sids = np.zeros(b, np.int64) if sids is None else np.asarray(sids, np.int64)
            emos = (np.zeros((b, self.cfg.emotion_channels), np.float32) if emos is None
                    else np.asarray(emos, np.float32))
            x, xl, sids, emos = (torch.from_numpy(a).to(dev) for a in (x, xl, sids, emos))
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        o, _, _, y_lengths = self.model.infer(
            x, xl, sids, emos,
            noise_scale=noise_scale, length_scale=length_scale, noise_scale_w=noise_scale_w,
            max_len=max_frames, generator=gen)
        o = o.float()
        if pcm16:
            # quantise on the device: halves the device-to-host bytes
            o = torch.round(torch.clamp(o, -1.0, 1.0) * 32767.0).to(torch.int16)
        return o, y_lengths

    def synthesize(self, texts: List[str], sids: Optional[np.ndarray] = None,
                   emos: Optional[np.ndarray] = None, noise_scale: float = 0.667,
                   length_scale: float = 1.0, noise_scale_w: float = 0.8,
                   max_frames: int = 1000, pcm16: bool = False) -> List[np.ndarray]:
        o, y_lengths = self.synthesize_device(
            texts, sids=sids, emos=emos, noise_scale=noise_scale, length_scale=length_scale,
            noise_scale_w=noise_scale_w, max_frames=max_frames, pcm16=pcm16)
        o, y_lengths = o.cpu().numpy(), y_lengths.cpu().numpy()
        count_frames(max_frames, y_lengths)
        return [o[i, :y_lengths[i] * self.cfg.hop_size] for i in range(len(texts))]

    @torch.no_grad()
    def reconstruct(self, wav: np.ndarray, sid: int = 0) -> np.ndarray:
        """Posterior-mean reconstruction of real audio (``Vits.reconstruct``):
        wav float32 at 16 kHz → reconstructed wav."""
        cfg, dev = self.cfg, self.device
        spec = spectrogram_vits(torch.from_numpy(np.asarray(wav, np.float32)), cfg.n_fft,
                                cfg.hop_size, cfg.win_size)          # (T, spec)
        t_len = _bucket(spec.shape[0], 64)
        y = torch.zeros(1, t_len, spec.shape[1])
        y[0, :spec.shape[0]] = spec
        o = self.model.reconstruct(y.to(dev),
                                   torch.tensor([spec.shape[0]], device=dev),
                                   torch.tensor([sid], device=dev))
        return o.float().cpu().numpy()[0, :spec.shape[0] * cfg.hop_size]
