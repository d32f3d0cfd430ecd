"""Speaker-encoder inference: wav → 256-d d-vector.

Port of ``mockingbird_tpu/models/encoder/inference.py``: partial slicing,
power-of-two batch padding and the L2-normalised mean of partial embeddings.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import encoder_audio_config
from ...dsp import mel_encoder, preprocess_wav
from ...weights import load_flax, load_npz
from .model import SpeakerEncoder


def compute_partial_slices(n_samples: int, cfg=None, partial_utterance_n_frames: Optional[int] = None,
                           min_pad_coverage: float = 0.75, overlap: float = 0.5,
                           rate: Optional[float] = None):
    """Split an utterance into fixed-length partials.

    Returns (wav_slices, mel_slices) lists of python `slice` objects.
    """
    cfg = cfg or encoder_audio_config()
    pn = partial_utterance_n_frames or cfg.partials_n_frames
    if not (0 <= overlap < 1 and 0 < min_pad_coverage <= 1):
        raise ValueError(f"overlap {overlap} / min_pad_coverage {min_pad_coverage} out of range")

    samples_per_frame = int(cfg.sample_rate * cfg.mel_window_step_ms / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    if rate is not None:
        frame_step = int(np.round((cfg.sample_rate / rate) / samples_per_frame))
    else:
        frame_step = max(int(np.round(pn * (1 - overlap))), 1)
    if not 0 < frame_step <= pn:
        raise ValueError(f"frame step {frame_step} outside (0, {pn}]")

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - pn + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + pn])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last = wav_slices[-1]
    coverage = (n_samples - last.start) / (last.stop - last.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        mel_slices, wav_slices = mel_slices[:-1], wav_slices[:-1]
    return wav_slices, mel_slices


class SpeakerEncoderInference:
    """Holds GE2E weights on the device and embeds wavs/mels on demand.

    ``params`` is the flax param tree of ``SpeakerEncoder`` (nested numpy
    dicts, see ``weights.py``); without it the weights are made from
    ``seed``."""

    def __init__(self, params: Optional[dict] = None, cfg=None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or encoder_audio_config()
        with seeded(seed):
            self.model = SpeakerEncoder()
        if params is not None:
            params = params["model"] if "model" in params else params
            load_flax(self.model, params)
        self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path: Union[str, Path], cfg=None,
                        device: Union[str, torch.device] = "cuda") -> "SpeakerEncoderInference":
        """An ``.npz`` export of any of the JAX package's layouts: {"model"},
        {"params": {"model", "similarity"}}, or bare params."""
        params = load_npz(path)
        if "params" in params:
            params = params["params"]
        return cls(params, cfg, device=device)

    @torch.no_grad()
    def embed_frames_batch(self, frames_batch) -> np.ndarray:
        """(B, T, 40) mel frames → (B, 256) embeddings. The batch is padded
        to a power of two, as the JAX package pads it."""
        frames = torch.as_tensor(frames_batch, dtype=torch.float32, device=self.device)
        b = frames.shape[0]
        b_pad = max(1, 1 << (b - 1).bit_length())
        if b_pad != b:
            frames = torch.cat([frames, frames.new_zeros((b_pad - b,) + frames.shape[1:])])
        return self.model(frames)[:b].cpu().numpy()

    @torch.no_grad()
    def wav_to_mel(self, wav: np.ndarray) -> torch.Tensor:
        return mel_encoder(torch.as_tensor(wav, dtype=torch.float32, device=self.device), self.cfg)

    def embed_utterance(self, wav: np.ndarray, using_partials: bool = True,
                        return_partials: bool = False, **kwargs):
        """wav (preprocessed float32) → (256,) embedding."""
        if not using_partials:
            frames = self.wav_to_mel(wav)
            embed = self.embed_frames_batch(frames[None, ...])[0]
            return (embed, None, None) if return_partials else embed

        wave_slices, mel_slices = compute_partial_slices(len(wav), self.cfg, **kwargs)
        max_wave_length = wave_slices[-1].stop
        if max_wave_length >= len(wav):
            wav = np.pad(wav, (0, max_wave_length - len(wav)), "constant")

        frames = self.wav_to_mel(wav)
        frames_batch = torch.stack([frames[s] for s in mel_slices])
        partial_embeds = self.embed_frames_batch(frames_batch)

        raw_embed = np.mean(partial_embeds, axis=0)
        embed = raw_embed / max(np.linalg.norm(raw_embed, 2), 1e-10)
        return (embed, partial_embeds, wave_slices) if return_partials else embed

    def preprocess_wav(self, fpath_or_wav, source_sr: Optional[int] = None) -> np.ndarray:
        return preprocess_wav(fpath_or_wav, self.cfg, source_sr)
