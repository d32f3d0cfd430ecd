"""End-to-end voice-cloning pipeline: reference wav + texts → waveforms.

Port of ``mockingbird_tpu/pipeline.py`` for the slice the port has:
GE2E encoder → Tacotron → WaveRNN. ``tts_batch`` takes the JAX package's
staged branch (the one it takes for a vocoder without ``vocode_device``) and
returns int16 PCM. Weights come from ``.npz`` exports of the JAX package's
param trees; no path gives weights made from ``seed``, and a path that does
not exist raises ``FileNotFoundError``.
A vocoder object passed as ``vocoder`` is used as it is, in place of one
loaded from ``vocoder_fpath``.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from . import resolve_device
from .config import sv2tts_audio_config
from .models.encoder import SpeakerEncoderInference
from .models.tacotron import Synthesizer
from .models.vocoder import load_vocoder


class VoiceCloningPipeline:
    """Few-seconds reference audio → cloned-voice TTS."""

    def __init__(self,
                 encoder_fpath: Optional[Union[str, Path]] = None,
                 synthesizer_fpath: Optional[Union[str, Path]] = None,
                 vocoder_fpath: Optional[Union[str, Path]] = None,
                 synthesizer: str = "tacotron",
                 verbose: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 vocoder=None):
        self.device = resolve_device(device)
        if synthesizer != "tacotron":
            raise NotImplementedError(f"synthesizer {synthesizer!r} is not ported yet")
        self.encoder = (SpeakerEncoderInference.from_checkpoint(encoder_fpath, device=self.device)
                        if encoder_fpath is not None
                        else SpeakerEncoderInference(seed=seed, device=self.device))
        self.synthesizer_kind = synthesizer
        self.synthesizer = Synthesizer(synthesizer_fpath, verbose=verbose, seed=seed,
                                       device=self.device)
        self.vocoder = (vocoder if vocoder is not None
                        else load_vocoder(vocoder_fpath, verbose=verbose, device=self.device))
        self.audio_cfg = sv2tts_audio_config()
        self._embed_cache: dict = {}

    def embed_reference(self, ref_wav: Union[str, Path, np.ndarray],
                        source_sr: Optional[int] = None) -> np.ndarray:
        key = str(ref_wav) if isinstance(ref_wav, (str, Path)) else None
        if key and key in self._embed_cache:
            return self._embed_cache[key]
        wav = self.encoder.preprocess_wav(ref_wav, source_sr)
        embed = self.encoder.embed_utterance(wav)
        if key:
            self._embed_cache[key] = embed
        return embed

    def clone_voice(self, texts: Union[str, List[str]],
                    ref_wav: Union[str, Path, np.ndarray],
                    style_idx: int = 0, min_stop_token: int = 5,
                    steps: int = 1000, use_griffin_lim: bool = False,
                    source_sr: Optional[int] = None) -> List[np.ndarray]:
        """texts + reference audio → float32 waveforms."""
        if use_griffin_lim:
            raise NotImplementedError("Griffin-Lim is not ported yet")
        if isinstance(texts, str):
            texts = [texts]
        embed = self.embed_reference(ref_wav, source_sr)
        embeds = np.tile(embed, (len(texts), 1))
        specs = self.synthesizer.synthesize_spectrograms(
            texts, embeds, style_idx=style_idx, min_stop_token=min_stop_token,
            steps=steps)
        if len(specs) > 1:
            return self.vocoder.infer_waveform_batch(specs)
        return [self.vocoder.infer_waveform(s) for s in specs]

    def tts_batch(self, texts: Union[str, List[str]],
                  ref_wav: Union[str, Path, np.ndarray],
                  style_idx: int = 0, min_stop_token: int = 5,
                  steps: int = 1000, source_sr: Optional[int] = None,
                  pcm16: bool = True, pcm_format: Optional[str] = None) -> List[np.ndarray]:
        """texts → per-text int16 (or, with ``pcm16=False``, float32)
        waveforms through ``clone_voice``: the JAX package's branch for a
        vocoder that cannot vocode on the device."""
        if isinstance(texts, str):
            texts = [texts]
        wavs = self.clone_voice(texts, ref_wav, style_idx=style_idx,
                                min_stop_token=min_stop_token, steps=steps,
                                source_sr=source_sr)
        if pcm_format is not None:
            warnings.warn(
                f"tts_batch: pcm_format={pcm_format!r} requested but the fused "
                f"on-device path is unavailable (vocoder={type(self.vocoder).__name__}); "
                "returning host-quantised int16 instead", stacklevel=2)
        if pcm16 or pcm_format is not None:
            wavs = [np.round(np.clip(w, -1.0, 1.0) * 32767).astype(np.int16) for w in wavs]
        return wavs
