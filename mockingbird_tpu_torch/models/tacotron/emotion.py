"""Emotion embedding extraction (wav2vec2 arousal/dominance/valence).

Port of ``mockingbird_tpu/models/tacotron/emotion.py``: the 1024-d
mean-pooled hidden embedding VITS consumes and 3 emotion logits, from the
port's ``models.wav2emo.EmotionExtractorModel`` on ``device``.

Wav lengths are padded up to 1 s buckets, as the JAX package pads them.
The bucket is part of the result, not only of the speed: with
``feat_extract_norm="group"`` the GroupNorm after the first conv takes its
statistics over every frame, padded ones included, and the convs' biases
make the zero tail non-zero.

Weights, in this order:
  * ``weights_path``: an ``.npz`` export (``weights.flatten_tree`` of the
    flax params, with a ``.json`` sidecar of the config beside it; the
    JAX package imports an orbax directory instead), a ``.safetensors``
    file (when ``safetensors`` can be imported), or a torch checkpoint
    (``.pt``/``.bin``) of the reference's EmotionExtractorModel or HF's
    Wav2Vec2Model, converted by ``interop.torch_weights``. A path that
    does not exist raises ``FileNotFoundError``, as every loader of the
    port does (the JAX package falls back to zeros there);
  * ``seed``: weights made from that seed;
  * neither: the local HF cache of the audeering model through
    ``transformers`` with ``local_files_only`` (nothing is fetched). When
    that fails, the extractor warns and returns the neutral zeros the JAX
    package returns (``emo`` conditioning is additive).
"""
from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ... import resolve_device
from ...config import Config
from ...weights import load_flax, load_npz
from ..wav2emo import (EmotionExtractorModel, frame_mask_of, init_wav2emo, normalize_wav,
                       wav2emo_config)

EMOTION_DIM = 1024
_MODEL_NAME = "audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim"
_BUCKET_SECONDS = 1.0   # wav lengths padded up to multiples of this

_HF_CFG_KEYS = ("conv_dim", "conv_stride", "conv_kernel", "conv_bias", "feat_extract_norm",
                "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
                "do_stable_layer_norm")


def _read_state_dict(path: Path) -> dict:
    """A torch state_dict from a ``.safetensors`` or ``torch.load`` file."""
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file
        return load_file(str(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


def _hf_cache_state_dict():
    """(state_dict, HF config) of the audeering model from the local HF
    cache, without network access."""
    from transformers import AutoConfig, AutoModel
    cfg = AutoConfig.from_pretrained(_MODEL_NAME, local_files_only=True)
    try:
        model = AutoModel.from_pretrained(_MODEL_NAME, local_files_only=True,
                                          trust_remote_code=False)
        return model.state_dict(), cfg
    except (OSError, ValueError):
        # the head's weights live in the full checkpoint
        from transformers.utils import cached_file
        fp = cached_file(_MODEL_NAME, "pytorch_model.bin", local_files_only=True)
        return torch.load(fp, map_location="cpu", weights_only=True), cfg


class EmotionExtractor:
    """wav → (1024-d embedding, 3 logits) on ``device``, ragged batches
    padded to 1 s buckets."""

    def __init__(self, weights_path: Optional[Union[str, Path]] = None, cfg=None,
                 verbose: bool = False, seed: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        from ...interop.torch_weights import convert_wav2vec2_emotion, state_dict_to_numpy

        self.device = resolve_device(device)
        self.cfg = Config(wav2emo_config()).merge(cfg or {})
        self.model: Optional[EmotionExtractorModel] = None
        tree = None
        if weights_path is not None:
            p = Path(weights_path)
            if not p.is_file():
                raise FileNotFoundError(f"no emotion weights at {p}")
            if p.suffix == ".npz":
                sidecar = p.with_suffix(".json")
                if sidecar.exists():
                    self.cfg = Config(wav2emo_config()).merge(
                        Config.from_json(sidecar)).merge(cfg or {})
                tree = load_npz(p)
            else:
                sd = state_dict_to_numpy(_read_state_dict(p))
                tree = convert_wav2vec2_emotion(sd, self.cfg, prefix=_prefix(sd))
            source = str(p)
        elif seed is not None:
            source = f"seed {seed}"
        else:
            try:
                sd, hf_cfg = _hf_cache_state_dict()
            except (ImportError, OSError, ValueError) as e:  # the neutral fallback
                warnings.warn(
                    "wav2vec2 emotion weights unavailable "
                    f"({type(e).__name__}: {e}); emotion embeddings fall back to "
                    f"zeros (neutral). Provide {_MODEL_NAME} in the HF cache or "
                    "pass weights_path= to enable emotion conditioning.")
                return
            self.cfg.merge({k: (tuple(getattr(hf_cfg, k)) if k.startswith("conv_")
                                and k != "conv_bias" else getattr(hf_cfg, k))
                            for k in _HF_CFG_KEYS})
            sd = state_dict_to_numpy(sd)
            tree = convert_wav2vec2_emotion(sd, self.cfg, prefix=_prefix(sd))
            source = f"the HF cache ({_MODEL_NAME})"
        model = init_wav2emo(seed or 0, self.cfg)
        if tree is not None:
            load_flax(model, tree)
        self.model = model.to(self.device).eval()
        if verbose:
            print(f"EmotionExtractor: {self.cfg.num_hidden_layers} blocks, weights from "
                  f"{source}")

    @property
    def available(self) -> bool:
        return self.model is not None

    def extract(self, wav: np.ndarray, sampling_rate: int = 16000):
        """Single utterance → ((1024,) embedding, (3,) logits)."""
        embeds, logits = self.extract_batch([np.asarray(wav, np.float32)])
        return embeds[0], logits[0]

    @torch.no_grad()
    def extract_batch(self, wavs):
        """List of wavs (ragged) → ((B, 1024), (B, 3)) in one forward: every
        wav zero-padded to the longest one's 1 s bucket, normalised over its
        own samples, its frames past its length masked out of attention and
        pooling."""
        if self.model is None:
            return (np.zeros((len(wavs), EMOTION_DIM), np.float32),
                    np.zeros((len(wavs), self.cfg.num_labels), np.float32))
        bucket = int(_BUCKET_SECONDS * self.cfg.sample_rate)
        lens = np.array([max(len(w), 1) for w in wavs])
        padded_len = int(max(bucket, bucket * math.ceil(lens.max() / bucket)))
        batch = np.zeros((len(wavs), padded_len), np.float32)
        for i, w in enumerate(wavs):
            batch[i, :len(w)] = w
        dev = self.device
        wav = normalize_wav(torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev))
        fmask = torch.from_numpy(frame_mask_of(lens, padded_len, self.cfg)).to(dev)
        emb, logits = self.model(wav, fmask)
        return emb.cpu().numpy(), logits.cpu().numpy()


def _prefix(sd: dict) -> str:
    return "wav2vec2" if any(k.startswith("wav2vec2.") for k in sd) else ""


_singleton: dict = {}


def _get(device: Union[str, torch.device] = "cuda") -> EmotionExtractor:
    key = str(resolve_device(device))
    if key not in _singleton:
        _singleton[key] = EmotionExtractor(device=device)
    return _singleton[key]


def extract_emo(wav: np.ndarray, sampling_rate: int = 16000, embeddings: bool = True,
                device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """wav → (1024,) mean-pooled emotion embedding (``embeddings=True``) or
    (3,) arousal/dominance/valence logits, from the HF-cache extractor on
    ``device``; zeros without weights."""
    emb, logits = _get(device).extract(np.asarray(wav, np.float32), sampling_rate)
    return emb if embeddings else logits


def available(device: Union[str, torch.device] = "cuda") -> bool:
    return _get(device).available
