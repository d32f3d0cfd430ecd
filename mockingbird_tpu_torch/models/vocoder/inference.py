"""Vocoder inference: mel → waveform.

Port of ``mockingbird_tpu/models/vocoder/inference.py``: ``GanVocoder``
(HiFi-GAN or Fre-GAN) with its device entry ``vocode_device`` (int16,
8-bit mu-law or float32 PCM quantised on the device), and ``load_vocoder``,
the dispatch by checkpoint filename ("fregan" → Fre-GAN, "hifigan" or no
path → HiFi-GAN, anything else → WaveRNN).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded, tracing
from ...config import Config
from ...dsp import encode_mulaw8_device
from ...ops.conv_epilogue import launches
from ...weights import load_flax, load_npz
from ..layers import Conv1d, ConvTranspose1d
from .fregan import FreGanGenerator, fregan_config
from .hifigan import Generator as HifiGenerator, hifigan_config


def _bucket(n: int, size: int = 64) -> int:
    return max(size, ((n + size - 1) // size) * size)


class GanVocoder:
    """Parallel conv vocoder (HiFi-GAN / Fre-GAN).

    Weights come from ``variables`` (the generator's flax tree, see
    ``weights.py``), from an ``.npz`` export at ``model_fpath`` (its ``g``
    subtree, else its ``params``, else the whole tree; a ``.json`` sidecar
    beside it replaces the stock config), or else from ``seed``. A
    ``model_fpath`` that does not exist raises. ``half=True`` (the default,
    as in the JAX package) casts every weight and the mel to bf16 and the
    output back to f32 before it is quantised."""

    def __init__(self, arch: str = "hifigan", model_fpath: Optional[Union[str, Path]] = None,
                 cfg=None, verbose: bool = True, seed: int = 0, half: bool = True,
                 variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.arch = arch
        self.cfg = Config(hifigan_config() if arch == "hifigan" else fregan_config())
        if model_fpath is not None:
            sidecar = Path(model_fpath).with_suffix(".json")
            if sidecar.exists():
                self.cfg = Config.from_json(sidecar)
            tree = load_npz(model_fpath)
            variables = tree.get("g", tree.get("params", tree))
            if verbose:
                print(f"Loaded {arch} from {model_fpath}")
        elif variables is None and verbose:
            print(f"{arch}: weights made from seed {seed}")
        self.cfg.merge(cfg or {})
        with seeded(seed):
            model = (HifiGenerator(self.cfg) if arch == "hifigan"
                     else FreGanGenerator(self.cfg))
        if variables is not None:
            load_flax(model, variables)
        self.half = half
        self.model = model.to(self.device, torch.bfloat16 if half else torch.float32).eval()
        # each runs once a call
        self.n_convs = sum(isinstance(m, (Conv1d, ConvTranspose1d)) for m in model.modules())

    @torch.no_grad()
    def _fwd(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, M) on the device → f32 wav (B, T·hop)."""
        return self.model(mel.to(torch.bfloat16 if self.half else torch.float32)).float()

    def infer_waveform(self, mel: np.ndarray) -> np.ndarray:
        """mel (M, T) or (T, M) → wav float32 of T·hop samples. T is padded
        with the mel's minimum to a multiple of 64 and the wav trimmed."""
        return self.infer_waveform_batch([mel])[0]

    def infer_waveform_batch(self, mels) -> list:
        """List of mels → list of wavs, in one generator call: every mel is
        padded with its own minimum to the longest one's 64-frame bucket."""
        n_mels = self.cfg.num_mels
        mels = [np.asarray(x, np.float32) for x in mels]
        mels = [x.T if (x.shape[0] == n_mels and x.shape[1] != n_mels) else x
                for x in mels]                                          # → (T, M)
        lengths = [m.shape[0] for m in mels]
        t_pad = _bucket(max(lengths))
        batch = np.stack([np.pad(m, ((0, t_pad - m.shape[0]), (0, 0)),
                                 constant_values=m.min()) for m in mels])
        wavs = self._fwd(torch.from_numpy(batch).to(self.device)).cpu().numpy()
        hop = self.cfg.hop_size
        return [wavs[i, : lengths[i] * hop] for i in range(len(mels))]

    @torch.no_grad()
    def vocode_device(self, mel_dev: torch.Tensor, pcm16: bool = True,
                      pcm_format: Optional[str] = None) -> torch.Tensor:
        """Device mel (B, T, M) → device wav (B, T·hop), quantised on the
        device: ``pcm_format`` "int16" (the default), "mulaw8" (uint8, one
        byte per sample; decode on the host with
        ``dsp.decode_mulaw8_to_int16``) or "float32"; ``pcm16=False`` with no
        ``pcm_format`` means "float32". Records the span ``hifigan.vocode``
        with ``convs``, the generator's convolutions, and ``fused_convs``,
        the epilogue kernel's launches on the calling thread in this call."""
        if pcm_format is None:
            pcm_format = "int16" if pcm16 else "float32"
        if pcm_format not in ("int16", "mulaw8", "float32"):
            raise KeyError(pcm_format)
        with tracing.span("hifigan.vocode") as vocode:
            launched = launches()
            wav = self._fwd(mel_dev)
            vocode.set("convs", self.n_convs)
            vocode.set("fused_convs", launches() - launched)
            if pcm_format == "int16":
                return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
            if pcm_format == "mulaw8":
                return encode_mulaw8_device(wav)
            return wav


def load_vocoder(model_fpath: Union[str, Path, None] = None, verbose: bool = True,
                 device: Union[str, torch.device] = "cuda"):
    """Dispatch by checkpoint filename: "fregan" → Fre-GAN, "hifigan" or no
    path → HiFi-GAN (seeded weights without a path), else WaveRNN."""
    name = str(model_fpath or "").lower()
    if "fregan" in name:
        return GanVocoder("fregan", model_fpath, verbose=verbose, device=device)
    if "hifigan" in name or model_fpath is None:
        return GanVocoder("hifigan", model_fpath, verbose=verbose, device=device)
    from .wavernn import WaveRnnVocoder
    return WaveRnnVocoder(model_fpath, verbose=verbose, device=device)
