"""Vocoder dispatch by checkpoint filename, mirroring the JAX package's
``load_vocoder`` (the toolbox rule: "hifigan"/"fregan" in the name → GAN
vocoder, else WaveRNN). The GAN vocoders are not ported yet."""
from __future__ import annotations

from pathlib import Path
from typing import Union

import torch


def load_vocoder(model_fpath: Union[str, Path, None] = None, verbose: bool = True,
                 device: Union[str, torch.device] = "cuda"):
    name = str(model_fpath or "").lower()
    if "fregan" in name or "hifigan" in name or model_fpath is None:
        raise NotImplementedError(
            "the HiFi-GAN and Fre-GAN vocoders are not ported yet; "
            "pass a WaveRNN checkpoint path")
    from .wavernn import WaveRnnVocoder
    return WaveRnnVocoder(model_fpath, verbose=verbose, device=device)
