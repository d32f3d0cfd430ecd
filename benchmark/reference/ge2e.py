"""Plain GE2E speaker encoder: a reference wav → its 256-d embedding.

The wav is volume-normalised and voice-trimmed, cut into half-overlapping
160-frame partials of its 40-channel power mel; three LSTM layers of 256 run
over each partial, the last output goes through a dense layer and a ReLU
and is L2-normalised (+1e-5); the partials' mean, L2-normalised, is the
embedding.
"""
from __future__ import annotations

import numpy as np
import torch

from . import audio
from .ops import Prec, linear, lstm_cell


def embed_wav(w: dict, wav: np.ndarray, p: Prec, device, layers: int = 3) -> torch.Tensor:
    """``w``: the encoder's leaves (``layout.ge2e`` keys) on ``device``."""
    wav = audio.vad_trim(audio.normalize_volume(wav))
    starts, n_pad = audio.partial_slices(len(wav))
    if n_pad >= len(wav):
        wav = np.pad(wav, (0, n_pad - len(wav)))
    mel = audio.encoder_mel(torch.from_numpy(wav).to(device))
    x = p.t(torch.stack([mel[s:s + 160] for s in starts]))          # (P, 160, 40)
    for i in range(layers):
        hidden = w[f"lstm_{i}/hi/kernel"].shape[0]
        c = h = x.new_zeros(x.shape[0], hidden)
        outs = []
        for t in range(x.shape[1]):
            c, h = lstm_cell(p, w, f"lstm_{i}", x[:, t], (c, h))
            outs.append(h)
        x = torch.stack(outs, dim=1)
    e = torch.relu(linear(p, x[:, -1], w["linear/kernel"], w["linear/bias"])).float()
    e = e / (torch.linalg.norm(e, dim=1, keepdim=True) + 1e-5)
    e = e.mean(dim=0)
    return e / torch.clamp(torch.linalg.norm(e), min=1e-10)
