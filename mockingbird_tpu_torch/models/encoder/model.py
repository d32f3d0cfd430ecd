"""GE2E speaker encoder (d-vector model), inference.

Port of ``mockingbird_tpu/models/encoder/model.py``: a 3-layer LSTM(40→256)
+ Linear(256→256) + ReLU + L2-norm producing a 256-d speaker embedding.
The GE2E loss and EER are training code and wait for the trainer slice.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import FusedLSTMLayer

MEL_N_CHANNELS = 40
MODEL_HIDDEN_SIZE = 256
MODEL_EMBEDDING_SIZE = 256
MODEL_NUM_LAYERS = 3


class SpeakerEncoder(nn.Module):
    """mel frames (B, T, 40) → L2-normalised embeddings (B, 256)."""

    def __init__(self, hidden_size: int = MODEL_HIDDEN_SIZE,
                 embedding_size: int = MODEL_EMBEDDING_SIZE,
                 num_layers: int = MODEL_NUM_LAYERS):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", FusedLSTMLayer(
                MEL_N_CHANNELS if i == 0 else hidden_size, hidden_size))
        self.num_layers = num_layers
        self.linear = nn.Linear(hidden_size, embedding_size)

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        x = utterances
        for i in range(self.num_layers):
            x = getattr(self, f"lstm_{i}")(x)
        # for an LSTM the final hidden state equals the last output
        embeds_raw = torch.relu(self.linear(x[:, -1, :]))
        return embeds_raw / (torch.linalg.norm(embeds_raw, dim=1, keepdim=True) + 1e-5)
