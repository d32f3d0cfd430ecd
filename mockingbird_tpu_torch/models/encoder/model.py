"""GE2E speaker encoder (d-vector model) and its training loss.

Port of ``mockingbird_tpu/models/encoder/model.py``: a 3-layer LSTM(40→256)
+ Linear(256→256) + ReLU + L2-norm producing a 256-d speaker embedding,
trained with the GE2E softmax loss over a (speakers × utterances) batch with
a learned similarity scale (w=10, b=−5). The similarity matrix is one
einsum and a mask select; the EER is taken on the device from the sorted
scores and returned as a tensor, so a training step never waits on the host.

One difference by design: the L2 norm's gradient at an all-zero ReLU row is
0 here (``torch.linalg.norm``) and NaN in JAX (``jnp.linalg.norm``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import seeded
from ..layers import FusedLSTMLayer

MEL_N_CHANNELS = 40
MODEL_HIDDEN_SIZE = 256
MODEL_EMBEDDING_SIZE = 256
MODEL_NUM_LAYERS = 3


class SpeakerEncoder(nn.Module):
    """mel frames (B, T, 40) → L2-normalised embeddings (B, 256).

    ``remat``: each LSTM layer's activations are recomputed in the backward
    instead of kept (``torch.utils.checkpoint``), as the JAX package's
    ``nn.remat`` does; the parameter names do not change."""

    def __init__(self, hidden_size: int = MODEL_HIDDEN_SIZE,
                 embedding_size: int = MODEL_EMBEDDING_SIZE,
                 num_layers: int = MODEL_NUM_LAYERS, remat: bool = False):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"lstm_{i}", FusedLSTMLayer(
                MEL_N_CHANNELS if i == 0 else hidden_size, hidden_size))
        self.num_layers = num_layers
        self.remat = remat
        self.linear = nn.Linear(hidden_size, embedding_size)

    def forward(self, utterances: torch.Tensor) -> torch.Tensor:
        x = utterances
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            x = getattr(self, f"lstm_{i}")(x, remat)
        # for an LSTM the final hidden state equals the last output
        embeds_raw = torch.relu(self.linear(x[:, -1, :]))
        return embeds_raw / (torch.linalg.norm(embeds_raw, dim=1, keepdim=True) + 1e-5)


def init_similarity_params() -> nn.ParameterDict:
    """The learned cosine-similarity scale, initial w=10 b=−5."""
    return nn.ParameterDict({"weight": nn.Parameter(torch.tensor([10.0])),
                             "bias": nn.Parameter(torch.tensor([-5.0]))})


def init_params(seed: int = 0, hidden_size: int = MODEL_HIDDEN_SIZE,
                embedding_size: int = MODEL_EMBEDDING_SIZE,
                num_layers: int = MODEL_NUM_LAYERS, remat: bool = False) -> nn.ModuleDict:
    """Every trained parameter, made from ``seed``: ``{"model": SpeakerEncoder,
    "similarity": {"weight", "bias"}}``, the JAX package's tree (``to_flax``
    of it is ``init_params``'s layout)."""
    with seeded(seed):
        model = SpeakerEncoder(hidden_size, embedding_size, num_layers, remat)
    return nn.ModuleDict({"model": model, "similarity": init_similarity_params()})


def similarity_matrix(embeds: torch.Tensor, sim_weight: torch.Tensor,
                      sim_bias: torch.Tensor) -> torch.Tensor:
    """GE2E §2.1 similarity matrix. embeds: (S, U, D) L2-normalised.
    Returns (S, U, S): entry [j, i, k] is the scaled cosine similarity of
    utterance (j, i) to centroid k, the exclusive centroid when k == j and
    the inclusive one otherwise."""
    s, u, _ = embeds.shape
    c_incl = embeds.mean(dim=1)                                          # (S, D)
    c_incl = c_incl / (torch.linalg.norm(c_incl, dim=1, keepdim=True) + 1e-5)
    c_excl = (embeds.sum(dim=1, keepdim=True) - embeds) / (u - 1)         # (S, U, D)
    c_excl = c_excl / (torch.linalg.norm(c_excl, dim=2, keepdim=True) + 1e-5)
    sim_incl = torch.einsum("jid,kd->jik", embeds, c_incl)
    sim_excl = (embeds * c_excl).sum(dim=2)                               # (S, U)
    eye = torch.eye(s, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(eye, sim_excl[:, :, None], sim_incl)
    return sim * sim_weight + sim_bias


def ge2e_loss(embeds: torch.Tensor, sim_weight: torch.Tensor, sim_bias: torch.Tensor):
    """GE2E softmax loss. Returns (scalar loss, (S·U, S) similarity matrix)."""
    s, u, _ = embeds.shape
    sim = similarity_matrix(embeds, sim_weight, sim_bias).reshape(s * u, s)
    target = torch.arange(s, device=embeds.device).repeat_interleave(u)
    logp = F.log_softmax(sim, dim=1)
    return -logp.gather(1, target[:, None]).mean(), sim


def equal_error_rate(sim: torch.Tensor, speakers_per_batch: int,
                     utterances_per_speaker: Optional[int] = None) -> torch.Tensor:
    """Exact EER from the flattened (positives vs negatives) score
    distribution, on the device: sort all S·U·S scores (stably, as
    ``jnp.argsort``), count true and false accepts above every score, and
    take the crossing of FAR and FRR. Returns a 0-d tensor."""
    s = speakers_per_batch
    n = sim.shape[0]                                                     # S·U
    classes = torch.arange(s, device=sim.device)
    labels = classes[None, :] == classes.repeat_interleave(n // s)[:, None]
    scores = sim.detach().reshape(-1)
    pos = labels.reshape(-1).float()
    pos_sorted = pos[torch.argsort(-scores, stable=True)]
    n_pos = pos.sum()
    n_neg = pos.numel() - n_pos
    far = torch.cumsum(1.0 - pos_sorted, 0) / torch.clamp(n_neg, min=1)
    frr = 1.0 - torch.cumsum(pos_sorted, 0) / torch.clamp(n_pos, min=1)
    idx = torch.argmin(torch.abs(far - frr))
    return (far[idx] + frr[idx]) / 2.0
