"""wav2vec2 speech-emotion model (arousal/dominance/valence).

Port of ``mockingbird_tpu/models/wav2emo.py``: HF ``Wav2Vec2Model`` with
eval semantics (conv feature encoder, feature projection, grouped positional
conv, pre-LN or post-LN transformer) plus the tanh regression head. The
mean-pooled 1024-d hidden embedding conditions VITS; the 3 logits are
arousal, dominance and valence.

The modules carry the flax tree's names, so ``weights.load_flax`` maps the
JAX params (or ``interop.torch_weights.convert_wav2vec2_emotion`` of a
reference or HF state_dict) strictly. Attention is plain ``torch.matmul``
and softmax, as the JAX package writes it with einsums, and the key mask is
a finite bias (``finfo(float32).min``, never ``-inf``): a row whose every key
is masked attends uniformly, as in JAX, instead of giving NaN.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import seeded
from ..config import Config
from .layers import Conv1d, Dense, LayerNorm

_LN_EPS = 1e-5


def wav2emo_config() -> Config:
    """audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim architecture
    (wav2vec2-large-robust pruned to 12 transformer blocks, 3 regression
    labels)."""
    return Config(
        conv_dim=(512, 512, 512, 512, 512, 512, 512),
        conv_stride=(5, 2, 2, 2, 2, 2, 2),
        conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_bias=True,
        feat_extract_norm="layer",      # "layer" (robust) or "group" (base)
        hidden_size=1024,
        num_hidden_layers=12,
        num_attention_heads=16,
        intermediate_size=4096,
        num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16,
        do_stable_layer_norm=True,
        num_labels=3,
        sample_rate=16000,
    )


def feat_extract_output_length(length: int, cfg) -> int:
    """Waveform samples → frame count after the conv feature encoder
    (floor division: a wav shorter than the first kernel gives ≤ 0)."""
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        length = (length - k) // s + 1
    return length


def normalize_wav(wav: torch.Tensor, n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HF Wav2Vec2FeatureExtractor zero-mean/unit-var normalisation. With
    ``n_valid`` (true sample counts), the statistics ignore the right
    padding and the padded tail is left at exactly 0."""
    if n_valid is None:
        mean = wav.mean(-1, keepdim=True)
        var = wav.var(-1, unbiased=False, keepdim=True)
        return (wav - mean) / torch.sqrt(var + 1e-7)
    t = wav.shape[-1]
    mask = (torch.arange(t, device=wav.device)[None, :] < n_valid[:, None]).to(wav.dtype)
    n = torch.clamp(n_valid[:, None].to(wav.dtype), min=1.0)
    mean = (wav * mask).sum(-1, keepdim=True) / n
    var = (torch.square(wav - mean) * mask).sum(-1, keepdim=True) / n
    return (wav - mean) / torch.sqrt(var + 1e-7) * mask


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over the channels of (B, T, C):
    statistics per (item, group) over every frame, padded ones included."""

    def __init__(self, num_groups: int, features: int, eps: float = _LN_EPS):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.transpose(1, 2), self.num_groups, self.scale, self.bias, self.eps)
        return y.transpose(1, 2)


class FeatureEncoder(nn.Module):
    """Strided conv stack (Wav2Vec2FeatureEncoder): raw wav → frame feats.
    ``feat_extract_norm="layer"`` puts a LayerNorm after every conv; "group"
    puts one GroupNorm after conv 0 only."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        in_ch = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(in_ch, dim, k, stride=s, bias=cfg.conv_bias,
                                                padding="VALID"))
            if cfg.feat_extract_norm == "layer":
                self.add_module(f"ln_{i}", LayerNorm(dim, _LN_EPS))
            elif i == 0:
                self.gn_0 = GroupNorm(dim, dim)
            in_ch = dim

    def forward(self, wav: torch.Tensor) -> torch.Tensor:       # (B, T) → (B, frames, C)
        x = wav[..., None]
        for i in range(len(self.cfg.conv_dim)):
            x = getattr(self, f"conv_{i}")(x)
            if self.cfg.feat_extract_norm == "layer":
                x = getattr(self, f"ln_{i}")(x)
            elif i == 0:
                x = self.gn_0(x)
            x = F.gelu(x)
        return x


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embeddings (weight norm folded into the
    kernel); an even kernel drops the trailing frame."""

    def __init__(self, cfg):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.k = k
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                           groups=cfg.num_conv_pos_embedding_groups, padding=(k // 2, k // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:          # (B, T, H)
        y = self.conv(x)
        if self.k % 2 == 0:
            y = y[:, :-1]
        return F.gelu(y)


class SelfAttention(nn.Module):
    """Post-scaling multi-head attention, every projection biased."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.n = cfg.num_attention_heads
        self.d = h // self.n
        self.q_proj, self.k_proj = Dense(h, h), Dense(h, h)
        self.v_proj, self.out_proj = Dense(h, h), Dense(h, h)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, h = x.shape

        def split(y):                                              # → (B, n, T, d)
            return y.reshape(b, t, self.n, self.d).transpose(1, 2)

        q = split(self.q_proj(x) * (self.d ** -0.5))
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        if attn_bias is not None:
            scores = scores + attn_bias
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, h))


class FeedForward(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.intermediate_dense = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """One transformer block; ``stable`` is the pre-LN variant, else post-LN."""

    def __init__(self, cfg, stable: bool):
        super().__init__()
        self.stable = stable
        self.attention = SelfAttention(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, _LN_EPS)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, _LN_EPS)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.stable:
            x = x + self.attention(self.layer_norm(x), attn_bias)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, attn_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class Wav2Vec2Encoder(nn.Module):
    """Positional conv + transformer stack. Padded frames are zeroed before
    the positional conv and left out of attention by a finite key bias."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, _LN_EPS)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, cfg.do_stable_layer_norm))

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor]) -> torch.Tensor:
        attn_bias = None
        if frame_mask is not None:
            x = x * frame_mask[..., None]
            attn_bias = torch.where(frame_mask[:, None, None, :] > 0, 0.0,
                                    torch.finfo(torch.float32).min)
        x = x + self.pos_conv_embed(x)
        if not self.cfg.do_stable_layer_norm:
            x = self.layer_norm(x)
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias)
        if self.cfg.do_stable_layer_norm:
            x = self.layer_norm(x)
        return x


class Wav2Vec2Model(nn.Module):
    """Feature encoder → projection → transformer (eval semantics: no
    spec-augment masking, no dropout)."""

    def __init__(self, cfg):
        super().__init__()
        self.feature_encoder = FeatureEncoder(cfg)
        self.fp_layer_norm = LayerNorm(cfg.conv_dim[-1], _LN_EPS)
        self.fp_projection = Dense(cfg.conv_dim[-1], cfg.hidden_size)
        self.encoder = Wav2Vec2Encoder(cfg)

    def forward(self, wav: torch.Tensor, frame_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:                                  # (B, T) → (B, frames, H)
        x = self.fp_projection(self.fp_layer_norm(self.feature_encoder(wav)))
        return self.encoder(x, frame_mask)


class EmotionExtractorModel(nn.Module):
    """Wav2Vec2 + tanh regression head. Returns (mean-pooled hidden
    embedding, emotion logits); with ``frame_mask`` the pooling is a masked
    mean over max(valid frames, 1)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg)
        self.cls_dense = Dense(cfg.hidden_size, cfg.hidden_size)
        self.cls_out_proj = Dense(cfg.hidden_size, cfg.num_labels)

    def forward(self, wav: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        hidden = self.wav2vec2(wav, frame_mask)
        if frame_mask is None:
            pooled = hidden.mean(1)
        else:
            n = torch.clamp(frame_mask.sum(-1, keepdim=True), min=1.0)
            pooled = (hidden * frame_mask[..., None]).sum(1) / n
        return pooled, self.cls_out_proj(torch.tanh(self.cls_dense(pooled)))


def frame_mask_of(n_valid: np.ndarray, n_samples: int, cfg) -> np.ndarray:
    """(B,) true sample counts → (B, frames) float32 validity of the conv
    encoder's frames for a batch padded to ``n_samples``."""
    frames = feat_extract_output_length(n_samples, cfg)
    nf = np.array([feat_extract_output_length(int(n), cfg) for n in n_valid])
    return (np.arange(frames)[None, :] < nf[:, None]).astype(np.float32)


def init_wav2emo(seed: int = 0, cfg=None) -> EmotionExtractorModel:
    """``EmotionExtractorModel`` with weights made from ``seed`` (the
    counterpart of the JAX package's ``init_wav2emo``; PyTorch's default
    initialisers, not flax's)."""
    cfg = Config(wav2emo_config()).merge(cfg or {})
    with seeded(seed):
        return EmotionExtractorModel(cfg).eval()
