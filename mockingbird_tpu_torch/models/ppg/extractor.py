"""PPG extractor: Conformer ASR encoder → frame-level bottleneck features.

Port of ``mockingbird_tpu/models/ppg/extractor.py`` (espnet-derived):
DefaultFrontend (STFT → 80 log-mel at 10 ms hop) → UtteranceMVN →
ConformerEncoder (macaron feed-forward ×0.5, relative-position MHSA with
learned u/v biases, depthwise conv module) → 144-d bottleneck per 10 ms
frame. The attention is written out with ``torch.matmul`` in the JAX
package's order of operations (legacy relative shift included), not with
``scaled_dot_product_attention``.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device, seeded
from ...config import Config
from ...dsp.mel import mel_filterbank
from ...dsp.stft import stft_magnitude
from ...weights import load_flax, load_npz
from ..layers import BatchNorm, Conv1d, Dense, LayerNorm
from ..vits.modules import sequence_mask


def ppg_config() -> Config:
    return Config(
        # frontend (espnet DefaultFrontend defaults @16 kHz)
        sample_rate=16000,
        n_fft=512,
        win_size=400,
        hop_size=160,
        num_mels=80,
        fmin=0.0,
        fmax=None,
        norm_means=True,
        norm_vars=False,
        # conformer
        output_size=144,
        attention_heads=4,
        linear_units=1024,
        num_blocks=8,
        dropout_rate=0.1,
        cnn_kernel=15,
        input_layer="linear",   # or "conv2d_nosub"; both keep the 10 ms rate
    )


def logmel_frontend(wav: torch.Tensor, cfg, lengths: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, L) → (B, T, 80) log-mel, 10 ms hop: POWER spectrum → slaney mel
    (norm=1) → natural log of (power_mel + 1e-20), padded frames zeroed. The
    mel projection is a full-f32 product (PyTorch's default for matmuls)."""
    mag = stft_magnitude(wav, cfg.n_fft, cfg.hop_size, cfg.win_size,
                         center=True, pad_mode="reflect")
    power = mag * mag
    melb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                          cfg.fmax or cfg.sample_rate / 2).T
    mel = power @ torch.from_numpy(np.ascontiguousarray(melb, np.float32)).to(power)
    logmel = torch.log(mel + 1e-20)
    if lengths is not None:
        logmel = logmel * sequence_mask(lengths, logmel.shape[1])[..., None]
    return logmel


def utterance_mvn(feats: torch.Tensor, lengths: torch.Tensor, norm_means: bool = True,
                  norm_vars: bool = False) -> torch.Tensor:
    """Per-utterance mean/variance normalisation over the valid frames."""
    mask = sequence_mask(lengths, feats.shape[1])[..., None]
    n = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    mean = (feats * mask).sum(dim=1, keepdim=True) / n
    if norm_means:
        feats = (feats - mean) * mask
    if norm_vars:
        var = ((feats * mask) ** 2).sum(dim=1, keepdim=True) / n
        feats = feats * torch.rsqrt(torch.clamp(var, min=1e-20))
    return feats


def legacy_rel_pos(t: int, d: int, max_len: int = 5000) -> np.ndarray:
    """espnet's legacy (reversed) positional table: built once for
    ``max_len`` = max(5000, t) positions and sliced to its FIRST t rows, so
    row m encodes absolute position max_len-1-m, not t-1-m."""
    max_len = max(max_len, t)
    pos = np.arange(max_len - 1, max_len - 1 - t, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(np.log(10000.0) / d))
    pe = np.zeros((t, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def _legacy_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """espnet's legacy rel_shift: pad one zero column on the left, read
    (B, H, T, S+1) as (B, H, S+1, T), drop the first row."""
    b, h, t, s = x.shape
    x = F.pad(x, (1, 0))
    return x.reshape(b, h, s + 1, t)[:, :, 1:].reshape(b, h, t, s)


class RelPositionMultiHeadAttention(nn.Module):
    """Relative-position attention with learned u/v biases (espnet's legacy
    ``RelPositionMultiHeadedAttention``). Masked scores are filled with the
    dtype's minimum and their weights zeroed after the softmax."""

    def __init__(self, n_heads: int, n_feat: int):
        super().__init__()
        self.n_heads, self.d_k = n_heads, n_feat // n_heads
        self.linear_q = Dense(n_feat, n_feat)
        self.linear_k = Dense(n_feat, n_feat)
        self.linear_v = Dense(n_feat, n_feat)
        self.linear_pos = Dense(n_feat, n_feat, bias=False)
        self.linear_out = Dense(n_feat, n_feat)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_heads, self.d_k))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, n_feat = x.shape
        h, d = self.n_heads, self.d_k
        q = self.linear_q(x).reshape(b, t, h, d).transpose(1, 2)      # (B, H, T, d)
        k = self.linear_k(x).reshape(b, t, h, d).transpose(1, 2)
        v = self.linear_v(x).reshape(b, t, h, d).transpose(1, 2)
        p = self.linear_pos(pos_emb).reshape(1, -1, h, d).transpose(1, 2)   # (1, H, T, d)
        ac = torch.matmul(q + self.pos_bias_u[None, :, None, :], k.transpose(-1, -2))
        bd = torch.matmul(q + self.pos_bias_v[None, :, None, :], p.transpose(-1, -2))
        scores = (ac + _legacy_rel_shift(bd)) / math.sqrt(d)
        if mask is not None:
            scores = scores.masked_fill(mask == 0, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(mask == 0, 0.0)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, n_feat)
        return self.linear_out(out)


class ConvModule(nn.Module):
    """Conformer conv module: LN → pointwise-GLU → ×mask → depthwise (SAME)
    → BatchNorm → swish → pointwise."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.norm = LayerNorm(channels, eps=1e-12)
        self.pw1 = Dense(channels, 2 * channels)
        self.dw = Conv1d(channels, channels, kernel, groups=channels)
        self.bn = BatchNorm(channels)
        self.pw2 = Dense(channels, channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = F.glu(self.pw1(self.norm(x)), dim=-1) * mask
        return self.pw2(F.silu(self.bn(self.dw(y))))


class ConformerBlock(nn.Module):
    """Macaron feed-forward ×0.5, attention, conv module, feed-forward ×0.5,
    final LayerNorm; every LayerNorm at epsilon 1e-12."""

    def __init__(self, size: int, heads: int, linear_units: int, cnn_kernel: int):
        super().__init__()
        for name in ("ff_macaron", "ff"):
            self.add_module(f"{name}_norm", LayerNorm(size, eps=1e-12))
            self.add_module(f"{name}_1", Dense(size, linear_units))
            self.add_module(f"{name}_2", Dense(linear_units, size))
        self.attn_norm = LayerNorm(size, eps=1e-12)
        self.attn = RelPositionMultiHeadAttention(heads, size)
        self.conv = ConvModule(size, cnn_kernel)
        self.final_norm = LayerNorm(size, eps=1e-12)

    def _ff(self, name: str, z: torch.Tensor) -> torch.Tensor:
        z = getattr(self, f"{name}_norm")(z)
        return getattr(self, f"{name}_2")(F.silu(getattr(self, f"{name}_1")(z)))

    def forward(self, x, pos_emb, pad_mask, attn_mask):
        x = x + 0.5 * self._ff("ff_macaron", x)
        x = x + self.attn(self.attn_norm(x), pos_emb, attn_mask)
        x = x + self.conv(x, pad_mask)
        x = x + 0.5 * self._ff("ff", x)
        return self.final_norm(x)


class ConformerEncoder(nn.Module):
    """Input layer (``"linear"``: Dense → LayerNorm at epsilon 1e-5;
    ``"conv2d_nosub"``: two 5×5 convs, stride 1, then a channel-major
    flatten and a Dense) → ×√d → blocks → LayerNorm → ×pad mask."""

    def __init__(self, cfg):
        super().__init__()
        c = self.cfg = cfg
        size = c.output_size
        self.conv2d = c.get("input_layer", "linear") == "conv2d_nosub"
        if self.conv2d:
            self.embed_conv_0 = nn.Conv2d(1, size, 5, padding=2)
            self.embed_conv_1 = nn.Conv2d(size, size, 5, padding=2)
            self.embed_out = Dense(size * c.num_mels, size)
        else:
            self.embed = Dense(c.num_mels, size)
            self.embed_norm = LayerNorm(size, eps=1e-5)
        for i in range(c.num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(size, c.attention_heads,
                                                         c.linear_units, c.cnn_kernel))
        self.after_norm = LayerNorm(size, eps=1e-12)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        size = self.cfg.output_size
        b, t, f = feats.shape
        if self.conv2d:
            y = torch.relu(self.embed_conv_0(feats[:, None]))          # (B, C, T, F)
            y = torch.relu(self.embed_conv_1(y))
            x = self.embed_out(y.transpose(1, 2).reshape(b, t, size * f))
        else:
            x = self.embed_norm(self.embed(feats))
        x = x * math.sqrt(size)
        pos_emb = torch.from_numpy(legacy_rel_pos(t, size)).to(x.device)[None]
        pad_mask = sequence_mask(lengths, t)[..., None]
        attn_mask = pad_mask[:, None, None, :, 0]                        # (B, 1, 1, T)
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, pad_mask, attn_mask)
        return self.after_norm(x) * pad_mask


class PPGModel(nn.Module):
    """wav (B, L) + lengths → (B, T, output_size) bottleneck features."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        feat_lengths = speech_lengths // c.hop_size + 1
        feats = logmel_frontend(speech, c, feat_lengths)
        feats = utterance_mvn(feats, feat_lengths, c.norm_means, c.norm_vars)
        return self.encoder(feats, feat_lengths)


class PPGExtractor:
    """Inference wrapper: wavs → PPGs, on ``device``.

    Weights come from ``variables`` (the flax tree ``{"params",
    "batch_stats"}``, see ``weights.py``), from an ``.npz`` export at
    ``model_fpath``, or else from ``seed``. A ``model_fpath`` that does not
    exist raises ``FileNotFoundError``."""

    def __init__(self, model_fpath: Optional[Union[str, Path]] = None, cfg=None,
                 verbose: bool = True, seed: int = 0, variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = Config(ppg_config()).merge(cfg or {})
        if model_fpath is not None:
            if not Path(model_fpath).is_file():
                raise FileNotFoundError(f"no PPG extractor weights at {model_fpath}")
            variables = load_npz(model_fpath)
            if verbose:
                print(f"Loaded PPG extractor from {model_fpath}")
        elif variables is None and verbose:
            print("PPG extractor: fresh (untrained) weights")
        with seeded(seed):
            model = PPGModel(self.cfg)
        if variables is not None:
            load_flax(model, variables)
        self.model = model.to(self.device).eval()

    def extract_from_wav(self, wav: np.ndarray) -> np.ndarray:
        """wav float32 → (T, output_size) PPG at 10 ms frames."""
        return self.extract_from_wavs([wav])[0]

    @torch.no_grad()
    def extract_from_wavs(self, wavs) -> List[np.ndarray]:
        """Batched extraction: every wav is zero-padded to one shared 1 s
        length bucket (at least 3200 samples) and the batch runs through one
        Conformer forward. The bucket is part of the result, not only of
        the speed: the last frames of each utterance see the padding."""
        ns = [len(w) for w in wavs]
        n_pad = max(3200, int(np.ceil(max(ns) / 16000)) * 16000)
        w = np.zeros((len(wavs), n_pad), np.float32)
        for i, wav in enumerate(wavs):
            w[i, : ns[i]] = wav
        out = self.model(torch.from_numpy(w).to(self.device),
                         torch.as_tensor(ns, dtype=torch.int64, device=self.device))
        out = out.cpu().numpy()
        return [out[i, : ns[i] // self.cfg.hop_size + 1] for i in range(len(wavs))]
