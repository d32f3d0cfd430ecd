"""PPG→Mel one-shot voice-conversion decoder (MelDecoderMOLv2).

Port of ``mockingbird_tpu/models/ppg/ppg2mel.py``: conv-downsampled PPG
prenet (×4) + parallel pitch (lf0+uv) convs summed, the L2-normalised
speaker d-vector concatenated → ``reduce_proj``; a MOL-attention
(location-relative GMMv2b) LSTM decoder emitting ``frames_per_step`` mel
frames per step with stop tokens; a 5-layer conv Postnet. Module I/O is
time-major (B, T, C) like the JAX package.

Two reference quirks are kept: the decoder prenet's dropout stays on at
inference (``prenet_always_dropout``), and the MOL attention's CDF is
``1/(1+sigmoid((mu-j)/sigma))``.

``model.train()`` is the JAX package's ``train=True``: dropout 0.5 on the
attention's mixture logits and after every postnet layer, and the postnet's
BatchNorms in flax's batch-statistics mode (``layers.FlaxBatchNorm``: biased
variance, running statistics at momentum 0.9). Every dropout draws from an
explicit ``torch.Generator``, and none draws without one; the teacher-forced
forward can instead take the keep masks handed in (``masks``), one per
dropout site and the same at every decoder step, as a ``jax.random`` draw
traced once inside JAX's ``nn.scan`` is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...config import Config
from ..layers import Conv1d, Dense, Dropout, FlaxBatchNorm, LSTMCell, dropout, promote
from ..vits.modules import sequence_mask


def ppg2mel_config() -> Config:
    return Config(
        num_speakers=1,
        spk_embed_dim=256,
        bottle_neck_feature_dim=144,
        encoder_dim=256,
        encoder_downsample_rates=[2, 2],
        attention_rnn_dim=512,
        decoder_rnn_dim=512,
        num_decoder_rnn_layer=1,
        concat_context_to_last=True,
        prenet_dims=[256, 128],
        num_mixtures=5,
        frames_per_step=2,
        num_mels=80,
        pitch_dim=2,
    )


class DecoderPrenet(nn.Module):
    """Bias-free Dense + relu + dropout 0.5, the dropout on at inference
    unless ``always_dropout`` is False."""

    def __init__(self, in_dim: int, sizes, always_dropout: bool = True):
        super().__init__()
        self.n = len(sizes)
        for i, (a, s) in enumerate(zip([in_dim] + list(sizes[:-1]), sizes)):
            self.add_module(f"fc{i}", Dense(a, s, bias=False))
        self.drop = Dropout(0.5 if always_dropout else 0.0)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keeps: Optional[list] = None):
        for i in range(self.n):
            x = self.drop(torch.relu(getattr(self, f"fc{i}")(x)), generator,
                          None if keeps is None else keeps[i])
        return x


def delta_bias(m: int, r: float) -> np.ndarray:
    """``query_fc2``'s initial bias: 0 on the mixture weights, 1 on sigma
    and on Delta the value whose softplus is about ``r``."""
    bias = {1: 0.5413, 2: 1.8545, 4: 3.9815}.get(int(r) if r >= 1 else -1, -0.432)
    b = np.zeros(3 * m, np.float32)
    b[m : 2 * m] = 1.0
    b[2 * m :] = bias
    return b


class MOLAttention(nn.Module):
    """Discretized mixture-of-logistics location-relative attention.
    Stateless: the caller carries ``mu_prev``. In training mode its mixture
    logits take dropout 0.5."""

    def __init__(self, query_dim: int, m: int = 5, r: float = 0.5):
        super().__init__()
        self.m = m
        self.query_fc1 = Dense(query_dim, 256)
        self.query_fc2 = Dense(256, 3 * m)
        with torch.no_grad():
            self.query_fc2.bias.copy_(torch.from_numpy(delta_bias(m, r)))

    def forward(self, query, memory, mu_prev, mask=None, generator=None, keep=None):
        m = self.m
        params = self.query_fc2(torch.relu(self.query_fc1(query)))
        w_hat, sigma_hat, delta_hat = params[:, :m], params[:, m : 2 * m], params[:, 2 * m :]
        if self.training:
            w_hat = dropout(w_hat, 0.5, generator, keep)
        eps = 1e-5
        w = torch.softmax(w_hat, dim=-1) + eps
        sigma = F.softplus(sigma_hat) + eps
        mu_cur = mu_prev + F.softplus(delta_hat)
        j = torch.arange(memory.shape[1] + 1, device=memory.device,
                         dtype=mu_cur.dtype)[None, None, :] + 0.5       # (1, 1, T+1)
        # the reference's CDF, kept as it is: 1/(1+sigmoid((mu-j)/sigma))
        phi = w[..., None] * (1.0 / (1.0 + torch.sigmoid(
            (mu_cur[..., None] - j) / sigma[..., None])))
        alpha = phi.sum(dim=1)                                           # (B, T+1)
        alpha = alpha[:, 1:] - alpha[:, :-1]                             # (B, T)
        alpha = torch.where(alpha == 0, torch.full_like(alpha, eps), alpha)
        if mask is not None:
            alpha = alpha * mask
        context = torch.einsum("bt,btd->bd", *promote(alpha, memory))
        return context, alpha, mu_cur


Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], tuple, torch.Tensor, torch.Tensor]


class MolDecoderCell(nn.Module):
    """One decode step: prenet → attention LSTM → MOL attention → decoder
    LSTM(s) → (context concatenated) → r mel frames and a stop logit."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        self.prenet = DecoderPrenet(c.num_mels, c.prenet_dims,
                                    c.get("prenet_always_dropout", True))
        self.attention_rnn = LSTMCell(c.prenet_dims[-1] + c.encoder_dim, c.attention_rnn_dim)
        down = int(np.prod(c.encoder_downsample_rates))
        self.attention_layer = MOLAttention(c.attention_rnn_dim, c.num_mixtures,
                                            c.frames_per_step / down)
        for i in range(c.num_decoder_rnn_layer):
            d_in = c.attention_rnn_dim + c.encoder_dim if i == 0 else c.decoder_rnn_dim
            self.add_module(f"decoder_rnn_{i}", LSTMCell(d_in, c.decoder_rnn_dim))
        out_in = c.decoder_rnn_dim + (c.encoder_dim if c.concat_context_to_last else 0)
        self.linear_projection = Dense(out_in, c.num_mels * c.frames_per_step)
        self.stop_layer = Dense(out_in, 1)

    def forward(self, memory, mem_mask, carry: Carry, prev_frame,
                generator: Optional[torch.Generator] = None, masks: Optional[Dict] = None):
        attn_state, dec_states, context, mu_prev = carry
        masks = masks or {}
        pre = self.prenet(prev_frame, generator, masks.get("prenet"))
        attn_state = self.attention_rnn(attn_state, torch.cat(promote(pre, context), dim=-1))
        attn_h = attn_state[1]
        context, alpha, mu_prev = self.attention_layer(attn_h, memory, mu_prev, mem_mask,
                                                       generator, masks.get("attention"))
        x = torch.cat([attn_h, context], dim=-1)
        new_dec = []
        for i, st in enumerate(dec_states):
            st = getattr(self, f"decoder_rnn_{i}")(st, x)
            new_dec.append(st)
            x = st[1]
        if self.cfg.concat_context_to_last:
            x = torch.cat([x, context], dim=-1)
        mel = self.linear_projection(x)                                  # (B, M·r)
        stop = self.stop_layer(x)[:, 0]
        return (attn_state, tuple(new_dec), context, mu_prev), (mel, stop, alpha)

    def init_carry(self, batch: int, enc_dim: int, device) -> Carry:
        c = self.cfg

        def z(d):
            return torch.zeros(batch, d, device=device)
        attn_state = (z(c.attention_rnn_dim), z(c.attention_rnn_dim))
        dec_states = tuple((z(c.decoder_rnn_dim), z(c.decoder_rnn_dim))
                           for _ in range(c.num_decoder_rnn_layer))
        return attn_state, dec_states, z(enc_dim), z(c.num_mixtures)


class Postnet(nn.Module):
    """4 × (conv 512, k5 SAME + BatchNorm + tanh), then conv num_mels k5 +
    BatchNorm; in training mode each layer followed by dropout 0.5. The
    BatchNorms are flax's, over the channel axis of (B, T, C)."""

    def __init__(self, num_mels: int = 80, hidden: int = 512, layers: int = 5,
                 kernel: int = 5):
        super().__init__()
        self.n = layers - 1
        for i in range(self.n):
            self.add_module(f"conv_{i}", Conv1d(num_mels if i == 0 else hidden, hidden, kernel))
            self.add_module(f"bn_{i}", FlaxBatchNorm(hidden))
        self.conv_out = Conv1d(hidden, num_mels, kernel)
        self.bn_out = FlaxBatchNorm(num_mels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keeps: Optional[list] = None) -> torch.Tensor:
        def drop(y, i):
            if not self.training:
                return y
            return dropout(y, 0.5, generator, None if keeps is None else keeps[i])

        def bn(module, y):
            return module(y.transpose(1, 2)).transpose(1, 2)

        for i in range(self.n):
            x = drop(torch.tanh(bn(getattr(self, f"bn_{i}"), getattr(self, f"conv_{i}")(x))), i)
        return drop(bn(self.bn_out, self.conv_out(x)), self.n)


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Non-affine instance norm per channel over the whole (padded) time
    axis, as the JAX package takes it."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class DownsampleConvStack(nn.Module):
    """1×1 bias-free conv + convs of kernel 2r, stride r, pads (r//2, r//2),
    each with leaky relu 0.1 and instance norm: (B, T, C) → (B, T/Πr, D)."""

    def __init__(self, in_dim: int, encoder_dim: int, rates):
        super().__init__()
        self.n = len(rates)
        self.conv_in = Conv1d(in_dim, encoder_dim, 1, bias=False)
        for i, r in enumerate(rates):
            self.add_module(f"down_{i}", Conv1d(encoder_dim, encoder_dim, 2 * r, stride=r,
                                                padding=(r // 2, r // 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _instance_norm(F.leaky_relu(self.conv_in(x), 0.1))
        for i in range(self.n):
            x = _instance_norm(F.leaky_relu(getattr(self, f"down_{i}")(x), 0.1))
        return x


class MelDecoderMOLv2(nn.Module):
    """The whole PPG→mel model."""

    def __init__(self, cfg):
        super().__init__()
        c = self.cfg = cfg
        rates = list(c.encoder_downsample_rates)
        self.bnf_prenet = DownsampleConvStack(c.bottle_neck_feature_dim, c.encoder_dim, rates)
        self.pitch_convs = DownsampleConvStack(c.pitch_dim, c.encoder_dim, rates)
        self.reduce_proj = Dense(c.encoder_dim + c.spk_embed_dim, c.encoder_dim)
        self.decoder = MolDecoderCell(c)
        self.postnet = Postnet(c.num_mels)

    def encode_inputs(self, bnf, logf0_uv, spembs) -> torch.Tensor:
        """(B, T, bnf) PPGs + (B, T, 2) lf0/uv + (B, spk) d-vectors → the
        (B, T/4, encoder_dim) memory."""
        x = self.bnf_prenet(bnf) + self.pitch_convs(logf0_uv)
        spk = spembs / (torch.linalg.norm(spembs, dim=-1, keepdim=True) + 1e-8)
        spk = spk[:, None, :].expand(x.shape[0], x.shape[1], spk.shape[-1])
        return self.reduce_proj(torch.cat([x, spk], dim=-1))

    def forward(self, bnf, feature_lengths, speech, speech_lengths, logf0_uv, spembs,
                generator: Optional[torch.Generator] = None, masks: Optional[Dict] = None):
        """Teacher-forced forward. speech (B, T_mel, M) → (mel, mel after
        the postnet, both masked to ``speech_lengths``; stop logits repeated
        r times; alignments (B, steps, T_mem)). The decoder is a Python loop
        over ``decode_step``, every draw from ``generator``. ``masks``
        hands in the keep masks: ``{"prenet": [(B, d_i)], "attention":
        (B, M), "postnet": [(B, T_mel, C_i)]}``, each used at every step."""
        c = self.cfg
        memory = self.encode_inputs(bnf, logf0_uv, spembs)
        down = int(np.prod(c.encoder_downsample_rates))
        mem_mask = sequence_mask(feature_lengths // down, memory.shape[1])
        b, t_mel, m = speech.shape
        r = c.frames_per_step
        steps = t_mel // r
        # the input at step s is frame s·r - 1 (zeros at step 0)
        dec_in = torch.cat([speech.new_zeros(b, 1, m), speech[:, r - 1 :: r][:, : steps - 1]],
                           dim=1)
        carry = self.init_carry(b, speech.device)
        mels, stops, aligns = [], [], []
        for s in range(steps):
            carry, (mel, stop, alpha) = self.decoder(memory, mem_mask, carry, dec_in[:, s],
                                                     generator, masks)
            mels.append(mel)
            stops.append(stop)
            aligns.append(alpha)
        mel_out = torch.stack(mels, dim=1).reshape(b, steps * r, m)
        stop_out = torch.stack(stops, dim=1).repeat_interleave(r, dim=1)
        mel_post = self.postnet_apply(mel_out, generator, (masks or {}).get("postnet"))
        out_mask = sequence_mask(speech_lengths, t_mel)[..., None]
        return mel_out * out_mask, mel_post * out_mask, stop_out, torch.stack(aligns, dim=1)

    def decode_step(self, memory, mem_mask, carry, prev_frame, generator=None):
        return self.decoder(memory, mem_mask, carry, prev_frame, generator)

    def postnet_apply(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None,
                      keeps: Optional[list] = None) -> torch.Tensor:
        return mel + self.postnet(mel, generator, keeps)

    def init_carry(self, batch: int, device) -> Carry:
        return self.decoder.init_carry(batch, self.cfg.encoder_dim, device)
