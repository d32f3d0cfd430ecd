"""Tacotron SV2TTS synthesizer.

Port of ``mockingbird_tpu/models/tacotron/model.py``: CBHG encoder +
per-char speaker-embedding concat + GST concat + autoregressive decoder with
location-sensitive attention, two residual zoneout LSTMs, reduction factor
r, stop-token head and CBHG postnet. Module I/O is time-major (B, T, C) like
the JAX package; convolutions transpose to PyTorch's (B, C, T) inside.

Two behaviours follow the JAX package and not the original reference:
  * ``LSA`` masks padded text positions additively with -1e9
    (``lsa_mask="additive"``; ``"reference"`` keeps the u·mask quirk);
  * ``PreNet`` keeps dropout on at inference. Its noise comes from an
    explicit ``torch.Generator``; ``prenet_dropout=False`` turns it off.

``Tacotron.forward`` is the teacher-forced training forward in the JAX
package's fused form (``fused_scan``): the PreNet runs over all S steps at
once, the zoneout masks are one (S, 2, B, lstm) draw (or handed in), the
recurrence is ``step_core`` alone, in a Python loop on the device, and the
mel and stop heads run once on the stacked outputs. The JAX package's
legacy unfused path differs only in the order of its random draws and is
not ported. ``remat_decoder`` checkpoints each step
(``torch.utils.checkpoint``); ``scan_unroll`` is a TPU compile knob, taken
and ignored. The module's mode is the switch ``train`` is in the JAX
package: ``model.train()`` turns zoneout on and puts every BatchNorm in
batch-statistics mode (``layers.FlaxBatchNorm``).

Every layer computes in the promoted dtype of its input and its parameters,
as flax does, so that a bf16 policy (``train/precision.py``) casts the
parameters and the float inputs and the float32 carries promote the decoder
back to float32, as they do in the JAX step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ...config import Config
from ...parallel import multihost
from ..layers import (Dense, Dropout, FlaxBatchNorm, FusedGRUCell, GRULayer, LSTMCell,
                      promote, with_bias)


def tacotron_config() -> Config:
    """Model hyperparameters: embed 512, encoder 256, decoder 128, lstm 1024,
    postnet 512, K=5/5, 4 highways, dropout 0.5; GST 10 tokens × 8 heads,
    E=512; reduction r ≤ 20."""
    from ...text import symbols as _symbols
    return Config(
        num_chars=len(_symbols),
        embed_dims=512,
        encoder_dims=256,
        decoder_dims=128,
        n_mels=80,
        fft_bins=80,
        postnet_dims=512,
        encoder_K=5,
        postnet_K=5,
        num_highways=4,
        lstm_dims=1024,
        dropout=0.5,
        speaker_embedding_size=256,
        max_r=20,
        stop_threshold=-3.4,
        lsa_mask="additive",
        remat_decoder=False,
        scan_unroll=4,
        use_gst=True,
        use_ser_for_gst=True,
        gst_E=512,
        gst_token_num=10,
        gst_num_heads=8,
        gst_ref_filters=(32, 32, 64, 64, 128, 128),
    )


def _tc(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) ↔ (B, C, T)."""
    return x.transpose(1, 2)


class HighwayNetwork(nn.Module):
    """y = g·relu(W1 x) + (1-g)·x."""

    def __init__(self, size: int):
        super().__init__()
        self.W1 = Dense(size, size)
        self.W2 = Dense(size, size)

    def forward(self, x):
        g = torch.sigmoid(self.W2(x))
        return g * torch.relu(self.W1(x)) + (1.0 - g) * x


class BatchNormConv(nn.Module):
    """Conv1d (no bias) → (relu) → BatchNorm, the reference's relu-before-BN
    order."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel, bias=False)
        self.bnorm = FlaxBatchNorm(out_channels)
        self.relu = relu

    def forward(self, x):                      # (B, C, T) → (B, C', T')
        x, w = promote(x, self.conv.weight)
        x = F.conv1d(x, w, None, 1, w.shape[-1] // 2)
        return self.bnorm(torch.relu(x) if self.relu else x)


class CBHG(nn.Module):
    """Conv bank (k=1..K) → maxpool(2,1) → 2 conv projections + residual →
    highways → BiGRU. (B, T, C_in) → (B, T, channels)."""

    def __init__(self, K: int, in_channels: int, channels: int,
                 proj_channels: Tuple[int, int], num_highways: int):
        super().__init__()
        self.K, self.num_highways = K, num_highways
        for k in range(1, K + 1):
            self.add_module(f"bank_{k}", BatchNormConv(in_channels, channels, k))
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3)
        self.conv_project2 = BatchNormConv(proj_channels[0], proj_channels[1], 3, relu=False)
        self.pre_highway = (Dense(proj_channels[1], channels, bias=False)
                            if proj_channels[-1] != channels else None)
        for i in range(num_highways):
            self.add_module(f"highway_{i}", HighwayNetwork(channels))
        self.gru_fwd = GRULayer(channels, channels // 2)
        self.gru_bwd = GRULayer(channels, channels // 2, reverse=True)

    def forward(self, x):
        seq_len = x.shape[1]
        residual = x
        xc = _tc(x)
        y = torch.cat([getattr(self, f"bank_{k}")(xc)[:, :, :seq_len]
                       for k in range(1, self.K + 1)], dim=1)
        y = F.max_pool1d(y, 2, stride=1, padding=1)[:, :, :seq_len]
        y = self.conv_project2(self.conv_project1(y))
        y = _tc(y) + residual
        if self.pre_highway is not None:
            y = self.pre_highway(y)
        for i in range(self.num_highways):
            y = getattr(self, f"highway_{i}")(y)
        return torch.cat([self.gru_fwd(y), self.gru_bwd(y)], dim=-1)


class PreNet(nn.Module):
    """Two dense+relu layers with dropout that stays on at inference."""

    def __init__(self, in_dims: int, fc1_dims: int, fc2_dims: int,
                 dropout: float = 0.5, enabled: bool = True):
        super().__init__()
        self.fc1 = Dense(in_dims, fc1_dims)
        self.fc2 = Dense(fc1_dims, fc2_dims)
        self.drop = Dropout(dropout if enabled else 0.0)

    def forward(self, x, generator: Optional[torch.Generator] = None, batch_dim: int = 0):
        x = self.drop(torch.relu(self.fc1(x)), generator, batch_dim=batch_dim)
        return self.drop(torch.relu(self.fc2(x)), generator, batch_dim=batch_dim)


class TacotronEncoder(nn.Module):
    """Char embedding → PreNet → CBHG."""

    def __init__(self, c):
        super().__init__()
        self.embedding = nn.Embedding(c.num_chars, c.embed_dims)
        self.pre_net = PreNet(c.embed_dims, c.encoder_dims, c.encoder_dims, c.dropout,
                              enabled=c.get("prenet_dropout", True))
        self.cbhg = CBHG(c.encoder_K, c.encoder_dims, c.encoder_dims,
                         (c.encoder_dims, c.encoder_dims), c.num_highways)

    def forward(self, texts, generator=None):
        return self.cbhg(self.pre_net(self.embedding(texts), generator))


class ReferenceEncoder(nn.Module):
    """Stride-2 conv2d + BN + relu stack, then GRU → (B, E/2). The input is
    the 256-d speaker embedding viewed as one 'mel' frame."""

    def __init__(self, c):
        super().__init__()
        chans = [1] + list(c.gst_ref_filters)
        self.n = len(c.gst_ref_filters)
        w = c.speaker_embedding_size
        for i in range(self.n):
            self.add_module(f"conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 3))
            self.add_module(f"bn_{i}", FlaxBatchNorm(chans[i + 1]))
            w = (w - 1) // 2 + 1
        self.gru = GRULayer(chans[-1] * w, c.gst_E // 2)

    def forward(self, inputs):
        b, n_feat = inputs.shape[0], inputs.shape[-1]
        x = inputs.reshape(b, 1, -1, n_feat)       # NCHW: (B, 1, T, n_feat)
        for i in range(self.n):
            conv = getattr(self, f"conv_{i}")
            x = with_bias(F.conv2d, *promote(x, conv.weight, conv.bias), 2, 1)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        b, ch, t, w = x.shape
        # channel-major (C, W) flatten, as the reference does
        x = x.permute(0, 2, 1, 3).reshape(b, t, ch * w)
        return self.gru(x)[:, -1, :]


class StyleTokenLayer(nn.Module):
    """Learned tokens attended by the reference encoding (+ speaker embed)
    through multi-head attention."""

    def __init__(self, c):
        super().__init__()
        self.heads = c.gst_num_heads
        d_token = c.gst_E // c.gst_num_heads
        d_query = c.gst_E // 2 + (c.speaker_embedding_size if c.use_ser_for_gst else 0)
        self.embed = nn.Parameter(torch.randn(c.gst_token_num, d_token) * 0.5)
        self.W_query = Dense(d_query, c.gst_E, bias=False)
        self.W_key = Dense(d_token, c.gst_E, bias=False)
        self.W_value = Dense(d_token, c.gst_E, bias=False)

    def forward(self, query_vec):
        """query_vec (B, d_q) → style embed (B, 1, E)."""
        n = query_vec.shape[0]
        keys = torch.tanh(self.embed)[None].expand(n, -1, -1)
        q = self.W_query(query_vec[:, None, :])
        k, v = self.W_key(keys), self.W_value(keys)
        dt = torch.promote_types(q.dtype, k.dtype)
        qs, ks, vs = (torch.stack(x.to(dt).chunk(self.heads, dim=2)) for x in (q, k, v))
        scores = torch.einsum("hbqd,hbkd->hbqk", qs, ks) / (self.embed.shape[-1] ** 0.5)
        out = torch.einsum("hbqk,hbkd->hbqd", torch.softmax(scores, dim=3), vs)
        return torch.cat(list(out), dim=2)

    def token_value(self, style_idx: int):
        """With a zero query the attention collapses to
        W_value(tanh(embed[style_idx])) → (1, 1, E)."""
        return self.W_value(torch.tanh(self.embed)[style_idx][None, None, :])


class GlobalStyleToken(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.use_ser = c.use_ser_for_gst
        self.encoder = ReferenceEncoder(c)
        self.stl = StyleTokenLayer(c)

    def forward(self, inputs, speaker_embedding):
        enc_out = self.encoder(inputs)
        if self.use_ser and speaker_embedding is not None:
            enc_out = torch.cat([enc_out, speaker_embedding], dim=-1)
        return self.stl(enc_out)


class LSA(nn.Module):
    """Location-sensitive attention: conv(31, 32) over the cumulative
    attention, additive scoring, -1e9 on padded text positions.

    As in the JAX package, the location conv and its projection ``L`` run
    as one composed conv (31, 1→attn_dim) with the constant bias L·b_conv:
    one kernel per decoder step instead of two, and the (B, T, 32)
    intermediate never exists; the parameters stay ``conv`` and ``L``. The
    composed kernel is formed in the parameters' dtype, as JAX forms it."""

    def __init__(self, query_dims: int, attn_dim: int, kernel_size: int = 31,
                 filters: int = 32, masking: str = "additive"):
        super().__init__()
        self.W = Dense(query_dims, attn_dim)
        self.conv = nn.Conv1d(1, filters, kernel_size)
        self.L = Dense(filters, attn_dim, bias=False)
        self.v = Dense(attn_dim, 1, bias=False)
        self.masking = masking

    def location_kernel(self):
        """The composed (attn_dim, 1, k) kernel and (attn_dim,) bias, in the
        parameters' dtype."""
        return (torch.einsum("fik,df->dik", self.conv.weight, self.L.weight),
                self.L.weight @ self.conv.bias)

    def forward(self, encoder_seq_proj, query, cumulative, char_mask, loc=None):
        """``loc``: ``location_kernel()`` made once for a whole decode."""
        processed_query = self.W(query)[:, None, :]
        k_eff, b_eff = loc if loc is not None else self.location_kernel()
        pad = (k_eff.shape[-1] - 1) // 2
        processed_loc = _tc(F.conv1d(cumulative[:, None, :], k_eff.to(cumulative.dtype),
                                     None, 1, pad)) + b_eff
        u = self.v(torch.tanh(processed_query + encoder_seq_proj + processed_loc))[..., 0]
        if self.masking == "reference":
            u = u * char_mask
        else:
            u = torch.where(char_mask > 0, u, torch.full_like(u, -1e9))
        return torch.softmax(u, dim=1)


class TacotronDecoderCell(nn.Module):
    """One decoder step: PreNet → attention GRU → LSA → context → 2 LSTMs
    with residuals (zoneout in training) → r mel frames + stop token."""

    def __init__(self, c, project_dims: int):
        super().__init__()
        self.c = c
        self.prenet = PreNet(c.n_mels, c.decoder_dims * 2, c.decoder_dims * 2, c.dropout,
                             enabled=c.get("prenet_dropout", True))
        self.attn_net = LSA(c.decoder_dims, c.decoder_dims, masking=c.get("lsa_mask", "additive"))
        self.attn_rnn = FusedGRUCell(project_dims + c.decoder_dims * 2, c.decoder_dims)
        self.rnn_input = Dense(project_dims + c.decoder_dims, c.lstm_dims)
        self.res_rnn1 = LSTMCell(c.lstm_dims, c.lstm_dims)
        self.res_rnn2 = LSTMCell(c.lstm_dims, c.lstm_dims)
        self.mel_proj = Dense(c.lstm_dims, c.n_mels * c.max_r, bias=False)
        self.stop_proj = Dense(c.lstm_dims + project_dims, 1)

    def step_core(self, encoder_seq, encoder_seq_proj, char_mask, carry, prenet_out,
                  zo_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, loc=None):
        """The recurrence of one step, everything that depends on the carry.
        ``zo_masks`` (m1, m2), boolean (B, lstm): zoneout keeps the previous
        hidden state where a mask is set (training); None: no zoneout.
        ``loc``: the LSA's composed location kernel, made once per decode.
        Returns (carry, (x, context_vec, scores)); ``x`` feeds the heads."""
        attn_hidden, rnn1_state, rnn2_state, context_vec, cumulative = carry
        attn_hidden = self.attn_rnn(attn_hidden, torch.cat([context_vec, prenet_out], dim=-1))

        scores = self.attn_net(encoder_seq_proj, attn_hidden, cumulative, char_mask, loc)
        cumulative = cumulative + scores
        context_vec = torch.einsum("bt,btd->bd", *promote(scores, encoder_seq))

        x = self.rnn_input(torch.cat([context_vec, attn_hidden], dim=1))
        states = []
        for i, (cell, state) in enumerate(((self.res_rnn1, rnn1_state),
                                           (self.res_rnn2, rnn2_state))):
            c_next, h_next = cell(state, x)
            if zo_masks is not None:
                h_next = torch.where(zo_masks[i], state[1], h_next)
            states.append((c_next, h_next))
            x = x + h_next
        carry = (attn_hidden, states[0], states[1], context_vec, cumulative)
        return carry, (x, context_vec, scores)

    def project_out(self, x, context_vec, r: int):
        """mel/stop heads over decoder output ``x`` (..., lstm): per step
        (B, lstm) or stacked over all steps (S, B, lstm) → mels (..., r, M),
        stop (...)."""
        c = self.c
        lead = x.shape[:-1]
        mels = self.mel_proj(x).reshape(*lead, c.n_mels, c.max_r)[..., :r].transpose(-1, -2)
        stop = torch.sigmoid(self.stop_proj(torch.cat([x, context_vec], dim=-1)))[..., 0]
        return mels, stop

    def step(self, encoder_seq, encoder_seq_proj, char_mask, carry, prenet_in,
             r: int, generator=None):
        """One generation step (no zoneout)."""
        prenet_out = self.prenet(prenet_in, generator)
        carry, (x, context_vec, scores) = self.step_core(
            encoder_seq, encoder_seq_proj, char_mask, carry, prenet_out)
        mels, stop = self.project_out(x, context_vec, r)
        return carry, (mels, scores, stop)

    def forward(self, encoder_seq, encoder_seq_proj, char_mask, carry, prenet_outs,
                zo_masks: Optional[torch.Tensor], loc, remat: bool = False):
        """The teacher-forced recurrence: ``step_core`` over the S PreNet
        outputs (S, B, P), with zoneout masks (S, 2, B, lstm) or None; with
        ``remat`` each step is recomputed in the backward pass. → the
        stacked (x, context_vec, scores) of all steps."""
        step = self.step_core
        if remat:
            def step(*args):
                return checkpoint(self.step_core, *args, use_reentrant=False)
        xs, contexts, scores = [], [], []
        for s in range(prenet_outs.shape[0]):
            masks = (zo_masks[s, 0], zo_masks[s, 1]) if zo_masks is not None else None
            carry, (x, ctx, sc) = step(encoder_seq, encoder_seq_proj, char_mask, carry,
                                       prenet_outs[s], masks, loc)
            xs.append(x)
            contexts.append(ctx)
            scores.append(sc)
        return torch.stack(xs), torch.stack(contexts), torch.stack(scores)


class Tacotron(nn.Module):
    """Full model: the teacher-forced ``forward`` and the inference methods
    (``encode``, ``decode_step``, ``postnet_apply``, ``init_carry``)."""

    def __init__(self, c):
        super().__init__()
        self.cfg = c
        self.project_dims = (c.encoder_dims + c.speaker_embedding_size
                             + (c.gst_E if c.use_gst else 0))
        self.encoder = TacotronEncoder(c)
        self.encoder_proj = Dense(self.project_dims, c.decoder_dims, bias=False)
        self.gst = GlobalStyleToken(c) if c.use_gst else None
        self.decoder = TacotronDecoderCell(c, self.project_dims)
        self.postnet = CBHG(c.postnet_K, c.n_mels, c.postnet_dims,
                            (c.postnet_dims, c.fft_bins), c.num_highways)
        self.post_proj = Dense(c.postnet_dims, c.fft_bins, bias=False)

    def encode(self, texts, speaker_embedding, style_idx: int = 0,
               style_mode: str = "token", generator=None):
        """→ (encoder_seq (B,T,P), encoder_seq_proj (B,T,D), char_mask (B,T)).

        style_mode: 'train' — GST on the speaker embedding; 'token' — GST
        token ``style_idx``; 'neutral' — zero reference input."""
        c = self.cfg
        b, t = texts.shape
        enc = self.encoder(texts, generator)
        spk = speaker_embedding[:, None, :].expand(b, t, c.speaker_embedding_size)
        parts = [enc, spk]
        if self.gst is not None:
            if style_mode == "train":
                style = self.gst(speaker_embedding, speaker_embedding)
            elif style_mode == "token":
                style = self.gst.stl.token_value(style_idx).expand(b, 1, c.gst_E)
            else:
                zeros = speaker_embedding.new_zeros((b, 1, c.speaker_embedding_size))
                style = self.gst(zeros, speaker_embedding)
            parts.append(style[:, :1, :].expand(b, t, c.gst_E))
        encoder_seq = torch.cat(parts, dim=-1)
        char_mask = (texts != 0).to(encoder_seq.dtype)
        return encoder_seq, self.encoder_proj(encoder_seq), char_mask

    def forward(self, texts, mels, speaker_embedding, r: int,
                generator: Optional[torch.Generator] = None,
                zo_masks: Optional[torch.Tensor] = None):
        """Teacher-forced forward. texts (B, T_text) int; mels (B, T_mel, M)
        with T_mel % r == 0; ``generator`` draws the PreNet dropout (off
        without one) and, in training mode, the zoneout masks unless
        ``zo_masks`` (S, 2, B, lstm) bool hands them in.

        Returns (mel_out (B, T_mel, M), postnet_out (B, T_mel, fft_bins),
        attn (B, S, T_text), stop (B, T_mel))."""
        c = self.cfg
        b, t_mel, m = mels.shape
        if t_mel % r:
            raise ValueError(f"mel length {t_mel} not divisible by r={r}")
        steps = t_mel // r
        dev = mels.device

        encoder_seq, encoder_seq_proj, char_mask = self.encode(
            texts, speaker_embedding, style_mode="train", generator=generator)

        # prenet input at group s is mel frame s*r - 1; the go frame is
        # float32, as in the JAX package, and promotes the decoder
        go_frame = torch.zeros((b, 1, m), device=dev)
        prenet_ins = torch.cat([go_frame, mels[:, r - 1::r, :][:, : steps - 1]], dim=1)
        prenet_outs = self.decoder.prenet(prenet_ins.transpose(0, 1), generator,
                                          batch_dim=1)                        # (S, B, P)
        if not self.training:
            zo_masks = None
        elif zo_masks is None:
            zo_masks = multihost.rand((steps, 2, b, c.lstm_dims), generator, dev,
                                      batch_dim=2) < 0.1

        # the float32 carries promote every product of the recurrence to
        # float32: under a bf16 policy the decoder's weights (and the LSA's
        # composed kernel, formed in bf16 as JAX forms it) are cast once
        # here, not once per step (XLA hoists the same converts out of the
        # scan), so the backward keeps one float32 copy, not S
        loc = tuple(t.float() for t in self.decoder.attn_net.location_kernel())
        loop_args = (encoder_seq, encoder_seq_proj, char_mask,
                     self.init_carry(b, texts.shape[1], dev), prenet_outs, zo_masks, loc,
                     self.training and c.get("remat_decoder", False))
        params = dict(self.decoder.named_parameters())
        if any(p.dtype != torch.float32 for p in params.values()):
            xs, contexts, scores = functional_call(
                self.decoder, {k: p.float() for k, p in params.items()}, loop_args)
        else:
            xs, contexts, scores = self.decoder(*loop_args)
        mel_groups, stops = self.decoder.project_out(xs, contexts, r)

        mel_out = mel_groups.transpose(0, 1).reshape(b, steps * r, m)
        attn = scores.transpose(0, 1)
        stop_out = stops.transpose(0, 1).repeat_interleave(r, dim=1)
        return mel_out, self.postnet_apply(mel_out), attn, stop_out

    def decode_step(self, encoder_seq, encoder_seq_proj, char_mask, carry, prenet_in,
                    r: int, generator=None):
        return self.decoder.step(encoder_seq, encoder_seq_proj, char_mask, carry, prenet_in,
                                 r, generator)

    def postnet_apply(self, mel_out):
        return self.post_proj(self.postnet(mel_out))

    def init_carry(self, batch: int, t_text: int, device=None):
        c = self.cfg

        def z(*s):
            return torch.zeros(s, device=device)
        return (z(batch, c.decoder_dims),
                (z(batch, c.lstm_dims), z(batch, c.lstm_dims)),
                (z(batch, c.lstm_dims), z(batch, c.lstm_dims)),
                z(batch, self.project_dims),
                z(batch, t_text))
