"""Plain Tacotron (SV2TTS synthesizer) inference.

Encoder: character embedding → PreNet (two dense+ReLU layers, each followed
by dropout that stays on at inference) → CBHG (a bank of K convolutions of
widths 1..K, each ReLU then BatchNorm; max-pool 2; two projection
convolutions; residual; highway layers; a bidirectional GRU). The speaker
embedding and the style embedding of global style token ``style_idx``
(``W_value(tanh(token))``, the attention collapsed on a zero query) are
concatenated to every position and projected for the attention.

Decoder, one step per ``r`` frames: PreNet of the previous frame → attention
GRU over [context, PreNet] → location-sensitive attention (a 31-tap
convolution of the cumulative weights, additive scoring, -1e9 on padded
positions, softmax) → context → dense → two residual LSTMs → a projection to
``r`` frames of ``n_mels``.

Dropout masks come from a ``torch.Generator`` seeded by the caller, drawn in
the order the program draws them: the encoder PreNet's two (B, T, d) masks,
then two (B, d) masks per decoder step; a unit is kept where the uniform
draw is at least p.

``decode`` runs free (each step fed its own last frame) or teacher-forced on
given frames (each step fed the given frame ``t·r − 1``), which is how the
check follows the program's decode from the program's own output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .ops import Prec, batch_norm, conv1d, gru_cell, linear, lstm_cell


class Tacotron:
    def __init__(self, w: dict, cfg: dict, p: Prec):
        self.w, self.c, self.p = w, cfg, p

    def _dropout(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.c["dropout"]
        return torch.where(keep, x / (1.0 - self.c["dropout"]), torch.zeros_like(x))

    def _prenet(self, key: str, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        p, w = self.p, self.w
        for fc in ("fc1", "fc2"):
            x = torch.relu(linear(p, x, w[f"params/{key}/{fc}/kernel"], w[f"params/{key}/{fc}/bias"]))
            x = self._dropout(x, gen)
        return x

    def _gru_seq(self, key: str, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        h = x.new_zeros(x.shape[0], self.w[f"{key}/hr/kernel"].shape[0])
        order = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
        outs = [None] * x.shape[1]
        for t in order:
            h = gru_cell(self.p, self.w, key, x[:, t], h)
            outs[t] = h
        return torch.stack(outs, dim=1)

    def _cbhg(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, T, channels)."""
        p, w, c = self.p, self.w, self.c
        t_len = x.shape[1]
        xc = x.transpose(1, 2)
        bank = []
        for k in range(1, c["encoder_K"] + 1):
            y = conv1d(p, xc, w[f"params/{key}/bank_{k}/conv/kernel"], pad=(k // 2, k // 2))
            bank.append(batch_norm(p, torch.relu(y[:, :, :t_len]), w, f"{key}/bank_{k}/bnorm"))
        y = F.max_pool1d(torch.cat(bank, dim=1), 2, stride=1, padding=1)[:, :, :t_len]
        y = torch.relu(conv1d(p, y, w[f"params/{key}/conv_project1/conv/kernel"], pad=(1, 1)))
        y = batch_norm(p, y, w, f"{key}/conv_project1/bnorm")
        y = conv1d(p, y, w[f"params/{key}/conv_project2/conv/kernel"], pad=(1, 1))
        y = batch_norm(p, y, w, f"{key}/conv_project2/bnorm").transpose(1, 2) + x
        if f"params/{key}/pre_highway/kernel" in w:
            y = linear(p, y, w[f"params/{key}/pre_highway/kernel"])
        for i in range(c["num_highways"]):
            hw = f"params/{key}/highway_{i}"
            g = torch.sigmoid(linear(p, y, w[f"{hw}/W2/kernel"], w[f"{hw}/W2/bias"]))
            y = g * torch.relu(linear(p, y, w[f"{hw}/W1/kernel"], w[f"{hw}/W1/bias"])) + (1.0 - g) * y
        return torch.cat([self._gru_seq(f"params/{key}/gru_fwd", y, False),
                          self._gru_seq(f"params/{key}/gru_bwd", y, True)], dim=-1)

    def encode(self, ids: torch.Tensor, spk: torch.Tensor, gen: torch.Generator,
               style_idx: int = 0):
        """ids (B, T) (0 = padding), spk (B, 256) → (memory (B, T, P),
        its attention projection (B, T, D), mask (B, T) bool)."""
        p, w = self.p, self.w
        b, t_len = ids.shape
        x = p.t(w["params/encoder/embedding/embedding"])[ids]
        x = self._cbhg("encoder/cbhg", self._prenet("encoder/pre_net", x, gen))
        style = linear(p, torch.tanh(p.t(w["params/gst/stl/embed"][style_idx])),
                       w["params/gst/stl/W_value/kernel"])
        memory = torch.cat([x, p.t(spk)[:, None, :].expand(b, t_len, spk.shape[-1]),
                            style.expand(b, t_len, style.shape[-1])], dim=-1)
        return memory, linear(p, memory, w["params/encoder_proj/kernel"]), ids != 0

    def decode(self, memory, memory_proj, mask, n_groups: int, r: int, gen: torch.Generator,
               teacher: Optional[torch.Tensor] = None) -> torch.Tensor:
        """→ frames (B, n_groups·r, n_mels). ``teacher`` (B, ≥ n_groups·r,
        n_mels) feeds frame t·r − 1 to step t in place of the decoder's own."""
        p, w, c = self.p, self.w, self.c
        b, t_len, _ = memory.shape
        m, lstm = c["n_mels"], c["lstm_dims"]
        dec = "params/decoder"
        zeros = memory.new_zeros
        h_att = zeros(b, c["decoder_dims"])
        s1 = (zeros(b, lstm), zeros(b, lstm))
        s2 = (zeros(b, lstm), zeros(b, lstm))
        context = zeros(b, memory.shape[-1])
        cumulative = zeros(b, t_len)
        prev = zeros(b, m)
        loc_kernel = w[f"{dec}/attn_net/conv/kernel"]
        frames = []
        for t in range(n_groups):
            if teacher is not None and t > 0:
                prev = p.t(teacher[:, t * r - 1])
            pre = self._prenet("decoder/prenet", prev, gen)
            h_att = gru_cell(p, w, f"{dec}/attn_rnn", torch.cat([context, pre], dim=-1), h_att)
            loc = conv1d(p, cumulative[:, None, :], loc_kernel, w[f"{dec}/attn_net/conv/bias"],
                         pad=(15, 15)).transpose(1, 2)
            energy = torch.tanh(linear(p, h_att, w[f"{dec}/attn_net/W/kernel"],
                                       w[f"{dec}/attn_net/W/bias"])[:, None, :]
                                + memory_proj + linear(p, loc, w[f"{dec}/attn_net/L/kernel"]))
            score = linear(p, energy, w[f"{dec}/attn_net/v/kernel"])[..., 0]
            score = torch.where(mask, score, torch.full_like(score, -1e9))
            align = torch.softmax(score.float(), dim=1).to(p.dtype)
            cumulative = cumulative + align
            context = torch.einsum("bt,btd->bd", align, memory)
            x = linear(p, torch.cat([context, h_att], dim=-1), w[f"{dec}/rnn_input/kernel"],
                       w[f"{dec}/rnn_input/bias"])
            s1 = lstm_cell(p, w, f"{dec}/res_rnn1", x, s1)
            x = x + s1[1]
            s2 = lstm_cell(p, w, f"{dec}/res_rnn2", x, s2)
            x = x + s2[1]
            out = linear(p, x, w[f"{dec}/mel_proj/kernel"]).reshape(b, m, c["max_r"])[:, :, :r]
            out = out.transpose(1, 2)                                       # (B, r, M)
            frames.append(out)
            prev = out[:, -1]
        return torch.cat(frames, dim=1).float()
