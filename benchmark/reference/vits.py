"""Plain VITS inference (Kim et al. 2021, arXiv:2106.06103, as MockingBird's
``models/synthesizer/models/vits.py`` runs it): token ids, a speaker id and
an emotion vector → log-durations, durations, the waveform.

* Text encoder: the token embedding scaled by √hidden, plus the emotion
  projection (a dense layer of the emotion vector, MockingBird's addition),
  then ``n_layers`` blocks of multi-head self-attention with relative
  positions in a window of ±4 (learnt key and value embeddings per offset;
  no term beyond the window) and a two-convolution ReLU feed-forward
  (kernel 3), each with a residual and a LayerNorm over channels; a 1×1
  projection to the prior's mean and log-scale. Padded symbols are masked.
* Duration predictor, run backwards from noise (the stochastic one): the
  encoder's output (gradient-free) through a 1×1 convolution plus the
  speaker's, a dilated depth-separable convolution stack (DDS, 3 layers,
  kernel 3, dilations 1, 3, 9, each with LayerNorm and exact GELU twice),
  a 1×1 projection; the noise ``noise_scale_w``·N(0, 1) of two channels
  then goes backwards through channel flips and neural-spline coupling
  flows (rational-quadratic, 10 bins, tails ±5 linear) conditioned on it,
  and through an element-wise affine; channel 0 is the log-duration.
  Departure kept from the code the system follows: of the four spline
  flows the last in reverse order (the first forwards) is dropped, as
  MockingBird's and the published code's "remove a useless vflow" does.
* Durations ⌈exp(logw)⌉ (masked; ``length_scale`` 1) — or handed in, to
  teacher-force the rest on another run's durations; the frame count is
  their sum, at least 1 and at most ``max_frames``. Each symbol's prior
  mean and log-scale repeat for its frames (``repeat_interleave``), frames
  past the count are zero.
* The prior sample m + noise·e^logs·``noise_scale``, then four mean-only
  affine coupling flows backwards (each a channel flip then a coupling
  whose conditioner is a 4-layer WaveNet of kernel 5 with the speaker
  added per layer, weight-normed convolutions), masked to the frame count.
* Decoder: HiFi-GAN's (``reference/hifigan.py``'s weight-normed
  convolutions, transposed-convolution upsampling and ResBlock1 stacks)
  after ``conv_pre`` (7 taps) plus the speaker's 1×1 ``cond``, both plain
  convolutions with biases; leaky ReLU 0.01, ``conv_post`` (7 taps, no
  bias, plain), tanh; over all ``max_frames`` frames.

Layout: flax's (``reference/layout.py``) under ``params/{enc_p, dp, flow,
dec, emb_g}``. Computed channels-first at a stated precision
(``reference/ops.py``): float32 with TF32 off (``no_tf32``, set while a
``Vits`` is built), or bfloat16 for the control. Imports nothing of the
system under test.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import hifigan
from .ops import Prec, conv1d, no_tf32

TAIL = 5.0
MIN_BIN = 1e-3
MIN_DERIVATIVE = 1e-3
WINDOW = 4


def _spline_inverse(x: torch.Tensor, uw: torch.Tensor, uh: torch.Tensor,
                    ud: torch.Tensor) -> torch.Tensor:
    """The inverse of the monotonic rational-quadratic spline (Durkan et
    al. 2019) on [−TAIL, TAIL], identity outside; ``x`` (...), the bin
    parameters (..., bins) and derivatives (..., bins − 1)."""
    bins = uw.shape[-1]

    def knots(u):
        size = MIN_BIN + (1 - MIN_BIN * bins) * torch.softmax(u, dim=-1)
        pos = F.pad(torch.cumsum(size, dim=-1), (1, 0))
        pos = 2 * TAIL * pos - TAIL
        pos = torch.cat([torch.full_like(pos[..., :1], -TAIL), pos[..., 1:-1],
                         torch.full_like(pos[..., :1], TAIL)], dim=-1)
        return pos, pos[..., 1:] - pos[..., :-1]

    xw, w = knots(uw)
    yh, h = knots(uh)
    edge = math.log(math.exp(1 - MIN_DERIVATIVE) - 1)
    d = MIN_DERIVATIVE + F.softplus(F.pad(ud, (1, 1), value=edge))
    inside = (x >= -TAIL) & (x <= TAIL)
    xc = x.clamp(-TAIL, TAIL)
    search = yh.clone()
    search[..., -1] += 1e-6
    k = (torch.sum(xc[..., None] >= search, dim=-1) - 1).clamp(0, bins - 1)[..., None]

    def at(t):
        return t.gather(-1, k)[..., 0]

    x0, wk, y0, hk = at(xw[..., :-1]), at(w), at(yh[..., :-1]), at(h)
    delta, d0, d1 = at(h / w), at(d[..., :-1]), at(d[..., 1:])
    s = d0 + d1 - 2 * delta
    a = (xc - y0) * s + hk * (delta - d0)
    b = hk * d0 - (xc - y0) * s
    c = -delta * (xc - y0)
    root = (2 * c) / (-b - torch.sqrt((b * b - 4 * a * c).clamp(min=0)))
    return torch.where(inside, root * wk + x0, x)


class Vits:
    """The reference network on weights ``w`` ({key: tensor}, as
    ``harness/weights.read`` gives them) and the model part of the
    configuration ``cfg``, computing at precision ``p``."""

    def __init__(self, w: dict, cfg: dict, p: Prec):
        no_tf32()
        self.w, self.c, self.p = w, cfg, p

    # -- operations --------------------------------------------------------

    def _conv(self, key: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """A plain convolution ``params/<key>`` with SAME padding."""
        k = self.w[f"params/{key}/kernel"]
        half = (k.shape[0] - 1) // 2
        b = self.w[f"params/{key}/bias"] if bias else None
        return conv1d(self.p, x, k, b, pad=(half, half))

    def _depthwise(self, key: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
        k = self.p.weight(self.w[f"params/{key}/kernel"]).permute(2, 1, 0)   # (C, 1, taps)
        half = dilation * (k.shape[-1] - 1) // 2
        y = F.conv1d(F.pad(self.p.operand(x), (half, half)), k, None, 1, 0, dilation,
                     groups=k.shape[0])
        return y + self.p.weight(self.w[f"params/{key}/bias"], False)[None, :, None]

    def _norm(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """LayerNorm over the channels of (B, C, T)."""
        y = F.layer_norm(x.transpose(1, 2), (x.shape[1],),
                         self.p.weight(self.w[f"params/{key}/scale"], False),
                         self.p.weight(self.w[f"params/{key}/bias"], False), 1e-5)
        return y.transpose(1, 2)

    def _wn_conv(self, name: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        """A weight-normed convolution (``reference/hifigan.py``'s)."""
        return hifigan._conv(self.p, self.w, name, x, dilation)

    # -- text encoder -------------------------------------------------------

    def _attention(self, key: str, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c, p = self.c, self.p
        heads = c["n_heads"]
        b, ch, t = x.shape
        d = ch // heads

        def split(u):                                       # (B, C, T) → (B, H, T, d)
            return u.reshape(b, heads, d, t).transpose(2, 3)

        q = split(self._conv(f"{key}/conv_q", x)) / math.sqrt(d)
        k = split(self._conv(f"{key}/conv_k", x))
        v = split(self._conv(f"{key}/conv_v", x))
        # one[t, s, j] = 1 where key s lies at offset j − WINDOW from query t
        offset = torch.arange(t, device=x.device)[None, :] - torch.arange(t, device=x.device)[:, None]
        one = p.t(F.one_hot((offset + WINDOW).clamp(0, 2 * WINDOW), 2 * WINDOW + 1).float()
                  * (offset.abs() <= WINDOW)[..., None].float())
        rel_k = p.weight(self.w[f"params/{key}/emb_rel_k"])[0]          # (2w+1, d)
        rel_v = p.weight(self.w[f"params/{key}/emb_rel_v"])[0]
        scores = q @ k.transpose(2, 3) + torch.einsum("bhtj,tsj->bhts", q @ rel_k.T, one)
        pair = mask[:, None, :, None] * mask[:, None, None, :]
        scores = torch.where(pair == 0, torch.full_like(scores, -1e4), scores)
        attn = torch.softmax(scores, dim=-1)
        out = attn @ v + torch.einsum("bhts,tsj->bhtj", attn, one) @ rel_v
        return self._conv(f"{key}/conv_o", out.transpose(2, 3).reshape(b, ch, t))

    def encode(self, ids: torch.Tensor, lengths: torch.Tensor, emo: torch.Tensor):
        """ids (B, T), lengths (B,), emo (B, E) → (hidden, m_p, logs_p)
        each (B, C, T), and the mask (B, T)."""
        c, p = self.c, self.p
        t = ids.shape[1]
        mask = p.t((torch.arange(t, device=ids.device)[None] < lengths[:, None]).float())
        h = p.weight(self.w["params/enc_p/emb/embedding"], False)[ids] * math.sqrt(c["hidden_channels"])
        emo_kernel = self.w["params/enc_p/emo_proj/kernel"]
        h = h + (p.operand(p.t(emo)) @ p.weight(emo_kernel)
                 + p.weight(self.w["params/enc_p/emo_proj/bias"], False))[:, None, :]
        x = h.transpose(1, 2) * mask[:, None]
        key = "enc_p/encoder"
        for i in range(c["n_layers"]):
            y = self._attention(f"{key}/attn_{i}", x, mask)
            x = self._norm(f"{key}/norm1_{i}", x + y)
            y = torch.relu(self._conv(f"{key}/ffn_{i}/conv_1", x * mask[:, None]))
            y = self._conv(f"{key}/ffn_{i}/conv_2", y * mask[:, None]) * mask[:, None]
            x = self._norm(f"{key}/norm2_{i}", x + y)
        x = x * mask[:, None]
        stats = self._conv("enc_p/proj", x) * mask[:, None]
        inter = c["inter_channels"]
        return x, stats[:, :inter], stats[:, inter:], mask

    def speaker(self, sid: torch.Tensor) -> torch.Tensor:
        """Speaker ids (B,) → (B, gin, 1)."""
        return self.p.weight(self.w["params/emb_g/embedding"], False)[sid][..., None]

    # -- duration predictor --------------------------------------------------

    def _dds(self, key: str, x: torch.Tensor, mask: torch.Tensor, layers: int,
             g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        m = mask[:, None]
        for i in range(layers):
            y = self._depthwise(f"{key}/convs_sep_{i}", x * m, self.c["kernel_size"] ** i)
            y = F.gelu(self._norm(f"{key}/norm1_{i}", y))
            y = self._conv(f"{key}/convs_1x1_{i}", y)
            y = F.gelu(self._norm(f"{key}/norm2_{i}", y))
            x = x + y
        return x * m

    def _spline_flow(self, i: int, z: torch.Tensor, cond: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Spline coupling flow ``i`` backwards on z (B, 2, T)."""
        key = f"dp/flow_conv_{i}"
        m = mask[:, None]
        h = self._conv(f"{key}/pre", z[:, :1])
        h = self._dds(f"{key}/convs", h, mask, 3, g=cond)
        h = (self._conv(f"{key}/proj", h) * m).transpose(1, 2)            # (B, T, 29)
        bins = (h.shape[-1] + 1) // 3
        root = math.sqrt(self.c["hidden_channels"])
        z1 = _spline_inverse(z[:, 1], h[..., :bins] / root, h[..., bins:2 * bins] / root,
                             h[..., 2 * bins:])
        return torch.cat([z[:, :1], z1[:, None]], dim=1) * m

    def log_durations(self, hidden: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                      noise: torch.Tensor, noise_scale_w: float) -> torch.Tensor:
        """The stochastic duration predictor backwards: ``noise`` (B, T, 2)
        standard normal → logw (B, T)."""
        p = self.p
        m = mask[:, None]
        x = self._conv("dp/pre", hidden) + self._conv("dp/cond", g)
        x = self._dds("dp/convs", x, mask, 3)
        x = self._conv("dp/proj", x) * m
        z = p.t(noise).transpose(1, 2) * noise_scale_w
        n_flows = sum(1 for k in self.w if k.startswith("params/dp/flow_conv_")
                      and k.endswith("/pre/kernel"))
        for i in reversed(range(1, n_flows)):          # the first flow dropped, as published
            z = z.flip(1)
            z = self._spline_flow(i, z, x, mask)
        z = z.flip(1)
        shift = p.weight(self.w["params/dp/flow_affine/m"], False)[None, :, None]
        logs = p.weight(self.w["params/dp/flow_affine/logs"], False)[None, :, None]
        z = (z - shift) * torch.exp(-logs) * m
        return z[:, 0]

    # -- frames and waveform -------------------------------------------------

    @staticmethod
    def expand(m_p: torch.Tensor, logs_p: torch.Tensor, durations: torch.Tensor,
               max_frames: int):
        """Each symbol's prior repeated for its frames: (B, C, max_frames)
        twice, and the frame counts (B,)."""
        b, ch, _ = m_p.shape
        m_f = m_p.new_zeros(b, ch, max_frames)
        logs_f = m_p.new_zeros(b, ch, max_frames)
        lengths = []
        for j in range(b):
            reps = durations[j].long()
            n = int(reps.sum().clamp(1, max_frames))
            mm = torch.repeat_interleave(m_p[j], reps, dim=1)[:, :max_frames]
            ll = torch.repeat_interleave(logs_p[j], reps, dim=1)[:, :max_frames]
            m_f[j, :, :mm.shape[1]] = mm
            logs_f[j, :, :ll.shape[1]] = ll
            lengths.append(n)
        return m_f, logs_f, torch.tensor(lengths, device=m_p.device)

    def _coupling(self, i: int, z: torch.Tensor, mask: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
        """Mean-only coupling ``i`` backwards on z (B, C, T)."""
        key = f"flow/coupling_{i}"
        half = z.shape[1] // 2
        m = mask[:, None]
        h = self._conv(f"{key}/pre", z[:, :half]) * m
        hidden = h.shape[1]
        cond = self._wn_conv(f"{key}/enc/cond_layer", g)
        out = torch.zeros_like(h)
        layers = cond.shape[1] // (2 * hidden)
        for n in range(layers):
            a = self._wn_conv(f"{key}/enc/in_layers_{n}", h) + cond[:, 2 * n * hidden:2 * (n + 1) * hidden]
            acts = torch.tanh(a[:, :hidden]) * torch.sigmoid(a[:, hidden:])
            rs = self._wn_conv(f"{key}/enc/res_skip_layers_{n}", acts)
            if n < layers - 1:
                h = (h + rs[:, :hidden]) * m
                out = out + rs[:, hidden:]
            else:
                out = out + rs
        mean = self._conv(f"{key}/post", out * m) * m
        return torch.cat([z[:, :half], (z[:, half:] - mean) * m], dim=1)

    def decode(self, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Frames (B, C, T) → waveform (B, T·hop) in float32."""
        c, p = self.c, self.p
        x = self._conv("dec/conv_pre", z) + self._conv("dec/cond", g)
        n_blocks = len(c["resblock_kernel_sizes"])
        for i, u in enumerate(c["upsample_rates"]):
            x = hifigan._upsample(p, self.w, f"dec/ups_{i}", F.leaky_relu(x, 0.1), u)
            acc = None
            for j, dilations in enumerate(c["resblock_dilation_sizes"]):
                y = x
                for n, d in enumerate(dilations):
                    t = self._wn_conv(f"dec/resblock_{i}_{j}/convs1_{n}", F.leaky_relu(y, 0.1), d)
                    y = self._wn_conv(f"dec/resblock_{i}_{j}/convs2_{n}", F.leaky_relu(t, 0.1)) + y
                acc = y if acc is None else acc + y
            x = acc / n_blocks
        x = self._conv("dec/conv_post", F.leaky_relu(x, 0.01), bias=False)
        return torch.tanh(x)[:, 0].float()

    def waveform(self, m_f: torch.Tensor, logs_f: torch.Tensor, lengths: torch.Tensor,
                 noise: torch.Tensor, noise_scale: float, g: torch.Tensor) -> torch.Tensor:
        """The prior sample (``noise`` (B, T, C) standard normal), the flows
        backwards and the decoder → (B, T·hop)."""
        p = self.p
        t = m_f.shape[-1]
        mask = p.t((torch.arange(t, device=m_f.device)[None] < lengths[:, None]).float())
        z = m_f + p.t(noise).transpose(1, 2) * torch.exp(logs_f) * noise_scale
        n_flows = sum(1 for k in self.w if k.startswith("params/flow/coupling_")
                      and k.endswith("/pre/kernel"))
        for i in reversed(range(n_flows)):
            z = self._coupling(i, z.flip(1), mask, g)
        return self.decode(z * mask[:, None], g)


def infer(net: Vits, ids: torch.Tensor, lengths: torch.Tensor, sid: torch.Tensor,
          emo: torch.Tensor, dur_noise: torch.Tensor, prior_noise: torch.Tensor,
          max_frames: int, noise_scale: float = 0.667, noise_scale_w: float = 0.8,
          length_scale: float = 1.0, durations: Optional[torch.Tensor] = None):
    """One batch: (logw (B, T_x), the durations used (B, T_x), frame counts
    (B,), waveform (B, max_frames·hop)). ``durations`` teacher-forces the
    frames on given durations instead of ⌈exp(logw)·length_scale⌉."""
    hidden, m_p, logs_p, mask = net.encode(ids, lengths, emo)
    g = net.speaker(sid)
    logw = net.log_durations(hidden, mask, g, dur_noise, noise_scale_w)
    if durations is None:
        durations = torch.ceil(torch.exp(logw.float()) * mask.float() * length_scale)
    m_f, logs_f, frames = net.expand(m_p, logs_p, durations, max_frames)
    wav = net.waveform(m_f, logs_f, frames, prior_noise, noise_scale, g)
    return logw.float(), durations, frames, wav
