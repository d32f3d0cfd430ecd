"""Plain HiFi-GAN generator (ResBlock1, transposed-convolution upsampling).

mel (B, T, n_mels) → conv_pre (7 taps) → per upsampling stage: leaky ReLU
0.1, a transposed convolution of stride u (flax's, with padding VALID and
the kernel not flipped: the input dilated by u, zero-padded by k − 1 on
both sides and cross-correlated with the kernel), cut to T·u samples from
u//2 + u%2 on, then the mean of the multi-receptive-field blocks (each 3 ×
[leaky ReLU, dilated conv, leaky ReLU, conv] with residuals) → leaky ReLU
0.01 → conv_post (7 taps, one channel) → tanh. Every convolution is
weight-normed: kernel = v · scale / ‖v‖, the norm over all but the output
axis. Convolutions keep the length (SAME padding).

In bfloat16 (``Prec("bfloat16")``), the precision the configuration states
for the generator, weights, activations and every sum are bfloat16, the
weight norm rounded as flax rounds it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Prec, conv1d


def _kernel(p: Prec, w: dict, name: str) -> torch.Tensor:
    """The weight-normed kernel (made once per precision and kept in
    ``w``). In bfloat16 the weights are held in bfloat16 and the norm is
    taken as flax takes it under a bfloat16 policy: the sum of squares,
    its reciprocal root and the normalised direction each rounded to
    bfloat16, the product with the gain in float32."""
    key = f"params/{name}_conv/kernel/normed/{p.name}"
    if key not in w:
        v = w[f"params/{name}_conv/kernel"].float()
        scale = w[f"params/{name}/{name.rsplit('/', 1)[-1]}_conv/kernel/scale"].float()
        if p.name == "bfloat16":
            def rnd(a):
                return a.to(torch.bfloat16).float()
            v, scale = rnd(v), rnd(scale)
            w[key] = rnd(v * rnd(torch.rsqrt(rnd((v * v).sum(dim=(0, 1))) + 1e-12))) * scale
        else:
            w[key] = v * (scale / torch.sqrt((v * v).sum(dim=(0, 1)) + 1e-12))
    return w[key]


def _conv(p: Prec, w: dict, name: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    k = _kernel(p, w, name)
    half = dilation * (k.shape[0] - 1) // 2
    return conv1d(p, x, k, w[f"params/{name}_conv/bias"], pad=(half, half), dilation=dilation)


def _upsample(p: Prec, w: dict, name: str, x: torch.Tensor, u: int) -> torch.Tensor:
    k = _kernel(p, w, name)
    taps = k.shape[0]
    b, ch, t_len = x.shape
    dilated = x.new_zeros(b, ch, (t_len - 1) * u + 1)
    dilated[:, :, ::u] = x
    y = conv1d(p, dilated, k, w[f"params/{name}_conv/bias"], pad=(taps - 1, taps - 1))
    off = u // 2 + u % 2
    return y[:, :, off:off + t_len * u]


def generate(w: dict, cfg: dict, mel: torch.Tensor, p: Prec) -> torch.Tensor:
    """mel (B, T, n_mels) → wav (B, T·hop) in [-1, 1], float32."""
    x = _conv(p, w, "conv_pre", p.t(mel.transpose(1, 2)))
    n_blocks = len(cfg["resblock_kernel_sizes"])
    for i, u in enumerate(cfg["upsample_rates"]):
        x = _upsample(p, w, f"ups_{i}", F.leaky_relu(x, 0.1), u)
        acc = None
        for j, dilations in enumerate(cfg["resblock_dilation_sizes"]):
            y = x
            for n, d in enumerate(dilations):
                t = _conv(p, w, f"resblock_{i}_{j}/convs1_{n}", F.leaky_relu(y, 0.1), d)
                y = _conv(p, w, f"resblock_{i}_{j}/convs2_{n}", F.leaky_relu(t, 0.1)) + y
            acc = y if acc is None else acc + y
        x = acc / n_blocks
    x = _conv(p, w, "conv_post", F.leaky_relu(x, 0.01))
    return torch.tanh(x)[:, 0].float()


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
