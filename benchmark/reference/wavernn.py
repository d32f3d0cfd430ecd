"""Plain WaveRNN (RAW, mu-law) vocoder: conditioning and the sampling
recurrence.

Conditioning of one mel (T, n_mels), already scaled to ±1 and padded by
``pad`` zero frames on each side: MelResNet (a (2·pad + 1)-tap valid
convolution, BatchNorm, ReLU, residual blocks of two 1×1 convolutions with
BatchNorm, a 1×1 output convolution) repeated ``hop`` times along time; the
mel itself upsampled by each factor s (repeat s times, then a (2s + 1)-tap
smoothing convolution along time) and cut by ``pad · hop`` samples at each
end. Both are folded into overlapping windows of target + 2·overlap samples
every target + overlap samples, the tail padded with zeros.

One step of the recurrence over F folds: u = I([x, mel_t, a1]);
h1 = GRU1(u, h1); u += h1; h2 = GRU2([u, a2], h2); u += h2;
u = ReLU(fc1([u, a3])); u = ReLU(fc2([u, a4])); logits = fc3(u). The sampled
label is argmax(logits + Gumbel noise), fed back as x = 2·label/(C − 1) − 1.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import Prec, batch_norm, conv1d, gru_cell, linear


def conditioning(w: dict, cfg: dict, mel: np.ndarray, p: Prec, device):
    """mel (T + 2·pad, M) → (mel_up (T·hop, M), aux (T·hop, res_out))."""
    x = torch.from_numpy(np.ascontiguousarray(mel, np.float32)).to(device)
    r = "upsample/resnet"
    h = conv1d(p, p.t(x.T[None]), w[f"params/{r}/conv_in/kernel"])
    h = torch.relu(batch_norm(p, h, w, f"{r}/bn"))
    for i in range(cfg["res_blocks"]):
        y = torch.relu(batch_norm(p, conv1d(p, h, w[f"params/{r}/res_{i}/conv1/kernel"]), w,
                                  f"{r}/res_{i}/bn1"))
        h = batch_norm(p, conv1d(p, y, w[f"params/{r}/res_{i}/conv2/kernel"]), w,
                       f"{r}/res_{i}/bn2") + h
    h = conv1d(p, h, w[f"params/{r}/conv_out/kernel"], w[f"params/{r}/conv_out/bias"])
    hop = int(np.prod(cfg["upsample_factors"]))
    aux = h[0].T.repeat_interleave(hop, dim=0)
    m = p.t(x)[None, None]                                  # (1, 1, T', M)
    for i, s in enumerate(cfg["upsample_factors"]):
        k = p.weight(w[f"params/upsample/up_conv_{i}/kernel"])   # (2s + 1, 1, 1, 1)
        m = F.conv2d(p.operand(m.repeat_interleave(s, dim=2)), k.permute(3, 2, 0, 1),
                     padding=(s, 0))
    indent = cfg["pad"] * hop
    return m[0, 0, indent:-indent].float(), aux.float()


def fold(x: torch.Tensor, target: int, overlap: int) -> torch.Tensor:
    """(L, C) → (folds, target + 2·overlap, C)."""
    width = target + 2 * overlap
    n = max((x.shape[0] - overlap) // (target + overlap), 0)
    if x.shape[0] - (n * (target + overlap) + overlap) > 0:
        n += 1
    need = (n - 1) * (target + overlap) + width
    x = F.pad(x, (0, 0, 0, max(need - x.shape[0], 0)))
    return torch.stack([x[i * (target + overlap): i * (target + overlap) + width]
                        for i in range(n)])


def run(w: dict, cfg: dict, mels: torch.Tensor, aux: torch.Tensor, p: Prec,
        noise: Callable[[int, int], torch.Tensor], labels: Optional[torch.Tensor] = None):
    """The recurrence over folds: mels (F, L, M), aux (F, L, 4·d).

    With ``labels`` (F, L) it is teacher-forced on them and returns, per
    step, how far the given label's score (logits + noise) lies below the
    best score: (F, L) float32, 0 where the label is the argmax. Without, it
    samples its own and returns them (F, L) int64. ``noise(t0, t1)`` gives
    the (t1 − t0, F, C) Gumbel noise of steps [t0, t1)."""
    n_f, length, _ = mels.shape
    d = aux.shape[-1] // 4
    n_classes = 2 ** cfg["bits"]
    rnn = cfg["rnn_dims"]
    mels, aux = p.t(mels), p.t(aux)
    x = mels.new_zeros(n_f, 1)
    h1 = h2 = mels.new_zeros(n_f, rnn)
    out = torch.empty(n_f, length, device=mels.device,
                      dtype=torch.float32 if labels is not None else torch.int64)
    chunk = max(1, (1 << 22) // (n_f * n_classes))
    for t in range(length):
        if t % chunk == 0:
            z = noise(t, min(t + chunk, length))
        a1, a2, a3, a4 = aux[:, t].split(d, dim=1)
        u = linear(p, torch.cat([x, mels[:, t], a1], dim=1), w["params/I/kernel"], w["params/I/bias"])
        h1 = gru_cell(p, w, "params/rnn1/cell", u, h1)
        u = u + h1
        h2 = gru_cell(p, w, "params/rnn2/cell", torch.cat([u, a2], dim=1), h2)
        u = u + h2
        u = torch.relu(linear(p, torch.cat([u, a3], dim=1), w["params/fc1/kernel"], w["params/fc1/bias"]))
        u = torch.relu(linear(p, torch.cat([u, a4], dim=1), w["params/fc2/kernel"], w["params/fc2/bias"]))
        score = linear(p, u, w["params/fc3/kernel"], w["params/fc3/bias"]).float() + z[t % chunk]
        if labels is not None:
            # a uniform that rounds to 1 gives infinite noise: that class wins
            label = labels[:, t].long()
            best, given = score.max(dim=1).values, score.gather(1, label[:, None])[:, 0]
            out[:, t] = torch.where(given >= best, torch.zeros_like(best), best - given)
        else:
            label = torch.argmax(score, dim=1)
            out[:, t] = label
        x = p.t(2.0 * label.float() / (n_classes - 1.0) - 1.0)[:, None]
    return out
