"""Fused WaveRNN autoregressive sampling: the Hopper kernel and its plain
PyTorch version.

Port of ``mockingbird_tpu/ops/wavernn_sample.py``. The kernel
(``csrc/wavernn_sample.cu``) replaces the Pallas TPU kernel ``_kernel_v2``:
per step, for F independent folds, I-dense → GRU1 → GRU2 → fc1 → fc2 → fc3
→ Gumbel-max (or greedy argmax) sample fed back as the next input, the whole
T-step loop inside one launch.

``wavernn_sample`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. Weight layout matches flax ``nn.GRUCell``
(r = σ(ir·x + hr·h), z = σ(iz·x + hz·h), n = tanh(in·x + r·(hn·h + bn)),
h' = (1−z)·n + z·h); ``pack_wavernn_weights`` fuses it from the port's
``WaveRNN`` module.

Sampling draws its random bits from Philox4x32-10 keyed by the seed, with
the counter (class, fold, step, 0), in the kernel and in the plain version
alike, so that a sampled run of the kernel can be held label by label
against the plain one.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

_MASK32 = 0xFFFFFFFF
# Gumbel noise for this many (step, fold, class) entries at a time
_NOISE_CHUNK = 1 << 22

W_NAMES = ("I_w", "I_b", "g1_wi", "g1_bi", "g1_wh", "g1_bn",
           "g2_wi", "g2_bi", "g2_wh", "g2_bn",
           "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fc3_w", "fc3_b")


def pack_wavernn_weights(model, dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The port's ``WaveRNN`` → fused (in, out) matrices for the sampler:
    I (in, rnn) + bias, per-GRU fused input/hidden kernels (·, 3·rnn) with
    gate order [r, z, n] and the ``hn`` bias, fc1/fc2/fc3 (+ biases)."""
    def gru(cell):
        return cell.wi.weight.T, cell.wi.bias, cell.wh.weight.T, cell.bn

    g1 = gru(model.rnn1.cell)
    g2 = gru(model.rnn2.cell)
    out = dict(zip(W_NAMES, (
        model.I.weight.T, model.I.bias, *g1, *g2,
        model.fc1.weight.T, model.fc1.bias, model.fc2.weight.T, model.fc2.bias,
        model.fc3.weight.T, model.fc3.bias)))
    return {k: v.detach().to(dtype).contiguous() for k, v in out.items()}


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a · m`` for int64 ``a`` < 2**32 and a
    32-bit constant ``m``, exact in int64: ``a`` is split into 16-bit halves."""
    lo_part = (a & 0xFFFF) * m                       # < 2**48
    hi_part = (a >> 16) * m                          # < 2**48
    s = ((hi_part & 0xFFFF) << 16) + lo_part         # < 2**49
    return (hi_part >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors (or ints) that
    hold 32-bit words; counters broadcast against each other. Returns the
    four output words, as the kernel's ``philox`` computes the first."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def gumbel_noise(seed: int, t0: int, t1: int, n_folds: int, n_classes: int,
                 device) -> torch.Tensor:
    """(t1 − t0, F, C) f32 Gumbel noise of steps t0 ≤ t < t1, bit for bit the
    kernel's: 32 Philox bits per (class, fold, step), 23 of them as a uniform
    + 1e-7, then −log(−log u)."""
    seed = int(seed) & (2**64 - 1)
    i64 = dict(dtype=torch.int64, device=device)
    bits = philox4x32_10(torch.arange(n_classes, **i64)[None, None, :],
                         torch.arange(n_folds, **i64)[None, :, None],
                         torch.arange(t0, t1, **i64)[:, None, None], 0,
                         seed & _MASK32, seed >> 32)[0]
    uni = (bits & 0x7FFFFF).float() * (1.0 / (1 << 23)) + 1e-7
    return -torch.log(-torch.log(uni))


def wavernn_sample_plain(weights: Dict[str, torch.Tensor], mels: torch.Tensor,
                         aux: torch.Tensor, seed: int, n_classes: int = 512,
                         greedy: bool = False, return_gaps: bool = False):
    """The sampler as a Python loop over T of the same step in torch ops.

    mels (F, T, 80), aux (F, T, 4·aux_d) → labels (F, T) int32. Activations
    are rounded to the weight dtype before each product and accumulated in
    f32, as the kernel does. Sampling adds the kernel's own Gumbel noise
    (``gumbel_noise``). With ``return_gaps`` also returns the (F, T) gap
    between the two highest scores of each step, noise included."""
    wdt = weights["I_w"].dtype
    w = {k: v.float() for k, v in weights.items()}
    rnn = w["I_w"].shape[1]
    aux_d = aux.shape[-1] // 4
    f, t_len, _ = mels.shape
    dev = mels.device

    def rnd(a):
        return a.to(wdt).float()

    def gru(x, h, p):
        gx = rnd(x) @ w[p + "_wi"] + w[p + "_bi"]
        gh = rnd(h) @ w[p + "_wh"]
        r = torch.sigmoid(gx[:, :rnn] + gh[:, :rnn])
        z = torch.sigmoid(gx[:, rnn:2 * rnn] + gh[:, rnn:2 * rnn])
        n = torch.tanh(gx[:, 2 * rnn:] + r * (gh[:, 2 * rnn:] + w[p + "_bn"]))
        return (1.0 - z) * n + z * h

    mels_c, aux_c = rnd(mels), rnd(aux)
    chunk = max(1, _NOISE_CHUNK // (f * n_classes))
    x = torch.zeros(f, 1, device=dev)
    h1 = torch.zeros(f, rnn, device=dev)
    h2 = torch.zeros(f, rnn, device=dev)
    labels = torch.empty(f, t_len, dtype=torch.int32, device=dev)
    gaps = torch.empty(f, t_len, device=dev) if return_gaps else None
    for t in range(t_len):
        a1, a2, a3, a4 = aux_c[:, t].split(aux_d, dim=1)
        u = rnd(torch.cat([x, mels_c[:, t], a1], dim=1)) @ w["I_w"] + w["I_b"]
        h1 = gru(u, h1, "g1")
        u = u + h1
        h2 = gru(torch.cat([u, a2], dim=1), h2, "g2")
        u = u + h2
        u = torch.relu(rnd(torch.cat([u, a3], dim=1)) @ w["fc1_w"] + w["fc1_b"])
        u = torch.relu(rnd(torch.cat([u, a4], dim=1)) @ w["fc2_w"] + w["fc2_b"])
        scores = rnd(u) @ w["fc3_w"] + w["fc3_b"]
        if not greedy:
            if t % chunk == 0:
                noise = gumbel_noise(seed, t, min(t + chunk, t_len), f, n_classes, dev)
            scores = scores + noise[t % chunk]
        label = torch.argmax(scores, dim=1)      # first maximum wins ties
        labels[:, t] = label.to(torch.int32)
        if gaps is not None:
            top2 = torch.topk(scores, 2, dim=1).values
            gaps[:, t] = top2[:, 0] - top2[:, 1]
        x = (2.0 * label.float() / float(n_classes - 1) - 1.0)[:, None]
    return (labels, gaps) if return_gaps else labels


def _check(weights, mels, aux, n_classes):
    dev, wdt = mels.device, weights["I_w"].dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, not {wdt}")
    for k in W_NAMES:
        v = weights[k]
        if v.device != dev or v.dtype != wdt or not v.is_contiguous():
            raise ValueError(f"weight {k}: {v.device}/{v.dtype}/contiguous="
                             f"{v.is_contiguous()}, expected {dev}/{wdt}/contiguous")
    if mels.ndim != 3 or aux.ndim != 3 or aux.shape[:2] != mels.shape[:2]:
        raise ValueError(f"mels {tuple(mels.shape)} / aux {tuple(aux.shape)}: expected (F, T, ·)")
    if aux.device != dev:
        raise ValueError(f"aux on {aux.device}, mels on {dev}")
    rnn = weights["I_w"].shape[1]
    fc = weights["fc1_w"].shape[1]
    a = aux.shape[2] // 4
    want = {"I_w": (1 + mels.shape[2] + a, rnn), "I_b": (rnn,),
            "g1_wi": (rnn, 3 * rnn), "g1_bi": (3 * rnn,), "g1_wh": (rnn, 3 * rnn),
            "g1_bn": (rnn,), "g2_wi": (rnn + a, 3 * rnn), "g2_bi": (3 * rnn,),
            "g2_wh": (rnn, 3 * rnn), "g2_bn": (rnn,), "fc1_w": (rnn + a, fc),
            "fc1_b": (fc,), "fc2_w": (fc + a, fc), "fc2_b": (fc,),
            "fc3_w": (fc, n_classes), "fc3_b": (n_classes,)}
    for k, shape in want.items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"weight {k} has shape {tuple(weights[k].shape)}, expected {shape}")
    if aux.shape[2] % 4:
        raise ValueError(f"aux width {aux.shape[2]} is not 4·aux_d")


def wavernn_sample(weights: Dict[str, torch.Tensor], mels: torch.Tensor, aux: torch.Tensor,
                   seed: int, n_classes: int = 512, greedy: bool = False) -> torch.Tensor:
    """mels (F, T, 80), aux (F, T, 4·aux_d) → labels (F, T) int32.

    On CUDA tensors this launches the Hopper kernel (and counts the launch in
    ``wavernn_sample.launches``); on CPU tensors it runs the plain version.
    Conditioning is streamed in the weight dtype, as the Pallas kernel does."""
    dev = mels.device
    if dev.type == "cpu":
        return wavernn_sample_plain(weights, mels, aux, seed, n_classes, greedy)
    if dev.type != "cuda":
        raise ValueError(f"wavernn_sample runs on cuda or cpu tensors, not {dev}")
    _check(weights, mels, aux, n_classes)
    from .build import load
    lib = _bind(load("wavernn_sample"))
    wdt = weights["I_w"].dtype
    f, t_len, m = mels.shape
    # (F, T, D) → time-major (T, F, D) in the weight dtype: one copy, and the
    # per-step rows of all folds are then adjacent
    mels_t = mels.to(wdt).transpose(0, 1).contiguous()
    aux_t = aux.to(wdt).transpose(0, 1).contiguous()
    labels = torch.empty((f, t_len), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(W_NAMES))(*(weights[k].data_ptr() for k in W_NAMES))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wavernn_sample_launch(
            mels_t.data_ptr(), aux_t.data_ptr(), ptrs, labels.data_ptr(),
            f, t_len, m, aux.shape[2] // 4, weights["I_w"].shape[1],
            weights["fc1_w"].shape[1], n_classes, int(wdt == torch.bfloat16),
            int(greedy), int(seed) & (2**64 - 1), stream)
    if err != 0:
        raise RuntimeError(f"wavernn_sample kernel launch failed: CUDA error {err} "
                           f"({lib.wavernn_sample_error_string(err).decode()})")
    wavernn_sample.launches += 1
    return labels


wavernn_sample.launches = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.wavernn_sample_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_ulonglong, p]
        fn.restype = i
        lib.wavernn_sample_error_string.argtypes = [i]
        lib.wavernn_sample_error_string.restype = ctypes.c_char_p
    return lib
