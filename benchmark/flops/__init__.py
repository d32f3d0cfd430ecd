"""Operations and bytes of the benchmark's work, from shapes alone, and the
card's published peaks.

Two floating-point operations per multiply-add. A convolution counts its
output elements times its kernel's (in/groups)·taps, a transposed
convolution its input elements times its out·taps (the count
``chip_smoke.py``'s ``conv_flops`` takes with hooks). Matrix products count
in·out per row. Element-wise work, softmaxes and the dropout are not
counted. K1, the WaveRNN sampler, counts its matrix parameters per fold and
step (``2 · mm_params · F · T``) and, as bytes, its weights once in bf16,
its conditioning in bf16 and its labels (int32), as ``chip_smoke.py`` does.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16,
3.35 TB/s HBM. Shares of these are stated with the card's power limit.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def hifigan(cfg: dict, batch: int, frames: int) -> float:
    """The generator's convolutions for mels (batch, frames, n_mels)."""
    ch = cfg["upsample_initial_channel"]
    t = frames
    total = 2.0 * batch * t * cfg["num_mels"] * ch * 7                       # conv_pre
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        total += 2.0 * batch * c_in * t * c_out * k                            # transposed
        t *= u
        for rk, dil in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            total += 2 * len(dil) * 2.0 * batch * t * c_out * c_out * rk
    return total + 2.0 * batch * t * (ch // 2 ** len(cfg["upsample_rates"])) * 7  # conv_post


def _gru(n_in: int, h: int) -> int:
    return 3 * h * (n_in + h)


def _cbhg(K: int, c_in: int, ch: int, proj, highways: int) -> int:
    macs = sum(k * c_in * ch for k in range(1, K + 1))
    macs += 3 * K * ch * proj[0] + 3 * proj[0] * proj[1]
    macs += (proj[1] * ch if proj[1] != ch else 0) + highways * 2 * ch * ch
    return macs + 2 * _gru(ch, ch // 2)


def tacotron(c: dict, batch: int, t_text: int, steps: int) -> float:
    """Inference for ``batch`` texts padded to ``t_text`` symbols, decoded
    for ``steps`` decoder steps (no postnet: inference does not run it)."""
    enc, dec, lstm, m = c["encoder_dims"], c["decoder_dims"], c["lstm_dims"], c["n_mels"]
    proj = enc + c["speaker_embedding_size"] + c["gst_E"]
    per_symbol = (c["embed_dims"] * enc + enc * enc
                  + _cbhg(c["encoder_K"], enc, enc, (enc, enc), c["num_highways"]) + proj * dec)
    per_step = (m * 2 * dec + 4 * dec * dec + _gru(proj + 2 * dec, dec) + dec * dec
                + t_text * (31 * 32 + 32 * dec + dec + proj)
                + (proj + dec) * lstm + 2 * 8 * lstm * lstm + lstm * m * c["max_r"]
                + lstm + proj)
    return 2.0 * batch * (t_text * per_symbol + steps * per_step)


def wavernn_upsampler(c: dict, batch: int, frames: int) -> float:
    """MelResNet and the mel smoothing for mels of ``frames`` (+ 2·pad)."""
    cd, m, k = c["compute_dims"], c["feat_dims"], 2 * c["pad"] + 1
    macs = frames * (k * m * cd + c["res_blocks"] * 2 * cd * cd + cd * c["res_out_dims"])
    t = frames + 2 * c["pad"]
    for s in c["upsample_factors"]:
        t *= s
        macs += t * m * (2 * s + 1)
    return 2.0 * batch * macs


def k1_mm_params(c: dict) -> int:
    rnn, fc, aux = c["rnn_dims"], c["fc_dims"], c["res_out_dims"] // 4
    return ((1 + c["feat_dims"] + aux) * rnn          # I
            + 2 * rnn * 3 * rnn                       # GRU1, input and hidden gates
            + (rnn + aux) * 3 * rnn + rnn * 3 * rnn   # GRU2
            + (rnn + aux) * fc + (fc + aux) * fc + fc * 2 ** c["bits"])


def k1(c: dict, folds: int, steps: int):
    """(FLOP, bytes, bound seconds) of one sampler launch over ``folds`` ×
    ``steps``: the bound is the larger of FLOP / bf16 peak and bytes / HBM
    bandwidth."""
    rnn, fc, aux, n = c["rnn_dims"], c["fc_dims"], c["res_out_dims"] // 4, 2 ** c["bits"]
    flop = 2.0 * k1_mm_params(c) * folds * steps
    params = k1_mm_params(c) + 9 * rnn + 2 * fc + n        # matrices and biases
    cond = folds * steps * (c["feat_dims"] + 4 * aux)
    nbytes = 2.0 * params + 2.0 * cond + 4.0 * folds * steps
    return flop, nbytes, max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)

