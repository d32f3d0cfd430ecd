"""The parameter layout of each model, as the reference reads it: flax's
naming and axis order (dense kernels (in, out), convolutions (k.., in, out),
GRU gates ir/iz/in with biases and hr/hz/hn with a bias on hn only, LSTM
gates ii..io without biases and hi..ho with them, weight-normed convolutions
as ``<n>_conv/{kernel,bias}`` plus the gain ``<n>/<n>_conv/kernel/scale``,
BatchNorm ``scale``/``bias`` under ``params`` and ``mean``/``var`` under
``batch_stats``).

Each function lists ``(key, shape, kind)`` for one model; ``kind`` says how
the seeded writer draws the leaf (``harness/weights.py``). The same keys are
what the reference looks its weights up by.
"""
from __future__ import annotations

from typing import List, Tuple

Leaf = Tuple[str, Tuple[int, ...], str]


def _dense(out: List[Leaf], key: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out.append((f"{key}/kernel", (n_in, n_out), "kernel"))
    if bias:
        out.append((f"{key}/bias", (n_out,), "bias"))


def _gru(out: List[Leaf], key: str, n_in: int, h: int) -> None:
    for g in ("ir", "iz", "in"):
        _dense(out, f"{key}/{g}", n_in, h)
    for g in ("hr", "hz"):
        _dense(out, f"{key}/{g}", h, h, bias=False)
    _dense(out, f"{key}/hn", h, h)


def _lstm(out: List[Leaf], key: str, n_in: int, h: int) -> None:
    for g in ("ii", "if", "ig", "io"):
        _dense(out, f"{key}/{g}", n_in, h, bias=False)
    for g in ("hi", "hf", "hg", "ho"):
        _dense(out, f"{key}/{g}", h, h)


def _bn(out: List[Leaf], key: str, ch: int) -> None:
    out += [(f"params/{key}/scale", (ch,), "bn_scale"), (f"params/{key}/bias", (ch,), "bn_bias"),
            (f"batch_stats/{key}/mean", (ch,), "bn_mean"), (f"batch_stats/{key}/var", (ch,), "bn_var")]


def ge2e(n_mels: int = 40, hidden: int = 256, embed: int = 256, layers: int = 3) -> List[Leaf]:
    out: List[Leaf] = []
    for i in range(layers):
        _lstm(out, f"lstm_{i}", n_mels if i == 0 else hidden, hidden)
    _dense(out, "linear", hidden, embed)
    return out


def _cbhg(out: List[Leaf], key: str, K: int, c_in: int, ch: int, proj: Tuple[int, int],
          highways: int) -> None:
    for k in range(1, K + 1):
        out.append((f"params/{key}/bank_{k}/conv/kernel", (k, c_in, ch), "kernel"))
        _bn(out, f"{key}/bank_{k}/bnorm", ch)
    out.append((f"params/{key}/conv_project1/conv/kernel", (3, K * ch, proj[0]), "kernel"))
    _bn(out, f"{key}/conv_project1/bnorm", proj[0])
    out.append((f"params/{key}/conv_project2/conv/kernel", (3, proj[0], proj[1]), "kernel"))
    _bn(out, f"{key}/conv_project2/bnorm", proj[1])
    if proj[1] != ch:
        _dense(out, f"params/{key}/pre_highway", proj[1], ch, bias=False)
    for i in range(highways):
        _dense(out, f"params/{key}/highway_{i}/W1", ch, ch)
        _dense(out, f"params/{key}/highway_{i}/W2", ch, ch)
    _gru(out, f"params/{key}/gru_fwd", ch, ch // 2)
    _gru(out, f"params/{key}/gru_bwd", ch, ch // 2)


def gst_reference_width(c) -> int:
    w = c["speaker_embedding_size"]
    for _ in c["gst_ref_filters"]:
        w = (w - 1) // 2 + 1
    return c["gst_ref_filters"][-1] * w


def tacotron(c) -> List[Leaf]:
    out: List[Leaf] = []
    enc = c["encoder_dims"]
    proj_dims = enc + c["speaker_embedding_size"] + c["gst_E"]
    out.append(("params/encoder/embedding/embedding", (c["num_chars"], c["embed_dims"]), "embed"))
    _dense(out, "params/encoder/pre_net/fc1", c["embed_dims"], enc)
    _dense(out, "params/encoder/pre_net/fc2", enc, enc)
    _cbhg(out, "encoder/cbhg", c["encoder_K"], enc, enc, (enc, enc), c["num_highways"])
    _dense(out, "params/encoder_proj", proj_dims, c["decoder_dims"], bias=False)
    chans = [1] + list(c["gst_ref_filters"])
    for i in range(len(c["gst_ref_filters"])):
        out.append((f"params/gst/encoder/conv_{i}/kernel", (3, 3, chans[i], chans[i + 1]), "kernel"))
        out.append((f"params/gst/encoder/conv_{i}/bias", (chans[i + 1],), "bias"))
        _bn(out, f"gst/encoder/bn_{i}", chans[i + 1])
    _gru(out, "params/gst/encoder/gru", gst_reference_width(c), c["gst_E"] // 2)
    d_token = c["gst_E"] // c["gst_num_heads"]
    out.append(("params/gst/stl/embed", (c["gst_token_num"], d_token), "gst_embed"))
    _dense(out, "params/gst/stl/W_query", c["gst_E"] // 2 + c["speaker_embedding_size"],
           c["gst_E"], bias=False)
    _dense(out, "params/gst/stl/W_key", d_token, c["gst_E"], bias=False)
    _dense(out, "params/gst/stl/W_value", d_token, c["gst_E"], bias=False)
    dec, lstm, m = c["decoder_dims"], c["lstm_dims"], c["n_mels"]
    _dense(out, "params/decoder/prenet/fc1", m, 2 * dec)
    _dense(out, "params/decoder/prenet/fc2", 2 * dec, 2 * dec)
    _dense(out, "params/decoder/attn_net/W", dec, dec)
    out.append(("params/decoder/attn_net/conv/kernel", (31, 1, 32), "kernel"))
    out.append(("params/decoder/attn_net/conv/bias", (32,), "bias"))
    _dense(out, "params/decoder/attn_net/L", 32, dec, bias=False)
    _dense(out, "params/decoder/attn_net/v", dec, 1, bias=False)
    _gru(out, "params/decoder/attn_rnn", proj_dims + 2 * dec, dec)
    _dense(out, "params/decoder/rnn_input", proj_dims + dec, lstm)
    _lstm(out, "params/decoder/res_rnn1", lstm, lstm)
    _lstm(out, "params/decoder/res_rnn2", lstm, lstm)
    _dense(out, "params/decoder/mel_proj", lstm, m * c["max_r"], bias=False)
    _dense(out, "params/decoder/stop_proj", lstm + proj_dims, 1)
    post = c["postnet_dims"]
    _cbhg(out, "postnet", c["postnet_K"], m, post, (post, c["fft_bins"]), c["num_highways"])
    _dense(out, "params/post_proj", post, c["fft_bins"], bias=False)
    return out


def _wn_conv(out: List[Leaf], name: str, k: int, c_in: int, c_out: int) -> None:
    base = name.rsplit("/", 1)[-1]
    out += [(f"params/{name}_conv/kernel", (k, c_in, c_out), "wn_kernel"),
            (f"params/{name}_conv/bias", (c_out,), "bias"),
            (f"params/{name}/{base}_conv/kernel/scale", (c_out,), "wn_scale")]


def hifigan(c) -> List[Leaf]:
    if c["resblock"] != "1" or c.get("use_interpolation"):
        raise ValueError("the reference HiFi-GAN has ResBlock1 and transposed convolutions only")
    out: List[Leaf] = []
    ch0 = c["upsample_initial_channel"]
    _wn_conv(out, "conv_pre", 7, c["num_mels"], ch0)
    for i, k in enumerate(c["upsample_kernel_sizes"]):
        ch = ch0 // 2 ** (i + 1)
        _wn_conv(out, f"ups_{i}", k, ch0 // 2 ** i, ch)
        for j, (rk, rd) in enumerate(zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"])):
            for n in range(len(rd)):
                _wn_conv(out, f"resblock_{i}_{j}/convs1_{n}", rk, ch, ch)
                _wn_conv(out, f"resblock_{i}_{j}/convs2_{n}", rk, ch, ch)
    _wn_conv(out, "conv_post", 7, ch0 // 2 ** len(c["upsample_rates"]), 1)
    return out


def wavernn(c) -> List[Leaf]:
    out: List[Leaf] = []
    cd, m = c["compute_dims"], c["feat_dims"]
    out.append(("params/upsample/resnet/conv_in/kernel", (2 * c["pad"] + 1, m, cd), "kernel"))
    _bn(out, "upsample/resnet/bn", cd)
    for i in range(c["res_blocks"]):
        for n in (1, 2):
            out.append((f"params/upsample/resnet/res_{i}/conv{n}/kernel", (1, cd, cd), "kernel"))
            _bn(out, f"upsample/resnet/res_{i}/bn{n}", cd)
    out.append(("params/upsample/resnet/conv_out/kernel", (1, cd, c["res_out_dims"]), "kernel"))
    out.append(("params/upsample/resnet/conv_out/bias", (c["res_out_dims"],), "bias"))
    for i, s in enumerate(c["upsample_factors"]):
        out.append((f"params/upsample/up_conv_{i}/kernel", (2 * s + 1, 1, 1, 1), "box"))
    aux = c["res_out_dims"] // 4
    rnn, fc = c["rnn_dims"], c["fc_dims"]
    n_classes = 2 ** c["bits"]
    _dense(out, "params/I", m + aux + 1, rnn)
    _gru(out, "params/rnn1/cell", rnn, rnn)
    _gru(out, "params/rnn2/cell", rnn + aux, rnn)
    _dense(out, "params/fc1", rnn + aux, fc)
    _dense(out, "params/fc2", fc + aux, fc)
    _dense(out, "params/fc3", fc, n_classes)
    return out
