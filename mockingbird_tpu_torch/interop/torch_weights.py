"""PyTorch state_dict → flax param tree (the layout ``weights.load_flax``
reads).

Port of ``mockingbird_tpu/interop/torch_weights.py``, which is numpy only:
the converters are copies, so a converted tree is bitwise the JAX
package's. They map a reference or HF ``state_dict`` onto the flax tree of
each family:

  * Conv1d      (out,in,k)   → (k,in,out)
  * ConvT1d     (in,out,k)   → (k,in,out) with the kernel axis reversed
                               (flax SAME conv_transpose == torch's
                               pad=(u//2+u%2), output_padding=u%2 scheme)
  * Linear      (out,in)     → (in,out)
  * weight_norm (g,v)        → WeightNorm{layer/kernel: v, kernel/scale: g}
  * GRU/LSTM    fused torch gates → flax per-gate kernels
  * LayerNorm / GroupNorm weight, bias → scale, bias

The converters take numpy arrays; ``state_dict_to_numpy`` turns torch
tensors into them. ``weights.load_flax`` then loads a tree into the port's
module.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    return {k: v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()
            for k, v in state_dict.items()}


def conv1d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 1, 0))


def conv2d(w: np.ndarray) -> np.ndarray:
    # torch (out,in,kh,kw) → flax (kh,kw,in,out)
    return np.transpose(w, (2, 3, 1, 0))


def conv_transpose1d(w: np.ndarray) -> np.ndarray:
    # torch (in,out,k) → flax (k,in,out), kernel axis reversed
    return np.transpose(w[:, :, ::-1], (2, 0, 1)).copy()


def dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _fold_torch_weight_norm(sd, prefix: str) -> np.ndarray:
    """Reconstruct the effective torch weight w = g · v/||v|| (norm over all
    dims except dim 0, torch's default). torch normalizes per dim-0 slice —
    for ConvTranspose that's the INPUT channel, which has no flax WeightNorm
    equivalent, so the norm is folded and re-expressed below."""
    v = sd[f"{prefix}.weight_v"]
    g = sd[f"{prefix}.weight_g"]
    norm = np.sqrt(np.sum(v.reshape(v.shape[0], -1) ** 2, axis=1))
    norm = norm.reshape((-1,) + (1,) * (v.ndim - 1))
    return g * v / np.maximum(norm, 1e-12)


def _flax_wn_split(kernel: np.ndarray) -> tuple:
    """Effective flax kernel → (v, scale) such that WeightNorm reproduces it
    exactly: scale_j = ||kernel[..., j]||, v = kernel."""
    flat = kernel.reshape(-1, kernel.shape[-1])
    scale = np.sqrt(np.sum(flat ** 2, axis=0))
    return kernel, scale


def wn_conv1d(sd: Dict[str, np.ndarray], prefix: str) -> tuple:
    """torch weight_norm Conv1d → (wrapped-conv params, flax scale)."""
    w_eff = _fold_torch_weight_norm(sd, prefix)
    kernel, scale = _flax_wn_split(conv1d(w_eff))
    conv = {"kernel": kernel}
    if f"{prefix}.bias" in sd:
        conv["bias"] = sd[f"{prefix}.bias"]
    return conv, scale


def wn_conv_transpose1d(sd: Dict[str, np.ndarray], prefix: str) -> tuple:
    w_eff = _fold_torch_weight_norm(sd, prefix)
    kernel, scale = _flax_wn_split(conv_transpose1d(w_eff))
    conv = {"kernel": kernel}
    if f"{prefix}.bias" in sd:
        conv["bias"] = sd[f"{prefix}.bias"]
    return conv, scale


def torch_gru_to_flax(w_ih, w_hh, b_ih, b_hh, h: int) -> Dict:
    """torch GRU(Cell) fused gates [r,z,n] → flax GRUCell params.

    torch: r=σ(Wir·x+bir+Whr·h+bhr), n=tanh(Win·x+bin + r*(Whn·h+bhn)).
    flax:  r=σ(ir(x)+hr(h)),         n=tanh(in(x)     + r*(hn(h)+bn)).
    ir bias ← bir+bhr (exact: both add pre-sigmoid); hn bias ← bhn; in bias ← bin.
    """
    wir, wiz, win = w_ih[:h], w_ih[h:2*h], w_ih[2*h:]
    whr, whz, whn = w_hh[:h], w_hh[h:2*h], w_hh[2*h:]
    bir, biz, bin_ = b_ih[:h], b_ih[h:2*h], b_ih[2*h:]
    bhr, bhz, bhn = b_hh[:h], b_hh[h:2*h], b_hh[2*h:]
    return {
        "ir": {"kernel": dense(wir), "bias": bir + bhr},
        "iz": {"kernel": dense(wiz), "bias": biz + bhz},
        "in": {"kernel": dense(win), "bias": bin_},
        "hr": {"kernel": dense(whr)},
        "hz": {"kernel": dense(whz)},
        "hn": {"kernel": dense(whn), "bias": bhn},
    }


def torch_lstm_to_flax(w_ih, w_hh, b_ih, b_hh, h: int) -> Dict:
    """torch LSTM fused gates [i,f,g,o] → flax OptimizedLSTMCell params
    (dense_i no bias; dense_h carries the combined bias)."""
    def split(w):
        return w[:h], w[h:2*h], w[2*h:3*h], w[3*h:]
    wii, wif, wig, wio = split(w_ih)
    whi, whf, whg, who = split(w_hh)
    bi, bf, bg, bo = split(b_ih + b_hh)
    return {
        "ii": {"kernel": dense(wii)}, "if": {"kernel": dense(wif)},
        "ig": {"kernel": dense(wig)}, "io": {"kernel": dense(wio)},
        "hi": {"kernel": dense(whi), "bias": bi},
        "hf": {"kernel": dense(whf), "bias": bf},
        "hg": {"kernel": dense(whg), "bias": bg},
        "ho": {"kernel": dense(who), "bias": bo},
    }


def batchnorm(sd: Dict[str, np.ndarray], prefix: str) -> tuple:
    """→ (params {scale,bias}, stats {mean,var})."""
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})


# ---------------------------------------------------------------------------
# Tree assembly helpers — flax WeightNorm stores scale as
# params[<wn_name>]['<wrapped>/kernel/scale'] and the wrapped layer under
# params[<wn_name>]['<wrapped>']{kernel,bias}; our modules name the wrapped
# conv 'layers_0'.
# ---------------------------------------------------------------------------

def _wn_entry(tree: Dict, flax_name: str, converted: tuple) -> None:
    """Place (conv_params, scale) as flax WeightNorm stores them: the wrapped
    layer lives at a sibling scope ``<name>_conv``; the scale inside the
    wrapper scope at ``<name>/<name>_conv/kernel/scale``."""
    conv, g = converted
    tree[f"{flax_name}_conv"] = {k: np.asarray(v) for k, v in conv.items()}
    # the scale lives under the wrapper's scope as ONE flat key with slashes
    tree[flax_name] = {f"{flax_name}_conv/kernel/scale": np.asarray(g)}


# ---------------------------------------------------------------------------
# HiFi-GAN generator (`models/vocoder/hifigan/models.py:93-150`)
# ---------------------------------------------------------------------------

def convert_hifigan_generator(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """torch Generator state_dict → params for `models.vocoder.hifigan.Generator`."""
    p: Dict = {}
    _wn_entry(p, "conv_pre", wn_conv1d(sd, "conv_pre"))
    _wn_entry(p, "conv_post", wn_conv1d(sd, "conv_post"))
    n_k = len(cfg.resblock_kernel_sizes)
    # 24 kHz variant (`models.py:107-118`): ups.{i} is Sequential(Interpolation,
    # weight-normed Conv1d) so the conv's keys sit at ups.{i}.1
    use_interp = bool(getattr(cfg, "use_interpolation", False)
                      or getattr(cfg, "sample_rate", 16000) == 24000)
    for i in range(len(cfg.upsample_rates)):
        if use_interp:
            _wn_entry(p, f"ups_{i}", wn_conv1d(sd, f"ups.{i}.1"))
        else:
            _wn_entry(p, f"ups_{i}", wn_conv_transpose1d(sd, f"ups.{i}"))
        for j in range(n_k):
            blk: Dict = {}
            flat = i * n_k + j
            if cfg.resblock == "1":
                for c in range(3):
                    _wn_entry(blk, f"convs1_{c}", wn_conv1d(sd, f"resblocks.{flat}.convs1.{c}"))
                    _wn_entry(blk, f"convs2_{c}", wn_conv1d(sd, f"resblocks.{flat}.convs2.{c}"))
            else:
                for c in range(2):
                    _wn_entry(blk, f"convs_{c}", wn_conv1d(sd, f"resblocks.{flat}.convs.{c}"))
            p[f"resblock_{i}_{j}"] = blk
    return p


# ---------------------------------------------------------------------------
# WaveRNN (`models/vocoder/wavernn/models/fatchord_version.py`)
# ---------------------------------------------------------------------------

def convert_wavernn(sd: Dict[str, np.ndarray], cfg) -> tuple:
    """torch WaveRNN state_dict → (params, batch_stats) for our WaveRNN."""
    h = cfg.rnn_dims
    p: Dict = {}
    stats: Dict = {}

    # upsample network
    up: Dict = {}
    up_stats: Dict = {}
    res: Dict = {}
    res_stats: Dict = {}
    res["conv_in"] = {"kernel": conv1d(sd["upsample.resnet.conv_in.weight"])}
    bn_p, bn_s = batchnorm(sd, "upsample.resnet.batch_norm")
    res["bn"] = bn_p
    res_stats["bn"] = bn_s
    for i in range(cfg.res_blocks):
        blk = {"conv1": {"kernel": conv1d(sd[f"upsample.resnet.layers.{i}.conv1.weight"])},
               "conv2": {"kernel": conv1d(sd[f"upsample.resnet.layers.{i}.conv2.weight"])}}
        b1p, b1s = batchnorm(sd, f"upsample.resnet.layers.{i}.batch_norm1")
        b2p, b2s = batchnorm(sd, f"upsample.resnet.layers.{i}.batch_norm2")
        blk["bn1"], blk["bn2"] = b1p, b2p
        res[f"res_{i}"] = blk
        res_stats[f"res_{i}"] = {"bn1": b1s, "bn2": b2s}
    res["conv_out"] = {"kernel": conv1d(sd["upsample.resnet.conv_out.weight"]),
                       "bias": sd["upsample.resnet.conv_out.bias"]}
    up["resnet"] = res
    up_stats["resnet"] = res_stats
    # smoothing convs: torch up_layers indices 1,3,5 are the Conv2d (1,1,(1,k))
    for li, i in enumerate(range(1, 2 * len(cfg.upsample_factors), 2)):
        w = sd[f"upsample.up_layers.{i}.weight"]  # (1,1,1,k) over (time) axis? torch kernel (1, k)
        # torch Conv2d kernel (out,in,kh,kw) with kh=1, kw=k over the TIME axis
        # of (B,1,M,T); ours convs over (B,T,M,1) with kernel (k,1)
        k = w.shape[-1]
        ours = np.transpose(w, (3, 2, 1, 0)).reshape(k, 1, 1, 1)
        up[f"up_conv_{li}"] = {"kernel": ours}
    p["upsample"] = up
    stats["upsample"] = up_stats

    p["I"] = {"kernel": dense(sd["I.weight"]), "bias": sd["I.bias"]}
    for name in ("rnn1", "rnn2"):
        p[name] = {"cell": torch_gru_to_flax(
            sd[f"{name}.weight_ih_l0"], sd[f"{name}.weight_hh_l0"],
            sd[f"{name}.bias_ih_l0"], sd[f"{name}.bias_hh_l0"], h)}
    for name in ("fc1", "fc2", "fc3"):
        p[name] = {"kernel": dense(sd[f"{name}.weight"]), "bias": sd[f"{name}.bias"]}
    return p, stats


# ---------------------------------------------------------------------------
# GE2E speaker encoder (`models/encoder/model.py`)
# ---------------------------------------------------------------------------

def convert_encoder(sd: Dict[str, np.ndarray], hidden: int = 256) -> Dict:
    """torch SpeakerEncoder state_dict → our params['model'] tree."""
    p: Dict = {}
    for layer in range(3):
        p[f"lstm_{layer}"] = torch_lstm_to_flax(
            sd[f"lstm.weight_ih_l{layer}"], sd[f"lstm.weight_hh_l{layer}"],
            sd[f"lstm.bias_ih_l{layer}"], sd[f"lstm.bias_hh_l{layer}"], hidden)
    p["linear"] = {"kernel": dense(sd["linear.weight"]), "bias": sd["linear.bias"]}
    return p


# ---------------------------------------------------------------------------
# Tacotron (`models/synthesizer/models/tacotron.py`)
# ---------------------------------------------------------------------------

def _convert_cbhg(sd: Dict[str, np.ndarray], prefix: str, K: int,
                  num_highways: int, bidir_hidden: int) -> tuple:
    p: Dict = {}
    stats: Dict = {}
    for i in range(K):
        bn_p, bn_s = batchnorm(sd, f"{prefix}.conv1d_bank.{i}.bnorm")
        p[f"bank_{i+1}"] = {"conv": {"kernel": conv1d(sd[f"{prefix}.conv1d_bank.{i}.conv.weight"])},
                            "bnorm": bn_p}
        stats[f"bank_{i+1}"] = {"bnorm": bn_s}
    for name in ("conv_project1", "conv_project2"):
        bn_p, bn_s = batchnorm(sd, f"{prefix}.{name}.bnorm")
        p[name] = {"conv": {"kernel": conv1d(sd[f"{prefix}.{name}.conv.weight"])},
                   "bnorm": bn_p}
        stats[name] = {"bnorm": bn_s}
    if f"{prefix}.pre_highway.weight" in sd:
        p["pre_highway"] = {"kernel": dense(sd[f"{prefix}.pre_highway.weight"])}
    for i in range(num_highways):
        p[f"highway_{i}"] = {
            "W1": {"kernel": dense(sd[f"{prefix}.highways.{i}.W1.weight"]),
                   "bias": sd[f"{prefix}.highways.{i}.W1.bias"]},
            "W2": {"kernel": dense(sd[f"{prefix}.highways.{i}.W2.weight"]),
                   "bias": sd[f"{prefix}.highways.{i}.W2.bias"]}}
    p["gru_fwd"] = torch_gru_to_flax(
        sd[f"{prefix}.rnn.weight_ih_l0"], sd[f"{prefix}.rnn.weight_hh_l0"],
        sd[f"{prefix}.rnn.bias_ih_l0"], sd[f"{prefix}.rnn.bias_hh_l0"], bidir_hidden)
    p["gru_bwd"] = torch_gru_to_flax(
        sd[f"{prefix}.rnn.weight_ih_l0_reverse"], sd[f"{prefix}.rnn.weight_hh_l0_reverse"],
        sd[f"{prefix}.rnn.bias_ih_l0_reverse"], sd[f"{prefix}.rnn.bias_hh_l0_reverse"],
        bidir_hidden)
    return p, stats


def _prenet(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    return {"fc1": {"kernel": dense(sd[f"{prefix}.fc1.weight"]), "bias": sd[f"{prefix}.fc1.bias"]},
            "fc2": {"kernel": dense(sd[f"{prefix}.fc2.weight"]), "bias": sd[f"{prefix}.fc2.bias"]}}


def convert_tacotron(sd: Dict[str, np.ndarray], cfg) -> tuple:
    """torch Tacotron state_dict → (params, batch_stats) for our Tacotron."""
    p: Dict = {}
    stats: Dict = {}

    enc: Dict = {"embedding": {"embedding": sd["encoder.embedding.weight"]},
                 "pre_net": _prenet(sd, "encoder.pre_net")}
    cbhg_p, cbhg_s = _convert_cbhg(sd, "encoder.cbhg", cfg.encoder_K,
                                   cfg.num_highways, cfg.encoder_dims // 2)
    enc["cbhg"] = cbhg_p
    p["encoder"] = enc
    stats["encoder"] = {"cbhg": cbhg_s}

    p["encoder_proj"] = {"kernel": dense(sd["encoder_proj.weight"])}

    if cfg.use_gst:
        g_enc: Dict = {}
        g_enc_s: Dict = {}
        for i in range(len(cfg.gst_ref_filters)):
            g_enc[f"conv_{i}"] = {"kernel": conv2d(sd[f"gst.encoder.convs.{i}.weight"]),
                                  "bias": sd[f"gst.encoder.convs.{i}.bias"]}
            bn_p, bn_s = batchnorm(sd, f"gst.encoder.bns.{i}")
            g_enc[f"bn_{i}"] = bn_p
            g_enc_s[f"bn_{i}"] = bn_s
        g_enc["gru"] = torch_gru_to_flax(
            sd["gst.encoder.gru.weight_ih_l0"], sd["gst.encoder.gru.weight_hh_l0"],
            sd["gst.encoder.gru.bias_ih_l0"], sd["gst.encoder.gru.bias_hh_l0"],
            cfg.gst_E // 2)
        p["gst"] = {"encoder": g_enc,
                    "stl": {"embed": sd["gst.stl.embed"],
                            "W_query": {"kernel": dense(sd["gst.stl.attention.W_query.weight"])},
                            "W_key": {"kernel": dense(sd["gst.stl.attention.W_key.weight"])},
                            "W_value": {"kernel": dense(sd["gst.stl.attention.W_value.weight"])}}}
        stats["gst"] = {"encoder": g_enc_s}

    dec: Dict = {"prenet": _prenet(sd, "decoder.prenet")}
    dec["attn_net"] = {
        "conv": {"kernel": conv1d(sd["decoder.attn_net.conv.weight"]),
                 "bias": sd["decoder.attn_net.conv.bias"]},
        "L": {"kernel": dense(sd["decoder.attn_net.L.weight"])},
        "W": {"kernel": dense(sd["decoder.attn_net.W.weight"]),
              "bias": sd["decoder.attn_net.W.bias"]},
        "v": {"kernel": dense(sd["decoder.attn_net.v.weight"])}}
    dec["attn_rnn"] = torch_gru_to_flax(
        sd["decoder.attn_rnn.weight_ih"], sd["decoder.attn_rnn.weight_hh"],
        sd["decoder.attn_rnn.bias_ih"], sd["decoder.attn_rnn.bias_hh"],
        cfg.decoder_dims)
    dec["rnn_input"] = {"kernel": dense(sd["decoder.rnn_input.weight"]),
                        "bias": sd["decoder.rnn_input.bias"]}
    for name in ("res_rnn1", "res_rnn2"):
        dec[name] = torch_lstm_to_flax(
            sd[f"decoder.{name}.weight_ih"], sd[f"decoder.{name}.weight_hh"],
            sd[f"decoder.{name}.bias_ih"], sd[f"decoder.{name}.bias_hh"],
            cfg.lstm_dims)
    dec["mel_proj"] = {"kernel": dense(sd["decoder.mel_proj.weight"])}
    dec["stop_proj"] = {"kernel": dense(sd["decoder.stop_proj.weight"]),
                        "bias": sd["decoder.stop_proj.bias"]}
    p["decoder"] = dec

    post_p, post_s = _convert_cbhg(sd, "postnet", cfg.postnet_K,
                                   cfg.num_highways, cfg.postnet_dims // 2)
    p["postnet"] = post_p
    stats["postnet"] = post_s
    p["post_proj"] = {"kernel": dense(sd["post_proj.weight"])}
    return p, stats


# ---------------------------------------------------------------------------
# VITS (`models/synthesizer/models/vits.py:389-527` + sublayer/vits_modules.py)
# ---------------------------------------------------------------------------

def _plain_conv1d(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    p = {"kernel": conv1d(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _vits_layernorm(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """reference vits LayerNorm stores gamma/beta (`vits_modules.py:13-25`)."""
    return {"scale": sd[f"{prefix}.gamma"], "bias": sd[f"{prefix}.beta"]}


def _convert_wn(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """reference WN (`vits_modules.py:104-177`) → our `modules.WN` tree."""
    t: Dict = {}
    if f"{prefix}.cond_layer.weight_v" in sd:
        _wn_entry(t, "cond_layer", wn_conv1d(sd, f"{prefix}.cond_layer"))
    i = 0
    while f"{prefix}.in_layers.{i}.weight_v" in sd:
        _wn_entry(t, f"in_layers_{i}", wn_conv1d(sd, f"{prefix}.in_layers.{i}"))
        _wn_entry(t, f"res_skip_layers_{i}",
                  wn_conv1d(sd, f"{prefix}.res_skip_layers.{i}"))
        i += 1
    return t


def _convert_ddsconv(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """reference DDSConv (`vits_modules.py:63-102`) → our `modules.DDSConv`."""
    t: Dict = {}
    i = 0
    while f"{prefix}.convs_sep.{i}.weight" in sd:
        t[f"convs_sep_{i}"] = _plain_conv1d(sd, f"{prefix}.convs_sep.{i}")
        t[f"convs_1x1_{i}"] = _plain_conv1d(sd, f"{prefix}.convs_1x1.{i}")
        t[f"norm1_{i}"] = _vits_layernorm(sd, f"{prefix}.norms_1.{i}")
        t[f"norm2_{i}"] = _vits_layernorm(sd, f"{prefix}.norms_2.{i}")
        i += 1
    return t


def _convert_convflow(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """reference ConvFlow (`vits_modules.py:339-383`) → our `modules.ConvFlow`."""
    return {"pre": _plain_conv1d(sd, f"{prefix}.pre"),
            "convs": _convert_ddsconv(sd, f"{prefix}.convs"),
            "proj": _plain_conv1d(sd, f"{prefix}.proj")}


def _convert_elementwise_affine(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """torch stores (C, 1); ours is (C,) (`vits_modules.py:273-289`)."""
    return {"m": sd[f"{prefix}.m"].reshape(-1),
            "logs": sd[f"{prefix}.logs"].reshape(-1)}


def _convert_sdp(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """StochasticDurationPredictor (`vits.py:15-94`). Torch flow list layout:
    flows.0 = ElementwiseAffine, flows.{1,3,5,7} = ConvFlow, even ≥2 = Flip."""
    t: Dict = {"pre": _plain_conv1d(sd, f"{prefix}.pre"),
               "proj": _plain_conv1d(sd, f"{prefix}.proj"),
               "convs": _convert_ddsconv(sd, f"{prefix}.convs"),
               "post_pre": _plain_conv1d(sd, f"{prefix}.post_pre"),
               "post_proj": _plain_conv1d(sd, f"{prefix}.post_proj"),
               "post_convs": _convert_ddsconv(sd, f"{prefix}.post_convs")}
    if f"{prefix}.cond.weight" in sd:
        t["cond"] = _plain_conv1d(sd, f"{prefix}.cond")
    t["flow_affine"] = _convert_elementwise_affine(sd, f"{prefix}.flows.0")
    t["post_affine"] = _convert_elementwise_affine(sd, f"{prefix}.post_flows.0")
    for i in range(4):
        t[f"flow_conv_{i}"] = _convert_convflow(sd, f"{prefix}.flows.{1 + 2 * i}")
        t[f"post_conv_{i}"] = _convert_convflow(sd, f"{prefix}.post_flows.{1 + 2 * i}")
    return t


def _convert_dp(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """Deterministic DurationPredictor (`vits.py:96-130`)."""
    t: Dict = {"conv_1": _plain_conv1d(sd, f"{prefix}.conv_1"),
               "conv_2": _plain_conv1d(sd, f"{prefix}.conv_2"),
               "norm_1": _vits_layernorm(sd, f"{prefix}.norm_1"),
               "norm_2": _vits_layernorm(sd, f"{prefix}.norm_2"),
               "proj": _plain_conv1d(sd, f"{prefix}.proj")}
    if f"{prefix}.cond.weight" in sd:
        t["cond"] = _plain_conv1d(sd, f"{prefix}.cond")
    return t


def _convert_text_encoder(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """TextEncoder (`vits.py:133-178`) incl. windowed-relative-attention
    transformer (`vits_modules.py:385-420, 473-560`)."""
    t: Dict = {"emb": {"embedding": sd["enc_p.emb.weight"]},
               "proj": _plain_conv1d(sd, "enc_p.proj")}
    if "enc_p.emo_proj.weight" in sd:
        t["emo_proj"] = {"kernel": dense(sd["enc_p.emo_proj.weight"]),
                         "bias": sd["enc_p.emo_proj.bias"]}
    enc: Dict = {}
    for i in range(cfg.n_layers):
        a = f"enc_p.encoder.attn_layers.{i}"
        enc[f"attn_{i}"] = {
            "conv_q": _plain_conv1d(sd, f"{a}.conv_q"),
            "conv_k": _plain_conv1d(sd, f"{a}.conv_k"),
            "conv_v": _plain_conv1d(sd, f"{a}.conv_v"),
            "conv_o": _plain_conv1d(sd, f"{a}.conv_o"),
            "emb_rel_k": sd[f"{a}.emb_rel_k"],
            "emb_rel_v": sd[f"{a}.emb_rel_v"],
        }
        enc[f"norm1_{i}"] = _vits_layernorm(sd, f"enc_p.encoder.norm_layers_1.{i}")
        enc[f"ffn_{i}"] = {
            "conv_1": _plain_conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1"),
            "conv_2": _plain_conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2")}
        enc[f"norm2_{i}"] = _vits_layernorm(sd, f"enc_p.encoder.norm_layers_2.{i}")
    t["encoder"] = enc
    return t


def _convert_vits_generator(sd: Dict[str, np.ndarray], cfg, prefix: str = "dec") -> Dict:
    """VITS decoder (`vits.py:245-297`): like HiFi-GAN but with a PLAIN
    conv_pre/conv_post (no weight norm) and a gin `cond` conv."""
    p: Dict = {"conv_pre": _plain_conv1d(sd, f"{prefix}.conv_pre")}
    if f"{prefix}.cond.weight" in sd:
        p["cond"] = _plain_conv1d(sd, f"{prefix}.cond")
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _wn_entry(p, f"ups_{i}", wn_conv_transpose1d(sd, f"{prefix}.ups.{i}"))
        for j in range(n_k):
            blk: Dict = {}
            flat = i * n_k + j
            if cfg.resblock == "1":
                for c in range(3):
                    _wn_entry(blk, f"convs1_{c}",
                              wn_conv1d(sd, f"{prefix}.resblocks.{flat}.convs1.{c}"))
                    _wn_entry(blk, f"convs2_{c}",
                              wn_conv1d(sd, f"{prefix}.resblocks.{flat}.convs2.{c}"))
            else:
                for c in range(2):
                    _wn_entry(blk, f"convs_{c}",
                              wn_conv1d(sd, f"{prefix}.resblocks.{flat}.convs.{c}"))
            p[f"resblock_{i}_{j}"] = blk
    p["conv_post"] = _plain_conv1d(sd, f"{prefix}.conv_post")
    return p


def convert_vits(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """torch Vits state_dict (a community `G_*.pth` 'model' entry) → params
    for `models.vits.Vits`."""
    p: Dict = {
        "enc_p": _convert_text_encoder(sd, cfg),
        "dec": _convert_vits_generator(sd, cfg, "dec"),
        "enc_q": {"pre": _plain_conv1d(sd, "enc_q.pre"),
                  "enc": _convert_wn(sd, "enc_q.enc"),
                  "proj": _plain_conv1d(sd, "enc_q.proj")},
    }
    flow: Dict = {}
    i = 0
    while f"flow.flows.{2 * i}.pre.weight" in sd:
        flow[f"coupling_{i}"] = {
            "pre": _plain_conv1d(sd, f"flow.flows.{2 * i}.pre"),
            "enc": _convert_wn(sd, f"flow.flows.{2 * i}.enc"),
            "post": _plain_conv1d(sd, f"flow.flows.{2 * i}.post")}
        i += 1
    p["flow"] = flow
    if cfg.use_sdp:
        p["dp"] = _convert_sdp(sd, "dp")
    else:
        p["dp"] = _convert_dp(sd, "dp")
    if "emb_g.weight" in sd:
        p["emb_g"] = {"embedding": sd["emb_g.weight"]}
    return p


# ---------------------------------------------------------------------------
# Fre-GAN generator (`models/vocoder/fregan/generator.py:79-168`)
# ---------------------------------------------------------------------------

def convert_fregan_generator(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """torch FreGAN state_dict → params for `models.vocoder.fregan.FreGanGenerator`."""
    p: Dict = {}
    _wn_entry(p, "conv_pre", wn_conv1d(sd, "conv_pre"))
    _wn_entry(p, "conv_post", wn_conv1d(sd, "conv_post"))
    n_k = len(cfg.resblock_kernel_sizes)
    n_up = len(cfg.upsample_rates)
    cond_level = n_up - cfg.top_k
    for i in range(n_up):
        _wn_entry(p, f"ups_{i}", wn_conv_transpose1d(sd, f"ups.{i}"))
        if i >= cond_level:
            _wn_entry(p, f"cond_up_{i - cond_level}",
                      wn_conv_transpose1d(sd, f"cond_up.{i - cond_level}"))
        if i > cond_level:
            # torch res_output.{n} is Sequential(Upsample, weight_norm(Conv1d))
            _wn_entry(p, f"res_output_{i - cond_level - 1}",
                      wn_conv1d(sd, f"res_output.{i - cond_level - 1}.1"))
        for j in range(n_k):
            blk: Dict = {}
            flat = i * n_k + j
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                _wn_entry(blk, f"convs1_{c}", wn_conv1d(sd, f"resblocks.{flat}.convs1.{c}"))
                _wn_entry(blk, f"convs2_{c}", wn_conv1d(sd, f"resblocks.{flat}.convs2.{c}"))
            p[f"resblock_{i}_{j}"] = blk
    return p


# ---------------------------------------------------------------------------
# PPG extractor ConformerEncoder (`models/ppg_extractor/encoder/`)
# ---------------------------------------------------------------------------

def _dense_entry(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    p = {"kernel": dense(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _ln_entry(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _pw_conv_to_dense(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """torch Conv1d kernel-1 (out,in,1) → flax Dense (in,out)."""
    return {"kernel": dense(sd[f"{prefix}.weight"][:, :, 0]),
            "bias": sd[f"{prefix}.bias"]}


def convert_conformer_encoder(sd: Dict[str, np.ndarray], cfg,
                              prefix: str = "encoder") -> tuple:
    """espnet-style ConformerEncoder state_dict → (params, batch_stats) for
    `models.ppg.extractor.ConformerEncoder` (`conformer_encoder.py:31-262`,
    `encoder_layer.py:55-140`, `convolution.py:27-74`, `attention.py:104-184`).

    Pass the PPGModel state_dict with prefix="encoder", or a bare encoder's
    with prefix=""."""
    pf = f"{prefix}." if prefix else ""
    p: Dict = {}
    stats: Dict = {}
    if f"{pf}embed.0.weight" in sd:                      # input_layer == linear
        p["embed"] = _dense_entry(sd, f"{pf}embed.0")
        p["embed_norm"] = _ln_entry(sd, f"{pf}embed.1")
    else:                                                # Conv2dNoSubsampling
        for i, ti in enumerate((0, 2)):
            w = sd[f"{pf}embed.conv.{ti}.weight"]        # (out,in,kh,kw)
            p[f"embed_conv_{i}"] = {"kernel": conv2d(w),
                                    "bias": sd[f"{pf}embed.conv.{ti}.bias"]}
        p["embed_out"] = _dense_entry(sd, f"{pf}embed.out.0")
    n = 0
    while f"{pf}encoders.{n}.norm_mha.weight" in sd:
        e = f"{pf}encoders.{n}"
        blk: Dict = {
            "ff_macaron_norm": _ln_entry(sd, f"{e}.norm_ff_macaron"),
            "ff_macaron_1": _dense_entry(sd, f"{e}.feed_forward_macaron.w_1"),
            "ff_macaron_2": _dense_entry(sd, f"{e}.feed_forward_macaron.w_2"),
            "attn_norm": _ln_entry(sd, f"{e}.norm_mha"),
            "attn": {
                "linear_q": _dense_entry(sd, f"{e}.self_attn.linear_q"),
                "linear_k": _dense_entry(sd, f"{e}.self_attn.linear_k"),
                "linear_v": _dense_entry(sd, f"{e}.self_attn.linear_v"),
                "linear_out": _dense_entry(sd, f"{e}.self_attn.linear_out"),
                "linear_pos": {"kernel": dense(sd[f"{e}.self_attn.linear_pos.weight"])},
                "pos_bias_u": sd[f"{e}.self_attn.pos_bias_u"],
                "pos_bias_v": sd[f"{e}.self_attn.pos_bias_v"],
            },
            "ff_norm": _ln_entry(sd, f"{e}.norm_ff"),
            "ff_1": _dense_entry(sd, f"{e}.feed_forward.w_1"),
            "ff_2": _dense_entry(sd, f"{e}.feed_forward.w_2"),
            "final_norm": _ln_entry(sd, f"{e}.norm_final"),
        }
        conv: Dict = {
            "norm": _ln_entry(sd, f"{e}.norm_conv"),
            "pw1": _pw_conv_to_dense(sd, f"{e}.conv_module.pointwise_conv1"),
            "dw": {"kernel": conv1d(sd[f"{e}.conv_module.depthwise_conv.weight"]),
                   "bias": sd[f"{e}.conv_module.depthwise_conv.bias"]},
            "pw2": _pw_conv_to_dense(sd, f"{e}.conv_module.pointwise_conv2"),
        }
        bn_p, bn_s = batchnorm(sd, f"{e}.conv_module.norm")
        conv["bn"] = bn_p
        blk["conv"] = conv
        p[f"block_{n}"] = blk
        stats[f"block_{n}"] = {"conv": {"bn": bn_s}}
        n += 1
    p["after_norm"] = _ln_entry(sd, f"{pf}after_norm")
    return p, stats


# ---------------------------------------------------------------------------
# PPG2Mel MelDecoderMOLv2 (`models/ppg2mel/__init__.py:20-209`,
# `rnn_decoder_mol.py`, `utils/mol_attention.py`, `utils/cnn_postnet.py`)
# ---------------------------------------------------------------------------

def convert_ppg2mel(sd: Dict[str, np.ndarray], cfg) -> tuple:
    """torch MelDecoderMOLv2 state_dict → (params, batch_stats) for
    `models.ppg.ppg2mel.MelDecoderMOLv2`."""
    def downstack(prefix: str) -> Dict:
        # torch Sequential indices: 0 conv1x1(no bias), 3/6 stride convs
        t: Dict = {"conv_in": {"kernel": conv1d(sd[f"{prefix}.0.weight"])}}
        for li, ti in enumerate((3, 6)):
            t[f"down_{li}"] = {"kernel": conv1d(sd[f"{prefix}.{ti}.weight"]),
                               "bias": sd[f"{prefix}.{ti}.bias"]}
        return t

    p: Dict = {
        "bnf_prenet": downstack("bnf_prenet"),
        "pitch_convs": downstack("pitch_convs"),
        "reduce_proj": {"kernel": dense(sd["reduce_proj.weight"]),
                        "bias": sd["reduce_proj.bias"]},
    }

    dec: Dict = {"prenet": {}}
    for i in range(len(cfg.prenet_dims)):
        dec["prenet"][f"fc{i}"] = {
            "kernel": dense(sd[f"decoder.prenet.layers.{i}.linear_layer.weight"])}
    dec["attention_rnn"] = torch_lstm_to_flax(
        sd["decoder.attention_rnn.weight_ih"], sd["decoder.attention_rnn.weight_hh"],
        sd["decoder.attention_rnn.bias_ih"], sd["decoder.attention_rnn.bias_hh"],
        cfg.attention_rnn_dim)
    dec["attention_layer"] = {
        "query_fc1": {"kernel": dense(sd["decoder.attention_layer.query_layer.0.weight"]),
                      "bias": sd["decoder.attention_layer.query_layer.0.bias"]},
        "query_fc2": {"kernel": dense(sd["decoder.attention_layer.query_layer.2.weight"]),
                      "bias": sd["decoder.attention_layer.query_layer.2.bias"]},
    }
    for i in range(cfg.num_decoder_rnn_layer):
        dec[f"decoder_rnn_{i}"] = torch_lstm_to_flax(
            sd[f"decoder.decoder_rnn_layers.{i}.weight_ih"],
            sd[f"decoder.decoder_rnn_layers.{i}.weight_hh"],
            sd[f"decoder.decoder_rnn_layers.{i}.bias_ih"],
            sd[f"decoder.decoder_rnn_layers.{i}.bias_hh"],
            cfg.decoder_rnn_dim)
    dec["linear_projection"] = {
        "kernel": dense(sd["decoder.linear_projection.linear_layer.weight"]),
        "bias": sd["decoder.linear_projection.linear_layer.bias"]}
    dec["stop_layer"] = {
        "kernel": dense(sd["decoder.stop_layer.linear_layer.weight"]),
        "bias": sd["decoder.stop_layer.linear_layer.bias"]}
    p["decoder"] = dec

    post: Dict = {}
    post_stats: Dict = {}
    n_layers = 5
    for i in range(n_layers):
        conv = {"kernel": conv1d(sd[f"postnet.convolutions.{i}.0.conv.weight"]),
                "bias": sd[f"postnet.convolutions.{i}.0.conv.bias"]}
        bn_p, bn_s = batchnorm(sd, f"postnet.convolutions.{i}.1")
        cname = f"conv_{i}" if i < n_layers - 1 else "conv_out"
        bname = f"bn_{i}" if i < n_layers - 1 else "bn_out"
        post[cname] = conv
        post[bname] = bn_p
        post_stats[bname] = bn_s
    p["postnet"] = post
    return p, {"postnet": post_stats}


def convert_wav2vec2_emotion(sd: Dict[str, np.ndarray], cfg,
                             prefix: str = "wav2vec2") -> Dict:
    """HF Wav2Vec2Model / reference EmotionExtractorModel state_dict →
    params for `models.wav2emo.EmotionExtractorModel`
    (`models/synthesizer/models/wav2emo.py:9-50`).

    Handles both `feat_extract_norm` variants, both encoder layouts
    (`do_stable_layer_norm`), weight-norm folding of the positional conv
    (torch dim=2 norm, i.e. per kernel-tap slice), and both torch
    weight-norm storages (`weight_g/weight_v` and
    `parametrizations.weight.original0/1`). The `classifier.*` head is
    converted when present (plain Wav2Vec2Model state_dicts get a
    zero-initialised head)."""
    pf = f"{prefix}." if prefix else ""
    fe: Dict = {}
    for i in range(len(cfg.conv_dim)):
        cl = f"{pf}feature_extractor.conv_layers.{i}"
        fe[f"conv_{i}"] = {"kernel": conv1d(sd[f"{cl}.conv.weight"])}
        if f"{cl}.conv.bias" in sd:
            fe[f"conv_{i}"]["bias"] = sd[f"{cl}.conv.bias"]
        if cfg.feat_extract_norm == "layer":
            fe[f"ln_{i}"] = _ln_entry(sd, f"{cl}.layer_norm")
        elif i == 0:
            fe["gn_0"] = _ln_entry(sd, f"{cl}.layer_norm")

    # positional conv: fold weight norm (dim=2 → norm over (out,in) per tap)
    pc = f"{pf}encoder.pos_conv_embed.conv"
    if f"{pc}.weight_v" in sd:
        v, g = sd[f"{pc}.weight_v"], sd[f"{pc}.weight_g"]
    else:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    norm = np.sqrt(np.sum(v ** 2, axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)           # (out, in/groups, k)
    pos_conv = {"kernel": conv1d(w), "bias": sd[f"{pc}.bias"]}

    layers: Dict = {}
    for i in range(cfg.num_hidden_layers):
        el = f"{pf}encoder.layers.{i}"
        layers[f"layer_{i}"] = {
            "attention": {
                name: _dense_entry(sd, f"{el}.attention.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm": _ln_entry(sd, f"{el}.layer_norm"),
            "final_layer_norm": _ln_entry(sd, f"{el}.final_layer_norm"),
            "feed_forward": {
                "intermediate_dense": _dense_entry(
                    sd, f"{el}.feed_forward.intermediate_dense"),
                "output_dense": _dense_entry(
                    sd, f"{el}.feed_forward.output_dense")},
        }

    encoder = {"pos_conv_embed": {"conv": pos_conv},
               "layer_norm": _ln_entry(sd, f"{pf}encoder.layer_norm"),
               **layers}

    w2v = {"feature_encoder": fe,
           "fp_layer_norm": _ln_entry(sd, f"{pf}feature_projection.layer_norm"),
           "fp_projection": _dense_entry(sd, f"{pf}feature_projection.projection"),
           "encoder": encoder}

    params: Dict = {"wav2vec2": w2v}
    if "classifier.dense.weight" in sd:
        params["cls_dense"] = _dense_entry(sd, "classifier.dense")
        params["cls_out_proj"] = _dense_entry(sd, "classifier.out_proj")
    else:
        h = sd[f"{pf}feature_projection.projection.weight"].shape[0]
        params["cls_dense"] = {"kernel": np.zeros((h, h), np.float32),
                               "bias": np.zeros((h,), np.float32)}
        params["cls_out_proj"] = {
            "kernel": np.zeros((h, cfg.num_labels), np.float32),
            "bias": np.zeros((cfg.num_labels,), np.float32)}
    return params
