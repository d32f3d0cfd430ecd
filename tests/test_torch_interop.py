"""The port's reference-checkpoint importer (``interop/``) against the JAX
package's.

The reference's torch classes are not in the repository, so a helper here
builds each family's reference-layout ``state_dict`` from a seeded JAX flax
tree (the inverse of the converter: transposes, gate concatenation, torch
weight norm with ``g = ||v||``). JAX's converter must give the tree back
(with weight-normed kernels in the canonical split the converter makes),
which checks the helper. Then, for all 8 families, the port's converter is
bitwise JAX's; ``import_reference_checkpoint`` of each torch container
writes the ``.npz`` that equals JAX's orbax import leaf for leaf; and for
HiFi-GAN, Tacotron, VITS and the GE2E encoder the port's loader of that
``.npz`` gives the output JAX gives from its own import, within each
family's tolerance (1e-4, as the port's parity tests of those models).
"""
import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.interop import import_checkpoint as jimport
from mockingbird_tpu.interop import torch_weights as jtw
from mockingbird_tpu.train.checkpoint import load_single
from mockingbird_tpu_torch.interop import import_checkpoint as timport
from mockingbird_tpu_torch.interop import reference_loader as tref
from mockingbird_tpu_torch.interop import torch_weights as ttw
from mockingbird_tpu_torch.weights import load_npz
from test_torch_vits import random_params

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4

HIFI = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]], num_mels=20,
            hop_size=16)
FREGAN = dict(upsample_rates=[2, 2, 2, 2], upsample_kernel_sizes=[4, 4, 4, 4],
              upsample_initial_channel=32, resblock_kernel_sizes=[3],
              resblock_dilation_sizes=[[1, 3]], num_mels=20, hop_size=16, top_k=3)
WAVERNN = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
               upsample_factors=[4, 4], hop_size=16, seq_len=16 * 4, pad=2)
TACOTRON = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32, lstm_dims=32,
                gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4), speaker_embedding_size=8,
                max_r=4, n_mels=20, fft_bins=20, prenet_dropout=False)
VITS = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
            upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=64,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]], spec_channels=65,
            segment_size=16 * 8, hop_size=16, n_speakers=4, gin_channels=16,
            emotion_channels=8, n_fft=128, win_size=128, num_mels=20)
PPG = dict(output_size=24, attention_heads=2, linear_units=48, num_blocks=2, cnn_kernel=7)
PPG2MEL = dict(encoder_dim=32, attention_rnn_dim=32, decoder_rnn_dim=32, prenet_dims=[32, 16],
               spk_embed_dim=16, bottle_neck_feature_dim=24, num_mels=20)


# ---------------------------------------------------------------------------
# seeded flax trees at the JAX modules' shapes
# ---------------------------------------------------------------------------

def _fill(shapes, rng):
    """``random_params`` for params; BatchNorm statistics mean ±0.2, var in
    [0.5, 1.5]; attention position biases ±0.3."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
        elif k == "mean":
            out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.startswith("pos_bias"):
            out[k] = (0.3 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = random_params({k: v}, rng)[k]
    return out


def _variables(init, seed):
    shapes = jax.eval_shape(init)
    rng = np.random.RandomState(seed)
    return {k: _fill(v, rng) for k, v in shapes.items()}


def _jcfg(module: str, fn: str, small: dict):
    return JConfig(getattr(importlib.import_module(f"mockingbird_tpu.models.{module}"), fn)()
                   ).merge(small)


def flax_tree(family: str) -> tuple:
    """(JAX config, variables {"params"[, "batch_stats"]}) of ``family``."""
    key = jax.random.PRNGKey(0)
    if family in ("hifigan", "fregan"):
        from mockingbird_tpu.models.vocoder.fregan import FreGanGenerator
        from mockingbird_tpu.models.vocoder.hifigan import Generator
        cfg = (_jcfg("vocoder.hifigan", "hifigan_config", HIFI) if family == "hifigan"
               else _jcfg("vocoder.fregan", "fregan_config", FREGAN))
        gen = (Generator if family == "hifigan" else FreGanGenerator)(cfg.freeze())
        v = _variables(lambda: gen.init(key, jnp.zeros((1, 8, 20))), 1)
    elif family == "wavernn":
        from mockingbird_tpu.models.vocoder.wavernn import WaveRNN
        cfg = _jcfg("vocoder.wavernn", "wavernn_config", WAVERNN)
        m = WaveRNN(cfg.freeze())
        v = _variables(lambda: m.init(key, jnp.zeros((1, 2 * cfg.hop_size)),
                                      jnp.zeros((1, 2 + 2 * cfg.pad, cfg.feat_dims))), 2)
    elif family == "encoder":
        from mockingbird_tpu.models.encoder.model import init_params
        cfg = None
        v = {"params": _variables(lambda: init_params(key)["model"], 3)}
    elif family == "tacotron":
        from mockingbird_tpu.models.tacotron.model import init_tacotron
        cfg = _jcfg("tacotron.model", "tacotron_config", TACOTRON)
        v = _variables(lambda: init_tacotron(key, cfg.clone())[1], 4)
    elif family == "vits":
        from mockingbird_tpu.models.vits.model import Vits
        cfg = _jcfg("vits.model", "vits_config", VITS)
        m = Vits(cfg.freeze())
        x = jnp.ones((1, 12), jnp.int32)
        v = _variables(lambda: m.init({"params": key, "dropout": key}, x, jnp.asarray([12]),
                                      jnp.zeros((1, 40, 65)), jnp.asarray([40]),
                                      jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8)),
                                      key=key, train=False), 5)
    elif family == "ppg_extractor":
        from mockingbird_tpu.models.ppg.extractor import PPGModel
        cfg = _jcfg("ppg.extractor", "ppg_config", PPG)
        m = PPGModel(cfg.freeze())
        v = _variables(lambda: m.init(key, jnp.zeros((1, 3200)), jnp.asarray([3200])), 6)
    else:
        from mockingbird_tpu.models.ppg.ppg2mel import init_ppg2mel
        cfg = _jcfg("ppg.ppg2mel", "ppg2mel_config", PPG2MEL)
        v = _variables(lambda: init_ppg2mel(key, cfg.clone())[1], 7)
    return cfg, v


# ---------------------------------------------------------------------------
# the inverse of the converters: flax tree → reference-layout state_dict
# ---------------------------------------------------------------------------

def _c1(k):            # flax (k, in, out) → torch Conv1d (out, in, k)
    return np.ascontiguousarray(np.transpose(k, (2, 1, 0)))


def _c2(k):            # flax (kh, kw, in, out) → torch Conv2d (out, in, kh, kw)
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _ct(k):            # flax (k, in, out) → torch ConvTranspose1d (in, out, k), reversed
    return np.ascontiguousarray(np.transpose(k, (1, 2, 0))[:, :, ::-1])


def _d(k):             # flax Dense (in, out) → torch Linear (out, in)
    return np.ascontiguousarray(k.T)


class SD(dict):
    """A state_dict under construction."""

    def conv(self, prefix, p, inv=_c1):
        self[f"{prefix}.weight"] = inv(p["kernel"])
        if "bias" in p:
            self[f"{prefix}.bias"] = p["bias"]

    def dense(self, prefix, p):
        self.conv(prefix, p, _d)

    def ln(self, prefix, p, names=("weight", "bias")):
        self[f"{prefix}.{names[0]}"], self[f"{prefix}.{names[1]}"] = p["scale"], p["bias"]

    def bn(self, prefix, p, s):
        self.ln(prefix, p)
        self[f"{prefix}.running_mean"], self[f"{prefix}.running_var"] = s["mean"], s["var"]
        self[f"{prefix}.num_batches_tracked"] = np.asarray(7, np.int64)

    def wn(self, prefix, tree, name, inv=_c1):
        """A flax WeightNorm pair → torch ``weight_g``/``weight_v`` with
        ``g = ||v||`` per dim-0 slice (so torch's weight is ``v``)."""
        conv, scale = tree[f"{name}_conv"], tree[name][f"{name}_conv/kernel/scale"]
        k = conv["kernel"]
        eff = k * scale / np.sqrt(np.sum(k.reshape(-1, k.shape[-1]) ** 2, axis=0))
        w = inv(eff.astype(np.float32))
        self[f"{prefix}.weight_v"] = w
        self[f"{prefix}.weight_g"] = np.sqrt(np.sum(w.reshape(w.shape[0], -1) ** 2, axis=1)
                                             ).reshape((-1,) + (1,) * (w.ndim - 1))
        if "bias" in conv:
            self[f"{prefix}.bias"] = conv["bias"]

    def gru(self, names, p):
        """``names`` = (w_ih, w_hh, b_ih, b_hh) keys; flax GRUCell gates."""
        h = p["hn"]["kernel"].shape[1]
        self[names[0]] = np.concatenate([_d(p[g]["kernel"]) for g in ("ir", "iz", "in")])
        self[names[1]] = np.concatenate([_d(p[g]["kernel"]) for g in ("hr", "hz", "hn")])
        self[names[2]] = np.concatenate([p[g]["bias"] for g in ("ir", "iz", "in")])
        self[names[3]] = np.concatenate([np.zeros(2 * h, np.float32), p["hn"]["bias"]])

    def lstm(self, names, p):
        gates = ("i", "f", "g", "o")
        self[names[0]] = np.concatenate([_d(p[f"i{g}"]["kernel"]) for g in gates])
        self[names[1]] = np.concatenate([_d(p[f"h{g}"]["kernel"]) for g in gates])
        self[names[2]] = np.concatenate([p[f"h{g}"]["bias"] for g in gates])
        self[names[3]] = np.zeros_like(self[names[2]])


def _rnn_names(prefix, suffix=""):
    return tuple(f"{prefix}.{w}{suffix}" for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


def _hifigan_like(sd, p, cfg, prefix="", plain_ends=False):
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        sd.wn(f"{prefix}ups.{i}", p, f"ups_{i}", _ct)
        for j in range(n_k):
            blk, flat = p[f"resblock_{i}_{j}"], i * n_k + j
            for c in range(3):
                sd.wn(f"{prefix}resblocks.{flat}.convs1.{c}", blk, f"convs1_{c}")
                sd.wn(f"{prefix}resblocks.{flat}.convs2.{c}", blk, f"convs2_{c}")


def sd_hifigan(v, cfg):
    sd, p = SD(), v["params"]
    sd.wn("conv_pre", p, "conv_pre")
    sd.wn("conv_post", p, "conv_post")
    _hifigan_like(sd, p, cfg)
    return sd


def sd_fregan(v, cfg):
    sd, p = SD(), v["params"]
    sd.wn("conv_pre", p, "conv_pre")
    sd.wn("conv_post", p, "conv_post")
    n_up, n_k = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    lvl = n_up - cfg.top_k
    for i in range(n_up):
        sd.wn(f"ups.{i}", p, f"ups_{i}", _ct)
        if i >= lvl:
            sd.wn(f"cond_up.{i - lvl}", p, f"cond_up_{i - lvl}", _ct)
        if i > lvl:
            sd.wn(f"res_output.{i - lvl - 1}.1", p, f"res_output_{i - lvl - 1}")
        for j in range(n_k):
            blk, flat = p[f"resblock_{i}_{j}"], i * n_k + j
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                sd.wn(f"resblocks.{flat}.convs1.{c}", blk, f"convs1_{c}")
                sd.wn(f"resblocks.{flat}.convs2.{c}", blk, f"convs2_{c}")
    return sd


def sd_wavernn(v, cfg):
    sd, p, s = SD(), v["params"], v["batch_stats"]
    res, rs = p["upsample"]["resnet"], s["upsample"]["resnet"]
    sd.conv("upsample.resnet.conv_in", res["conv_in"])
    sd.bn("upsample.resnet.batch_norm", res["bn"], rs["bn"])
    for i in range(cfg.res_blocks):
        blk, bs = res[f"res_{i}"], rs[f"res_{i}"]
        for n in (1, 2):
            sd.conv(f"upsample.resnet.layers.{i}.conv{n}", blk[f"conv{n}"])
            sd.bn(f"upsample.resnet.layers.{i}.batch_norm{n}", blk[f"bn{n}"], bs[f"bn{n}"])
    sd.conv("upsample.resnet.conv_out", res["conv_out"])
    for li, i in enumerate(range(1, 2 * len(cfg.upsample_factors), 2)):
        k = p["upsample"][f"up_conv_{li}"]["kernel"]
        sd[f"upsample.up_layers.{i}.weight"] = k.reshape(1, 1, 1, k.shape[0])
    sd.dense("I", p["I"])
    for name in ("rnn1", "rnn2"):
        sd.gru(_rnn_names(name, "_l0"), p[name]["cell"])
    for name in ("fc1", "fc2", "fc3"):
        sd.dense(name, p[name])
    return sd


def sd_encoder(v, cfg):
    sd, p = SD(), v["params"]
    for layer in range(3):
        sd.lstm(_rnn_names("lstm", f"_l{layer}"), p[f"lstm_{layer}"])
    sd.dense("linear", p["linear"])
    return sd


def _cbhg(sd, prefix, p, s, k, highways):
    for i in range(k):
        sd.conv(f"{prefix}.conv1d_bank.{i}.conv", p[f"bank_{i + 1}"]["conv"])
        sd.bn(f"{prefix}.conv1d_bank.{i}.bnorm", p[f"bank_{i + 1}"]["bnorm"],
              s[f"bank_{i + 1}"]["bnorm"])
    for name in ("conv_project1", "conv_project2"):
        sd.conv(f"{prefix}.{name}.conv", p[name]["conv"])
        sd.bn(f"{prefix}.{name}.bnorm", p[name]["bnorm"], s[name]["bnorm"])
    if "pre_highway" in p:
        sd.dense(f"{prefix}.pre_highway", p["pre_highway"])
    for i in range(highways):
        for w in ("W1", "W2"):
            sd.dense(f"{prefix}.highways.{i}.{w}", p[f"highway_{i}"][w])
    sd.gru(_rnn_names(f"{prefix}.rnn", "_l0"), p["gru_fwd"])
    sd.gru(_rnn_names(f"{prefix}.rnn", "_l0_reverse"), p["gru_bwd"])


def sd_tacotron(v, cfg):
    sd, p, s = SD(), v["params"], v["batch_stats"]
    enc = p["encoder"]
    sd["encoder.embedding.weight"] = enc["embedding"]["embedding"]
    for fc in ("fc1", "fc2"):
        sd.dense(f"encoder.pre_net.{fc}", enc["pre_net"][fc])
    _cbhg(sd, "encoder.cbhg", enc["cbhg"], s["encoder"]["cbhg"], cfg.encoder_K,
          cfg.num_highways)
    sd.dense("encoder_proj", p["encoder_proj"])
    if cfg.use_gst:
        g, gs = p["gst"]["encoder"], s["gst"]["encoder"]
        for i in range(len(cfg.gst_ref_filters)):
            sd.conv(f"gst.encoder.convs.{i}", g[f"conv_{i}"], _c2)
            sd.bn(f"gst.encoder.bns.{i}", g[f"bn_{i}"], gs[f"bn_{i}"])
        sd.gru(_rnn_names("gst.encoder.gru", "_l0"), g["gru"])
        stl = p["gst"]["stl"]
        sd["gst.stl.embed"] = stl["embed"]
        for w in ("W_query", "W_key", "W_value"):
            sd.dense(f"gst.stl.attention.{w}", stl[w])
    dec = p["decoder"]
    for fc in ("fc1", "fc2"):
        sd.dense(f"decoder.prenet.{fc}", dec["prenet"][fc])
    sd.conv("decoder.attn_net.conv", dec["attn_net"]["conv"])
    for w in ("L", "W", "v"):
        sd.dense(f"decoder.attn_net.{w}", dec["attn_net"][w])
    sd.gru(_rnn_names("decoder.attn_rnn"), dec["attn_rnn"])
    sd.dense("decoder.rnn_input", dec["rnn_input"])
    for name in ("res_rnn1", "res_rnn2"):
        sd.lstm(_rnn_names(f"decoder.{name}"), dec[name])
    sd.dense("decoder.mel_proj", dec["mel_proj"])
    sd.dense("decoder.stop_proj", dec["stop_proj"])
    _cbhg(sd, "postnet", p["postnet"], s["postnet"], cfg.postnet_K, cfg.num_highways)
    sd.dense("post_proj", p["post_proj"])
    return sd


def _vits_ln(sd, prefix, p):
    sd.ln(prefix, p, ("gamma", "beta"))


def _wn_module(sd, prefix, t):
    if "cond_layer" in t:
        sd.wn(f"{prefix}.cond_layer", t, "cond_layer")
    i = 0
    while f"in_layers_{i}" in t:
        sd.wn(f"{prefix}.in_layers.{i}", t, f"in_layers_{i}")
        sd.wn(f"{prefix}.res_skip_layers.{i}", t, f"res_skip_layers_{i}")
        i += 1


def _dds(sd, prefix, t):
    i = 0
    while f"convs_sep_{i}" in t:
        sd.conv(f"{prefix}.convs_sep.{i}", t[f"convs_sep_{i}"])
        sd.conv(f"{prefix}.convs_1x1.{i}", t[f"convs_1x1_{i}"])
        _vits_ln(sd, f"{prefix}.norms_1.{i}", t[f"norm1_{i}"])
        _vits_ln(sd, f"{prefix}.norms_2.{i}", t[f"norm2_{i}"])
        i += 1


def sd_vits(v, cfg):
    sd, p = SD(), v["params"]
    ep = p["enc_p"]
    sd["enc_p.emb.weight"] = ep["emb"]["embedding"]
    sd.conv("enc_p.proj", ep["proj"])
    if "emo_proj" in ep:
        sd.dense("enc_p.emo_proj", ep["emo_proj"])
    for i in range(cfg.n_layers):
        a, e = f"enc_p.encoder.attn_layers.{i}", ep["encoder"]
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            sd.conv(f"{a}.{c}", e[f"attn_{i}"][c])
        sd[f"{a}.emb_rel_k"], sd[f"{a}.emb_rel_v"] = (e[f"attn_{i}"]["emb_rel_k"],
                                                      e[f"attn_{i}"]["emb_rel_v"])
        _vits_ln(sd, f"enc_p.encoder.norm_layers_1.{i}", e[f"norm1_{i}"])
        for c in ("conv_1", "conv_2"):
            sd.conv(f"enc_p.encoder.ffn_layers.{i}.{c}", e[f"ffn_{i}"][c])
        _vits_ln(sd, f"enc_p.encoder.norm_layers_2.{i}", e[f"norm2_{i}"])
    dec = p["dec"]
    sd.conv("dec.conv_pre", dec["conv_pre"])
    if "cond" in dec:
        sd.conv("dec.cond", dec["cond"])
    _hifigan_like(sd, dec, cfg, "dec.")
    sd.conv("dec.conv_post", dec["conv_post"])
    sd.conv("enc_q.pre", p["enc_q"]["pre"])
    _wn_module(sd, "enc_q.enc", p["enc_q"]["enc"])
    sd.conv("enc_q.proj", p["enc_q"]["proj"])
    i = 0
    while f"coupling_{i}" in p["flow"]:
        c = p["flow"][f"coupling_{i}"]
        sd.conv(f"flow.flows.{2 * i}.pre", c["pre"])
        _wn_module(sd, f"flow.flows.{2 * i}.enc", c["enc"])
        sd.conv(f"flow.flows.{2 * i}.post", c["post"])
        i += 1
    dp = p["dp"]
    for c in ("pre", "proj", "post_pre", "post_proj", "cond"):
        if c in dp:
            sd.conv(f"dp.{c}", dp[c])
    _dds(sd, "dp.convs", dp["convs"])
    _dds(sd, "dp.post_convs", dp["post_convs"])
    for name, key in (("flows", "flow_affine"), ("post_flows", "post_affine")):
        sd[f"dp.{name}.0.m"] = dp[key]["m"].reshape(-1, 1)
        sd[f"dp.{name}.0.logs"] = dp[key]["logs"].reshape(-1, 1)
    for i in range(4):
        for name, key in (("flows", "flow_conv"), ("post_flows", "post_conv")):
            f, t = f"dp.{name}.{1 + 2 * i}", dp[f"{key}_{i}"]
            sd.conv(f"{f}.pre", t["pre"])
            _dds(sd, f"{f}.convs", t["convs"])
            sd.conv(f"{f}.proj", t["proj"])
    if "emb_g" in p:
        sd["emb_g.weight"] = p["emb_g"]["embedding"]
    return sd


def sd_ppg_extractor(v, cfg):
    sd, p, s = SD(), v["params"]["encoder"], v["batch_stats"]["encoder"]
    pf = "encoder."
    sd.dense(f"{pf}embed.0", p["embed"])
    sd.ln(f"{pf}embed.1", p["embed_norm"])
    n = 0
    while f"block_{n}" in p:
        b, e = p[f"block_{n}"], f"{pf}encoders.{n}"
        sd.ln(f"{e}.norm_ff_macaron", b["ff_macaron_norm"])
        sd.dense(f"{e}.feed_forward_macaron.w_1", b["ff_macaron_1"])
        sd.dense(f"{e}.feed_forward_macaron.w_2", b["ff_macaron_2"])
        sd.ln(f"{e}.norm_mha", b["attn_norm"])
        for w in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            sd.dense(f"{e}.self_attn.{w}", b["attn"][w])
        for w in ("pos_bias_u", "pos_bias_v"):
            sd[f"{e}.self_attn.{w}"] = b["attn"][w]
        sd.ln(f"{e}.norm_ff", b["ff_norm"])
        sd.dense(f"{e}.feed_forward.w_1", b["ff_1"])
        sd.dense(f"{e}.feed_forward.w_2", b["ff_2"])
        sd.ln(f"{e}.norm_final", b["final_norm"])
        c = b["conv"]
        sd.ln(f"{e}.norm_conv", c["norm"])
        for w, name in (("pw1", "pointwise_conv1"), ("pw2", "pointwise_conv2")):
            sd[f"{e}.conv_module.{name}.weight"] = _d(c[w]["kernel"])[:, :, None]
            sd[f"{e}.conv_module.{name}.bias"] = c[w]["bias"]
        sd.conv(f"{e}.conv_module.depthwise_conv", c["dw"])
        sd.bn(f"{e}.conv_module.norm", c["bn"], s[f"block_{n}"]["conv"]["bn"])
        n += 1
    sd.ln(f"{pf}after_norm", p["after_norm"])
    return sd


def sd_ppg2mel(v, cfg):
    sd, p, s = SD(), v["params"], v["batch_stats"]
    for name in ("bnf_prenet", "pitch_convs"):
        sd.conv(f"{name}.0", p[name]["conv_in"])
        for li, ti in enumerate((3, 6)):
            sd.conv(f"{name}.{ti}", p[name][f"down_{li}"])
    sd.dense("reduce_proj", p["reduce_proj"])
    dec = p["decoder"]
    for i in range(len(cfg.prenet_dims)):
        sd.dense(f"decoder.prenet.layers.{i}.linear_layer", dec["prenet"][f"fc{i}"])
    sd.lstm(_rnn_names("decoder.attention_rnn"), dec["attention_rnn"])
    sd.dense("decoder.attention_layer.query_layer.0", dec["attention_layer"]["query_fc1"])
    sd.dense("decoder.attention_layer.query_layer.2", dec["attention_layer"]["query_fc2"])
    for i in range(cfg.num_decoder_rnn_layer):
        sd.lstm(_rnn_names(f"decoder.decoder_rnn_layers.{i}"), dec[f"decoder_rnn_{i}"])
    sd.dense("decoder.linear_projection.linear_layer", dec["linear_projection"])
    sd.dense("decoder.stop_layer.linear_layer", dec["stop_layer"])
    for i in range(5):
        cname, bname = (f"conv_{i}", f"bn_{i}") if i < 4 else ("conv_out", "bn_out")
        sd.conv(f"postnet.convolutions.{i}.0.conv", p["postnet"][cname])
        sd.bn(f"postnet.convolutions.{i}.1", p["postnet"][bname], s["postnet"][bname])
    return sd


FAMILIES = {"hifigan": sd_hifigan, "fregan": sd_fregan, "wavernn": sd_wavernn,
            "encoder": sd_encoder, "tacotron": sd_tacotron, "vits": sd_vits,
            "ppg_extractor": sd_ppg_extractor, "ppg2mel": sd_ppg2mel}
# each family's own container in the reference (import_checkpoint.py's table)
CONTAINERS = {"encoder": "model_state", "tacotron": "model_state", "wavernn": "model_state",
              "hifigan": "generator", "fregan": "generator", "vits": "model",
              "ppg_extractor": None, "ppg2mel": "model"}


def convert(tw, family, sd, cfg):
    """(params[, batch_stats]) of ``tw``'s converter, as import_checkpoint calls it."""
    return {"hifigan": lambda: tw.convert_hifigan_generator(sd, cfg),
            "fregan": lambda: tw.convert_fregan_generator(sd, cfg),
            "wavernn": lambda: tw.convert_wavernn(sd, cfg),
            "encoder": lambda: tw.convert_encoder(sd),
            "tacotron": lambda: tw.convert_tacotron(sd, cfg),
            "vits": lambda: tw.convert_vits(sd, cfg),
            "ppg_extractor": lambda: tw.convert_conformer_encoder(sd, cfg, prefix="encoder"),
            "ppg2mel": lambda: tw.convert_ppg2mel(sd, cfg)}[family]()


def canonical(tree):
    """The weight-normed kernels as the converter splits a torch weight:
    the effective kernel and its norm per output feature."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            scale_key = f"{k}_conv/kernel/scale"
            if list(v) == [scale_key] and f"{k}_conv" in tree:
                kern = tree[f"{k}_conv"]["kernel"]
                eff = kern * v[scale_key] / np.sqrt(np.sum(kern.reshape(-1, kern.shape[-1]) ** 2,
                                                           axis=0))
                out[k] = {scale_key: np.sqrt(np.sum(eff.reshape(-1, eff.shape[-1]) ** 2, axis=0))}
            else:
                out[k] = canonical(v)
        else:
            out[k] = v
    for k, v in tree.items():
        if k.endswith("_conv") and isinstance(tree.get(k[:-5]), dict) \
                and f"{k}/kernel/scale" in tree[k[:-5]]:
            kern, scale = v["kernel"], tree[k[:-5]][f"{k}/kernel/scale"]
            out[k] = dict(v, kernel=kern * scale / np.sqrt(
                np.sum(kern.reshape(-1, kern.shape[-1]) ** 2, axis=0)))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_trees(a, b, exact=True, rtol=1e-5, atol=1e-6, what=""):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), f"{what}: {sorted(la.keys() ^ lb.keys())[:8]}"
    for k in la:
        if exact:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{what}{k}")
        else:
            np.testing.assert_allclose(la[k], lb[k], rtol=rtol, atol=atol, err_msg=f"{what}{k}")


@pytest.fixture(scope="module")
def cases():
    """family → (JAX config, seeded variables, reference-layout state_dict)."""
    out = {}
    for family, build in FAMILIES.items():
        cfg, v = flax_tree(family)
        out[family] = (cfg, v, build(v, cfg))
    return out


def _as_variables(converted):
    if isinstance(converted, tuple):
        return {"params": converted[0], "batch_stats": converted[1]}
    return {"params": converted}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_helper_state_dict_converts_back_to_the_tree(cases, family):
    """JAX's converter on the helper's state_dict gives the seeded tree
    back (weight-normed kernels in their canonical split)."""
    cfg, v, sd = cases[family]
    got = _as_variables(convert(jtw, family, sd, cfg.freeze() if cfg is not None else None))
    want = v
    if family == "ppg_extractor":
        got = {"params": {"encoder": got["params"]},
               "batch_stats": {"encoder": got["batch_stats"]}}
    assert_trees(got, canonical(want), exact=False, what=f"{family}: ")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_bitwise_equals_jax(cases, family):
    cfg, _, sd = cases[family]
    c = cfg.freeze() if cfg is not None else None
    assert_trees(_as_variables(convert(ttw, family, sd, c)),
                 _as_variables(convert(jtw, family, sd, c)), what=f"{family}: ")


def _save(path: Path, sd: dict, container):
    tensors = {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()}
    torch.save(tensors if container is None else {container: tensors, "step": 3}, path)
    return path


@pytest.mark.parametrize("container", ["model_state", "model", "generator", "state_dict", None])
def test_containers_load_as_jax(cases, tmp_path, container):
    """``_load_torch_state_dict`` unwraps each container as JAX's does."""
    _, _, sd = cases["hifigan"]
    path = _save(tmp_path / "g.pt", sd, container)
    got, want = timport._load_torch_state_dict(path), jimport._load_torch_state_dict(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_writes_jax_tree_as_npz(cases, tmp_path, family):
    """``import_reference_checkpoint`` of the family's container: the
    ``.npz`` holds JAX's orbax import leaf for leaf, and its ``.json``
    sidecar the family's config (none for the encoder)."""
    cfg, _, sd = cases[family]
    path = _save(tmp_path / f"{family}.pt", sd, CONTAINERS[family])
    out = timport.import_reference_checkpoint(family, path, tmp_path / "port", cfg,
                                              verbose=False)
    jimport.import_reference_checkpoint(family, path, tmp_path / "jax", cfg, verbose=False)
    assert out == tmp_path / "port.npz"
    assert_trees(load_npz(out), jax.tree.map(np.asarray, load_single(tmp_path / "jax")),
                 what=f"{family}: ")
    sidecar = out.with_suffix(".json")
    if family == "encoder":
        assert not sidecar.exists()
    else:
        side = json.loads(sidecar.read_text())
        for k, val in cfg.to_dict().items():
            assert side[k] == (list(val) if isinstance(val, tuple) else val), k


def _imports(cases, tmp_path, family):
    cfg, _, sd = cases[family]
    path = _save(tmp_path / f"{family}.pt", sd, CONTAINERS[family])
    npz = timport.import_reference_checkpoint(family, path, tmp_path / "port", verbose=False)
    jimport.import_reference_checkpoint(family, path, tmp_path / "jax", verbose=False)
    return npz, tmp_path / "jax"


def test_imported_hifigan_vocodes_as_jax(cases, tmp_path):
    """The port's ``GanVocoder`` of the imported ``.npz`` (its sidecar gives
    the config) against JAX's of its orbax import, f32."""
    from mockingbird_tpu.models.vocoder.inference import GanVocoder as JVoc
    from mockingbird_tpu_torch.models.vocoder.inference import GanVocoder as TVoc
    cfg, _, sd = cases["hifigan"]
    path = _save(tmp_path / "g_00001000", sd, "generator")
    npz = timport.import_reference_checkpoint("hifigan", path, tmp_path / "port", cfg,
                                              verbose=False)
    jimport.import_reference_checkpoint("hifigan", path, tmp_path / "jax", cfg, verbose=False)
    mel = np.random.RandomState(0).randn(20, 50).astype(np.float32)
    ref = JVoc("hifigan", tmp_path / "jax", cfg=cfg, verbose=False, half=False).infer_waveform(mel)
    out = TVoc("hifigan", npz, verbose=False, half=False, device="cpu").infer_waveform(mel)
    assert ref.shape == (50 * 16,) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_imported_tacotron_synthesizes_as_jax(cases, tmp_path):
    """The port's ``Synthesizer`` of the imported ``.npz`` (config from its
    sidecar) against JAX's of its orbax import: mels and alignments."""
    from mockingbird_tpu.models.tacotron import Synthesizer as JSynth
    from mockingbird_tpu_torch.models.tacotron import Synthesizer as TSynth
    cfg, _, sd = cases["tacotron"]
    path = _save(tmp_path / "taco.pt", sd, "model_state")
    npz = timport.import_reference_checkpoint("tacotron", path, tmp_path / "port", cfg,
                                              verbose=False)
    jimport.import_reference_checkpoint("tacotron", path, tmp_path / "jax", cfg, verbose=False)
    texts = ["ni3 hao3 shi4 jie4", "hello world"]
    embeds = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    kw = dict(steps=12, min_stop_token=5)
    ref = JSynth(tmp_path / "jax", cfg=cfg.clone(), verbose=False).synthesize_spectrograms(
        texts, embeds, **kw)
    out = TSynth(npz, verbose=False, device="cpu").synthesize_spectrograms(texts, embeds, **kw)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and np.abs(b).max() > 1e-2
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_imported_vits_infers_as_jax(cases, tmp_path):
    """The port's ``VitsSynthesizer`` of the imported ``.npz`` against JAX's
    ``Vits.infer`` on its orbax import, with the noise scales at 0 (no draw
    reaches the output): wav, durations, lengths."""
    from mockingbird_tpu.models.vits.model import Vits as JVits
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    cfg, _, sd = cases["vits"]
    path = _save(tmp_path / "G_100.pth", sd, "model")
    npz = timport.import_reference_checkpoint("vits", path, tmp_path / "port", cfg,
                                              verbose=False)
    jimport.import_reference_checkpoint("vits", path, tmp_path / "jax", cfg, verbose=False)
    rng = np.random.RandomState(2)
    x = rng.randint(1, 60, (2, 16)).astype(np.int32)
    xl = np.array([16, 11], np.int32)
    sid = np.array([1, 3], np.int32)
    emo = rng.randn(2, 8).astype(np.float32)
    kw = dict(noise_scale=0.0, noise_scale_w=0.0, length_scale=1.0, max_len=80)
    jv = {"params": jax.tree.map(jnp.asarray, load_single(tmp_path / "jax")["params"])}
    ref = jax.jit(lambda v, *a: JVits(cfg.freeze()).apply(
        v, *a, key=jax.random.PRNGKey(0), method=JVits.infer, **kw))(jv, x, xl, sid, emo)
    syn = VitsSynthesizer(npz, cfg=cfg.to_dict(), verbose=False, device="cpu")
    with torch.no_grad():
        out = syn.model.infer(torch.from_numpy(x).long(), torch.from_numpy(xl).long(),
                              torch.from_numpy(sid).long(), torch.from_numpy(emo), **kw,
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert np.abs(np.asarray(ref[0])).max() > 1e-3
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL, rtol=0)


def test_imported_encoder_embeds_as_jax(cases, tmp_path):
    """``SpeakerEncoderInference.from_checkpoint`` of the imported ``.npz``
    against JAX's of its orbax import (full width: the converter's)."""
    from mockingbird_tpu.models.encoder.inference import SpeakerEncoderInference as JEnc
    from mockingbird_tpu_torch.models.encoder.inference import SpeakerEncoderInference as TEnc
    npz, jax_path = _imports(cases, tmp_path, "encoder")
    frames = np.random.RandomState(3).randn(3, 40, 40).astype(np.float32)
    ref = JEnc.from_checkpoint(jax_path).embed_frames_batch(frames)
    out = TEnc.from_checkpoint(npz, device="cpu").embed_frames_batch(frames)
    assert ref.shape == (3, 256) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_cli_import_checkpoint(cases, tmp_path):
    """``cli import-checkpoint`` has JAX's family choices (no ``wav2emo``,
    which stays reachable through the function) and writes the ``.npz``
    that the function writes."""
    cfg, _, sd = cases["hifigan"]
    path = _save(tmp_path / "g.pt", sd, "generator")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", "cpu",
                          "import-checkpoint", "--family", "hifigan", "--torch-ckpt", str(path),
                          "--out", str(tmp_path / "cli"), "--config", str(tmp_path / "cfg.json")],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    direct = timport.import_reference_checkpoint("hifigan", path, tmp_path / "fn", cfg,
                                                 verbose=False)
    assert_trees(load_npz(tmp_path / "cli.npz"), load_npz(direct))
    from mockingbird_tpu.cli.main import build_parser as jparser
    from mockingbird_tpu_torch.cli.main import build_parser

    def choices(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return next(a for a in sub.choices["import-checkpoint"]._actions
                    if a.dest == "family").choices
    assert choices(build_parser()) == choices(jparser())
    assert "wav2emo" in timport.FAMILIES and timport.FAMILIES == jimport.FAMILIES


def test_reference_loader_copy():
    """The port's ``reference_loader`` is JAX's: the same stubs, loaders and
    fixed reference location; without the reference checkout it reports
    none (its torch classes are then untestable here, as
    ``tests/test_interop.py`` skips)."""
    from mockingbird_tpu.interop import reference_loader as jref
    assert tref._STUBS == jref._STUBS
    names = [n for n in dir(jref) if n.startswith("load_reference_")]
    assert len(names) == 8 and all(callable(getattr(tref, n)) for n in names)
    assert tref.REFERENCE_ROOT == jref.REFERENCE_ROOT
    assert tref.reference_available() == tref.REFERENCE_ROOT.exists()


@pytest.mark.skipif(not tref.reference_available(), reason="the reference checkout is absent")
def test_reference_hifigan_state_dict_converts_as_jax():
    """With the reference checkout: its own HiFi-GAN's state_dict through
    both converters."""
    cfg = JConfig(importlib.import_module("mockingbird_tpu.models.vocoder.hifigan")
                  .hifigan_config()).merge(HIFI)
    try:
        ref = tref.load_reference_hifigan_generator(cfg)
        sd = ttw.state_dict_to_numpy(ref.state_dict())
    finally:
        tref.teardown_reference_imports()
    assert_trees(ttw.convert_hifigan_generator(sd, cfg), jtw.convert_hifigan_generator(sd, cfg))
