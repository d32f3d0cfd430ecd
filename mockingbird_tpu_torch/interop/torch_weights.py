"""PyTorch state_dict → flax param tree (the layout ``weights.load_flax``
reads).

Port of the emotion part of ``mockingbird_tpu/interop/torch_weights.py``
(``convert_wav2vec2_emotion`` and the helpers it uses):

  * Conv1d      (out, in, k) → (k, in, out)
  * Linear      (out, in)    → (in, out)
  * LayerNorm / GroupNorm weight, bias → scale, bias
  * weight norm of the positional conv (torch ``dim=2``: the norm per
    kernel tap, over (out, in)) folded into a plain kernel, from either
    torch storage (``weight_g``/``weight_v`` or
    ``parametrizations.weight.original0/1``).

The converters take numpy arrays; ``state_dict_to_numpy`` turns torch
tensors into them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    return {k: v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()
            for k, v in state_dict.items()}


def conv1d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 1, 0))


def dense(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _dense_entry(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    p = {"kernel": dense(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def _ln_entry(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def convert_wav2vec2_emotion(sd: Dict[str, np.ndarray], cfg,
                             prefix: str = "wav2vec2") -> Dict:
    """HF Wav2Vec2Model / reference EmotionExtractorModel state_dict →
    params for ``models.wav2emo.EmotionExtractorModel``.

    Handles both ``feat_extract_norm`` variants and both encoder layouts
    (``do_stable_layer_norm``). The ``classifier.*`` head is converted when
    present; a plain Wav2Vec2Model state_dict gets a zero head."""
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

    # positional conv: fold weight norm (dim=2 → norm over (out, in) per tap)
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
