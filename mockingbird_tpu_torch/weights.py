"""Carry the JAX package's parameters across into the port's modules.

A param tree is the flax layout as nested dicts of numpy arrays:
``{"params": {...}, "batch_stats": {...}}`` or a bare ``params`` dict. The
port's modules name their children exactly as the flax modules are named
(``encoder/cbhg/bank_1/conv``, ``rnn1/cell``, ...), so one walk over the
torch module tree maps every leaf; only the layouts differ:

  * flax ``Dense`` kernels are (in, out), ``nn.Linear`` weights (out, in);
  * flax convolutions are time-major: (k, in, out) and (kh, kw, in, out);
    a depthwise conv's (k, 1, C) becomes torch's (C, 1, k) by the same
    move of axes, whatever its padding or stride;
  * a module's own parameters (the attention's ``pos_bias_u``) by name;
  * GRU gates r, z, n (flax ``ir/iz/in`` + ``hr/hz/hn``, biases on the input
    gates and ``hn``), fused into (in, 3h) / (h, 3h) blocks;
  * LSTM gates i, f, g, o (flax ``ii..io`` + ``hi..ho``, biases on the hidden
    gates), fused into (in, 4h) / (h, 4h) blocks;
  * BatchNorm ``scale``/``bias`` from ``params``, ``mean``/``var`` from
    ``batch_stats``; LayerNorm ``scale``/``bias``;
  * flax ``ConvTranspose`` kernels (k, in, out) are not flipped, torch's
    transposed conv flips: (in, out, k) reversed along k;
  * flax ``WeightNorm(Conv(name=<n>_conv), name=<n>)`` keeps the conv's
    ``kernel``/``bias`` under the sibling ``<n>_conv`` and the gain under
    ``<n>/"<n>_conv/kernel/scale"``; the port's weight-normed conv is one
    child ``<n>`` holding direction, bias and gain. A conv flax named
    automatically (``Conv_3``) carries that name as ``flax_name`` and takes
    the place of ``<n>_conv``;
  * flax ``SpectralNorm(Conv(name=<c>), name=<n>)`` keeps the kernel/bias
    under ``<c>`` in ``params`` and the power iteration's state under
    ``<n>/"<c>/kernel/u"`` and ``"<c>/kernel/sigma"`` in ``batch_stats``;
    the port's ``SpectralNorm`` child ``<n>`` holds the conv as ``layer``
    and the buffers ``u`` and ``sigma``.

The load is strict: a torch parameter with no flax leaf, a flax leaf no
torch parameter took, or a shape that differs, raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from .models.layers import (Conv1d, Conv2d, ConvTranspose1d, FusedGRUCell, FusedLSTMLayer,
                            GRULayer, LSTMCell, SpectralNorm)


class WeightMismatch(KeyError):
    """A param tree does not fit the module it is loaded into."""


class _Tree:
    """A view of one flax subtree that records which leaves were read."""

    def __init__(self, tree: dict, path: str, used: set):
        self.tree, self.path, self.used = tree, path, used

    def sub(self, key: str) -> "_Tree":
        if key not in self.tree or not isinstance(self.tree[key], dict):
            raise WeightMismatch(f"missing subtree {self.path}/{key}")
        return _Tree(self.tree[key], f"{self.path}/{key}", self.used)

    def has(self, key: str) -> bool:
        return key in self.tree

    def leaf(self, key: str) -> np.ndarray:
        head, _, rest = key.partition("/")
        if key not in self.tree and rest and isinstance(self.tree.get(head), dict):
            # an ``.npz`` export nests flax's "<n>_conv/kernel/scale" key by
            # its slashes; the recorded path is the same either way
            try:
                return self.sub(head).leaf(rest)
            except WeightMismatch:
                pass
        if key not in self.tree or isinstance(self.tree[key], dict):
            raise WeightMismatch(f"missing leaf {self.path}/{key}")
        self.used.add(f"{self.path}/{key}")
        return np.asarray(self.tree[key], np.float32)


def _leaves(tree: dict, path: str = "") -> set:
    out = set()
    for k, v in tree.items():
        p = f"{path}/{k}"
        out |= _leaves(v, p) if isinstance(v, dict) else {p}
    return out


def _set(t: torch.Tensor, value: np.ndarray, where: str) -> None:
    if tuple(t.shape) != tuple(value.shape):
        raise WeightMismatch(f"{where}: torch shape {tuple(t.shape)} vs flax {value.shape}")
    with torch.no_grad():
        t.copy_(torch.tensor(value))


def _cat(t: _Tree, names, key="kernel") -> np.ndarray:
    return np.concatenate([t.sub(n).leaf(key) for n in names], axis=-1)


def _load_gru(w_ih, b_ih, w_hh, t: _Tree):
    """flax GRU gates → fused (3h, in) / (3h, h) weights; returns b_hn."""
    _set(w_ih, _cat(t, ("ir", "iz", "in")).T, t.path + "/i*")
    _set(b_ih, _cat(t, ("ir", "iz", "in"), "bias"), t.path + "/i*/bias")
    _set(w_hh, _cat(t, ("hr", "hz", "hn")).T, t.path + "/h*")
    return t.sub("hn").leaf("bias")


def _load_lstm(w_ih, w_hh, b_hh, t: _Tree):
    _set(w_ih, _cat(t, ("ii", "if", "ig", "io")).T, t.path + "/i*")
    _set(w_hh, _cat(t, ("hi", "hf", "hg", "ho")).T, t.path + "/h*")
    _set(b_hh, _cat(t, ("hi", "hf", "hg", "ho"), "bias"), t.path + "/h*/bias")


def _load_conv(m: nn.Module, p: _Tree, scale: Optional[np.ndarray]) -> None:
    k = p.leaf("kernel")                            # (k.., in, out)
    if isinstance(m, ConvTranspose1d):
        w = np.flip(np.transpose(k, (1, 2, 0)), -1)
    else:
        w = np.moveaxis(k, (-1, -2), (0, 1))
    _set(m.weight, np.ascontiguousarray(w), p.path)
    if m.bias is not None:
        _set(m.bias, p.leaf("bias"), p.path + "/bias")
    if scale is not None:
        _set(m.scale, scale, p.path + "/scale")


def _conv_name(name: str, conv: nn.Module) -> str:
    """The flax name of a normed child ``name``'s conv."""
    return getattr(conv, "flax_name", None) or f"{name}_conv"


def _load(m: nn.Module, p: _Tree, s: Optional[_Tree]) -> None:
    if isinstance(m, (Conv1d, Conv2d, ConvTranspose1d)):
        _load_conv(m, p, None)
    elif isinstance(m, nn.LayerNorm):
        _set(m.weight, p.leaf("scale"), p.path)
        _set(m.bias, p.leaf("bias"), p.path + "/bias")
    elif isinstance(m, nn.Linear):
        _set(m.weight, p.leaf("kernel").T, p.path)
        if m.bias is not None:
            _set(m.bias, p.leaf("bias"), p.path + "/bias")
    elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
        k = p.leaf("kernel")                        # (k.., in, out)
        _set(m.weight, np.moveaxis(k, (-1, -2), (0, 1)), p.path)
        if m.bias is not None:
            _set(m.bias, p.leaf("bias"), p.path + "/bias")
    elif isinstance(m, nn.modules.batchnorm._BatchNorm):
        if s is None:
            raise WeightMismatch(f"{p.path}: BatchNorm needs batch_stats")
        _set(m.weight, p.leaf("scale"), p.path)
        _set(m.bias, p.leaf("bias"), p.path)
        _set(m.running_mean, s.leaf("mean"), s.path)
        _set(m.running_var, s.leaf("var"), s.path)
    elif isinstance(m, nn.Embedding):
        _set(m.weight, p.leaf("embedding"), p.path)
    elif isinstance(m, FusedGRUCell):
        bn = _load_gru(m.wi.weight, m.wi.bias, m.wh.weight, p)
        _set(m.bn, bn, p.path + "/hn/bias")
    elif isinstance(m, GRULayer):
        bn = _load_gru(m.weight_ih_l0, m.bias_ih_l0, m.weight_hh_l0, p)
        _set(m.bias_hn, bn, p.path + "/hn/bias")
    elif isinstance(m, FusedLSTMLayer):
        _load_lstm(m.weight_ih_l0, m.weight_hh_l0, m.bias_hh_l0, p)
    elif isinstance(m, LSTMCell):
        _load_lstm(m.weight_ih, m.weight_hh, m.bias_hh, p)
    else:
        for name, prm in m.named_parameters(recurse=False):
            _set(prm, p.leaf(name), f"{p.path}/{name}")
        for name, child in m.named_children():
            if not any(True for _ in child.parameters()):
                continue
            if isinstance(child, SpectralNorm):
                conv = _conv_name(name, child.layer)
                if s is None:
                    raise WeightMismatch(f"{p.path}/{name}: SpectralNorm needs batch_stats")
                _load_conv(child.layer, p.sub(conv), None)
                stats = s.sub(name)
                _set(child.u, stats.leaf(f"{conv}/kernel/u"), f"{stats.path}/{conv}/kernel/u")
                _set(child.sigma, stats.leaf(f"{conv}/kernel/sigma"),
                     f"{stats.path}/{conv}/kernel/sigma")
                continue
            if getattr(child, "weight_norm", False):
                conv = _conv_name(name, child)
                _load_conv(child, p.sub(conv), p.sub(name).leaf(f"{conv}/kernel/scale"))
                continue
            cs = s.sub(name) if s is not None and s.has(name) else None
            _load(child, p.sub(name), cs)


def load_flax(module: nn.Module, tree: Dict) -> nn.Module:
    """Load a flax tree (``{"params", "batch_stats"}`` or bare params) into
    ``module`` in place; strict on missing and extra leaves."""
    if "params" in tree and isinstance(tree["params"], dict):
        params, stats = tree["params"], tree.get("batch_stats", {})
    else:
        params, stats = tree, {}
    used: set = set()
    _load(module, _Tree(params, "params", used),
          _Tree(stats, "batch_stats", used) if stats else None)
    extra = (_leaves(params, "params") | _leaves(stats, "batch_stats")) - used
    if extra:
        raise WeightMismatch(f"leaves no module took: {sorted(extra)[:8]}"
                             f"{' ...' if len(extra) > 8 else ''}")
    return module


# ---------------------------------------------------------------------------
# The inverse: a port module → its flax tree
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _gates(w: torch.Tensor, names, bias: Optional[torch.Tensor] = None) -> Dict:
    """Fused (n·h, in) weight (+ (n·h,) bias) → flax per-gate {kernel(, bias)}."""
    ks = np.split(_np(w).T, len(names), axis=-1)
    bs = np.split(_np(bias), len(names)) if bias is not None else [None] * len(names)
    return {n: ({"kernel": k} if b is None else {"kernel": k, "bias": b})
            for n, k, b in zip(names, ks, bs)}


def _check_zero_slot(t: torch.Tensor, where: str) -> None:
    if bool(t.detach().ne(0).any()):
        raise WeightMismatch(f"{where}: a bias slot flax does not have is not zero")


def _dump_conv(m: nn.Module) -> Dict:
    w = _np(m.weight)
    if isinstance(m, ConvTranspose1d):
        k = np.transpose(np.flip(w, -1), (2, 0, 1))
    else:
        k = np.moveaxis(w, (0, 1), (-1, -2))
    out = {"kernel": np.ascontiguousarray(k)}
    if m.bias is not None:
        out["bias"] = _np(m.bias)
    return out


def _dump(m: nn.Module, path: str):
    """(params, batch_stats) subtrees of ``m``, the inverse of ``_load``."""
    if isinstance(m, (Conv1d, Conv2d, ConvTranspose1d, nn.Conv1d, nn.Conv2d)):
        return _dump_conv(m), None
    if isinstance(m, nn.LayerNorm):
        return {"scale": _np(m.weight), "bias": _np(m.bias)}, None
    if isinstance(m, nn.Linear):
        p = {"kernel": _np(m.weight).T.copy()}
        if m.bias is not None:
            p["bias"] = _np(m.bias)
        return p, None
    if isinstance(m, nn.modules.batchnorm._BatchNorm):
        return ({"scale": _np(m.weight), "bias": _np(m.bias)},
                {"mean": _np(m.running_mean), "var": _np(m.running_var)})
    if isinstance(m, nn.Embedding):
        return {"embedding": _np(m.weight)}, None
    if isinstance(m, (FusedGRUCell, GRULayer)):
        _check_zero_slot(m.bias_hh_rz, path + "/hr,hz/bias")
        if isinstance(m, GRULayer):
            w_ih, b_ih, w_hh, bn = m.weight_ih_l0, m.bias_ih_l0, m.weight_hh_l0, m.bias_hn
        else:
            w_ih, b_ih, w_hh, bn = m.wi.weight, m.wi.bias, m.wh.weight, m.bn
        p = {**_gates(w_ih, ("ir", "iz", "in"), b_ih), **_gates(w_hh, ("hr", "hz", "hn"))}
        p["hn"]["bias"] = _np(bn)
        return p, None
    if isinstance(m, (FusedLSTMLayer, LSTMCell)):
        if isinstance(m, LSTMCell):
            _check_zero_slot(m.bias_ih, path + "/i*/bias")
            w_ih, w_hh, b_hh = m.weight_ih, m.weight_hh, m.bias_hh
        else:
            _check_zero_slot(m.bias_ih_l0, path + "/i*/bias")
            w_ih, w_hh, b_hh = m.weight_ih_l0, m.weight_hh_l0, m.bias_hh_l0
        return {**_gates(w_ih, ("ii", "if", "ig", "io")),
                **_gates(w_hh, ("hi", "hf", "hg", "ho"), b_hh)}, None
    params: Dict = {name: _np(prm) for name, prm in m.named_parameters(recurse=False)}
    stats: Dict = {}
    for name, child in m.named_children():
        if not any(True for _ in child.parameters()):
            continue
        if isinstance(child, SpectralNorm):
            conv = _conv_name(name, child.layer)
            params[conv] = _dump_conv(child.layer)
            stats[name] = {f"{conv}/kernel/u": _np(child.u),
                           f"{conv}/kernel/sigma": _np(child.sigma)}
            continue
        if getattr(child, "weight_norm", False):
            conv = _conv_name(name, child)
            params[conv] = _dump_conv(child)
            params[name] = {f"{conv}/kernel/scale": _np(child.scale)}
            continue
        p, s = _dump(child, f"{path}/{name}")
        params[name] = p
        if s:
            stats[name] = s
    return params, stats or None


def to_flax(module: nn.Module) -> Dict:
    """The inverse of ``load_flax``: ``module``'s parameters and BatchNorm
    running statistics as the flax tree ``{"params", "batch_stats"}`` of
    float32 numpy arrays (``batch_stats`` only where the module has any).
    Raises ``WeightMismatch`` if a bias slot flax does not have is not
    zero."""
    params, stats = _dump(module, "params")
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def save_npz(path: Union[str, Path], tree: Dict) -> None:
    """Write a tree as the ``.npz`` export ``load_npz`` reads (the port's
    counterpart of the JAX package's ``save_single``)."""
    np.savez(path, **flatten_tree(tree))


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict → {"a/b/c": array}, the key layout of an ``.npz`` export."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def load_npz(path: Union[str, Path]) -> Dict:
    """A framework-free export (``np.savez`` of ``flatten_tree``) → nested dict.
    A path that does not exist raises ``FileNotFoundError`` (``np.load``'s):
    weights made from a seed come only from passing no path."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key].astype(np.float32)
    return tree
