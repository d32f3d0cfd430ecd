"""Carry the JAX package's parameters across into the port's modules.

A param tree is the flax layout as nested dicts of numpy arrays:
``{"params": {...}, "batch_stats": {...}}`` or a bare ``params`` dict. The
port's modules name their children exactly as the flax modules are named
(``encoder/cbhg/bank_1/conv``, ``rnn1/cell``, ...), so one walk over the
torch module tree maps every leaf; only the layouts differ:

  * flax ``Dense`` kernels are (in, out), ``nn.Linear`` weights (out, in);
  * flax convolutions are time-major: (k, in, out) and (kh, kw, in, out);
  * GRU gates r, z, n (flax ``ir/iz/in`` + ``hr/hz/hn``, biases on the input
    gates and ``hn``), fused into (in, 3h) / (h, 3h) blocks;
  * LSTM gates i, f, g, o (flax ``ii..io`` + ``hi..ho``, biases on the hidden
    gates), fused into (in, 4h) / (h, 4h) blocks;
  * BatchNorm ``scale``/``bias`` from ``params``, ``mean``/``var`` from
    ``batch_stats``.

The load is strict: a torch parameter with no flax leaf, a flax leaf no
torch parameter took, or a shape that differs, raises.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from .models.layers import FusedGRUCell, FusedLSTMLayer, GRULayer, LSTMCell


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


def _load(m: nn.Module, p: _Tree, s: Optional[_Tree]) -> None:
    if isinstance(m, nn.Linear):
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
        g = m.gru
        bn = _load_gru(g.weight_ih_l0, g.bias_ih_l0, g.weight_hh_l0, p)
        _set(g.bias_hh_l0, np.concatenate([np.zeros(2 * bn.size, np.float32), bn]),
             p.path + "/hn/bias")
    elif isinstance(m, FusedLSTMLayer):
        _load_lstm(m.lstm.weight_ih_l0, m.lstm.weight_hh_l0, m.lstm.bias_hh_l0, p)
    elif isinstance(m, LSTMCell):
        _load_lstm(m.cell.weight_ih, m.cell.weight_hh, m.cell.bias_hh, p)
    else:
        for name, prm in m.named_parameters(recurse=False):
            _set(prm, p.leaf(name), f"{p.path}/{name}")
        for name, child in m.named_children():
            if not any(True for _ in child.parameters()):
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
    """A framework-free export (``np.savez`` of ``flatten_tree``) → nested dict."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key].astype(np.float32)
    return tree
