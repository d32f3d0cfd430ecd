"""Seeded weights for one configuration, written as the ``.npz`` exports
that the port's loaders take and the reference reads, each beside a
``.json`` sidecar of its part of the configuration. The parts and their
leaves are the family's (``benchmark/families/<family>.py`` ``parts``).

The values are drawn on the device in one call (a ``torch.Generator`` there,
seeded from the run's seed) and shaped per leaf: dense and convolution
kernels N(0, 1/fan_in); biases N(0, 0.05²); weight-normed directions N(0, 1)
with gains 1 + N(0, 0.1²); BatchNorm scale 1 + N(0, 0.1²), bias and mean
N(0, 0.1²), variance 1 + 0.2·|N(0, 1)|; embeddings N(0, 1), style tokens
N(0, 0.5²); smoothing kernels the box 1/(2s + 1) they start from. A family
may add kinds of its own (``SHAPES``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import registry


def seed_of(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1), purpose]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _shape(view: torch.Tensor, key: str, shape, kind: str,
           extra: Optional[Dict[str, Callable]] = None) -> None:
    if extra and kind in extra:
        extra[kind](view, shape)
    elif kind == "kernel":
        view.mul_(float(np.prod(shape[:-1])) ** -0.5)
    elif kind == "bias":
        view.mul_(0.05)
    elif kind in ("wn_scale", "bn_scale"):
        view.mul_(0.1).add_(1.0)
    elif kind in ("bn_bias", "bn_mean"):
        view.mul_(0.1)
    elif kind == "bn_var":
        view.abs_().mul_(0.2).add_(1.0)
    elif kind == "gst_embed":
        view.mul_(0.5)
    elif kind == "box":
        view.fill_(1.0 / shape[0])
    elif kind not in ("wn_kernel", "embed"):
        raise ValueError(f"{key}: unknown kind {kind}")


def write(cfg: dict, seed: int, out_dir: Path, device) -> Dict[str, Path]:
    """Draw every part's weights and write ``<part>.npz`` + ``.json``
    into ``out_dir``; returns {part: path}."""
    out_dir = Path(out_dir)
    family = registry.family(cfg)
    plan = family.parts(cfg)
    extra = getattr(family, "SHAPES", None)
    total = sum(int(np.prod(s)) for _, _, leaves in plan for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    flat = torch.randn(total, generator=gen, device=device)
    offset = 0
    spans = []
    for _, _, leaves in plan:
        for key, shape, kind in leaves:
            n = int(np.prod(shape))
            _shape(flat[offset:offset + n].view(shape), key, shape, kind, extra)
            spans.append((key, shape, offset, n))
            offset += n
    host = flat.cpu().numpy()
    paths = {}
    it = iter(spans)
    for part, fname, leaves in plan:
        arrays = {}
        for _ in leaves:
            key, shape, o, n = next(it)
            arrays[key] = host[o:o + n].reshape(shape)
        path = out_dir / fname
        np.savez(path, **arrays)
        path.with_suffix(".json").write_text(json.dumps(cfg[part], indent=1))
        paths[part] = path
    return paths


def read(path: Path, device) -> Dict[str, torch.Tensor]:
    """An ``.npz`` written by ``write`` → {key: float32 tensor on device}."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}
