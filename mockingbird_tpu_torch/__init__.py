"""mockingbird_tpu_torch — the PyTorch/CUDA port of ``mockingbird_tpu``.

The JAX package stays beside it as the reference. This package imports
``torch``, numpy and scipy only: never ``jax``, ``flax``, ``orbax`` or any
module of ``mockingbird_tpu``. What it needs of the framework-free code there
(text frontend, host DSP, ``Config``) it keeps as its own copy.

Modules and names mirror the JAX package. Every entry point takes
``device=`` and defaults to ``"cuda"``; without a card it raises unless the
caller asks for ``device="cpu"``. There is no silent CPU fallback.

The hand-written Hopper kernels live under ``ops/`` (CUDA sources in
``ops/csrc``, built with ``nvcc`` on first use and loaded with ``ctypes``).
"""
from __future__ import annotations

import contextlib
from typing import Union

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device] = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when a CUDA device is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mockingbird_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def seeded(seed: int):
    """Initialise modules from ``seed`` without touching the global RNG."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield
