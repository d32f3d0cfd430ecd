"""What every trainer's step loop shares: a collated numpy batch moved to
the device, and the random generator of one step."""
from __future__ import annotations

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device`` (int32 → int64 indices)."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v).to(device)
            for k, v in batch.items()}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``, keyed by (seed, step) like
    ``fold_in(PRNGKey(seed), step)``."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)
