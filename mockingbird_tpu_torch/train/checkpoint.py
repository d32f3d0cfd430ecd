"""Step-numbered checkpoints with ``torch.save``.

The port's counterpart of ``mockingbird_tpu/train/checkpoint.py``'s
``CheckpointManager``, reduced to what the VITS trainer calls: ``save``
(keeping the newest ``max_to_keep``) and ``restore_latest``. A checkpoint is
one file ``<step>.pt`` holding a dict of state dicts.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional, Tuple

import torch


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self):
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state: Any) -> Path:
        """Write ``state`` as step ``step`` (atomically: a temporary file
        renamed into place), then drop all but the newest ``max_to_keep``."""
        path = self.directory / f"{step}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.directory / f"{old}.pt").unlink()
        return path

    def restore_latest(self, map_location=None) -> Tuple[Optional[int], Any]:
        """(step, state) of the newest checkpoint; (None, None) when there is
        none."""
        steps = self.steps()
        if not steps:
            return None, None
        path = self.directory / f"{steps[-1]}.pt"
        return steps[-1], torch.load(path, map_location=map_location, weights_only=True)
