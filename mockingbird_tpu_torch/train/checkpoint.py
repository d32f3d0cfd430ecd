"""Step-numbered checkpoints with ``torch.save``.

The port's counterpart of ``mockingbird_tpu/train/checkpoint.py``'s
``CheckpointManager``, reduced to what the VITS and Tacotron trainers call:
``save`` (keeping the newest ``max_to_keep``, copying every
``backup_every``-th step aside; rank 0 alone writes) and ``restore_latest``
(every rank reads). A checkpoint is one
file ``<step>.pt`` holding a dict of state dicts.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from ..parallel import multihost


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, backup_every: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.backup_every = backup_every

    def steps(self):
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state: Any, force: bool = False) -> Path:
        """Write ``state`` as step ``step`` (atomically: a temporary file
        renamed into place), then drop all but the newest ``max_to_keep``.
        A step that is already saved raises ``FileExistsError`` unless
        ``force`` (then it is overwritten). Every ``backup_every``-th step
        is also copied to ``<directory>_backup_<step:06d>.pt`` beside the
        directory, which pruning never touches. In a multi-process run only
        rank 0 writes; the others return the path."""
        path = self.directory / f"{step}.pt"
        if not multihost.is_primary():
            return path
        if path.exists() and not force:
            raise FileExistsError(f"checkpoint of step {step} exists: {path}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        if self.backup_every and step % self.backup_every == 0:
            backup = self.directory.parent / f"{self.directory.name}_backup_{step:06d}.pt"
            if not backup.exists():
                shutil.copyfile(path, backup)
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
