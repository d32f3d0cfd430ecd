"""The ranks as a ``('data', 'model')`` mesh, and batch placement.

Port of ``mockingbird_tpu/parallel/mesh.py``. The port's data parallelism is
one process per card (``multihost``), so the mesh is a description of the
ranks: ``data`` is the world of processes and ``model`` is 1 for every
trainer. ``parallel.shardings`` builds a ``torch.distributed`` device mesh
of any ``(data, model)`` split for tensor-parallel placement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import multihost


@dataclass(frozen=True)
class Mesh:
    """``shape`` maps the axis names ``data`` and ``model`` to their sizes."""
    shape: dict


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A ``('data', 'model')`` mesh over the ranks: by default every rank on
    the data axis."""
    n = multihost.process_count()
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model <= n, f"mesh {data}x{model} needs more than {n} ranks"
    return Mesh({"data": data, "model": model})


def shard_batch(mesh: Optional[Mesh], batch):
    """This rank's rows of a global host batch every rank computed alike;
    the batch itself without a mesh or a process group."""
    if mesh is None or multihost.process_count() == 1:
        return batch
    return multihost.shard_global_batch(batch)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
