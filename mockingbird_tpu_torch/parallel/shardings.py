"""Tensor-parallel placement rules.

Port of ``mockingbird_tpu/parallel/shardings.py``: large kernels go on the
``model`` axis along their widest divisible dimension, small tensors stay
replicated. ``param_spec`` is JAX's rule unchanged (a spec is a tuple of
axis names or None per dimension, as a ``PartitionSpec``); ``shard_params``
places each leaf of a parameter tree with ``distribute_tensor`` on an
``init_device_mesh`` of the ranks, ``Shard(d)`` on ``model`` or
``Replicate()``, and ``Replicate()`` on ``data``. As in the JAX package no
trainer calls it.
"""
from __future__ import annotations

from typing import Any

import numpy as np


def param_spec(path: tuple, leaf, mesh, min_size: int = 1024) -> tuple:
    """Shard the largest dimension divisible by the model-axis size.

    Small tensors (biases, norms) stay replicated; kernels big enough to
    matter get their widest divisible dim on 'model'. ``mesh`` is anything
    with ``shape["model"]``."""
    n_model = mesh.shape["model"]
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
    if n_model <= 1 or np.prod(shape, dtype=np.int64) < min_size or len(shape) == 0:
        return ()
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in dims:
        if shape[d] % n_model == 0 and shape[d] >= n_model * 8:
            spec = [None] * len(shape)
            spec[d] = "model"
            return tuple(spec)
    return ()


def device_mesh(mesh, device_type: str = "cuda"):
    """The ``torch.distributed`` device mesh of ``mesh``'s (data, model)
    split over the ranks of the process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (mesh.shape["data"], mesh.shape["model"]),
                            mesh_dim_names=("data", "model"))


def _placements(spec: tuple):
    from torch.distributed.tensor import Replicate, Shard
    model = next((Shard(d) for d, axis in enumerate(spec) if axis == "model"), Replicate())
    return [Replicate(), model]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def params_sharding_tree(params: Any, mesh, min_size: int = 1024) -> Any:
    """The placements (``[data, model]``: ``Replicate()`` or ``Shard(d)``)
    that ``shard_params`` gives each leaf of ``params``."""
    return _map_with_path(lambda path, leaf: _placements(param_spec(path, leaf, mesh, min_size)),
                          params)


def shard_params(params: Any, mesh, min_size: int = 1024, device_mesh_=None,
                 device_type: str = "cuda") -> Any:
    """Place each tensor of a parameter tree (nested dicts, lists or tuples)
    on the ranks per ``param_spec``, as ``DTensor``s of ``device_mesh_``
    (default ``device_mesh(mesh, device_type)``). Every rank passes the same
    full tensors; each keeps its shard."""
    from torch.distributed.tensor import distribute_tensor
    dm = device_mesh_ if device_mesh_ is not None else device_mesh(mesh, device_type)
    return _map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf, dm, _placements(param_spec(path, leaf, mesh, min_size))), params)
