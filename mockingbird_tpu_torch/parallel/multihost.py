"""Data-parallel training across processes on ``torch.distributed``.

Port of ``mockingbird_tpu/parallel/multihost.py``. One process per card;
the data axis is the world of processes. The environment contract is the
JAX package's::

    MB_COORDINATOR=host0:12345 MB_NUM_PROCESSES=4 MB_PROCESS_ID=$i \\
        python -m mockingbird_tpu_torch.cli train-vits ...

or ``MB_MULTIHOST=auto`` for torchrun's variables (``init_method="env://"``);
``python -m mockingbird_tpu_torch.cli launch --nprocs N -- <command>``
starts N such processes on one host.

Where the JAX package writes one SPMD program and XLA inserts the
collectives, the port's trainers call them explicitly:

  * every rank builds the same global batch and takes its rows
    (``shard_global_batch``), or loads its own rows (``assemble_local_batch``,
    VITS's ``BucketBatcher(num_shards, shard_index)``);
  * inside ``sharded()`` (the training step's forward and loss) the batch is
    this rank's share of the global one: ``rand``/``randn`` draw at the
    global batch's shape and keep this rank's rows, so 2 ranks apply the
    masks 1 rank would; ``layers.FlaxBatchNorm`` takes the statistics of the
    global batch (``all_reduce_mean``); a masked sum divides by the global
    count (``global_count``); the GE2E loss sees every rank's embeddings
    (``all_gather``). The collectives carry their gradient: the backward of
    each sums over ranks what the ranks' losses ask of it;
  * ``average_gradients`` takes the mean of the gradients over ranks between
    ``backward`` and ``step`` (what JAX's psum does), so the update equals
    the single-process update of the global batch;
  * ``make_global`` broadcasts rank 0's parameters, buffers and optimizer
    state; rank 0 alone writes checkpoints, logs and samples.

Without a process group (or with one rank) every function here is the
identity of the single-process path.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

# the row layout of each open ``sharded()``, innermost last; process-wide,
# not thread-local: a backward inside the context recomputes checkpointed
# regions in autograd's own threads
_SHARDED: list = []


def initialize_from_env(device: Union[str, torch.device] = "cuda",
                        backend: Optional[str] = None) -> bool:
    """``init_process_group`` driven by the ``MB_*`` environment; a no-op
    returning False when it is unset. ``MB_COORDINATOR=<host:port>``,
    ``MB_NUM_PROCESSES`` and ``MB_PROCESS_ID`` start a ``tcp://`` group of
    that size and rank; ``MB_MULTIHOST=auto`` starts an ``env://`` group
    (torchrun's ``MASTER_ADDR``/``RANK``/``WORLD_SIZE``). ``backend``
    defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` otherwise. On a
    CUDA device each rank takes card ``(LOCAL_RANK or rank) % device_count``
    as its current device. Safe to call more than once."""
    if dist.is_available() and dist.is_initialized():
        return True
    coord = os.environ.get("MB_COORDINATOR")
    auto = os.environ.get("MB_MULTIHOST", "").lower() == "auto"
    if not coord and not auto:
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coord:
        world, rank = int(os.environ["MB_NUM_PROCESSES"]), int(os.environ["MB_PROCESS_ID"])
        dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world,
                                rank=rank)
    else:
        dist.init_process_group(backend, init_method="env://")
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that logs, checkpoints and samples (the reference's
    ``rank == 0`` guards)."""
    return process_index() == 0


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with the rank's card: a bare ``cuda`` becomes
    ``cuda:(LOCAL_RANK or rank) % device_count``; any other device is kept."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not torch.cuda.is_available():
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if is_initialized():
        dist.destroy_process_group()


def _comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it: NCCL takes CUDA tensors only."""
    if dist.get_backend() == "nccl" and t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _broadcast_(t: torch.Tensor) -> None:
    c = _comm(t.data)
    dist.broadcast(c, 0)
    if c is not t.data:
        t.data.copy_(c)


def make_global(*objects) -> None:
    """Broadcast rank 0's state into every rank, in place: the parameters
    and buffers of each ``nn.Module`` and the state of each optimizer (or
    scheduler-free state dict holder with ``.state``) given, so a resumed or
    freshly made state agrees on every rank. A no-op with one rank."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for obj in objects:
            if isinstance(obj, torch.nn.Module):
                for t in list(obj.parameters()) + list(obj.buffers()):
                    _broadcast_(t)
            else:   # an optimizer: its per-parameter state, in parameter order
                for group in obj.param_groups:
                    for p in group["params"]:
                        for v in obj.state.get(p, {}).values():
                            if torch.is_tensor(v):
                                _broadcast_(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_global_batch(batch):
    """This rank's rows of a host batch (an array or a dict of arrays) that
    every rank computed alike; 0-d leaves are kept whole. The identity with
    one rank."""
    n_proc = process_count()
    if n_proc == 1:
        return batch
    pid = process_index()

    def take(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x
        assert x.shape[0] % n_proc == 0, \
            f"global batch {x.shape[0]} not divisible by {n_proc} processes"
        rows = x.shape[0] // n_proc
        return x[pid * rows:(pid + 1) * rows]

    return _tree_map(take, batch)


def assemble_local_batch(local_batch):
    """Per-rank rows that each rank loaded itself (``BucketBatcher`` with
    ``num_shards``): the rank feeds them as they are, and their global batch
    is the concatenation of the ranks' rows in rank order. Every rank must
    collate the same shapes."""
    return local_batch


@contextlib.contextmanager
def sharded(strided: bool = False):
    """Within this context the step's batch is this rank's share of the
    global batch (see the module's docstring): its rows are the rank's
    contiguous block of the global batch (``shard_global_batch``), or with
    ``strided`` the global rows ``rank, rank + world, ...`` (what
    ``BucketBatcher(num_shards, shard_index)`` deals each rank), which
    decides the rows of a global draw it keeps. Nothing changes without a
    process group of more than one rank."""
    _SHARDED.append(strided)
    try:
        yield
    finally:
        _SHARDED.pop()


def active() -> bool:
    """True inside ``sharded()`` under a process group of more than one rank."""
    return bool(_SHARDED) and process_count() > 1


def _global_draw(fn, shape: Sequence[int], generator, device, dtype, batch_dim: int):
    shape = list(shape)
    if not active():
        return fn(shape, generator=generator, device=device, dtype=dtype)
    rows, n, r = shape[batch_dim], process_count(), process_index()
    shape[batch_dim] = rows * n
    full = fn(shape, generator=generator, device=device, dtype=dtype)
    if _SHARDED[-1]:
        return full.index_select(batch_dim, torch.arange(r, rows * n, n, device=full.device))
    return full.narrow(batch_dim, r * rows, rows)


def rand(shape: Sequence[int], generator=None, device=None, dtype=None,
         batch_dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)``; inside ``sharded()`` drawn at the global
    batch's shape (``batch_dim`` times the world) and narrowed to this
    rank's rows, so the ranks together draw what one process would."""
    return _global_draw(torch.rand, shape, generator, device, dtype, batch_dim)


def randn(shape: Sequence[int], generator=None, device=None, dtype=None,
          batch_dim: int = 0) -> torch.Tensor:
    """``torch.randn`` as ``rand`` draws."""
    return _global_draw(torch.randn, shape, generator, device, dtype, batch_dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _comm(x.contiguous().clone())
        dist.all_reduce(y)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.rows = dim, x.shape[dim]
        c = _comm(x.contiguous())
        parts = [torch.empty_like(c) for _ in range(process_count())]
        dist.all_gather(parts, c)
        return torch.cat(parts, dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss asks for every row: sum the asks, keep ours
        g = _AllReduceSum.apply(g)
        return g.narrow(ctx.dim, process_index() * ctx.rows, ctx.rows), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable (its backward sums the
    gradients over ranks); ``x`` inside ``sharded()``'s world of one."""
    return _AllReduceSum.apply(x) if active() else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over ranks, differentiable; ``x`` when not
    ``active()``. For equal shares this is the global batch's mean of a
    per-rank mean."""
    return _AllReduceSum.apply(x) / process_count() if active() else x


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order,
    differentiable; ``x`` when not ``active()``."""
    return _AllGather.apply(x, dim) if active() else x


def global_count(count: torch.Tensor, minimum: Optional[float] = None) -> torch.Tensor:
    """A local count (of a mask, of decoder steps) as the divisor of a local
    masked sum: the global count, clamped below at ``minimum`` when given,
    over the number of ranks. The mean over ranks of ``local_sum /
    global_count(local)`` is the global masked mean, which the gradient mean
    then matches. Without ``active()``: the count, clamped."""
    total = count
    if active():
        with torch.no_grad():
            total = _comm(count.detach().clone())
            dist.all_reduce(total)
            total = total.to(count.device)
    if minimum is not None:
        total = torch.clamp(total, min=minimum)
    return total / process_count() if active() else total


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """A detached value's mean over ranks, for the step's reported losses:
    the loss of the global batch. The identity with one rank."""
    if process_count() == 1:
        return x
    y = _comm(x.detach().clone().float())
    dist.all_reduce(y)
    return (y / process_count()).to(x.device, x.dtype)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean over ranks (one flat all-reduce
    per dtype), between ``backward`` and the optimizer. Parameters without
    a gradient are left so; every rank must have the same ones."""
    n = process_count()
    if n == 1:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _comm(torch.cat([g.reshape(-1) for g in grads]))
        dist.all_reduce(flat)
        flat /= n
        offset = 0
        for g in grads:
            k = g.numel()
            g.copy_(flat[offset:offset + k].view_as(g))
            offset += k
