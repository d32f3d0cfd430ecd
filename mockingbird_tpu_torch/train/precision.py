"""bf16 mixed-precision policy for training.

Port of ``mockingbird_tpu/train/precision.py``, with its semantics:

  * master parameters, optimizer state and losses stay float32;
  * the model computes in bfloat16 because its parameters and floating
    inputs are *cast* to bfloat16 inside the loss function (not autocast):
    ``apply`` runs the module through ``torch.func.functional_call`` with
    cast parameters, and the cast is differentiable, so the gradients reach
    the f32 master parameters;
  * outputs are uncast to float32 before the loss math;
  * no loss scaling: bfloat16 has float32's exponent range.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.func import functional_call


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested tuple/list/dict to ``dtype``;
    integer tensors and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree


@dataclass(frozen=True)
class Policy:
    """``cast`` moves a tree to the compute dtype, ``uncast`` brings results
    back to f32; ``apply`` calls a module with its parameters cast."""
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_name(name: str) -> "Policy":
        name = (name or "fp32").lower()
        if name in ("fp32", "float32", "f32"):
            return Policy(torch.float32)
        if name in ("bf16", "bfloat16", "mixed"):
            return Policy(torch.bfloat16)
        raise ValueError(f"unknown precision {name!r} (use 'fp32' or 'bf16')")

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != torch.float32

    def cast(self, tree):
        return cast_floating(tree, self.compute_dtype) if self.is_mixed else tree

    def uncast(self, tree):
        return cast_floating(tree, torch.float32) if self.is_mixed else tree

    def apply(self, module: torch.nn.Module, *args, method: Optional[str] = None, **kwargs):
        """``module(*args, **kwargs)`` (or its method ``method``) with
        parameters and floating positional inputs cast to the compute dtype;
        outputs uncast. Keyword arguments (options, draws handed in, inputs
        flax receives uncast) pass as they are, as the JAX step passes its
        key and flags."""
        if not self.is_mixed:
            return (module if method is None else getattr(module, method))(*args, **kwargs)
        params = {k: v.to(self.compute_dtype) for k, v in module.named_parameters()}
        if method is not None:
            module = _Bound(module, method)
            params = {f"m.{k}": v for k, v in params.items()}
        out = functional_call(module, params, self.cast(args), kwargs)
        return self.uncast(out)


class _Bound(torch.nn.Module):
    """``module``'s method ``method`` as the forward of a module, for
    ``functional_call``."""

    def __init__(self, module: torch.nn.Module, method: str):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)
