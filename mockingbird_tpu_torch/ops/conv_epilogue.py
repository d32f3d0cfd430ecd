"""The element-wise work after a convolution of a HiFi-GAN generator, in
one pass over channels-last memory: the hand-written kernel
(``csrc/conv_epilogue.cu``) and its plain PyTorch version.

Replaces no TPU kernel (the JAX package left this work to XLA). On a
convolution's product ``y`` (..., C), channels contiguous, it computes in
order, each step optional:

    x   = y + bias + residual                 (``keep_x`` returns it)
    s   = (block_sum + x) / n_blocks
    out = leaky_relu(s, slope)  or  tanh(s)

as PyTorch's separate operators compute it (the residual blocks' own
``forward`` in ``models/vocoder/hifigan.py``): below float32 each step
rounds to the storage type. ``conv_epilogue`` launches the kernel on a
CUDA tensor with gradients off (``uses_kernel``), where nothing needs an
autograd graph, and takes the plain version everywhere else; the plain
version is the kernel's yardstick on the card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_BIAS, _RESIDUAL, _SUM, _SCALE, _TANH, _LEAKY, _OUT_X, _OUT_SUM = (1 << k for k in range(8))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_counts = threading.local()

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def launches() -> int:
    """The kernel's launches so far on the calling thread (a thread's
    count, so that a caller can count its own call's launches while other
    threads launch too)."""
    return getattr(_counts, "n", 0)


def uses_kernel(y: torch.Tensor) -> bool:
    """Whether ``conv_epilogue`` launches the kernel on ``y``: on a card
    with gradients off. The kernel writes in place and records no autograd
    graph."""
    return y.is_cuda and not torch.is_grad_enabled()


def conv_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None,
                        block_sum: Optional[torch.Tensor] = None, n_blocks: int = 0,
                        slope: Optional[float] = None, tanh: bool = False,
                        keep_x: bool = False) -> Result:
    """``conv_epilogue`` as the unfused operators compute it."""
    x = y if bias is None else y + bias
    if residual is not None:
        x = x + residual
    v = x if block_sum is None else block_sum + x
    if n_blocks:
        v = v / n_blocks
    if tanh:
        v = torch.tanh(v)
    if slope is not None:
        v = F.leaky_relu(v, slope)
    return (x, v) if keep_x else v


def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  block_sum: Optional[torch.Tensor] = None, n_blocks: int = 0,
                  slope: Optional[float] = None, tanh: bool = False,
                  keep_x: bool = False) -> Result:
    """The chain above on ``y`` (..., C); ``bias`` (C,), ``residual`` and
    ``block_sum`` shaped as ``y``; ``n_blocks`` > 0 divides by it. Returns
    the chain's last value, or ``(x, last)`` with ``keep_x``.

    Where it launches the kernel (``uses_kernel``), the kernel writes in
    place where nothing reads the old values: the last value goes into
    ``y``, or into ``block_sum`` where that is given and no activation
    follows; with ``keep_x``, ``x`` goes into ``y`` and the last value into
    a new tensor. Raises on what the kernel does not take."""
    if not uses_kernel(y):
        return conv_epilogue_plain(y, bias, residual, block_sum, n_blocks, slope, tanh, keep_x)
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue takes float32 or bfloat16, not {y.dtype}")
    if not y.is_contiguous() or y.ndim < 1 or y.shape[-1] == 0:
        raise ValueError(f"y must be contiguous (..., C), got {tuple(y.shape)}")
    c = y.shape[-1]
    if bias is not None:
        bias = bias.to(y.dtype)     # as ``layers.promote`` hands it to the unfused add
    for name, t, shape in (("bias", bias, (c,)), ("residual", residual, y.shape),
                           ("block_sum", block_sum, y.shape)):
        if t is None:
            continue
        if t.device != y.device or t.dtype != y.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, y {y.dtype} on {y.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(shape)}, got {tuple(t.shape)}")
    if n_blocks < 0:
        raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
    flags = ((_BIAS if bias is not None else 0) | (_RESIDUAL if residual is not None else 0)
             | (_SUM if block_sum is not None else 0) | (_SCALE if n_blocks else 0)
             | (_TANH if tanh else 0) | (_LEAKY if slope is not None else 0))
    act = tanh or slope is not None
    out_x = out_sum = out_act = None
    if keep_x:
        out_x = y
        last = out_act = torch.empty_like(y)
        if not act:
            out_act = None
            out_sum = last
    elif act:
        last = out_act = y
    elif block_sum is not None:
        last = out_sum = block_sum
    else:
        last = out_x = y
    flags |= (_OUT_X if out_x is not None else 0) | (_OUT_SUM if out_sum is not None else 0)

    def ptr(t):
        return None if t is None else t.data_ptr()
    from .build import load
    lib = _bind(load("conv_epilogue"))
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.conv_epilogue_launch(ptr(y), ptr(bias), ptr(residual), ptr(block_sum),
                                       ptr(out_x), ptr(out_sum), ptr(out_act), y.numel(), c,
                                       _DTYPES[y.dtype], flags, float(slope or 0.0),
                                       n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error {err} "
                           f"({lib.conv_epilogue_error_string(err).decode()})")
    _counts.n = launches() + 1
    return (y, last) if keep_x else last


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.conv_epilogue_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int64, i, i, i, ctypes.c_float, i, p]
        fn.restype = i
        lib.conv_epilogue_error_string.argtypes = [i]
        lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib
