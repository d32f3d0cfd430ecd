"""Monotonic alignment search (VITS MAS): the Hopper kernel and its plain
PyTorch version.

Port of ``mockingbird_tpu/ops/monotonic_align.py``. The kernel
(``csrc/monotonic_align.cu``) replaces the Pallas TPU kernel ``_mas_kernel``
of ``mockingbird_tpu/ops/monotonic_align_pallas.py``: per batch element, the
forward DP

    value[y, x] = neg_cent[y, x] + max(value[y-1, x], value[y-1, x-1])

inside the band ``t_x + y - t_y <= x <= min(y, t_x - 1)`` (cells outside it
hold exactly -1e9, staying is barred on the diagonal ``x == y``), then a
backtrack from ``(t_y - 1, t_x - 1)`` that steps left when ``x == y`` or
``value[y-1, x] < value[y-1, x-1]`` (strictly less), writing a one-hot path.

``maximum_path`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. The result is an argmax (a stop-gradient), so
no autograd function is needed.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e9


def _lengths(mask: torch.Tensor):
    mask_f = mask.float()
    t_ys = mask_f[:, :, 0].sum(dim=1).to(torch.int32)     # mel lengths
    t_xs = mask_f[:, 0, :].sum(dim=1).to(torch.int32)     # text lengths
    return mask_f, t_ys, t_xs


@torch.no_grad()
def maximum_path_plain(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                       t_xs: torch.Tensor) -> torch.Tensor:
    """The search as a row scan in torch ops (``_maximum_path_impl`` of the
    JAX package): neg_cent (B, T_y, T_x) f32, lengths (B,) → path (B, T_y,
    T_x) f32, one 1 per real row."""
    b, t_y, t_x = neg_cent.shape
    dev = neg_cent.device
    xs = torch.arange(t_x, device=dev)[None, :]
    t_ys = t_ys.to(dev, torch.int64)[:, None]
    t_xs = t_xs.to(dev, torch.int64)[:, None]
    neg = torch.full((b, 1), NEG, device=dev)
    values = torch.empty(b, t_y, t_x, device=dev)
    prev = torch.full((b, t_x), NEG, device=dev)
    for y in range(t_y):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        v_cur = torch.where(xs == y, NEG, prev)            # no stay on the diagonal
        best = torch.maximum(v_cur, shifted)
        if y == 0:
            best = torch.where(xs == 0, 0.0, NEG).expand(b, t_x)
        value = neg_cent[:, y] + best
        band_lo = t_xs + y - t_ys
        prev = torch.where((xs > y) | (xs < band_lo) | (xs >= t_xs), NEG, value)
        values[:, y] = prev

    path = torch.zeros(b, t_y, t_x, device=dev)
    rows = torch.arange(b, device=dev)
    index = (t_xs[:, 0] - 1).clamp(min=0)
    for y in range(t_y - 1, -1, -1):
        active = y < t_ys[:, 0]
        path[rows[active], y, index[active]] = 1.0
        if y > 0:
            v_here = values[rows, y - 1, index]
            v_left = values[rows, y - 1, (index - 1).clamp(min=0)]
            step = (index != 0) & ((index == y) | (v_here < v_left))
        else:
            step = torch.zeros_like(active)
        index = torch.where(active & step, index - 1, index)
    return path


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_mel, T_text); mask of the same shape in {0, 1} → the
    one-hot path times the mask, in the dtype of ``neg_cent``.

    Lengths come from the mask. The search runs in f32 whatever the
    caller's dtype (the path is an argmax: bf16 ties would perturb it). On
    CUDA tensors this launches the Hopper kernel (``maximum_path_cuda``); on
    CPU tensors it runs the plain version."""
    in_dtype = neg_cent.dtype
    mask_f, t_ys, t_xs = _lengths(mask)
    nc = (neg_cent.float() * mask_f).contiguous()
    dev = nc.device
    if dev.type == "cpu":
        path = maximum_path_plain(nc, t_ys, t_xs)
    elif dev.type == "cuda":
        path = maximum_path_cuda(nc, t_ys, t_xs)
    else:
        raise ValueError(f"maximum_path runs on cuda or cpu tensors, not {dev}")
    return (path * mask_f).to(in_dtype)


_SMEM_LIMIT = 232448


def smem_bytes(t_y: int, t_x: int) -> int:
    """The kernel's shared memory: with C = ceil(T_x / 32) columns per lane,
    one decision word of C bits per lane and row, of 1, 2 or 4 bytes."""
    c = max(1, -(-t_x // 32))
    word = 1 if c <= 8 else 2 if c <= 16 else 4
    return 32 * word * t_y


def maximum_path_cuda(neg_cent: torch.Tensor, t_ys: torch.Tensor,
                      t_xs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: neg_cent (B, T_y, T_x) f32 contiguous on the card,
    lengths (B,) → path (B, T_y, T_x) f32. Counts each launch in
    ``maximum_path_cuda.launches``; raises on what the kernel does not take."""
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path_cuda needs a CUDA tensor, not {neg_cent.device}")
    if neg_cent.dtype != torch.float32:
        raise TypeError(f"neg_cent must be float32, not {neg_cent.dtype}")
    if neg_cent.ndim != 3:
        raise ValueError(f"neg_cent must be (B, T_y, T_x), got {tuple(neg_cent.shape)}")
    if not neg_cent.is_contiguous():
        raise ValueError("neg_cent must be contiguous")
    b, t_y, t_x = neg_cent.shape
    if t_x > 1024:
        raise ValueError(f"T_x = {t_x} > 1024: one warp holds one row")
    if smem_bytes(t_y, t_x) > _SMEM_LIMIT:
        raise ValueError(f"(T_y, T_x) = ({t_y}, {t_x}) needs {smem_bytes(t_y, t_x)} B of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    dev = neg_cent.device
    t_ys = t_ys.to(dev, torch.int32).contiguous()
    t_xs = t_xs.to(dev, torch.int32).contiguous()
    if t_ys.shape != (b,) or t_xs.shape != (b,):
        raise ValueError(f"lengths {tuple(t_ys.shape)}/{tuple(t_xs.shape)}, expected ({b},)")
    path = torch.zeros_like(neg_cent)      # the kernel writes only the ones
    from .build import load
    lib = _bind(load("monotonic_align"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.maximum_path_launch(neg_cent.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
                                      path.data_ptr(), b, t_y, t_x, stream)
    if err != 0:
        raise RuntimeError(f"maximum_path kernel launch failed: CUDA error {err} "
                           f"({lib.maximum_path_error_string(err).decode()})")
    maximum_path_cuda.launches += 1
    return path


maximum_path_cuda.launches = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.maximum_path_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
        lib.maximum_path_error_string.argtypes = [i]
        lib.maximum_path_error_string.restype = ctypes.c_char_p
    return lib
