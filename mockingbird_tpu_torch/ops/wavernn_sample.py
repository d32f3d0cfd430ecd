"""Fused WaveRNN autoregressive sampling: the Hopper kernel and its plain
PyTorch version.

Port of ``mockingbird_tpu/ops/wavernn_sample.py``. The kernel
(``csrc/wavernn_sample.cu``) replaces the Pallas TPU kernels ``_kernel_v2``
(time-major conditioning) and ``_kernel`` (fold-major, ``time_major=False``):
per step, for F independent folds, I-dense → GRU1 → GRU2 → fc1 → fc2 → fc3
→ Gumbel-max (or greedy argmax) sample fed back as the next input, the whole
T-step loop inside one launch.

The kernel is persistent and weight-stationary: one cooperative launch of
at most one block per SM, in clusters of 4, each block holding its slice of
every weight matrix in shared memory for the whole launch and exchanging
layer outputs with the others through global memory between grid barriers.
With bf16 weights its products run on the tensor cores (``wgmma``), each
layer's exchanged rows and conditioning columns streamed through a ring of
64-fold tiles in shared memory (``cond_tiles`` lays the conditioning out as
those tiles); f32 weights (the parity mode) take staged FMA tiles. ``plan``
places the slices, a pure function of the widths, the fold count, the
weight dtype and the blocks the card keeps resident in clusters of 4
(``resident_blocks``).

``wavernn_sample`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors. Weight layout matches flax ``nn.GRUCell``
(r = σ(ir·x + hr·h), z = σ(iz·x + hz·h), n = tanh(in·x + r·(hn·h + bn)),
h' = (1−z)·n + z·h); ``pack_wavernn_weights`` fuses it from the port's
``WaveRNN`` module.

Sampling draws its random bits from Philox4x32-10 keyed by the seed, with
the counter (class, fold, step, 0), in the kernel and in the plain version
alike, so that a sampled run of the kernel can be held label by label
against the plain one.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

_MASK32 = 0xFFFFFFFF
_counts = threading.local()
# Gumbel noise for this many (step, fold, class) entries at a time
_NOISE_CHUNK = 1 << 22

W_NAMES = ("I_w", "I_b", "g1_wi", "g1_bi", "g1_wh", "g1_bn",
           "g2_wi", "g2_bi", "g2_wh", "g2_bn",
           "fc1_w", "fc1_b", "fc2_w", "fc2_b", "fc3_w", "fc3_b")


SMEM_LIMIT = 232448      # dynamic shared memory one block may use on sm_90
CLUSTER = 4              # blocks per cluster: they share the staging of exchanged rows
TILE = 64                # bf16: folds per tile (wgmma's M) and columns per tile
MIN_SLOTS, MAX_SLOTS = 8, 32  # bf16: tiles in the shared-memory ring


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Plan:
    """Where the kernel's launch puts things: ``grid`` blocks, each owning
    ``nu`` GRU units (their I, g1 and g2 rows), ``nv`` columns of fc1 and of
    fc2 and ``nq`` classes of fc3; ``smem`` bytes of shared memory per block;
    workspaces of ``exchange_elems`` (weight dtype), ``arg_elems`` (uint64)
    and ``state_elems`` (f32) elements; ``exchange_bytes`` written to the
    exchange buffers per step (by all blocks) and ``staged_bytes`` copied
    from them into shared memory per step (summed over blocks; a cluster's
    blocks share one read from L2). ``grid`` is a multiple of ``CLUSTER``;
    blocks past the last owner own nothing.

    bf16 weights: every layer's input streams through a ring of ``slots``
    tiles of ``TILE`` folds x ``TILE`` columns, all ``folds`` in one pass
    (``fold_tiles``; ``fchunk`` is their span); f32 weights: activations
    staged ``fchunk`` folds at a time (``slots`` 0)."""
    grid: int
    nu: int
    nv: int
    nq: int
    folds: int
    fchunk: int
    slots: int
    smem: int
    exchange_elems: int
    arg_elems: int
    state_elems: int
    exchange_bytes: int
    staged_bytes: int

    def owned(self, width: int, per_block: int) -> List[Tuple[int, int]]:
        """The [start, stop) column range of each block for a layer of
        ``width`` columns sliced ``per_block`` at a time (empty when past)."""
        return [(min(b * per_block, width), min((b + 1) * per_block, width))
                for b in range(self.grid)]

    def fold_tiles(self) -> List[Tuple[int, int]]:
        """The [start, stop) folds of each pass of a layer's product: bf16,
        the ``TILE``-fold tiles of wgmma's M side (the last ragged when
        ``folds`` is not a multiple of it); f32, the stages."""
        step = TILE if self.slots else self.fchunk
        return [(f, min(f + step, self.folds)) for f in range(0, self.folds, step)]


def _smem_bytes(rows, ks, ksmax, fchunk, nbias, wbytes) -> int:
    """``layout`` in csrc/wavernn_sample.cu (f32): weight slices, the
    activation stage [fchunk][ksmax], the f32 biases, then the staging
    mbarrier, 16-byte aligned."""
    elems = sum(r * k for r, k in zip(rows, ks)) + fchunk * ksmax
    return _ceil(_ceil(elems * wbytes, 16) * 16 + 4 * nbias, 16) * 16 + 16


def _ring_blocks(rnn: int, fc: int, aux_d: int, n_mels: int):
    """bf16: the 64-column K blocks of each weight slice of ``ring_layout``,
    the exchanged columns, then the conditioning columns, and I's x."""
    kr, kf, ka, ki = (_ceil(k, TILE) for k in (rnn, fc, aux_d, n_mels + aux_d))
    return (ki + 1, kr, kr, kr + ka, kr, kr + ka, kf + ka, kf)


def _ring_weight_bytes(rows, blocks) -> int:
    """bf16: the swizzled weight slices of ``ring_layout``, each [blocks][n][64]
    with its rows padded to n, a multiple of 8 (wgmma's N)."""
    return sum(_ceil(r, 8) * 8 * b * TILE * 2 for r, b in zip(rows, blocks))


def _ring_bytes(weight_bytes, slots, nbias) -> int:
    """``ring_layout`` in csrc/wavernn_sample.cu (bf16): the weight slices,
    the ring, the f32 biases, the ring's two mbarriers a slot, and 1024 bytes
    to align the base to the swizzle's period."""
    tiles = slots * TILE * TILE * 2
    return _ceil(weight_bytes + tiles + 4 * nbias, 16) * 16 + 16 * slots + 1024


def plan(rnn: int, fc: int, n_classes: int, aux_d: int, n_mels: int, n_folds: int,
         dtype: torch.dtype, max_blocks: int) -> Plan:
    """The launch plan of the kernel for these widths, ``n_folds`` folds,
    weights of ``dtype`` and a card that keeps ``max_blocks`` blocks
    resident in clusters of ``CLUSTER`` (``resident_blocks``; at most its SM
    count). Raises ``ValueError`` when that is less than one cluster, or a
    block's slices and one 8-fold stage (f32) or ``MIN_SLOTS`` ring tiles
    (bf16) do not fit in shared memory, or (bf16) a slice is wider than
    wgmma's N of 32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, not {dtype}")
    wb = 2 if dtype == torch.bfloat16 else 4
    cap = max_blocks // CLUSTER * CLUSTER
    if cap < CLUSTER:
        raise ValueError(f"the sampler cannot place a cluster of {CLUSTER} blocks on a card "
                         f"that keeps {max_blocks} resident")
    g = min(cap, max(rnn, fc, n_classes))
    nu, nv, nq = _ceil(rnn, g), _ceil(fc, g), _ceil(n_classes, g)
    g = _ceil(max(_ceil(rnn, nu), _ceil(fc, nv), _ceil(n_classes, nq)), CLUSTER) * CLUSTER
    k0 = 1 + n_mels + aux_d
    rows = (nu, 3 * nu, 3 * nu, 3 * nu, 3 * nu, nv, nv, nq)
    nbias = 9 * nu + 2 * nv + nq
    what = f"rnn={rnn}, fc={fc}, classes={n_classes} in {dtype} on {max_blocks} blocks"
    f = n_folds
    rs, fs = _ceil(rnn, 8) * 8, _ceil(fc, 8) * 8
    # a layer runs in every block of a cluster that owns some of it
    unit_blocks, fc_blocks, class_blocks = (_ceil(_ceil(width, per), CLUSTER) * CLUSTER
                                            for width, per in ((rnn, nu), (fc, nv),
                                                               (n_classes, nq)))
    if wb == 2:
        if max(_ceil(r, 8) * 8 for r in rows) > 32:
            raise ValueError(f"the sampler cannot place {what}: a slice of more than 32 rows")
        kr, kf, ka, ki = (_ceil(k, TILE) for k in (rnn, fc, aux_d, n_mels + aux_d))
        weights = _ring_weight_bytes(rows, _ring_blocks(rnn, fc, aux_d, n_mels))
        slots = MAX_SLOTS
        while slots >= MIN_SLOTS and _ring_bytes(weights, slots, nbias) > SMEM_LIMIT:
            slots -= 1
        if slots < MIN_SLOTS:
            raise ValueError(
                f"the sampler cannot place {what}: a block's weight slices and {MIN_SLOTS} ring "
                f"tiles need {_ring_bytes(weights, MIN_SLOTS, nbias)} B of shared memory, "
                f"more than {SMEM_LIMIT}")
        mt = _ceil(max(f, 1), TILE)
        return Plan(grid=g, nu=nu, nv=nv, nq=nq, folds=f, fchunk=mt * TILE, slots=slots,
                    smem=_ring_bytes(weights, slots, nbias),
                    exchange_elems=2 * mt * (5 * kr + 2 * kf) * TILE * TILE, arg_elems=2 * f,
                    state_elems=g * f * (12 * nu + nq),
                    exchange_bytes=f * wb * (5 * rnn + 2 * fc) + 8 * f,
                    # the rows of folds < F of every tile a block takes
                    staged_bytes=f * TILE * wb * (unit_blocks * (4 * kr + ki + ka)
                                                  + fc_blocks * (kr + kf + 2 * ka)
                                                  + class_blocks * kf) + g * 8 * f)
    ks = [_ceil(k, 16) * 16 + 16 // wb
          for k in (k0, rnn, rnn, rnn + aux_d, rnn, rnn + aux_d, fc + aux_d, fc)]
    fchunk = _ceil(max(n_folds, 1), 8) * 8
    while fchunk >= 8 and _smem_bytes(rows, ks, max(ks), fchunk, nbias, wb) > SMEM_LIMIT:
        fchunk -= 8
    if fchunk < 8:
        raise ValueError(
            f"the sampler cannot place {what}: a block's weight slices and one 8-fold stage need "
            f"{_smem_bytes(rows, ks, max(ks), 8, nbias, wb)} B of shared memory, "
            f"more than {SMEM_LIMIT}")
    return Plan(grid=g, nu=nu, nv=nv, nq=nq, folds=f, fchunk=fchunk, slots=0,
                smem=_smem_bytes(rows, ks, max(ks), fchunk, nbias, wb),
                exchange_elems=2 * f * (5 * rs + 2 * fs), arg_elems=2 * f,
                state_elems=g * f * (12 * nu + nq),
                exchange_bytes=f * wb * (5 * rnn + 2 * fc) + 8 * f,
                staged_bytes=f * wb * (unit_blocks * 4 * rnn + fc_blocks * (rnn + fc)
                                       + class_blocks * fc) + g * 8 * f)


def pack_wavernn_weights(model, dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The port's ``WaveRNN`` → fused (in, out) matrices for the sampler:
    I (in, rnn) + bias, per-GRU fused input/hidden kernels (·, 3·rnn) with
    gate order [r, z, n] and the ``hn`` bias, fc1/fc2/fc3 (+ biases)."""
    def gru(cell):
        return cell.wi.weight.T, cell.wi.bias, cell.wh.weight.T, cell.bn

    g1 = gru(model.rnn1.cell)
    g2 = gru(model.rnn2.cell)
    out = dict(zip(W_NAMES, (
        model.I.weight.T, model.I.bias, *g1, *g2,
        model.fc1.weight.T, model.fc1.bias, model.fc2.weight.T, model.fc2.bias,
        model.fc3.weight.T, model.fc3.bias)))
    return {k: v.detach().to(dtype).contiguous() for k, v in out.items()}


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a · m`` for int64 ``a`` < 2**32 and a
    32-bit constant ``m``, exact in int64: ``a`` is split into 16-bit halves."""
    lo_part = (a & 0xFFFF) * m                       # < 2**48
    hi_part = (a >> 16) * m                          # < 2**48
    s = ((hi_part & 0xFFFF) << 16) + lo_part         # < 2**49
    return (hi_part >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors (or ints) that
    hold 32-bit words; counters broadcast against each other. Returns the
    four output words, as the kernel's ``philox`` computes the first."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def gumbel_noise(seed: int, t0: int, t1: int, n_folds: int, n_classes: int,
                 device) -> torch.Tensor:
    """(t1 − t0, F, C) f32 Gumbel noise of steps t0 ≤ t < t1, bit for bit the
    kernel's: 32 Philox bits per (class, fold, step), 23 of them as a uniform
    + 1e-7, then −log(−log u)."""
    seed = int(seed) & (2**64 - 1)
    i64 = dict(dtype=torch.int64, device=device)
    bits = philox4x32_10(torch.arange(n_classes, **i64)[None, None, :],
                         torch.arange(n_folds, **i64)[None, :, None],
                         torch.arange(t0, t1, **i64)[:, None, None], 0,
                         seed & _MASK32, seed >> 32)[0]
    uni = (bits & 0x7FFFFF).float() * (1.0 / (1 << 23)) + 1e-7
    return -torch.log(-torch.log(uni))


def wavernn_sample_plain(weights: Dict[str, torch.Tensor], mels: torch.Tensor,
                         aux: torch.Tensor, seed: int, n_classes: int = 512,
                         greedy: bool = False, return_gaps: bool = False):
    """The sampler as a Python loop over T of the same step in torch ops.

    mels (F, T, 80), aux (F, T, 4·aux_d) → labels (F, T) int32. Activations
    are rounded to the weight dtype before each product and accumulated in
    f32, as the kernel does. Sampling adds the kernel's own Gumbel noise
    (``gumbel_noise``). With ``return_gaps`` also returns the (F, T) gap
    between the two highest scores of each step, noise included."""
    wdt = weights["I_w"].dtype
    w = {k: v.float() for k, v in weights.items()}
    rnn = w["I_w"].shape[1]
    aux_d = aux.shape[-1] // 4
    f, t_len, _ = mels.shape
    dev = mels.device

    def rnd(a):
        return a.to(wdt).float()

    def gru(x, h, p):
        gx = rnd(x) @ w[p + "_wi"] + w[p + "_bi"]
        gh = rnd(h) @ w[p + "_wh"]
        r = torch.sigmoid(gx[:, :rnn] + gh[:, :rnn])
        z = torch.sigmoid(gx[:, rnn:2 * rnn] + gh[:, rnn:2 * rnn])
        n = torch.tanh(gx[:, 2 * rnn:] + r * (gh[:, 2 * rnn:] + w[p + "_bn"]))
        return (1.0 - z) * n + z * h

    mels_c, aux_c = rnd(mels), rnd(aux)
    chunk = max(1, _NOISE_CHUNK // (f * n_classes))
    x = torch.zeros(f, 1, device=dev)
    h1 = torch.zeros(f, rnn, device=dev)
    h2 = torch.zeros(f, rnn, device=dev)
    labels = torch.empty(f, t_len, dtype=torch.int32, device=dev)
    gaps = torch.empty(f, t_len, device=dev) if return_gaps else None
    for t in range(t_len):
        a1, a2, a3, a4 = aux_c[:, t].split(aux_d, dim=1)
        u = rnd(torch.cat([x, mels_c[:, t], a1], dim=1)) @ w["I_w"] + w["I_b"]
        h1 = gru(u, h1, "g1")
        u = u + h1
        h2 = gru(torch.cat([u, a2], dim=1), h2, "g2")
        u = u + h2
        u = torch.relu(rnd(torch.cat([u, a3], dim=1)) @ w["fc1_w"] + w["fc1_b"])
        u = torch.relu(rnd(torch.cat([u, a4], dim=1)) @ w["fc2_w"] + w["fc2_b"])
        scores = rnd(u) @ w["fc3_w"] + w["fc3_b"]
        if not greedy:
            if t % chunk == 0:
                noise = gumbel_noise(seed, t, min(t + chunk, t_len), f, n_classes, dev)
            scores = scores + noise[t % chunk]
        label = torch.argmax(scores, dim=1)      # first maximum wins ties
        labels[:, t] = label.to(torch.int32)
        if gaps is not None:
            top2 = torch.topk(scores, 2, dim=1).values
            gaps[:, t] = top2[:, 0] - top2[:, 1]
        x = (2.0 * label.float() / float(n_classes - 1) - 1.0)[:, None]
    return (labels, gaps) if return_gaps else labels


def _check(weights, mels, aux, n_classes):
    dev, wdt = mels.device, weights["I_w"].dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, not {wdt}")
    for k in W_NAMES:
        v = weights[k]
        if v.device != dev or v.dtype != wdt or not v.is_contiguous():
            raise ValueError(f"weight {k}: {v.device}/{v.dtype}/contiguous="
                             f"{v.is_contiguous()}, expected {dev}/{wdt}/contiguous")
    if mels.ndim != 3 or aux.ndim != 3 or aux.shape[:2] != mels.shape[:2]:
        raise ValueError(f"mels {tuple(mels.shape)} / aux {tuple(aux.shape)}: expected (F, T, ·)")
    if aux.device != dev:
        raise ValueError(f"aux on {aux.device}, mels on {dev}")
    rnn = weights["I_w"].shape[1]
    fc = weights["fc1_w"].shape[1]
    a = aux.shape[2] // 4
    want = {"I_w": (1 + mels.shape[2] + a, rnn), "I_b": (rnn,),
            "g1_wi": (rnn, 3 * rnn), "g1_bi": (3 * rnn,), "g1_wh": (rnn, 3 * rnn),
            "g1_bn": (rnn,), "g2_wi": (rnn + a, 3 * rnn), "g2_bi": (3 * rnn,),
            "g2_wh": (rnn, 3 * rnn), "g2_bn": (rnn,), "fc1_w": (rnn + a, fc),
            "fc1_b": (fc,), "fc2_w": (fc + a, fc), "fc2_b": (fc,),
            "fc3_w": (fc, n_classes), "fc3_b": (n_classes,)}
    for k, shape in want.items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"weight {k} has shape {tuple(weights[k].shape)}, expected {shape}")
    if aux.shape[2] % 4:
        raise ValueError(f"aux width {aux.shape[2]} is not 4·aux_d")


def cond_tiles(mels: torch.Tensor, aux: torch.Tensor, steps: int = 256) -> torch.Tensor:
    """The conditioning as the bf16 kernel's ring takes it: mels (F, T, M)
    and aux (F, T, 4·aux_d) → (T, ⌈F/64⌉, KC, 64, 64) bf16, per step and
    64-fold tile the column blocks [mel, a1] (padded to a multiple of 64),
    then a2, a3 and a4 (each padded), each 64 x 64 block under the 128-byte
    swizzle (16-byte chunk j of row r at j ^ (r mod 8)), folds past F zero.
    Built ``steps`` steps at a time, so that the copy in between stays
    small."""
    f, t_len, m = mels.shape
    a = aux.shape[2] // 4
    mt, ki, ka = _ceil(f, TILE), _ceil(m + a, TILE), _ceil(a, TILE)
    kc = ki + 3 * ka
    dev = mels.device
    out = torch.empty((t_len, mt, kc, TILE, TILE), dtype=torch.bfloat16, device=dev)
    rows = torch.arange(TILE, device=dev)
    chunk = (torch.arange(8, device=dev)[None, :] ^ (rows[:, None] % 8))  # (64 rows, 8)
    # where each part's columns start, in the [mel, a1 | a2 | a3 | a4] blocks
    starts = [(0, mels, 0, m), (m, aux, 0, a)] + [
        ((ki + (k - 1) * ka) * TILE, aux, k * a, a) for k in (1, 2, 3)]
    for t0 in range(0, t_len, steps):
        t1 = min(t0 + steps, t_len)
        flat = torch.zeros((t1 - t0, mt * TILE, kc * TILE), dtype=torch.bfloat16, device=dev)
        for col, src, off, width in starts:
            flat[:, :f, col:col + width] = src[:, t0:t1, off:off + width].transpose(0, 1)
        tiles = flat.view(t1 - t0, mt, TILE, kc, TILE // 8, 8).permute(0, 1, 3, 2, 4, 5)
        out[t0:t1] = tiles[:, :, :, rows[:, None], chunk].reshape(t1 - t0, mt, kc, TILE, TILE)
    return out


def _launch(lib: ctypes.CDLL, weights, mels, aux, seed, n_classes, greedy,
            time_major) -> torch.Tensor:
    """Plan, lay out the conditioning, allocate the workspaces and launch."""
    dev = mels.device
    wdt = weights["I_w"].dtype
    f, t_len, m = mels.shape
    aux_d = aux.shape[2] // 4
    rnn, fc = weights["I_w"].shape[1], weights["fc1_w"].shape[1]
    pl = plan(rnn, fc, n_classes, aux_d, m, f, wdt, resident_blocks(dev, wdt))
    if wdt == torch.bfloat16:
        # both layouts as the ring's tiles, rounded to bf16: one copy
        mels_t, aux_t = cond_tiles(mels, aux), None
    elif time_major:
        # (F, T, D) → (T, F, D) in the weight dtype: one copy, and the
        # per-step rows of all folds are then adjacent
        mels_t = mels.to(wdt).transpose(0, 1).contiguous()
        aux_t = aux.to(wdt).transpose(0, 1).contiguous()
    else:
        mels_t = mels.float().contiguous()
        aux_t = aux.float().contiguous()
    labels = torch.empty((f, t_len), dtype=torch.int32, device=dev)
    # workspaces: exchange rows (zeroed: step 0 reads h = 0 from them), the
    # argmax keys and the grid-barrier counter (zeroed), block-private state
    xch = torch.zeros(pl.exchange_elems, dtype=wdt, device=dev)
    arg = torch.zeros(pl.arg_elems, dtype=torch.int64, device=dev)
    state = torch.empty(pl.state_elems, dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(W_NAMES))(*(weights[k].data_ptr() for k in W_NAMES))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wavernn_sample_launch(
            mels_t.data_ptr(), aux_t.data_ptr() if aux_t is not None else None, ptrs,
            labels.data_ptr(), xch.data_ptr(),
            arg.data_ptr(), state.data_ptr(), bar.data_ptr(),
            f, t_len, m, aux_d, rnn, fc, n_classes, pl.grid, pl.nu, pl.nv, pl.nq, pl.fchunk,
            pl.slots, pl.smem, int(wdt == torch.bfloat16), int(greedy), int(time_major),
            int(seed) & (2**64 - 1), stream)
    if err != 0:
        raise RuntimeError(f"wavernn_sample kernel launch failed: CUDA error {err} "
                           f"({lib.wavernn_sample_error_string(err).decode()})")
    return labels


def wavernn_sample(weights: Dict[str, torch.Tensor], mels: torch.Tensor, aux: torch.Tensor,
                   seed: int, n_classes: int = 512, greedy: bool = False,
                   time_major: bool = True) -> torch.Tensor:
    """mels (F, T, 80), aux (F, T, 4·aux_d) → labels (F, T) int32.

    On CUDA tensors this launches the Hopper kernel and counts the launch by
    layout, in ``wavernn_sample.launches`` (time-major) or
    ``wavernn_sample.launches_fold_major``, and, when its products ran on the
    tensor cores (bf16 weights), in ``wavernn_sample.launches_tensor_core``
    and in this thread's ``tensor_core_launches()``; on CPU tensors it runs
    the plain version.
    With f32 weights ``time_major`` streams the conditioning as one
    (T, F, D) copy, as ``_kernel_v2`` does, and ``time_major=False`` reads
    the (F, T, D) conditioning in place, as ``_kernel`` does; with bf16
    weights both layouts are first copied into the tiles the kernel's ring
    streams (``cond_tiles``). Every path rounds the conditioning to the
    weight dtype before the products, so the labels are the same.
    Raises ``ValueError`` before any launch for widths ``plan`` cannot
    place, and ``RuntimeError`` with the CUDA error when the launch is
    refused (there is no fallback)."""
    dev = mels.device
    if dev.type == "cpu":
        return wavernn_sample_plain(weights, mels, aux, seed, n_classes, greedy)
    if dev.type != "cuda":
        raise ValueError(f"wavernn_sample runs on cuda or cpu tensors, not {dev}")
    _check(weights, mels, aux, n_classes)
    from .build import load
    labels = _launch(_bind(load("wavernn_sample")), weights, mels, aux, seed, n_classes,
                     greedy, time_major)
    if time_major:
        wavernn_sample.launches += 1
    else:
        wavernn_sample.launches_fold_major += 1
    if weights["I_w"].dtype == torch.bfloat16:
        wavernn_sample.launches_tensor_core += 1
        _counts.tensor_core = tensor_core_launches() + 1
    return labels


wavernn_sample.launches = 0
wavernn_sample.launches_fold_major = 0
wavernn_sample.launches_tensor_core = 0


def tensor_core_launches() -> int:
    """The kernel's launches so far on the calling thread whose products ran
    on the tensor cores (a thread's count, so that a caller can tell its own
    launch's path while other threads launch too)."""
    return getattr(_counts, "tensor_core", 0)


def resident_blocks(device, dtype: torch.dtype = torch.bfloat16) -> int:
    """The blocks of the kernel for weights of ``dtype`` that the CUDA card
    ``device`` keeps resident at once in clusters of ``CLUSTER``: the
    ``max_blocks`` of ``plan``. Builds the kernel if needed."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"resident_blocks needs a CUDA device, not {dev}")
    from .build import load
    lib = _bind(load("wavernn_sample"))
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.wavernn_sample_resident_blocks(int(dtype == torch.bfloat16), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"querying the sampler's resident blocks failed: CUDA error {err} "
                           f"({lib.wavernn_sample_error_string(err).decode()})")
    return out.value


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.wavernn_sample_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p] + [i] * 17 + [ctypes.c_ulonglong, p]
        fn.restype = i
        lib.wavernn_sample_error_string.argtypes = [i]
        lib.wavernn_sample_error_string.restype = ctypes.c_char_p
        lib.wavernn_sample_resident_blocks.argtypes = [i, p]
        lib.wavernn_sample_resident_blocks.restype = i
    return lib
