"""The port's monotonic alignment search against the JAX package: its plain
row scan (what CPU tensors take) and its mask-level wrapper equal the numpy
oracle, the JAX ``lax.scan`` and the Pallas kernel in interpret mode
exactly, on ragged batches with planted ties."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.ops.monotonic_align import (maximum_path as j_maximum_path,
                                                 maximum_path_numpy, maximum_path_with_lengths)
from mockingbird_tpu.ops.monotonic_align_pallas import maximum_path_pallas
from mockingbird_tpu_torch.ops.monotonic_align import (maximum_path, maximum_path_cuda,
                                                       maximum_path_plain, smem_bytes)


def _case(seed, b, t_y, t_x, ties):
    rng = np.random.RandomState(seed)
    nc = rng.randn(b, t_y, t_x).astype(np.float32)
    if ties:
        nc = np.round(nc * 2) / 2          # many equal cumulative values
    t_xs = rng.randint(1, t_x + 1, b)
    t_ys = np.maximum(rng.randint(1, t_y + 1, b), t_xs)
    t_xs[0], t_ys[0] = t_x, t_y            # one full-size element
    return nc, t_ys.astype(np.int32), t_xs.astype(np.int32)


@pytest.mark.parametrize("seed,b,t_y,t_x,ties", [
    (0, 4, 24, 12, False), (1, 4, 24, 12, True), (2, 3, 40, 12, True),
    (3, 3, 9, 9, True), (4, 2, 30, 1, False)])
def test_plain_equals_oracle_scan_and_pallas(seed, b, t_y, t_x, ties):
    nc, t_ys, t_xs = _case(seed, b, t_y, t_x, ties)
    got = maximum_path_plain(torch.from_numpy(nc), torch.from_numpy(t_ys),
                             torch.from_numpy(t_xs)).numpy()
    np.testing.assert_array_equal(got, maximum_path_numpy(nc, t_ys, t_xs))
    np.testing.assert_array_equal(got, np.asarray(maximum_path_with_lengths(nc, t_ys, t_xs)))
    pallas = maximum_path_pallas(jnp.asarray(nc), jnp.asarray(t_ys), jnp.asarray(t_xs),
                                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("seed", [6, 7])
def test_plain_equals_jax_with_fewer_rows_than_columns(seed):
    """Elements with t_y < t_x have no band: every cell holds exactly -1e9
    and the walk back steps left only on the diagonal. neg_cent of magnitude
    ~1e3 survives an add to -1e9, so a cell wrongly taken into the band
    would change the path."""
    rng = np.random.RandomState(seed)
    b, t_y, t_x = 6, 10, 16
    nc = (rng.randn(b, t_y, t_x) * 1000).astype(np.float32)
    t_xs = rng.randint(1, t_x + 1, b).astype(np.int32)
    t_ys = rng.randint(1, t_y + 1, b).astype(np.int32)
    t_xs[:4] = np.maximum(t_xs[:4], t_ys[:4] + 1)
    got = maximum_path_plain(torch.from_numpy(nc), torch.from_numpy(t_ys),
                             torch.from_numpy(t_xs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(maximum_path_with_lengths(nc, t_ys, t_xs)))
    pallas = maximum_path_pallas(jnp.asarray(nc), jnp.asarray(t_ys), jnp.asarray(t_xs),
                                 interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got.sum(axis=(1, 2)), t_ys)


def test_mask_wrapper_matches_jax():
    """``maximum_path(neg_cent, mask)``: lengths from the mask, the search in
    f32, the path times the mask in the caller's dtype."""
    nc, t_ys, t_xs = _case(5, 3, 20, 8, True)
    mask = ((np.arange(20)[None, :, None] < t_ys[:, None, None])
            & (np.arange(8)[None, None, :] < t_xs[:, None, None])).astype(np.float32)
    ref = np.asarray(j_maximum_path(jnp.asarray(nc), jnp.asarray(mask)))
    got = maximum_path(torch.from_numpy(nc), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), ref)
    half = maximum_path(torch.from_numpy(nc).bfloat16(), torch.from_numpy(mask))
    assert half.dtype == torch.bfloat16
    ref16 = np.asarray(j_maximum_path(jnp.asarray(nc, jnp.bfloat16), jnp.asarray(mask)))
    np.testing.assert_array_equal(half.float().numpy(), ref16.astype(np.float32))


def test_kernel_launcher_refuses_cpu_and_other_devices():
    """CPU tensors take the plain version in ``maximum_path`` only; the
    launcher itself takes CUDA tensors or raises, and other devices raise."""
    nc = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        maximum_path_cuda(nc, torch.tensor([4]), torch.tensor([3]))
    meta = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        maximum_path(meta, meta)
    assert smem_bytes(1000, 160) == 32 * 1000
