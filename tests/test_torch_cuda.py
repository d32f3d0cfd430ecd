"""The hand-written kernels against their plain versions on a CUDA card:
the WaveRNN sampler (both conditioning layouts) and monotonic alignment
search.

These tests need the card and skip without one. On the card's machine (no
JAX there, so without the JAX-side conftest) they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from mockingbird_tpu_torch.models.vocoder import WaveRNN, wavernn_config
from mockingbird_tpu_torch.ops.monotonic_align import (maximum_path, maximum_path_cuda,
                                                       maximum_path_plain)
from mockingbird_tpu_torch.ops.wavernn_sample import (pack_wavernn_weights, wavernn_sample,
                                                      wavernn_sample_plain)

pytestmark = pytest.mark.cuda

SMALL = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
             upsample_factors=[4, 4], hop_size=16, pad=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(card, cfg, f, t, seed=0):
    c = wavernn_config().merge(cfg)
    torch.manual_seed(seed)
    model = WaveRNN(c).to(card)
    rng = np.random.RandomState(seed)
    mels = torch.from_numpy(rng.randn(f, t, 80).astype(np.float32) * 0.5).to(card)
    aux = torch.from_numpy(rng.randn(f, t, c.res_out_dims).astype(np.float32) * 0.5)
    return model, mels, aux.to(card)


def _hold(k, p, gaps, bound):
    """Per fold, the first step where kernel and plain labels differ (if
    any) is one whose plain top-2 score gap, noise included, is under
    ``bound``."""
    for f in range(k.shape[0]):
        diff = torch.nonzero(k[f] != p[f])
        if len(diff):
            assert float(gaps[f, int(diff[0])]) < bound, (f, int(diff[0]))


@pytest.mark.parametrize("cfg", [SMALL, {}], ids=["small", "full"])
def test_kernel_greedy_f32_matches_plain(card, cfg):
    """F=5 leaves the last block of 4 folds with one real fold. A fold's
    labels may first differ only at a step whose plain top-2 gap is under
    1e-3."""
    model, mels, aux = _case(card, cfg, 5, 96)
    w = pack_wavernn_weights(model, torch.float32)
    k = wavernn_sample(w, mels, aux, 0, greedy=True)
    p, gaps = wavernn_sample_plain(w, mels, aux, 0, greedy=True, return_gaps=True)
    torch.cuda.synchronize()
    assert k.dtype == torch.int32 and k.shape == (5, 96)
    _hold(k, p, gaps, 1e-3)


@pytest.mark.parametrize("cfg", [SMALL, {}], ids=["small", "full"])
def test_kernel_sampled_f32_matches_plain(card, cfg):
    """The plain version draws the kernel's Philox noise, so sampled labels
    are held as greedy ones are: a fold's labels may first differ only at a
    step whose plain top-2 gap, noise included, is under 1e-3."""
    model, mels, aux = _case(card, cfg, 5, 96)
    w = pack_wavernn_weights(model, torch.float32)
    k = wavernn_sample(w, mels, aux, 3)
    p, gaps = wavernn_sample_plain(w, mels, aux, 3, return_gaps=True)
    torch.cuda.synchronize()
    _hold(k, p, gaps, 1e-3)
    assert not torch.equal(k, wavernn_sample(w, mels, aux, 3, greedy=True))


def test_kernel_bf16_and_sampled(card):
    """bf16 weights, as the vocoder runs: greedy and sampled labels held with
    a gap bound of 5e-2 (activations rounded to bf16 may round the other way
    in the kernel's order of sums); a seed gives one draw, another seed
    another."""
    model, mels, aux = _case(card, {}, 8, 128, seed=1)
    w = pack_wavernn_weights(model)
    for greedy in (True, False):
        k = wavernn_sample(w, mels, aux, 7, greedy=greedy)
        p, gaps = wavernn_sample_plain(w, mels, aux, 7, greedy=greedy, return_gaps=True)
        _hold(k, p, gaps, 5e-2)
    a = wavernn_sample(w, mels, aux, 7)
    b = wavernn_sample(w, mels, aux, 7)
    c = wavernn_sample(w, mels, aux, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len(torch.unique(a)) > 20


def test_kernel_counts_launches_and_checks_inputs(card):
    model, mels, aux = _case(card, SMALL, 2, 16)
    w = pack_wavernn_weights(model, torch.float32)
    before = wavernn_sample.launches, wavernn_sample.launches_fold_major
    wavernn_sample(w, mels, aux, 0)
    assert (wavernn_sample.launches, wavernn_sample.launches_fold_major) == (
        before[0] + 1, before[1])
    wavernn_sample(w, mels, aux, 0, time_major=False)
    wavernn_sample_plain(w, mels, aux, 0)
    assert (wavernn_sample.launches, wavernn_sample.launches_fold_major) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        wavernn_sample({k: v.half() for k, v in w.items()}, mels, aux, 0)
    with pytest.raises(ValueError):
        wavernn_sample(w, mels, aux[:, :, :8], 0)


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_fold_major_layout_matches_plain(card, weights):
    """``time_major=False`` reads (F, T, D) f32 conditioning in place: greedy
    and sampled labels held against the plain version with the gap rule, and
    equal to the time-major launch's labels (same rounding, same math)."""
    model, mels, aux = _case(card, {}, 6, 96, seed=2)
    w = pack_wavernn_weights(model, torch.float32 if weights == "f32" else torch.bfloat16)
    bound = 1e-3 if weights == "f32" else 5e-2
    for greedy in (True, False):
        k = wavernn_sample(w, mels, aux, 5, greedy=greedy, time_major=False)
        p, gaps = wavernn_sample_plain(w, mels, aux, 5, greedy=greedy, return_gaps=True)
        _hold(k, p, gaps, bound)
        assert torch.equal(k, wavernn_sample(w, mels, aux, 5, greedy=greedy))


def _mas_case(card, b, t_y, t_x, t_ys, t_xs, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    nc = rng.randn(b, t_y, t_x).astype(np.float32)
    if ties:
        nc = np.round(nc)
    return (torch.from_numpy(nc).to(card), torch.as_tensor(t_ys, dtype=torch.int32, device=card),
            torch.as_tensor(t_xs, dtype=torch.int32, device=card))


@pytest.mark.parametrize("case", ["ragged", "ties", "tx1", "square", "long"])
def test_mas_kernel_exact(card, case):
    """Every element of the kernel's path equals the plain version's."""
    rng = np.random.RandomState(1)
    b, t_y, t_x = 16, 1000, 160
    t_xs = rng.randint(1, t_x + 1, b)
    t_ys = np.maximum(rng.randint(1, t_y + 1, b), t_xs)
    ties = case == "ties"
    if case == "tx1":
        t_x, t_xs = 1, np.ones(b, int)
    elif case == "square":
        t_y, t_x = 160, 160
        t_xs = rng.randint(1, t_x + 1, b)
        t_ys = t_xs.copy()
    elif case == "long":
        t_y, t_x = 1000, 12
        t_xs = rng.randint(1, t_x + 1, b)
        t_ys = rng.randint(900, t_y + 1, b)
    nc, tys, txs = _mas_case(card, b, t_y, t_x, t_ys, t_xs, seed=3, ties=ties)
    k = maximum_path_cuda(nc, tys, txs)
    p = maximum_path_plain(nc, tys, txs)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert torch.equal(k.sum(dim=(1, 2)).long(), torch.as_tensor(t_ys, device=card).long())


def test_mas_wrapper_and_checks(card):
    """``maximum_path`` takes the kernel for CUDA tensors (one launch,
    counted), agrees with the plain version through the mask, keeps the
    caller's dtype; the launcher rejects what the kernel does not take."""
    nc, tys, txs = _mas_case(card, 3, 50, 20, [50, 40, 20], [20, 7, 20])
    mask = ((torch.arange(50, device=card)[None, :, None] < tys[:, None, None])
            & (torch.arange(20, device=card)[None, None, :] < txs[:, None, None])).float()
    before = maximum_path_cuda.launches
    out = maximum_path(nc.bfloat16(), mask)
    assert maximum_path_cuda.launches == before + 1 and out.dtype == torch.bfloat16
    assert torch.equal(out.float(), maximum_path_plain(nc.bfloat16().float() * mask, tys, txs)
                       * mask)
    with pytest.raises(TypeError):
        maximum_path_cuda(nc.double(), tys, txs)
    with pytest.raises(ValueError, match="contiguous"):
        maximum_path_cuda(nc.transpose(1, 2), tys, txs)
    with pytest.raises(ValueError, match="T_y, T_x"):
        maximum_path_cuda(nc[0], tys, txs)
    with pytest.raises(ValueError, match="lengths"):
        maximum_path_cuda(nc, tys[:2], txs)
