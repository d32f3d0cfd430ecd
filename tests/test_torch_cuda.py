"""The WaveRNN sampler kernel against its plain version on a CUDA card.

These tests need the card and skip without one. On the card's machine (no
JAX there, so without the JAX-side conftest) they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from mockingbird_tpu_torch.models.vocoder import WaveRNN, wavernn_config
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
    before = wavernn_sample.launches
    wavernn_sample(w, mels, aux, 0)
    assert wavernn_sample.launches == before + 1
    wavernn_sample_plain(w, mels, aux, 0)
    assert wavernn_sample.launches == before + 1
    with pytest.raises(TypeError):
        wavernn_sample({k: v.half() for k, v in w.items()}, mels, aux, 0)
    with pytest.raises(ValueError):
        wavernn_sample(w, mels, aux[:, :, :8], 0)
