"""The generators' channels-last inference path on the CPU: the plain
version of the conv epilogue (``ops/conv_epilogue.py``), which the kernel
is held against on the card, equals the unfused operators of
``hifigan.py`` bit for bit in bf16; ``forward_channels_last`` (HiFi-GAN)
and the VITS decoder's channels-last branch, run here with the plain
epilogue, equal the unfused ``forward`` (float64 to rounding, bf16 bit for
bit); and the CPU and gradients take the unfused path.

No JAX: the unfused ``forward`` is the yardstick here, and
``test_torch_gan_vocoder.py`` / ``test_torch_vits.py`` hold it against the
JAX package.
"""
import pytest
import torch
import torch.nn.functional as F

from mockingbird_tpu_torch.config import Config
from mockingbird_tpu_torch.models.vits import model as vits_model
from mockingbird_tpu_torch.models.vits.model import VitsGenerator, vits_config
from mockingbird_tpu_torch.models.vocoder import GanVocoder, hifigan
from mockingbird_tpu_torch.models.vocoder.hifigan import Generator, hifigan_config
from mockingbird_tpu_torch.ops import conv_epilogue as ce

GENERATORS = {
    "small": dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                  upsample_initial_channel=32, resblock_kernel_sizes=[3, 7],
                  resblock_dilation_sizes=[[1, 3], [1, 3]], hop_size=16),
    # odd rates (output_padding 1), one block a stage
    "odd_rates": dict(upsample_rates=[5, 3], upsample_kernel_sizes=[10, 6],
                      upsample_initial_channel=32, resblock_kernel_sizes=[3],
                      resblock_dilation_sizes=[[1, 3, 5]], hop_size=15),
    # ResBlock2, an even kernel (asymmetric SAME padding), a transposed
    # kernel whose window needs the sliced output
    "resblock2": dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 5],
                      upsample_initial_channel=16, resblock="2", resblock_kernel_sizes=[3, 4],
                      resblock_dilation_sizes=[[1, 3], [1, 3]], hop_size=8),
    "interpolation": dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
                          upsample_initial_channel=16, use_interpolation=True,
                          resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
                          hop_size=4),
}


def _bf16(*shape, gen):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def _unfused(case, y, b, res, xs, n_k):
    """What ``hifigan.py``'s unfused path computes on channels-first
    (B, C, T) tensors after a conv whose product is ``y``: ``with_bias``'s
    add, the residual add, the block sum, its division, the activations."""
    x = y + b.reshape(1, -1, 1)
    if case == "conv":                       # a ResBlock's first conv, conv_pre
        return F.leaky_relu(x, hifigan.LRELU_SLOPE)
    if case == "post":                       # conv_post
        return torch.tanh(x)
    x = x + res
    if case == "residual":                   # a ResBlock's inner residual, an upsample
        return x, F.leaky_relu(x, hifigan.LRELU_SLOPE)
    if case == "first_block":
        return x
    xs = xs + x
    if case == "middle_block":
        return xs
    return F.leaky_relu(xs / n_k, hifigan.LAST_SLOPE)   # "last_block"


def _fused(case, y, b, res, xs, n_k):
    """The same through ``conv_epilogue`` on channels-last (B, T, C)."""
    if case == "conv":
        return ce.conv_epilogue(y, b, slope=hifigan.LRELU_SLOPE)
    if case == "post":
        return ce.conv_epilogue(y, b, tanh=True)
    if case == "residual":
        return ce.conv_epilogue(y, b, residual=res, slope=hifigan.LRELU_SLOPE, keep_x=True)
    if case == "first_block":
        return ce.conv_epilogue(y, b, residual=res)
    if case == "middle_block":
        return ce.conv_epilogue(y, b, residual=res, block_sum=xs)
    return ce.conv_epilogue(y, b, residual=res, block_sum=xs, n_blocks=n_k,
                            slope=hifigan.LAST_SLOPE)


@pytest.mark.parametrize("case", ["conv", "post", "residual", "first_block", "middle_block",
                                  "last_block"])
@pytest.mark.parametrize("channels", [512, 256, 128, 64, 32])
def test_plain_epilogue_is_the_unfused_ops_bit_for_bit(case, channels):
    """bf16, 37 samples (not a multiple of any vector width)."""
    gen = torch.Generator().manual_seed(channels)
    y, res, xs = (_bf16(2, 37, channels, gen=gen) for _ in range(3))
    b = _bf16(channels, gen=gen)

    def cf(t):
        return t.transpose(1, 2)
    want = _unfused(case, cf(y), b, cf(res), cf(xs), 3)
    got = _fused(case, y, b, res, xs, 3)
    want, got = ((want,), (got,)) if torch.is_tensor(want) else (want, got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        assert torch.equal(cf(w), g)


def _generator(name, dtype, seed=0):
    torch.manual_seed(seed)
    g = Generator(Config(hifigan_config()).merge(GENERATORS[name]))
    with torch.no_grad():
        for p in g.parameters():
            p.normal_(0, 0.3)
    return g.to(dtype).eval()


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_channels_last_generator_equals_forward(name, dtype):
    """The channels-last path with the plain epilogue against ``forward``:
    float64 to 1e-12 (padding, windows and layouts), bf16 bit for bit (the
    same rounding points; the CPU's convolutions agree across layouts)."""
    g = _generator(name, dtype)
    mel = torch.randn(2, 13, 80, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.no_grad():
        want = g(mel)
        got = g.forward_channels_last(mel)
    assert got.shape == want.shape
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_vits_decoder_channels_last_equals_forward(monkeypatch, dtype):
    """The VITS decoder's channels-last branch, taken here by patching the
    choice, against its unfused branch."""
    cfg = vits_config().merge(dict(upsample_initial_channel=32, upsample_rates=[4, 2, 2],
                                   upsample_kernel_sizes=[8, 4, 4], gin_channels=8,
                                   inter_channels=12))
    torch.manual_seed(0)
    dec = VitsGenerator(cfg)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_(0, 0.3)
    dec = dec.to(dtype).eval()
    z = torch.randn(2, 11, 12, dtype=dtype)
    g = torch.randn(2, 1, 8, dtype=dtype)
    with torch.no_grad():
        want = dec(z, g=g)
        monkeypatch.setattr(vits_model, "channels_last_path", lambda x: True)
        got = dec(z, g=g)
    assert got.shape == want.shape == (2, 11 * 16)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    else:
        assert torch.equal(got, want)


def test_cpu_and_gradients_take_the_unfused_path(monkeypatch):
    """``channels_last_path`` is true only for a card's tensor with
    gradients off; on the CPU ``forward`` runs unfused and the vocoder
    launches nothing."""
    def refuse(self, mel):
        raise AssertionError("the channels-last path ran on the CPU")
    monkeypatch.setattr(Generator, "forward_channels_last", refuse)
    voc = GanVocoder("hifigan", cfg=GENERATORS["small"], verbose=False, device="cpu")
    assert voc.n_convs == 1 + 2 * (1 + 2 * 4) + 1
    before = ce.launches()
    wav = voc.vocode_device(torch.randn(1, 16, 80))
    assert wav.dtype == torch.int16 and wav.shape == (1, 16 * 16)
    assert ce.launches() == before
    x = torch.zeros(1)
    assert not hifigan.channels_last_path(x)
    with torch.no_grad():
        assert not hifigan.channels_last_path(x)
    meta = torch.empty(1, device="meta")
    with torch.no_grad():
        assert not hifigan.channels_last_path(meta)
