"""The plain version of the generators' conv epilogue
(``ops/conv_epilogue.py``), which the kernel is held against on the card,
equals the unfused operators of flax's HiFi-GAN bit for bit in bf16; the
CPU and every call with gradients take the plain version; a residual
block's convs run in its own order on the channels-last path.

No JAX: ``test_torch_gan_vocoder.py`` / ``test_torch_vits.py`` hold the
generators against the JAX package.
"""
import pytest
import torch
import torch.nn.functional as F

from mockingbird_tpu_torch.models.vocoder import GanVocoder, hifigan
from mockingbird_tpu_torch.ops import conv_epilogue as ce

SMALL = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
             resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
             hop_size=16)


def _bf16(*shape, gen):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def _unfused(case, y, b, res, xs, n_k):
    """What the unfused operators (the residual blocks' own ``forward``,
    ``layers.with_bias``) compute on channels-first (B, C, T) tensors after
    a conv whose product is ``y``: the bias add, the residual add, the
    block sum, its division, the activations."""
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


def test_cpu_and_gradients_take_the_plain_epilogue():
    """``uses_kernel`` is true only for a card's tensor with gradients off:
    on the CPU the vocoder launches nothing, and a backward through a
    generator call reaches every parameter."""
    voc = GanVocoder("hifigan", cfg=SMALL, verbose=False, device="cpu")
    assert voc.n_convs == 1 + 2 * (1 + 2 * 4) + 1
    before = ce.launches()
    wav = voc.vocode_device(torch.randn(1, 16, 80))
    assert wav.dtype == torch.int16 and wav.shape == (1, 16 * 16)
    assert ce.launches() == before
    gen = voc.model.train()
    gen.zero_grad()
    gen(torch.randn(2, 8, 80)).square().mean().backward()
    assert ce.launches() == before
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in gen.parameters())
    x = torch.zeros(1)
    assert not ce.uses_kernel(x)
    with torch.no_grad():
        assert not ce.uses_kernel(x)
        assert not ce.uses_kernel(torch.empty(1, device="meta"))


@pytest.mark.parametrize("block", ["resblock1", "resblock2", "identity"])
def test_residual_units_follow_the_blocks_order(block):
    """``residual_units`` groups a block's convs by their index in the order
    the block's ``forward`` runs them, and ``fused_residuals`` on those
    units equals ``forward`` channels-first; a module without convs has no
    units and passes its input through, with the stage's tail."""
    torch.manual_seed(0)
    mod = {"resblock1": lambda: hifigan.ResBlock1(8, 3, (1, 3)),
           "resblock2": lambda: hifigan.ResBlock2(8, 3, (1, 3)),
           "identity": torch.nn.Identity}[block]()
    units = hifigan.residual_units(mod)
    names = {id(m): n for n, m in mod.named_children()}
    want = {"resblock1": [["convs1_0", "convs2_0"], ["convs1_1", "convs2_1"]],
            "resblock2": [["convs_0"], ["convs_1"]], "identity": []}[block]
    assert [[names[id(m)] for m in unit] for unit in units] == want
    x, s = torch.randn(2, 12, 8), torch.randn(2, 12, 8)
    a = F.leaky_relu(x, hifigan.LRELU_SLOPE)
    with torch.no_grad():
        got = hifigan.fused_residuals(units, x, a, block_sum=s, n_blocks=2, slope=0.1)
        ref = mod(x.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, F.leaky_relu((s + ref) / 2, 0.1), rtol=1e-5, atol=1e-6)
