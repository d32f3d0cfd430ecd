"""The operation and byte counts against hand counts at tiny shapes, and
the generator's count against the convolutions the reference runs."""
import pytest
import torch
import torch.nn.functional as F

from benchmark import flops
from benchmark.harness import registry


def test_hifigan_by_hand():
    cfg = dict(upsample_initial_channel=4, num_mels=2, upsample_rates=[2],
               upsample_kernel_sizes=[4], resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]])
    # conv_pre 2·B·T·80→ch·7; transposed: input 4 ch × 3 frames × out 2 × 4 taps;
    # 2 dilations × 2 convs of 2→2 ch × 3 taps over 6 samples; conv_post 2 ch × 7 taps
    hand = 2 * (3 * 2 * 4 * 7 + 4 * 3 * 2 * 4 + 4 * 6 * 2 * 2 * 3 + 6 * 2 * 7)
    assert flops.hifigan(cfg, 1, 3) == hand
    assert flops.hifigan(cfg, 5, 3) == 5 * hand


def test_hifigan_counts_the_reference_convolutions():
    from benchmark.reference import hifigan
    cfg = dict(registry.cell("tts-hifigan.b128-f800")["config"]["vocoder"],
               upsample_initial_channel=8)
    seen = []
    real = F.conv1d

    def counting(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = real(x, w, b, stride, padding, dilation, groups)
        seen.append(2.0 * y.numel() * w.shape[1] * w.shape[2])
        return y

    from benchmark.reference import layout
    from benchmark.harness.weights import _shape
    w = {}
    for key, shape, kind in layout.hifigan(cfg):
        t = torch.randn(shape)
        _shape(t, key, shape, kind)
        w[key] = t
    F.conv1d = counting
    try:
        hifigan.generate(w, cfg, torch.randn(2, 5, 80), hifigan.Prec("float32"))
    finally:
        F.conv1d = real
    # the reference's transposed convolutions run on the dilated input:
    # count those the way a transposed convolution is counted
    rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    ch, t, idx, total = cfg["upsample_initial_channel"], 5, 0, seen[0]
    idx = 1
    for i, (u, k) in enumerate(zip(rates, kernels)):
        total += 2.0 * 2 * (ch // 2 ** i) * t * (ch // 2 ** (i + 1)) * k
        idx += 1
        t *= u
        n_res = sum(2 * len(d) for d in cfg["resblock_dilation_sizes"])
        total += sum(seen[idx:idx + n_res])
        idx += n_res
    total += sum(seen[idx:])
    assert flops.hifigan(cfg, 2, 5) == pytest.approx(total)


def test_tacotron_step_by_hand():
    c = dict(encoder_dims=2, decoder_dims=1, lstm_dims=2, n_mels=1, speaker_embedding_size=1,
             gst_E=1, embed_dims=1, encoder_K=1, num_highways=0, max_r=1)
    proj = 4
    per_step = (1 * 2 + 4 + 3 * 1 * (proj + 2 + 1) + 1
                + 1 * (31 * 32 + 32 + 1 + proj) + (proj + 1) * 2 + 16 * 4 + 2 + 2 + proj)
    per_symbol = (1 * 2 + 4 + (1 * 2 * 2 + 3 * 2 * 2 + 3 * 2 * 2 + 2 * 3 * (2 + 1)) + proj)
    assert flops.tacotron(c, 1, 1, 1) == 2 * (per_symbol + per_step)
    assert flops.tacotron(c, 3, 1, 5) == 2 * 3 * (per_symbol + 5 * per_step)


def test_k1_by_hand():
    c = dict(rnn_dims=2, fc_dims=3, res_out_dims=4, feat_dims=1, bits=1)
    mm = (1 + 1 + 1) * 2 + 2 * 2 * 6 + 3 * 6 + 2 * 6 + 3 * 3 + 4 * 3 + 3 * 2
    assert flops.k1_mm_params(c) == mm
    flop, nbytes, bound = flops.k1(c, 5, 7)
    assert flop == 2 * mm * 5 * 7
    assert nbytes == 2 * (mm + 9 * 2 + 2 * 3 + 2) + 2 * 5 * 7 * (1 + 4) + 4 * 5 * 7
    assert bound == max(flop / flops.PEAK_BF16_FLOPS, nbytes / flops.PEAK_BYTES_PER_S)


def test_k1_at_the_cell():
    voc = registry.cell("tts-wavernn.b16-f800")["config"]["vocoder"]
    flop, _, bound = flops.k1(voc, 186, 2400)
    assert flop == pytest.approx(2 * 4_071_936 * 186 * 2400)
    assert bound == pytest.approx(flop / flops.PEAK_BF16_FLOPS)
