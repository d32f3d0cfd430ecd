"""The hand-written kernels against their plain versions on a CUDA card:
the WaveRNN sampler (both conditioning layouts), monotonic alignment
search and the HiFi-GAN conv epilogue, with the generators' calls with
gradients off (the kernel) against the same calls with gradients on (its
plain version); the voice-conversion models (no kernel) in f32 on the card
against the same models on the CPU; and Tacotron's decode replayed from a
captured CUDA graph against the same decode stepped from Python.

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
from mockingbird_tpu_torch.ops.wavernn_sample import (CLUSTER, pack_wavernn_weights, plan,
                                                      resident_blocks, wavernn_sample,
                                                      wavernn_sample_plain)

pytestmark = pytest.mark.cuda

SMALL = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
             upsample_factors=[4, 4], hop_size=16, pad=2)


@pytest.fixture
def card():
    """The card, with TF32 off around the test (the plain versions are the
    reference: full f32 in matmuls and cuDNN), restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul


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


@pytest.mark.parametrize("t_len", [1, 96])
@pytest.mark.parametrize("n_folds", [1, 5, 9, 72])
@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("cfg", [SMALL, {}], ids=["small", "full"])
def test_kernel_matches_plain_across_shapes(card, cfg, weights, n_folds, t_len):
    """Fold counts that fill no 8-fold tile (1, 5, 9) and one that spans
    several (72), a single step and 96, at both widths (SMALL leaves most
    blocks without a GRU unit or fc column), in f32 and bf16, greedy and
    sampled, in both layouts: held against the plain version by the gap
    rule, and the two layouts equal."""
    model, mels, aux = _case(card, cfg, n_folds, t_len, seed=n_folds + t_len)
    w = pack_wavernn_weights(model, torch.float32 if weights == "f32" else torch.bfloat16)
    bound = 1e-3 if weights == "f32" else 5e-2
    for greedy in (True, False):
        p, gaps = wavernn_sample_plain(w, mels, aux, 11, greedy=greedy, return_gaps=True)
        k = wavernn_sample(w, mels, aux, 11, greedy=greedy)
        assert k.shape == (n_folds, t_len) and k.dtype == torch.int32
        _hold(k, p, gaps, bound)
        assert torch.equal(k, wavernn_sample(w, mels, aux, 11, greedy=greedy, time_major=False))


@pytest.mark.parametrize("rnn", [130, 131])
def test_kernel_at_odd_widths(card, rnn):
    """rnn 130 and 131 own more units than the card keeps blocks resident in
    clusters of 4, so the grid is rounded to whole clusters within that
    (blocks past the last owner own nothing), and widths that are not a
    multiple of 8 take the gathered conditioning and the exchange rows'
    gathered tails: held against the plain version by the gap rule, both
    layouts equal."""
    cfg = dict(SMALL, rnn_dims=rnn, fc_dims=rnn - 90)
    model, mels, aux = _case(card, cfg, 9, 48, seed=rnn)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for dtype, bound in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        w = pack_wavernn_weights(model, dtype)
        resident = resident_blocks(card, dtype)
        assert resident % CLUSTER == 0 and CLUSTER <= resident <= sms
        pl = plan(rnn, rnn - 90, 512, 4, 80, 9, dtype, resident)
        assert pl.grid % CLUSTER == 0 and pl.grid <= resident
        for greedy in (True, False):
            p, gaps = wavernn_sample_plain(w, mels, aux, 4, greedy=greedy, return_gaps=True)
            k = wavernn_sample(w, mels, aux, 4, greedy=greedy)
            _hold(k, p, gaps, bound)
            assert torch.equal(k, wavernn_sample(w, mels, aux, 4, greedy=greedy,
                                                 time_major=False))


def test_kernel_stages_folds_in_chunks(card):
    """200 folds exceed one shared-memory stage of activations in f32 (40
    folds), so every f32 layer is staged in chunks; in bf16 they stream
    through the ring in one pass of four 64-fold tiles, the last of 8: held
    against the plain version by the gap rule."""
    model, mels, aux = _case(card, {}, 200, 24, seed=4)
    for dtype, bound in ((torch.bfloat16, 5e-2), (torch.float32, 1e-3)):
        w = pack_wavernn_weights(model, dtype)
        pl = plan(512, 512, 512, 32, 80, 200, dtype, resident_blocks(card, dtype))
        if dtype == torch.float32:
            assert pl.fchunk < 200 and pl.slots == 0
        else:
            assert pl.fold_tiles() == [(0, 64), (64, 128), (128, 192), (192, 200)]
        k = wavernn_sample(w, mels, aux, 2)
        p, gaps = wavernn_sample_plain(w, mels, aux, 2, return_gaps=True)
        _hold(k, p, gaps, bound)


@pytest.mark.parametrize("n_folds", [1, 12, 58, 64, 65, 186, 256])
def test_ring_matches_plain_across_fold_tiles(card, n_folds):
    """bf16 weights take the tensor-core ring: one fold, a partial tile, a
    whole one and one fold past it, the cell's 186 (three tiles, the last of
    58) and 256 (four tiles: two rounds on the three consumer warpgroups),
    greedy and sampled, in both layouts: held against the plain version by
    the gap rule, the two layouts equal, every launch counted as a
    tensor-core launch."""
    model, mels, aux = _case(card, {}, n_folds, 24, seed=100 + n_folds)
    w = pack_wavernn_weights(model)
    pl = plan(512, 512, 512, 32, 80, n_folds, torch.bfloat16, resident_blocks(card))
    assert pl.slots >= 8 and len(pl.fold_tiles()) == -(-n_folds // 64)
    before = wavernn_sample.launches_tensor_core
    for greedy in (True, False):
        p, gaps = wavernn_sample_plain(w, mels, aux, 9, greedy=greedy, return_gaps=True)
        k = wavernn_sample(w, mels, aux, 9, greedy=greedy)
        assert k.shape == (n_folds, 24) and k.dtype == torch.int32
        _hold(k, p, gaps, 5e-2)
        assert torch.equal(k, wavernn_sample(w, mels, aux, 9, greedy=greedy, time_major=False))
    assert wavernn_sample.launches_tensor_core == before + 4


def test_f32_mode_stays_on_fma_tiles(card):
    """f32 weights (the parity mode; wgmma has no f32) keep the staged FMA
    tiles: their launches count as launches but not as tensor-core ones,
    and a bf16 launch does, on this thread too."""
    from mockingbird_tpu_torch.ops.wavernn_sample import tensor_core_launches
    model, mels, aux = _case(card, SMALL, 5, 16)
    before = (wavernn_sample.launches, wavernn_sample.launches_tensor_core,
              tensor_core_launches())
    wavernn_sample(pack_wavernn_weights(model, torch.float32), mels, aux, 0)
    assert (wavernn_sample.launches, wavernn_sample.launches_tensor_core,
            tensor_core_launches()) == (before[0] + 1, before[1], before[2])
    wavernn_sample(pack_wavernn_weights(model), mels, aux, 0)
    assert (wavernn_sample.launches, wavernn_sample.launches_tensor_core,
            tensor_core_launches()) == (before[0] + 2, before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k1_launch_span_records_tensor_core(card, dtype):
    """The vocoder's ``k1.launch`` span, recorded under a profiler session,
    has ``tensor_core`` 1 for a launch on the wgmma ring (bf16 weights, the
    vocoder's own) and 0 for one on the FMA tiles (f32)."""
    from torch.profiler import ProfilerActivity, profile

    from mockingbird_tpu_torch import tracing
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
    voc = WaveRnnVocoder(cfg=dict(SMALL, seq_len=64, gen_target_tpu=400, gen_overlap_tpu=50),
                         verbose=False, device=card)
    voc.packed = pack_wavernn_weights(voc.model, dtype)
    mels = [np.random.RandomState(k).randn(80, 60).astype(np.float32) for k in range(2)]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        voc.infer_waveform_batch(mels, max_lanes=7)
    launches = [s for s in tracing.spans() if s.name == "k1.launch"]
    assert launches and all(s.attrs["tensor_core"] == int(dtype == torch.bfloat16)
                            for s in launches)


def test_smoke_holds_k1_at_the_cells_fold_count(card):
    """``chip_smoke.hold_k1_call``, as the smoke runs it on a path's call,
    at the WaveRNN cell's 186 folds: greedy and sampled, f32 and bf16, no
    label differs from the plain version's before a fold's first near-tie."""
    import chip_smoke
    model, mels, aux = _case(card, {}, 186, 16, seed=186)
    err = chip_smoke.hold_k1_call(pack_wavernn_weights(model, torch.float32),
                                  pack_wavernn_weights(model), mels, aux, 11, 512)
    assert err == 0.0


def test_kernel_refuses_a_width_it_cannot_place(card):
    """rnn = fc = 2048 in bf16 puts 16 GRU units (48 rows of 2048) of each
    of four matrices on a block, past wgmma's N of 32 rows and beyond shared
    memory: the plan raises ValueError before any launch."""
    rnn, fc, a = 2048, 2048, 32
    shapes = {"I_w": (1 + 80 + a, rnn), "I_b": (rnn,), "g1_wi": (rnn, 3 * rnn),
              "g1_bi": (3 * rnn,), "g1_wh": (rnn, 3 * rnn), "g1_bn": (rnn,),
              "g2_wi": (rnn + a, 3 * rnn), "g2_bi": (3 * rnn,), "g2_wh": (rnn, 3 * rnn),
              "g2_bn": (rnn,), "fc1_w": (rnn + a, fc), "fc1_b": (fc,), "fc2_w": (fc + a, fc),
              "fc2_b": (fc,), "fc3_w": (fc, 512), "fc3_b": (512,)}
    w = {k: torch.zeros(v, dtype=torch.bfloat16, device=card) for k, v in shapes.items()}
    mels = torch.zeros(4, 8, 80, device=card)
    aux = torch.zeros(4, 8, 4 * a, device=card)
    before = wavernn_sample.launches
    with pytest.raises(ValueError, match="cannot place"):
        wavernn_sample(w, mels, aux, 0)
    assert wavernn_sample.launches == before


def _mas_case(card, b, t_y, t_x, t_ys, t_xs, seed=0, ties=False, scale=1.0):
    rng = np.random.RandomState(seed)
    nc = (rng.randn(b, t_y, t_x) * scale).astype(np.float32)
    if ties:
        nc = np.round(nc)
    return (torch.from_numpy(nc).to(card), torch.as_tensor(t_ys, dtype=torch.int32, device=card),
            torch.as_tensor(t_xs, dtype=torch.int32, device=card))


@pytest.mark.parametrize("case", ["ragged", "ties", "tx1", "square", "long",
                                  "tx31", "tx32", "tx33", "tx1024", "ty_below_tx"])
def test_mas_kernel_exact(card, case):
    """Every element of the kernel's path equals the plain version's."""
    rng = np.random.RandomState(1)
    b, t_y, t_x = 16, 1000, 160
    t_xs = rng.randint(1, t_x + 1, b)
    t_ys = np.maximum(rng.randint(1, t_y + 1, b), t_xs)
    ties, scale = case == "ties", 1.0
    if case == "ty_below_tx":
        # most elements have fewer rows than columns, which leaves no band:
        # every cell holds exactly -1e9. neg_cent of magnitude ~1e3 (VITS's
        # is in the hundreds) survives an add to -1e9, so a cell wrongly
        # taken as in the band changes the walk back
        t_y = 120
        t_ys = rng.randint(1, t_y + 1, b)
        t_ys[:4] = np.minimum(t_ys[:4], t_xs[:4])
        t_xs[4:12] = np.maximum(t_xs[4:12], t_ys[4:12] + 1)
        scale = 1000.0
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
    elif case.startswith("tx") and case != "tx1":
        # lane and warp edges: 31, 32 and 33 columns, and one full warp of
        # 32 columns per lane (ties, so the strict < is held at the edges)
        t_x = int(case[2:])
        t_y = 1200 if t_x == 1024 else 400
        t_xs = np.maximum(t_x - rng.randint(0, 3, b), 1)
        t_xs[0] = t_x
        t_ys = np.maximum(rng.randint(t_y // 2, t_y + 1, b), t_xs)
        ties = True
    nc, tys, txs = _mas_case(card, b, t_y, t_x, t_ys, t_xs, seed=3, ties=ties, scale=scale)
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


PPG_SMALL = dict(output_size=24, attention_heads=2, linear_units=48, num_blocks=2, cnn_kernel=7)
P2M_SMALL = dict(encoder_dim=32, attention_rnn_dim=32, decoder_rnn_dim=32, prenet_dims=[32, 16],
                 bottle_neck_feature_dim=24, num_mels=20)


def _random_bn_stats(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(rng.randn(m.num_features) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features)))


@pytest.mark.parametrize("width", ["small", "full"])
def test_ppg_extractor_on_card_matches_cpu(card, width):
    """Seeded f32 extractor, random BatchNorm statistics, two wavs of
    different lengths: the card (TF32 off) within 1e-4 of the CPU."""
    from mockingbird_tpu_torch.models.ppg import PPGExtractor
    cfg = PPG_SMALL if width == "small" else {}
    cpu = PPGExtractor(cfg=cfg, verbose=False, device="cpu")
    _random_bn_stats(cpu.model, np.random.RandomState(0))
    gpu = PPGExtractor(cfg=cfg, verbose=False, device=card)
    gpu.model.load_state_dict(cpu.model.state_dict())
    rng = np.random.RandomState(1)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32) for n in (37_000, 12_345)]
    for g, c in zip(gpu.extract_from_wavs(wavs), cpu.extract_from_wavs(wavs)):
        assert g.shape == c.shape
        np.testing.assert_allclose(g, c, atol=1e-4)


@pytest.mark.parametrize("width", ["small", "full"])
def test_ppg2mel_teacher_forced_on_card_matches_cpu(card, width):
    """Seeded f32 ``MelDecoderMOLv2``, prenet dropout off, random BatchNorm
    statistics, ragged lengths: every output of the teacher-forced forward
    on the card (TF32 off) within 1e-4 of the CPU."""
    from mockingbird_tpu_torch.models.ppg.ppg2mel import MelDecoderMOLv2, ppg2mel_config
    cfg = ppg2mel_config().merge(P2M_SMALL if width == "small" else {}).merge(
        dict(prenet_always_dropout=False))
    torch.manual_seed(0)
    cpu = MelDecoderMOLv2(cfg).eval()
    _random_bn_stats(cpu, np.random.RandomState(2))
    gpu = MelDecoderMOLv2(cfg).to(card).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    b, t = 3, 96
    lengths = np.array([96, 70, 41])
    inputs = [rng.randn(b, t, cfg.bottle_neck_feature_dim).astype(np.float32), lengths,
              rng.randn(b, t, cfg.num_mels).astype(np.float32), lengths,
              np.stack([rng.randn(b, t) + 5, rng.rand(b, t) > 0.3], -1).astype(np.float32),
              rng.randn(b, cfg.spk_embed_dim).astype(np.float32)]
    with torch.no_grad():
        want = cpu(*(torch.from_numpy(x) for x in inputs))
        got = gpu(*(torch.from_numpy(x).to(card) for x in inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)


TACO_SMALL = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
                  lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4),
                  speaker_embedding_size=8, max_r=4, n_mels=20, fft_bins=20)


def _taco_batch(cfg, b=2, t_text=32, t_mel=40, seed=0):
    rng = np.random.RandomState(seed)
    texts = np.zeros((b, t_text), np.int64)
    for i, n in enumerate(rng.randint(8, t_text + 1, b)):
        texts[i, :n] = rng.randint(1, 75, n)
    spk = rng.randn(b, cfg.speaker_embedding_size).astype(np.float32)
    stop = np.zeros((b, t_mel), np.float32)
    stop[:, -3:] = 1
    return dict(texts=texts, embeds=spk / np.linalg.norm(spk, axis=1, keepdims=True),
                mels=np.clip(rng.randn(b, t_mel, cfg.n_mels) * 2, -4, 4).astype(np.float32),
                stop=stop)


def _taco_pair(card, width):
    from mockingbird_tpu_torch.models.tacotron import Tacotron, tacotron_config
    cfg = tacotron_config().merge(TACO_SMALL if width == "small" else {})
    torch.manual_seed(0)
    cpu = Tacotron(cfg).train()
    gpu = Tacotron(cfg).to(card).train()
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


@pytest.mark.parametrize("width", ["small", "full"])
def test_tacotron_f32_step_on_card_matches_cpu(card, width):
    """One f32 training step of the seeded model, dropout and zoneout off,
    BatchNorm in batch-statistics mode: on the card (TF32 off) the loss
    within 1e-5 relative of the CPU's, the gradients within 1e-4 relative
    L2 at small width and 2e-3 at full width (measured 1.5e-6 and 1.2e-3;
    at full width only a run with cuDNN on is that far from the CPU, an
    open question, PERF.md §7: ``chip_smoke.py``'s hold prints the same
    comparison with cuDNN off). At small width also the update of the clip
    and one Adam step: within 1% of the learning rate of the CPU's on at
    least 99.9% of the parameters' elements. Adam's first step is
    lr·g/(|g| + 1e-8), the sign of the gradient, so an element whose
    gradient is within the card-CPU difference of 0 moves by ±lr on either
    side (the GST reference encoder's conv biases, before a BatchNorm in
    batch-statistics mode, have no gradient in exact arithmetic); at full
    width, with gradients 1e-3 apart, 1.3% of the elements did."""
    import importlib
    ttrain = importlib.import_module("mockingbird_tpu_torch.models.tacotron.train")
    from mockingbird_tpu_torch.train.precision import Policy
    cfg, cpu, gpu = _taco_pair(card, width)
    host = _taco_batch(cfg)
    zo = torch.zeros((20, 2, 2, cfg.lstm_dims), dtype=torch.bool)
    out = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", gpu, card)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, _, _ = ttrain.loss_of(m, b, 2, Policy.from_name("fp32"), zo_masks=zo.to(dev))
        loss.backward()
        grads = [p.grad.detach().cpu().double() for p in m.parameters()]
        m.zero_grad()
        before = [p.detach().cpu().clone() for p in m.parameters()]
        step = ttrain.make_train_step(m, ttrain.make_optimizer(m, 1e-3), 2, "fp32")
        step(b, None, zo.to(dev))
        update = [p.detach().cpu().double() - q for p, q in zip(m.parameters(), before)]
        out[name] = (loss.item(), grads, update)

    def rel_l2(got, want):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
        return (num / sum(float((b ** 2).sum()) for b in want)) ** 0.5
    (lc, gc, uc), (lg, gg, ug) = out["cpu"], out["card"]
    assert lg == pytest.approx(lc, rel=1e-5)
    assert rel_l2(gg, gc) <= (1e-4 if width == "small" else 2e-3)
    if width == "small":
        agree = sum(int(((a - b).abs() <= 1e-5).sum()) for a, b in zip(ug, uc))
        total = sum(u.numel() for u in uc)
        assert agree >= 0.999 * total, f"{total - agree} of {total} updates differ"


def test_tacotron_bf16_step_on_card(card):
    """The trainer's default precision on the card at small width: the
    bf16 loss within 1e-2 relative of the CPU's bf16 loss (other kernels,
    other roundings), finite gradients, and the bias slots flax lacks still
    exactly 0 after the step."""
    import importlib
    ttrain = importlib.import_module("mockingbird_tpu_torch.models.tacotron.train")
    from mockingbird_tpu_torch.train.precision import Policy
    cfg, cpu, gpu = _taco_pair(card, "small")
    host = _taco_batch(cfg, seed=1)
    zo = torch.from_numpy(np.random.RandomState(2).rand(20, 2, 2, cfg.lstm_dims) < 0.1)
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, card)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, _, _ = ttrain.loss_of(m, b, 2, Policy.from_name("bf16"), zo_masks=zo.to(dev))
        losses.append(loss.item())
    assert losses[1] == pytest.approx(losses[0], rel=1e-2)
    b = {k: torch.from_numpy(v).to(card) for k, v in host.items()}
    ttrain.make_train_step(gpu, ttrain.make_optimizer(gpu, 1e-3), 2, "bf16")(
        b, torch.Generator(device=card).manual_seed(0))
    assert all(bool(torch.isfinite(p.grad).all()) for p in gpu.parameters())
    for name, buf in gpu.named_buffers():
        if name.endswith(("bias_hh_rz", "bias_ih")):
            assert not bool(buf.ne(0).any()), name


def _synthesizer(card, seed=3):
    """The full-width synthesizer with weights drawn from ``seed``,
    dropout on, as inference runs it."""
    from mockingbird_tpu_torch.models.tacotron import Synthesizer
    syn = Synthesizer(verbose=False, seed=seed, device=card)
    syn.load()
    return syn


def _decode_inputs(card, b, seed):
    """``b`` texts of 9-32 symbols in the bucket of 32 and unit speaker
    embeddings."""
    rng = np.random.RandomState(seed)
    texts = np.zeros((b, 32), np.int64)
    for j in range(b):
        n = rng.randint(9, 33)
        texts[j, :n] = rng.randint(1, 75, n)
    spk = rng.randn(b, 256).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=1, keepdims=True)
    return torch.from_numpy(texts).to(card), torch.from_numpy(spk).to(card)


def _decode(syn, texts, spk, min_stop_token=11.0):
    """400 frames asked (200 steps at r = 2) → mels, attention, frames,
    ``done_at``."""
    return syn.generate(texts, spk, 400, 2, 0, "token", min_stop_token)


def _equal(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
            and torch.equal(a[3], b[3]))


@pytest.fixture
def eager_steps(monkeypatch):
    """Decoders that capture no graph: each step runs from Python."""
    from mockingbird_tpu_torch.models.tacotron import inference
    monkeypatch.setattr(inference._Decoder, "_capture", lambda self: None)


@pytest.mark.parametrize("min_stop_token", [11.0, 5.0], ids=["no_stop", "stop"])
@pytest.mark.parametrize("b", [16, 128])
def test_graphed_decode_equals_eager_bit_for_bit(card, request, b, min_stop_token):
    """The decode replayed from a captured CUDA graph, dropout drawn from
    the seeded generator, equals the same decode stepped from Python bit
    for bit: the first (which captures) and the second (which only
    replays); with the stop rule off and with it on (with seeded weights
    items stop early, so the loop ends at a read of the flags past the
    last stop)."""
    syn = _synthesizer(card)
    texts, spk = _decode_inputs(card, b, 0)
    first, second = _decode(syn, texts, spk, min_stop_token), _decode(syn, texts, spk,
                                                                      min_stop_token)
    request.getfixturevalue("eager_steps")
    eager = _decode(_synthesizer(card), texts, spk, min_stop_token)
    torch.cuda.synchronize()
    assert _equal(first, eager) and _equal(second, eager)
    if min_stop_token == 11.0:
        assert first[2] == 400
    assert not first[0][:, first[2]:].any()


def test_a_later_decode_leaves_returned_tensors_alone(card):
    """Every tensor a decode returns is its own: a second decode of other
    texts at the same shape, which replays the same graph over the same
    state, leaves the first call's mels, attention and ``done_at`` as
    they were."""
    syn = _synthesizer(card)
    first = _decode(syn, *_decode_inputs(card, 16, 1))
    kept = [first[k].clone() for k in (0, 1, 3)]
    second = _decode(syn, *_decode_inputs(card, 16, 2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, first[k]) for a, k in zip(kept, (0, 1, 3)))
    assert not torch.equal(first[0], second[0])


def test_a_second_shape_captures_a_second_graph(card, request):
    """A second batch size captures a graph of its own and is exact; the
    ``tacotron.decode`` span counts the graphs captured and the steps
    replayed: 1 and 200 for a new shape, 0 and 200 for a known one, 0 and 0
    stepped from Python."""
    from torch.profiler import ProfilerActivity, profile

    from mockingbird_tpu_torch import tracing
    syn = _synthesizer(card)
    inputs = [_decode_inputs(card, 16, 4), _decode_inputs(card, 16, 5),
              _decode_inputs(card, 8, 6)]
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            graphed = [_decode(syn, *x) for x in inputs]
        request.getfixturevalue("eager_steps")
        eager_syn = _synthesizer(card)
        with profile(activities=[ProfilerActivity.CUDA]):
            eager = [_decode(eager_syn, *x) for x in inputs]
        torch.cuda.synchronize()
        decodes = [s.attrs for s in tracing.spans() if s.name == "tacotron.decode"]
    finally:
        tracing.clear()
    assert [(d["batch"], d["captures"], d["graphed"], d["steps_run"]) for d in decodes] == [
        (16, 1, 200, 200), (16, 0, 200, 200), (8, 1, 200, 200),
        (16, 0, 0, 200), (16, 0, 0, 200), (8, 0, 0, 200)]
    assert len(syn._decoders) == 2
    assert all(_equal(g, e) for g, e in zip(graphed, eager))


def test_mol_loss_and_sampler_on_card_match_cpu(card):
    """The mixture-of-logistics loss and the sampler with handed-in draws:
    the card within 1e-5 (loss, relative) and 1e-6 (samples) of the CPU."""
    from mockingbird_tpu_torch.models.vocoder import distribution as dist
    rng = np.random.RandomState(0)
    y_hat = torch.from_numpy(rng.randn(4, 300, 30).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (4, 300, 1)).astype(np.float32))
    draws = (-torch.log(-torch.log(torch.from_numpy(rng.uniform(1e-6, 1, (4, 300, 10))
                                                    .astype(np.float32)))),
             torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, (4, 300)).astype(np.float32)))
    want = dist.discretized_mix_logistic_loss(y_hat, y)
    got = dist.discretized_mix_logistic_loss(y_hat.to(card), y.to(card))
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    want = dist.sample_from_discretized_mix_logistic(y_hat, draws=draws)
    got = dist.sample_from_discretized_mix_logistic(y_hat.to(card),
                                                    draws=tuple(d.to(card) for d in draws))
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


def test_mol_generator_on_card_matches_cpu(card):
    """``WaveRnnVocoder.generate`` in MOL mode at small width, 3 folds x 200
    steps with handed-in draws: the card (TF32 off) within 1e-4 of the
    CPU."""
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
    cpu = WaveRnnVocoder(cfg=dict(SMALL, mode="MOL"), verbose=False, seed=0, device="cpu")
    gpu = WaveRnnVocoder(cfg=dict(SMALL, mode="MOL"), verbose=False, seed=0, device=card)
    rng = np.random.RandomState(1)
    mels = torch.from_numpy(rng.randn(3, 200, 80).astype(np.float32) * 0.5)
    aux = torch.from_numpy(rng.randn(3, 200, 16).astype(np.float32) * 0.5)
    draws = (-torch.log(-torch.log(torch.from_numpy(rng.uniform(1e-6, 1, (200, 3, 10))
                                                    .astype(np.float32)))),
             torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, (200, 3)).astype(np.float32)))
    want = cpu.generate(mels, aux, draws=draws)
    got = gpu.generate(mels.to(card), aux.to(card), draws=tuple(d.to(card) for d in draws))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["hifigan", "fregan"])
def test_discriminators_with_spectral_norm_on_card_match_cpu(card, arch):
    """Both discriminator bundles at full width, seeded, on (2, 4096) real
    and generated wavs with ``train`` on (the spectral-norm statistics
    move): every score and feature map on the card (TF32 off) within 1e-4
    relative L2 of the CPU's, the stored ``u``/``sigma`` within 1e-5, and
    the gradients of a discriminator loss within 1e-4 relative L2."""
    from mockingbird_tpu_torch.models.vocoder import gan_losses
    from mockingbird_tpu_torch.models.vocoder.fregan import FreGanDiscriminators
    from mockingbird_tpu_torch.models.vocoder.hifigan import HifiganDiscriminators
    cls = HifiganDiscriminators if arch == "hifigan" else FreGanDiscriminators
    torch.manual_seed(0)
    cpu = cls()
    gpu = cls().to(card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    y, y_hat = torch.from_numpy((0.3 * rng.randn(2, 2, 4096)).astype(np.float32))
    outs = {}
    for name, m in (("cpu", cpu), ("card", gpu)):
        dev = next(m.parameters()).device
        mpd, msd = m(y.to(dev), y_hat.to(dev), True)
        loss = (gan_losses.discriminator_loss(mpd[0], mpd[1])[0]
                + gan_losses.discriminator_loss(msd[0], msd[1])[0])
        loss.backward()
        flat = [t for out in (mpd, msd) for part in out for x in part
                for t in (x if isinstance(x, list) else [x])]
        outs[name] = ([t.detach().cpu() for t in flat], [p.grad.cpu() for p in m.parameters()],
                      [b.cpu() for n, b in m.named_buffers() if n.endswith((".u", ".sigma"))])
    for got, want in zip(outs["card"][0], outs["cpu"][0]):
        assert float((got - want).norm()) <= 1e-4 * float(want.norm())
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(outs["card"][1], outs["cpu"][1]))
    assert num ** 0.5 <= 1e-4 * sum(float((b ** 2).sum()) for b in outs["cpu"][1]) ** 0.5
    for got, want in zip(outs["card"][2], outs["cpu"][2]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("width", ["small", "full"])
def test_wavernn_training_forward_on_card_matches_cpu(card, width):
    """The WaveRNN training forward (``train()``: batch-statistics
    BatchNorms, the GRUs through the fused call) at batch 4 × 1280 steps,
    seeded: the logits on the card (TF32 off) within 1e-4 of the CPU's
    largest, the moved running statistics within 1e-5, and with ``remat``
    the same logits."""
    cfg = wavernn_config().merge(dict(SMALL, seq_len=1280) if width == "small" else {})
    torch.manual_seed(0)
    cpu = WaveRNN(cfg).train()
    gpu = WaveRNN(cfg.merge(dict(remat=False))).to(card).train()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    t_frames = 1280 // cfg.hop_size
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 1280)).astype(np.float32))
    mels = torch.from_numpy((rng.randn(4, t_frames + 2 * cfg.pad, 80) * 0.5).astype(np.float32))
    want = cpu(x, mels).detach()
    got = gpu(x.to(card), mels.to(card)).detach()
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4 * scale, rtol=0)
    for (name, a), b in zip(gpu.named_buffers(), cpu.buffers()):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0, msg=name)
    gpu.remat = True
    again = gpu(x.to(card), mels.to(card)).detach()
    torch.testing.assert_close(again, got, atol=1e-6 * scale, rtol=0)


def _rel_l2(got, want):
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((b ** 2).sum()) for b in want)) ** 0.5


@pytest.mark.parametrize("remat", [False, True])
def test_ge2e_f32_step_on_card_matches_cpu(card, remat):
    """The GE2E loss at full width (3 × LSTM 256), batch 4 speakers × 3
    partials × 160 frames, seeded: on the card (TF32 off) the loss within
    1e-5 relative of the CPU's, the EER within one rank (1/12), the
    gradients within 1e-3 relative L2; with ``remat`` the same."""
    from mockingbird_tpu_torch.models.encoder import model as enc
    s, u = 4, 3
    x = torch.from_numpy(np.abs(np.random.RandomState(0).randn(s * u, 160, 40))
                         .astype(np.float32))
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", card)):
        p = enc.init_params(0, remat=remat and name == "card").to(dev).train()
        embeds = p["model"](x.to(dev)).reshape(s, u, -1)
        loss, sim = enc.ge2e_loss(embeds, p["similarity"]["weight"], p["similarity"]["bias"])
        loss.backward()
        out[name] = (loss.item(), float(enc.equal_error_rate(sim, s, u)),
                     [q.grad.detach().cpu().double() for q in p.parameters()])
    (lc, ec, gc), (lg, eg, gg) = out["cpu"], out["card"]
    assert lg == pytest.approx(lc, rel=1e-5)
    assert abs(eg - ec) <= 1 / (s * u)
    assert _rel_l2(gg, gc) <= 1e-3


def test_ppg2mel_f32_training_step_on_card_matches_cpu(card):
    """The ppg2mel training forward at full width (``ppg2mel_config()``),
    batch 2 × 64 frames (32 decoder steps), seeded, every dropout mask
    handed in: on the card (TF32 off) the loss within 1e-5 relative of the
    CPU's, the gradients within 1e-3 relative L2, the moved BatchNorm
    statistics within 1e-5."""
    import importlib
    from mockingbird_tpu_torch.models.ppg import MelDecoderMOLv2, ppg2mel_config
    ptrain = importlib.import_module("mockingbird_tpu_torch.models.ppg.train")
    cfg = ppg2mel_config()
    rng = np.random.RandomState(0)
    items = [(rng.randn(n, 144).astype(np.float32),
              np.stack([rng.randn(n), rng.rand(n) > 0.3], -1).astype(np.float32),
              np.clip(rng.randn(n, 80) * 2, -4, 4).astype(np.float32),
              rng.randn(256).astype(np.float32)) for n in (64, 41)]
    host = ptrain.collate_vc(items)
    b, t = host["mels"].shape[:2]

    def keep(*shape):
        return torch.from_numpy(rng.rand(*shape) >= 0.5)
    masks = {"prenet": [keep(b, d) for d in cfg.prenet_dims], "attention": keep(b, 5),
             "postnet": [keep(b, t, 512) for _ in range(4)] + [keep(b, t, 80)]}
    torch.manual_seed(0)
    cpu = MelDecoderMOLv2(cfg).train()
    gpu = MelDecoderMOLv2(cfg).to(card).train()
    gpu.load_state_dict(cpu.state_dict())
    out = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", gpu, card)):
        bt = ptrain.to_device(host, dev)
        mk = {k: [x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)
              for k, v in masks.items()}
        o = m(*(bt[k] for k in ("ppgs", "lengths", "mels", "lengths", "lf0s", "embeds")),
              masks=mk)
        loss = ptrain.vc_loss(o, bt)[0]
        loss.backward()
        out[name] = (loss.item(), [q.grad.detach().cpu().double() for q in m.parameters()])
    assert out["card"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    assert _rel_l2(out["card"][1], out["cpu"][1]) <= 1e-3
    for (name, a), b in zip(gpu.named_buffers(), cpu.buffers()):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0, msg=name)


@pytest.mark.parametrize("width", ["small", "full"])
def test_emotion_extractor_on_card_matches_cpu(card, width):
    """Seeded f32 wav2vec2 emotion extractor (full: ``wav2emo_config()``, 12
    x 1024 pre-LN, about 164 M parameters; small: 2 x 64 post-LN with the
    group norm), two wavs of different lengths in one 1 s bucket padding:
    embeddings and logits on the card (TF32 off) within 1e-4 relative L2 of
    the CPU."""
    from mockingbird_tpu_torch.models.tacotron.emotion import EmotionExtractor
    cfg = {} if width == "full" else dict(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        feat_extract_norm="group", do_stable_layer_norm=False)
    cpu = EmotionExtractor(cfg=cfg, seed=0, device="cpu")
    gpu = EmotionExtractor(cfg=cfg, seed=0, device=card)
    rng = np.random.RandomState(0)
    wavs = [(0.3 * rng.randn(n)).astype(np.float32) for n in (32_000, 21_111)]
    for g, c in zip(gpu.extract_batch(wavs), cpu.extract_batch(wavs)):
        assert g.shape == c.shape and np.isfinite(g).all()
        assert np.linalg.norm(g - c) <= 1e-4 * np.linalg.norm(c)


@pytest.mark.parametrize("frames", [31, 47])
def test_unbatched_vocoder_launches_k1_once_at_one_fold(card, frames):
    """``infer_waveform(batched=False)``: the whole utterance (frames · 256
    steps at the full width) as one fold, one K1 launch at F=1, greedy f32
    labels held against the plain version by the gap rule."""
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
    voc = WaveRnnVocoder(verbose=False, seed=0, device=card)
    voc.packed = pack_wavernn_weights(voc.model, torch.float32)
    captured = []
    import mockingbird_tpu_torch.models.vocoder.wavernn as wavernn_module
    real = wavernn_module.wavernn_sample

    def recording(w, mels, aux, *a, **k):
        captured.append((mels, aux))
        return real(w, mels, aux, *a, **k)

    wavernn_module.wavernn_sample = recording
    try:
        before = wavernn_sample.launches
        mel = np.random.RandomState(frames).randn(80, frames).astype(np.float32)
        wav = voc.infer_waveform(mel, batched=False, greedy=True)
        assert wavernn_sample.launches == before + 1
    finally:
        wavernn_module.wavernn_sample = real
    (mels, aux), = captured
    assert mels.shape[:2] == (1, frames * voc.cfg.hop_size)
    assert wav.shape == ((frames - 1) * voc.cfg.hop_size,) and np.isfinite(wav).all()
    p, gaps = wavernn_sample_plain(voc.packed, mels, aux, 0, greedy=True, return_gaps=True)
    k = wavernn_sample(voc.packed, mels, aux, 0, greedy=True)
    _hold(k, p, gaps, 1e-3)


def test_nccl_world_of_one_trains_as_no_group(card):
    """``initialize_from_env`` on the card with ``MB_*`` set to a world of
    one picks NCCL, and two GE2E steps on it give the losses the same steps
    give without a group (a subprocess each; the group's collectives are
    then identities, but they run)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    script = """
import json, sys, numpy as np, torch
from mockingbird_tpu_torch.parallel import multihost
started = multihost.initialize_from_env("cuda")
from mockingbird_tpu_torch.models.encoder.model import init_params
from mockingbird_tpu_torch.models.encoder.train import make_optimizer, make_train_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = multihost.rank_device("cuda")
params = init_params(0, 64, 32).to(dev).train()
opt = make_optimizer(params)
multihost.make_global(params, opt)
step = make_train_step(params, opt, 4, 3, "fp32")
rng = np.random.RandomState(0)
losses = [float(step(torch.from_numpy(rng.randn(4, 3, 20, 40).astype(np.float32)).to(dev))[0])
          for _ in range(2)]
backend = torch.distributed.get_backend() if started else None
print("OUT " + json.dumps(dict(started=started, backend=backend, losses=losses)))
multihost.shutdown()
"""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    runs = {}
    base = {k: v for k, v in os.environ.items() if not k.startswith("MB_")}
    for name, extra in (("group", dict(MB_COORDINATOR=f"localhost:{port}", MB_NUM_PROCESSES="1",
                                       MB_PROCESS_ID="0")), ("none", {})):
        out = subprocess.run([sys.executable, "-c", script], env=dict(base, **extra),
                             capture_output=True, text=True, timeout=300,
                             cwd=str(__import__("pathlib").Path(__file__).parents[1]))
        assert out.returncode == 0, out.stderr[-3000:]
        runs[name] = json.loads([ln for ln in out.stdout.splitlines()
                                 if ln.startswith("OUT ")][0][4:])
    assert runs["group"]["started"] and runs["group"]["backend"] == "nccl"
    assert not runs["none"]["started"]
    np.testing.assert_allclose(runs["group"]["losses"], runs["none"]["losses"], rtol=1e-6)


# the HiFi-GAN conv epilogue: each case's arguments to ``conv_epilogue``
EPILOGUE_CASES = {
    "conv": dict(bias=True, slope=0.1),                  # a ResBlock's first conv, conv_pre
    "post": dict(bias=True, tanh=True),                  # conv_post
    "post_no_bias": dict(tanh=True),                     # VITS's conv_post
    "act_only": dict(slope=0.1),                         # VITS after conv_pre
    "residual": dict(bias=True, residual=True, slope=0.1, keep_x=True),
    "first_block": dict(bias=True, residual=True),
    "middle_block": dict(bias=True, residual=True, block_sum=True),
    "last_block": dict(bias=True, residual=True, block_sum=True, n_blocks=3, slope=0.01),
    "single_block": dict(bias=True, residual=True, n_blocks=1, slope=0.1),
}


@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
@pytest.mark.parametrize("t_len", [1, 37, 203])
@pytest.mark.parametrize("channels", [512, 256, 128, 64, 32, 12, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_conv_epilogue_kernel_bit_for_bit(card, dtype, channels, t_len, case):
    """The kernel against its plain version (the unfused operators) on the
    card, bit for bit: every case the generators use, at the generators'
    widths, 12 (no 16-byte vector of channels) and 1 (conv_post), at
    lengths that are not multiples of a vector; the result written in
    place where the wrapper says, one launch counted."""
    from mockingbird_tpu_torch.ops import conv_epilogue as ce
    kw = dict(EPILOGUE_CASES[case])
    gen = torch.Generator(device=card).manual_seed(channels * 1000 + t_len)

    def draw(*shape):
        return (2 * torch.randn(*shape, generator=gen, device=card)).to(dtype)
    y = draw(3, t_len, channels)
    args = dict(bias=draw(channels) if kw.pop("bias", False) else None,
                residual=draw(*y.shape) if kw.pop("residual", False) else None,
                block_sum=draw(*y.shape) if kw.pop("block_sum", False) else None, **kw)
    want = ce.conv_epilogue_plain(y, **args)
    y_in, sum_in = y.clone(), None if args["block_sum"] is None else args["block_sum"].clone()
    before = ce.launches()
    with torch.no_grad():                  # where ``conv_epilogue`` launches the kernel
        got = ce.conv_epilogue(y_in, **dict(args, block_sum=sum_in))
    torch.cuda.synchronize()
    assert ce.launches() == before + 1
    want, got = ((want,), (got,)) if torch.is_tensor(want) else (want, got)
    for w, g in zip(want, got):
        assert g.dtype == dtype and g.shape == y.shape
        assert torch.equal(g, w), (case, float((g.float() - w.float()).abs().max()))
    in_place = sum_in if sum_in is not None and not (kw.get("slope") or kw.get("tanh")) else y_in
    assert got[0].data_ptr() == in_place.data_ptr()


@torch.no_grad()
def test_conv_epilogue_refuses_what_it_does_not_take(card):
    from mockingbird_tpu_torch.ops.conv_epilogue import conv_epilogue
    y = torch.zeros(2, 5, 8, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv_epilogue(y.half(), slope=0.1)
    with pytest.raises(ValueError):
        conv_epilogue(y.transpose(1, 2), slope=0.1)
    with pytest.raises(ValueError):
        conv_epilogue(y, torch.zeros(4, device=card, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        conv_epilogue(y, residual=torch.zeros(2, 5, 8, device=card))


FLAGSHIP_GAN = dict(upsample_rates=[8, 8, 4], upsample_kernel_sizes=[16, 16, 8], hop_size=256)


def test_hifigan_channels_last_on_card_matches_unfused(card):
    """The flagship's bf16 generator at its published widths, seeded, on 4
    mels x 64 frames: the same call with gradients off (every conv followed
    by the epilogue kernel, 59 launches) and on (the plain epilogue, no
    launch), on the same card and the same convolutions, bit for bit."""
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    from mockingbird_tpu_torch.ops.conv_epilogue import launches
    half = GanVocoder("hifigan", cfg=FLAGSHIP_GAN, seed=5, verbose=False, device=card)
    mel = torch.from_numpy(np.random.RandomState(5).randn(4, 64, 80).astype(np.float32))
    mel = mel.to(card, torch.bfloat16)
    before = launches()
    with torch.no_grad():
        new = half.model(mel)
    assert launches() - before == half.n_convs == 59
    with torch.enable_grad():
        old = half.model(mel).detach()
    assert launches() - before == 59
    assert new.shape == old.shape == (4, 64 * 256)
    assert torch.equal(new, old), float((new.float() - old.float()).abs().max())


def test_vits_decoder_channels_last_on_card_matches_unfused(card):
    """VITS's float32 decoder at its published widths, seeded, on 4 x 64
    frames with the speaker conditioning: the same call with gradients off
    (the epilogue kernel) and on (its plain version), on the same card and
    the same convolutions, bit for bit."""
    from mockingbird_tpu_torch.models.vits.model import VitsGenerator, vits_config
    from mockingbird_tpu_torch.ops.conv_epilogue import launches
    torch.manual_seed(7)
    cfg = vits_config().merge(dict(upsample_rates=[8, 8, 2, 2],
                                   upsample_kernel_sizes=[16, 16, 4, 4], gin_channels=256))
    dec = VitsGenerator(cfg).to(card).eval()
    rng = np.random.RandomState(7)
    z = torch.from_numpy(rng.randn(4, 64, cfg.inter_channels).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.randn(4, 1, 256).astype(np.float32)).to(card)
    before = launches()
    with torch.no_grad():
        new = dec(z, g=g)
    assert launches() - before == 78
    with torch.enable_grad():
        old = dec(z, g=g).detach()
    assert launches() - before == 78
    assert new.shape == old.shape == (4, 64 * 256)
    assert torch.equal(new, old), float((new - old).abs().max())


def test_hifigan_with_gradients_runs_unfused_on_card(card):
    """With gradients on (training), the generator takes the plain
    epilogue on the card: no epilogue launched, a gradient through every
    weight."""
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    from mockingbird_tpu_torch.ops.conv_epilogue import launches
    voc = GanVocoder("hifigan", cfg=FLAGSHIP_GAN, seed=5, verbose=False, device=card)
    mel = torch.randn(1, 8, 80, device=card, dtype=torch.bfloat16)
    before = launches()
    with torch.enable_grad():
        wav = voc.model(mel)
        wav.float().square().mean().backward()
    assert launches() == before
    assert all(p.grad is not None for p in voc.model.parameters())
