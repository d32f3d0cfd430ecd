"""The port's program spans (``mockingbird_tpu_torch/tracing.py``): off
outside a profiler session, the same output with them on and off, the span
tree of a fused, a staged and a VITS ``tts_batch`` call at small widths on
the CPU, the vocoder's own span, VITS's frame counters, the recorder's
arithmetic, its buffer and its threads; and on a CUDA card, the spans
against the kernels on the profiler's clock.

The card case skips without one. On the card's machine it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mockingbird_tpu_torch import tracing
from mockingbird_tpu_torch.models.tacotron import Synthesizer
from mockingbird_tpu_torch.models.tacotron.model import tacotron_config
from mockingbird_tpu_torch.models.vocoder import GanVocoder, WaveRnnVocoder
from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
from mockingbird_tpu_torch.text import romanize, text_to_sequence

REF_WAV = "saved_models/gan_run/eval/ground_truth.wav"
TACO = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
            lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4),
            max_r=4, prenet_dropout=False)
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
           upsample_factors=[4, 4], hop_size=16, seq_len=16 * 4, pad=2,
           gen_target_tpu=400, gen_overlap_tpu=50)
GAN = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
           resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
           segment_size=1600, hop_size=16)
TEXTS = ["ni3 hao3, shi4 jie4", "你好，欢迎使用语音克隆"]
# the stop rule never met: every decode runs the 200 frames asked, 100 steps at r = 2
CALL = dict(steps=200, min_stop_token=1000)
STEPS = 100

FUSED_CHILDREN = {"pipeline.embed", "tacotron.text", "tacotron.decode", "hifigan.vocode",
                  "pipeline.fetch_wait", "pipeline.unpack"}
STAGED_CHILDREN = {"pipeline.embed", "tacotron.text", "tacotron.decode", "tacotron.to_host",
                   "wavernn.fold", "k1.launch", "wavernn.labels_wait", "wavernn.finalize",
                   "pipeline.unpack"}


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _pipeline(vocoder):
    pipe = VoiceCloningPipeline(verbose=False, device="cpu", vocoder=vocoder)
    pipe.synthesizer = Synthesizer(cfg=tacotron_config().merge(TACO), verbose=False,
                                   device="cpu")
    return pipe


@pytest.fixture(scope="module")
def fused():
    return _pipeline(GanVocoder("hifigan", cfg=GAN, half=False, verbose=False, device="cpu"))


@pytest.fixture(scope="module")
def staged():
    return _pipeline(WaveRnnVocoder(cfg=VOC, verbose=False, device="cpu"))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_no_span_outside_a_profiler_session(fused):
    assert not torch.autograd._profiler_enabled()
    with tracing.span("tts_batch") as root:
        root.set("texts", 1)
        with tracing.span("tacotron.step"):
            pass
    fused.tts_batch(TEXTS[:1], REF_WAV, **CALL)
    assert tracing.spans() == [] and tracing.dropped() == 0
    _profiled(lambda: tracing.span("x").__enter__().__exit__(None, None, None))
    assert [s.name for s in tracing.spans()] == ["x"]


@pytest.mark.parametrize("which", ["fused", "staged"])
def test_spans_on_and_off_give_the_same_output(which, request):
    pipe = request.getfixturevalue(which)
    off = pipe.tts_batch(TEXTS, REF_WAV, **CALL)
    on = _profiled(lambda: pipe.tts_batch(TEXTS, REF_WAV, **CALL))
    assert tracing.spans()
    assert [o.dtype for o in off] == [np.int16] * 2
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def _tree(pipe, children, fused):
    """One profiled call: every span shares the root's call id, lies inside
    its parent, and the root's children are ``children``; the decode ran
    the steps it was asked, eagerly on the CPU, one ``tacotron.step`` span
    each; every 16th step and the last hold one ``tacotron.step_wait``."""
    _profiled(lambda: pipe.tts_batch(TEXTS, REF_WAV, **CALL))
    found = tracing.spans()
    roots = [s for s in found if s.parent is None]
    assert [r.name for r in roots] == ["tts_batch"]
    root = roots[0]
    assert root.attrs == {"texts": len(TEXTS), "fused": int(fused)}
    by_id = {s.id: s for s in found}
    assert len(by_id) == len(found)
    for s in found:
        assert s.call == root.id and s.thread == root.thread
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s.name, p.name)
    assert {s.name for s in found if s.parent == root.id} == children
    decode = [s for s in found if s.name == "tacotron.decode"]
    assert len(decode) == 1
    assert decode[0].attrs == {"batch": len(TEXTS), "steps_asked": STEPS, "steps_run": STEPS,
                               "graphed": 0, "captures": 0}
    steps = sorted((s for s in found if s.name == "tacotron.step"), key=lambda s: s.start_ns)
    waits = [s for s in found if s.name == "tacotron.step_wait"]
    assert len(steps) == STEPS
    assert all(s.parent == decode[0].id for s in steps)
    assert sorted(w.parent for w in waits) == [steps[k].id for k in (*range(15, STEPS, 16),
                                                                      STEPS - 1)]
    return found


def test_fused_call_span_tree(fused):
    found = _tree(fused, FUSED_CHILDREN, fused=True)
    assert not [s for s in found if s.name.startswith(("wavernn.", "k1."))]


def test_vocode_span_counts_the_generators_convs(fused):
    """``hifigan.vocode`` carries ``convs``, the generator's convolutions
    (conv_pre, 2 upsamples each followed by 2 ResBlock1s of 2 conv pairs,
    conv_post), and ``fused_convs``, those followed by the hand-written
    epilogue: none on the CPU."""
    _profiled(lambda: fused.tts_batch(TEXTS, REF_WAV, **CALL))
    vocode = [s for s in tracing.spans() if s.name == "hifigan.vocode"]
    assert [s.attrs for s in vocode] == [{"convs": 1 + 2 * (1 + 2 * 2 * 2) + 1,
                                          "fused_convs": 0}]


@pytest.mark.parametrize("pcm_format", ["int16", "mulaw8", "float32"])
def test_vocode_device_records_its_own_span(fused, pcm_format):
    """``vocode_device`` called alone, outside ``tts_batch``, records one
    root ``hifigan.vocode`` span around its whole call, the quantisation
    included, with the same attributes."""
    mel = torch.randn(2, 8, 80)
    wav = _profiled(lambda: fused.vocoder.vocode_device(mel, pcm_format=pcm_format))
    assert wav.shape == (2, 8 * 16)
    vocode = tracing.spans()
    assert [(s.name, s.parent, s.attrs) for s in vocode] == [
        ("hifigan.vocode", None, {"convs": 1 + 2 * (1 + 2 * 2 * 2) + 1, "fused_convs": 0})]


def test_staged_call_span_tree(staged):
    found = _tree(staged, STAGED_CHILDREN, fused=False)
    launches = [s for s in found if s.name == "k1.launch"]
    # 200 frames × hop 16 = 3200 samples: 7 folds of 400 + 2·50 an utterance;
    # on the CPU the plain version runs, not the tensor cores
    assert [s.attrs for s in launches] == [{"F": 7 * len(TEXTS), "T": 500, "tensor_core": 0}]
    names = [s.name for s in sorted(found, key=lambda s: s.start_ns)
             if s.name.startswith(("wavernn.", "k1."))]
    assert names == ["wavernn.fold", "k1.launch", "wavernn.labels_wait", "wavernn.finalize"]


VITS_CHILDREN = {"pipeline.embed", "vits.text", "vits.encode", "vits.duration",
                 "vits.expand", "vits.flow", "vits.decode", "pipeline.fetch_wait",
                 "pipeline.unpack"}
VITS_STAGES = ("vits.encode", "vits.duration", "vits.expand", "vits.flow", "vits.decode")
VITS_FRAMES = 40


# the small VITS of ``tests/test_torch_vits.py``
VITS = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
            upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=64,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], spec_channels=65,
            segment_size=16 * 8, hop_size=16, n_speakers=4, gin_channels=16,
            emotion_channels=8, n_fft=128, win_size=128, num_mels=20)


@pytest.fixture(scope="module")
def vits():
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    pipe = VoiceCloningPipeline(synthesizer="vits", verbose=False, device="cpu")
    pipe.synthesizer = VitsSynthesizer(cfg=VITS, verbose=False, seed=2, device="cpu")
    return pipe


def test_vits_call_span_tree(vits):
    """A VITS ``tts_batch`` of two chunks records nothing outside a profiler
    session and the same output with spans on; under one, the host's text
    work and every stage of ``Vits.infer`` once a chunk, each under the
    root, the stages in order and each with ``batch``, ``t_text`` and
    ``max_frames``."""
    texts = TEXTS + TEXTS[:1]
    kw = dict(steps=VITS_FRAMES, batch_size=2)
    off = vits.tts_batch(texts, REF_WAV, **kw)
    assert tracing.spans() == []
    on = _profiled(lambda: vits.tts_batch(texts, REF_WAV, **kw))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    found = tracing.spans()
    (root,) = [s for s in found if s.parent is None]
    assert root.name == "tts_batch" and root.attrs == {"texts": 3, "fused": 1}
    assert all(s.call == root.id and s.parent == root.id for s in found if s is not root)
    assert {s.name for s in found if s is not root} == VITS_CHILDREN
    order = [s.name for s in sorted(found, key=lambda s: s.start_ns) if s.name in VITS_STAGES]
    assert order == list(VITS_STAGES) * 2
    t_text = [16 * -(-max(len(text_to_sequence(romanize(t))) for t in c) // 16)
              for c in (texts[:2], texts[2:])]
    stages = sorted((s for s in found if s.name in VITS_STAGES), key=lambda s: s.start_ns)
    assert [s.attrs for s in stages] == [
        {"batch": b, "t_text": t, "max_frames": VITS_FRAMES}
        for b, t in ((2, t_text[0]), (1, t_text[1])) for _ in VITS_STAGES]
    assert [s.name for s in found].count("vits.text") == 2
    assert [s.name for s in found].count("pipeline.fetch_wait") == 2


def test_vits_frame_counters(vits):
    """The two counters add ``max_frames`` a text and Σ ``y_lengths``, where
    the lengths reach the host, in ``tts_batch`` and in ``synthesize``."""
    from mockingbird_tpu_torch.models.vits import inference
    syn = vits.synthesizer
    before = inference.counts()
    pcm = vits.tts_batch(TEXTS, REF_WAV, steps=VITS_FRAMES, batch_size=2)
    wavs = syn.synthesize(TEXTS[:2], max_frames=VITS_FRAMES + 8)
    after = inference.counts()
    hop = syn.cfg.hop_size
    assert after["frames_decoded"] - before["frames_decoded"] == (
        VITS_FRAMES * len(TEXTS) + (VITS_FRAMES + 8) * 2)
    assert after["frames_returned"] - before["frames_returned"] == (
        sum(len(p) for p in pcm + wavs) // hop)
    assert all(len(p) % hop == 0 for p in pcm + wavs)


def test_graphed_share_reads_the_decode_spans(monkeypatch):
    """The benchmark's reader of ``tacotron.graphed_pct`` on hand-made
    decodes: Σ ``graphed`` over Σ ``steps_run`` inside the window; None
    where a decode span has no ``graphed``, as a program that does not
    count it records, or where no decode lies inside the window."""
    from benchmark.harness import registry
    read = registry.reader("tacotron.graphed_pct").read
    run = SimpleNamespace(spans=[("window", 0.0, 1.0, 100, 200)])

    def decode(steps_run, t0=110, **graphed):
        return tracing.Span("tacotron.decode", t0, t0 + 10, attrs=dict(steps_run=steps_run,
                                                                     **graphed))
    for found, want in (([decode(400, graphed=400), decode(100, graphed=0),
                          decode(400, t0=300, graphed=0)], 80.0),
                        ([decode(400, graphed=0)], 0.0),
                        ([decode(400, graphed=400), decode(400)], None),
                        ([decode(400, t0=300, graphed=400)], None)):
        monkeypatch.setattr(tracing, "spans", lambda: found)
        assert read(run) == (want if want is None else pytest.approx(want))


def test_self_time_and_window():
    S = tracing.Span
    found = [S("call", 0, 100, id=1, call=1), S("a", 10, 30, id=2, parent=1, call=1),
             S("b", 40, 50, id=3, parent=1, call=1), S("a_wait", 12, 20, id=4, parent=2, call=1),
             S("later", 200, 210, id=5, call=5)]
    assert tracing.self_ns(found) == {1: 70, 2: 12, 3: 10, 4: 8, 5: 10}
    # a child outside the list given takes nothing off its parent
    assert tracing.self_ns(found[:3]) == {1: 70, 2: 20, 3: 10}
    assert [s.id for s in tracing.within(found, 0, 100)] == [1, 2, 3, 4]
    assert [s.id for s in tracing.within(found, 11, 205)] == [3, 4]
    assert found[0].duration_ns == 100


def test_buffer_cap_and_drop_count():
    tracing.clear(capacity=3)

    def record():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    _profiled(record)
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
    _profiled(record)
    assert len(tracing.spans()) == 5 and tracing.dropped() == 0


def test_two_threads_nest_independently():
    """Two threads open their spans interleaved: each inner span's parent
    is its own thread's outer span, and each thread's tree has its own
    call id."""
    barrier = threading.Barrier(2, timeout=30)

    def work(k):
        with tracing.span(f"outer{k}"):
            barrier.wait()
            with tracing.span(f"inner{k}"):
                barrier.wait()
            barrier.wait()

    def run():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    _profiled(run)
    by_name = {s.name: s for s in tracing.spans()}
    assert set(by_name) == {"outer0", "outer1", "inner0", "inner1"}
    for k in range(2):
        outer, inner = by_name[f"outer{k}"], by_name[f"inner{k}"]
        assert outer.parent is None and outer.call == outer.id
        assert inner.parent == outer.id and inner.call == outer.id
        assert inner.thread == outer.thread
    assert by_name["outer0"].call != by_name["outer1"].call
    assert by_name["outer0"].thread != by_name["outer1"].thread


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


@pytest.mark.cuda
def test_k1_kernels_lie_inside_their_spans_on_the_card():
    """In a profiled WaveRNN call on the card, each ``wavernn_sample_kernel``
    starts after its ``k1.launch`` span's start and ends before its
    ``wavernn.labels_wait`` span's end: the spans and the trace share one
    clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    voc = WaveRnnVocoder(cfg=VOC, verbose=False, device="cuda")
    mels = [np.random.RandomState(k).randn(80, 200).astype(np.float32) for k in range(3)]
    voc.infer_waveform_batch(mels, max_lanes=7)               # builds and warms K1
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        voc.infer_waveform_batch(mels, max_lanes=7)           # 3 launches of 7 folds
    kernels = sorted((_ns(e, "start"), _ns(e, "start") + _ns(e, "duration"))
                     for e in prof.profiler.kineto_results.events()
                     if "wavernn_sample_kernel" in e.name())
    found = tracing.spans()
    launches = sorted((s for s in found if s.name == "k1.launch"), key=lambda s: s.start_ns)
    waits = sorted((s for s in found if s.name == "wavernn.labels_wait"),
                   key=lambda s: s.start_ns)
    assert len(kernels) == len(launches) == len(waits) == 3
    for (k0, k1), launch, wait in zip(kernels, launches, waits):
        assert launch.end_ns <= wait.start_ns
        assert launch.start_ns <= k0 and k1 <= wait.end_ns, \
            (launch.start_ns, k0, k1, wait.end_ns)


def test_many_threads_lose_no_span_and_no_drop():
    """More threads than cores, switching every microsecond, each recording
    nested spans into a buffer too small for them: every span is either
    kept or counted as dropped, and every kept inner span's parent is its
    own thread's outer span."""
    import os
    import sys
    threads_n, per_thread = 2 * (os.cpu_count() or 4), 200
    tracing.clear(capacity=1000)

    def work(k):
        for _ in range(per_thread // 2):
            with tracing.span(f"outer{k}"):
                with tracing.span(f"inner{k}"):
                    pass

    def run():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _profiled(run)
    finally:
        sys.setswitchinterval(interval)
    found = tracing.spans()
    assert len(found) == 1000
    assert len(found) + tracing.dropped() == threads_n * per_thread
    by_id = {s.id: s for s in found}
    for s in found:
        if s.name.startswith("inner") and s.parent in by_id:
            outer = by_id[s.parent]
            assert outer.name == "outer" + s.name[5:] and outer.thread == s.thread
