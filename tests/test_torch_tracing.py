"""The port's program spans (``mockingbird_tpu_torch/tracing.py``): off
outside a profiler session, the same output with them on and off, the span
tree of a fused and of a staged ``tts_batch`` call at small widths on the
CPU, the recorder's arithmetic, its buffer and its threads; and on a CUDA
card, the spans against the kernels on the profiler's clock.

The card case skips without one. On the card's machine it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mockingbird_tpu_torch import tracing
from mockingbird_tpu_torch.models.tacotron import Synthesizer
from mockingbird_tpu_torch.models.tacotron.model import tacotron_config
from mockingbird_tpu_torch.models.vocoder import GanVocoder, WaveRnnVocoder
from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline

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
    the steps it was asked, one ``tacotron.step`` span each, each holding
    one ``tacotron.step_wait``."""
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
    assert decode[0].attrs == {"batch": len(TEXTS), "steps_asked": STEPS, "steps_run": STEPS}
    steps = [s for s in found if s.name == "tacotron.step"]
    waits = [s for s in found if s.name == "tacotron.step_wait"]
    assert len(steps) == len(waits) == STEPS
    assert all(s.parent == decode[0].id for s in steps)
    assert sorted(w.parent for w in waits) == sorted(s.id for s in steps)
    return found


def test_fused_call_span_tree(fused):
    found = _tree(fused, FUSED_CHILDREN, fused=True)
    assert not [s for s in found if s.name.startswith(("wavernn.", "k1."))]


def test_staged_call_span_tree(staged):
    found = _tree(staged, STAGED_CHILDREN, fused=False)
    launches = [s for s in found if s.name == "k1.launch"]
    # 200 frames × hop 16 = 3200 samples: 7 folds of 400 + 2·50 an utterance
    assert [s.attrs for s in launches] == [{"F": 7 * len(TEXTS), "T": 500}]
    names = [s.name for s in sorted(found, key=lambda s: s.start_ns)
             if s.name.startswith(("wavernn.", "k1."))]
    assert names == ["wavernn.fold", "k1.launch", "wavernn.labels_wait", "wavernn.finalize"]


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
