"""The metric arithmetic on hand-made runs and traces."""
import pytest
import torch

from benchmark.harness import check, registry, runner, trace


def _run(call_seconds, audio_per_call=10.0):
    run = runner.Run("x", registry.cell("tts-hifigan.b128-f800")["config"],
                     registry.cell("tts-hifigan.b128-f800")["traffic"], torch.device("cpu"), 1.0)
    run.window_s = sum(call_seconds)
    run.audio_s = audio_per_call * len(call_seconds)
    return run


def test_audio_per_second_counts_all_the_window_and_a_stall_lowers_it():
    read = registry.reader("audio_s_per_s").read
    steady = read(_run([1.0] * 10))
    assert steady == pytest.approx(10.0)
    stalled = read(_run([1.0] * 9 + [3.0]))
    assert stalled == pytest.approx(100.0 / 12.0)
    assert stalled < steady


def test_idle_share_from_a_hand_made_trace():
    ms = 1_000_000
    dev = [("k_a", 0, 2 * ms), ("k_b", 1 * ms, 3 * ms), ("copy", 6 * ms, 7 * ms),
           ("k_a", 9 * ms, 12 * ms)]                       # the last one runs past the window
    # as the recorder lists them: a span when it ends, inner ones first
    spans = [("tacotron", 3 * ms, 6 * ms), ("call", 0, 10 * ms), ("window", 0, 10 * ms)]
    s = trace.reduce(dev, spans, 0, 10 * ms)
    assert s["busy_s"] == pytest.approx(0.005)            # [0, 3] + [6, 7] + [9, 10]
    assert s["window_s"] == pytest.approx(0.010)
    assert s["kernel_s"]["k_a"] == pytest.approx(0.003)
    assert s["idle_gaps"][0] == ["tacotron", pytest.approx(0.003)]
    assert s["idle_gaps"][1] == ["call", pytest.approx(0.002)]
    s2 = trace.reduce(dev, [("call", 0, 4 * ms), ("call", 5 * ms, 10 * ms)], 0, 10 * ms)
    assert ["call to call", pytest.approx(0.003)] in s2["idle_gaps"]
    run = _run([0.01])
    run.trace = s
    assert registry.reader("device.idle_pct").read(run) == pytest.approx(50.0)
    assert trace.kernel_seconds(s, "k_") == pytest.approx(0.005)


@pytest.mark.parametrize("metric", ["k1_roofline", "k1.launches_per_call", "device.idle_pct",
                                    "device.peak_mem_gib", "tacotron.decode_ms_per_step",
                                    "pipeline.self_ms_per_call", "hifigan.peak_pct"])
def test_a_reader_with_nothing_to_read_returns_none(metric):
    run = _run([1.0])
    run.counters["k1_launches"] = 0
    assert registry.reader(metric).read(run) is None


def test_per_layer_metrics_of_each_cell():
    names = {c: {m["name"] for m in registry.metrics_of(c, True)}
             for c in ("tts-hifigan.b128-f800", "tts-wavernn.b16-f800")}
    assert "hifigan.peak_pct" in names["tts-hifigan.b128-f800"]
    assert "hifigan.peak_pct" not in names["tts-wavernn.b16-f800"]
    assert "k1_roofline" in names["tts-wavernn.b16-f800"]
    assert {m["name"] for m in registry.metrics_of("tts-wavernn.b16-f800", False)} == \
        {"audio_s_per_s", "setup_s"}


def test_bucket():
    assert [check.bucket(n, 32) for n in (1, 32, 33, 288)] == [32, 32, 64, 288]
