"""The port's command line, ``speak/``, profiler and console helpers against
the JAX package's.

* Parser parity: on each argv list, the port's ``build_parser`` gives the
  Namespace JAX's gives, ``func`` and the port's global ``--device`` set
  aside; the subcommands the port leaves for a later slice are absent.
* A real ``tts`` run and the ``demo`` REPL, in process, on the CPU, from
  tiny ``.npz`` exports: the wav equals the pipeline's own.
* ``text-to-srt`` and ``render-timeline`` (a fake backend in both packages)
  write what JAX's write; ``speak``'s WSOLA stretch, SRT round trip and
  timeline mix equal JAX's on the same inputs (exactly, or within 1e-6
  for the float mixes).
"""
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mockingbird_tpu import speak as jspeak
from mockingbird_tpu.cli.main import build_parser as jbuild_parser
from mockingbird_tpu_torch import speak
from mockingbird_tpu_torch.cli.main import build_parser, cmd_demo, main

ROOT = Path(__file__).resolve().parents[1]
REF_WAV = ROOT / "saved_models/gan_run/eval/ground_truth.wav"

ARGVS = [
    ["tts", "hello", "--ref", "r.wav", "--out", "o.wav"],
    ["tts", "ni3 hao3", "--ref", "r.wav", "--synthesizer", "vits", "--style_idx", "2",
     "--griffin-lim", "--encoder", "e.npz", "--synth", "s.npz", "--vocoder", "v.npz"],
    ["train-vocoder", "syn", "run1", "--arch", "fregan"],
    ["train-vocoder", "syn", "run1", "--arch", "wavernn", "--ground_truth",
     "--total_steps", "5", "--precision", "fp32", "-m", "models"],
    ["preprocess", "/data", "-d", "aishell3"],
    ["preprocess", "/data", "-o", "out", "-n", "2", "-s"],
    ["demo", "--out-dir", "/tmp/x"],
    ["demo", "--encoder", "e", "--synth", "s", "--vocoder", "v", "--seed", "3"],
    ["emo", "syn"],
    ["emo", "syn", "--weights", "emotion.npz"],
    ["embed", "syn", "-e", "enc.npz"],
    ["encoder-preprocess", "/data", "-d", "voxceleb1,aidatatang_200zh", "-s"],
    ["train-encoder", "clean", "run", "--total_steps", "3", "--precision", "fp32"],
    ["--hparams", "tts_schedule=[(2,1e-3,10,12)]", "train-synth", "syn", "run",
     "--guided_attn", "0.2"],
    ["train-vits", "syn", "run", "--batch_size", "4", "-m", "m"],
    ["gta", "syn", "run", "-m", "m"],
    ["preprocess-vc", "wavs", "out"],
    ["train-vc", "vc", "run", "--total_steps", "2"],
    ["convert", "a.wav", "b.wav", "--ref", "r.wav", "--out-dir", "o", "--ppg2mel", "p.npz",
     "--vocoder", "v.npz"],
    ["serve", "--port", "0", "--datasets_root", "d", "--seed", "1"],
    ["serve"],
    ["text-to-srt", "-", "--out", "o.srt", "--cps", "5", "--gap-ms", "100",
     "--start-offset-ms", "20"],
    ["render-timeline", "--srt", "s.srt", "--out", "o.wav", "--backend", "http",
     "--base-url", "http://localhost:1", "--api-key", "k", "--duration-mode", "pad_trim"],
    ["render-timeline", "--srt", "s.srt", "--out", "o.wav", "--ref", "r.wav",
     "--voice-map", "vm.json"],
]


def _ns(parser, argv):
    """The parsed namespace without what only the port has: the global
    ``--device`` and ``train-vits``'s ``--log_every``."""
    d = vars(parser.parse_args(argv))
    d.pop("func")
    d.pop("device", None)
    d.pop("log_every", None)
    return d


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_parser_matches_jax(argv):
    assert _ns(build_parser(), argv) == _ns(jbuild_parser(), argv)


def test_device_option_and_deferred_subcommands(capsys):
    p = build_parser()
    assert p.parse_args(["serve"]).device == "cuda"
    assert p.parse_args(["--device", "cpu", "serve"]).device == "cpu"
    # the subcommands ported last parse as JAX's do; wav2emo is no CLI family
    for argv in (["import-checkpoint", "--family", "encoder", "--torch-ckpt", "a", "--out", "b"],
                 ["import-checkpoint", "--family", "ppg2mel", "--torch-ckpt", "a", "--out", "b",
                  "--config", "c.json"],
                 ["download-datasets", "/d"],
                 ["download-datasets", "/d", "--datasets", "aishell3", "magicdata",
                  "--mirror", "eu", "--no-extract", "--list"],
                 ["launch", "--", "tts", "x"], ["launch", "--nprocs", "4", "--port", "99",
                                                "--", "train-vits", "s", "r"]):
        assert _ns(p, argv) == _ns(jbuild_parser(), argv), argv
    for parser in (p, jbuild_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args(["import-checkpoint", "--family", "wav2emo", "--torch-ckpt", "a",
                               "--out", "b"])
        assert "invalid choice" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# real runs from tiny exports
# ---------------------------------------------------------------------------

TACO = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
            lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=[4, 4],
            max_r=4, prenet_dropout=False)
GAN = dict(upsample_rates=[8, 8, 4], upsample_kernel_sizes=[16, 16, 8],
           upsample_initial_channel=32, resblock_kernel_sizes=[3, 7],
           resblock_dilation_sizes=[[1, 3], [1, 3]], hop_size=256)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Seeded tiny Tacotron and HiFi-GAN and the full-width GE2E, written as
    ``.npz`` exports with their config sidecars."""
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
    from mockingbird_tpu_torch.models.tacotron import Synthesizer, tacotron_config
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    from mockingbird_tpu_torch.weights import save_npz, to_flax
    d = tmp_path_factory.mktemp("exports")
    save_npz(d / "encoder.npz", to_flax(SpeakerEncoderInference(seed=1, device="cpu").model))
    syn = Synthesizer(cfg=tacotron_config().merge(TACO), seed=2, verbose=False, device="cpu")
    syn.load()
    save_npz(d / "synthesizer.npz", to_flax(syn._model))
    (d / "synthesizer.json").write_text(json.dumps(TACO))
    voc = GanVocoder("hifigan", cfg=GAN, seed=3, verbose=False, device="cpu")
    save_npz(d / "vocoder_hifigan.npz", to_flax(voc.model))
    (d / "vocoder_hifigan.json").write_text(json.dumps(voc.cfg.to_dict()))
    return d


def _model_args(d):
    return ["--encoder", str(d / "encoder.npz"), "--synth", str(d / "synthesizer.npz"),
            "--vocoder", str(d / "vocoder_hifigan.npz")]


def test_tts_writes_the_pipelines_wav(exports, tmp_path):
    """``main(["--device", "cpu", "tts", ...])`` writes a 16 kHz wav equal
    to ``VoiceCloningPipeline.tts_to_file`` from the same exports."""
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
    out = tmp_path / "out.wav"
    text = "ni3 hao3, shi4 jie4"
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--device", "cpu", "tts", text, "--ref", str(REF_WAV), "--out", str(out)]
             + _model_args(exports))
    assert f"Wrote {out} (RTF" in buf.getvalue()
    sr, got = wavfile.read(out)
    assert sr == 16000 and got.dtype == np.int16 and len(got) > 0
    pipe = VoiceCloningPipeline(exports / "encoder.npz", exports / "synthesizer.npz",
                                exports / "vocoder_hifigan.npz", verbose=False, device="cpu")
    pipe.tts_to_file(text, REF_WAV, tmp_path / "direct.wav")
    np.testing.assert_array_equal(got, wavfile.read(tmp_path / "direct.wav")[1])


def test_demo_repl(exports, tmp_path):
    """The REPL with injected input: a reference, two texts, then an empty
    line; one wav per text."""
    args = build_parser().parse_args(["--device", "cpu", "demo", "--out-dir",
                                      str(tmp_path / "demo")] + _model_args(exports))
    answers = iter([str(REF_WAV), "ni3 hao3", "zai4 jian4", ""])
    said = []
    cmd_demo(args, _input=lambda prompt: next(answers), _print=said.append)
    wavs = sorted((tmp_path / "demo").glob("demo_*.wav"))
    assert [w.name for w in wavs] == ["demo_000.wav", "demo_001.wav"]
    assert sum("Wrote" in s for s in said) == 2
    for w in wavs:
        sr, x = wavfile.read(w)
        assert sr == 16000 and len(x) > 0


# ---------------------------------------------------------------------------
# subtitles
# ---------------------------------------------------------------------------

def test_text_to_srt_equals_jax(tmp_path):
    from mockingbird_tpu.cli.main import main as jmain
    src = tmp_path / "in.txt"
    src.write_text("你好。再见！ This is a test, of timing. Short.", encoding="utf-8")
    for fn, name in ((jmain, "jax.srt"), (main, "port.srt")):
        with redirect_stdout(io.StringIO()):
            fn(["text-to-srt", str(src), "--out", str(tmp_path / name), "--cps", "5"])
    assert (tmp_path / "port.srt").read_text() == (tmp_path / "jax.srt").read_text()
    assert len(speak.parse_srt(tmp_path / "port.srt")) == 4


class _FakeBackend:
    """A tone per cue whose pitch and length follow the cue's text."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, cue, cfg):
        sr = 16000
        t = np.arange(int(sr * 0.2 * len(cue.text) / 4)) / sr
        freq = 150.0 + 10 * len(cue.text) + (50.0 if cfg.get("reference_audio") else 0.0)
        return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32), sr


def test_render_timeline_equals_jax(tmp_path, monkeypatch):
    """``render-timeline`` through the pipeline backend, replaced by the same
    fake in both packages, with a voice map: the same wav."""
    from mockingbird_tpu.cli.main import main as jmain
    srt = tmp_path / "in.srt"
    speak.text_to_srt("First sentence here. Then a second one! And the third.", srt)
    (tmp_path / "vm.json").write_text(json.dumps(
        {"default": {"duration_mode": "stretch"}, "segments": {"2": {"duration_mode": "pad_trim"}}}))
    monkeypatch.setattr(jspeak, "PipelineBackend", _FakeBackend)
    monkeypatch.setattr(speak, "PipelineBackend", _FakeBackend)
    for fn, name in ((jmain, "jax.wav"), (main, "port.wav")):
        with redirect_stdout(io.StringIO()):
            fn(["render-timeline", "--srt", str(srt), "--out", str(tmp_path / name),
                "--ref", "r.wav", "--voice-map", str(tmp_path / "vm.json")])
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


# ---------------------------------------------------------------------------
# speak/ against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.6, 1.0, 1.7])
def test_wsola_stretch_equals_jax(ratio):
    rng = np.random.default_rng(0)
    sr = 16000
    t = np.arange(sr) / sr
    wav = (0.4 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(sr)).astype(np.float32)
    target = int(len(wav) * ratio)
    np.testing.assert_array_equal(speak.wsola_stretch(wav, target, sr),
                                  jspeak.wsola_stretch(wav, target, sr))
    for mode in ("stretch", "pad_trim"):
        np.testing.assert_array_equal(speak.normalize_duration(wav, target, sr, mode=mode),
                                      jspeak.normalize_duration(wav, target, sr, mode=mode))


def test_srt_round_trip_equals_jax(tmp_path):
    text = ("1\n00:00:00,000 --> 00:00:01,500\nHello there.\n\n"
            "junk block\n\n2\n00:00:02,000 --> 00:00:03,250\n第二句。\n\n")
    path = tmp_path / "a.srt"
    path.write_text(text, encoding="utf-8")
    cues, jcues = speak.parse_srt(path), jspeak.parse_srt(path)
    assert [(c.index, c.start_ms, c.end_ms, c.text) for c in cues] == \
           [(c.index, c.start_ms, c.end_ms, c.text) for c in jcues]
    assert speak.format_srt(cues) == jspeak.format_srt(jcues)
    prose = "One. Two! Three? 四。五！"
    assert [c.text for c in speak.text_to_cues(prose)] == \
           [c.text for c in jspeak.text_to_cues(prose)]


def test_render_timeline_equals_jax_in_process():
    cues = [speak.Cue(1, 0, 1000, "one"), speak.Cue(2, 500, 2500, "two two"),
            speak.Cue(3, 2600, 3000, "three")]
    jcues = [jspeak.Cue(c.index, c.start_ms, c.end_ms, c.text) for c in cues]
    vm = {"default": {}, "segments": {"2-3": {"duration_mode": "pad_trim"}}}
    got = speak.render_timeline(cues, _FakeBackend(), voice_map=vm, tail_ms=150)
    want = jspeak.render_timeline(jcues, _FakeBackend(), voice_map=vm, tail_ms=150)
    assert got.sample_rate == want.sample_rate
    assert [(s.raw_len, s.final_len) for s in got.segments] == \
           [(s.raw_len, s.final_len) for s in want.segments]
    np.testing.assert_allclose(got.wav, want.wav, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# profiler and console helpers (tests/test_infra.py's cases)
# ---------------------------------------------------------------------------

def test_value_window_and_table(capsys):
    from mockingbird_tpu.train.logging import progbar as jprogbar
    from mockingbird_tpu.train.logging import simple_table as jtable
    from mockingbird_tpu_torch.train.logging import ValueWindow, progbar, simple_table, stream
    w = ValueWindow(3)
    for v in [1, 2, 3, 4]:
        w.append(v)
    assert w.average == 3.0 and w.count == 3  # last 3 of [1,2,3,4]
    rows = [("a", 1), ("bb", "cc"), ("step", 12345)]
    simple_table(rows)
    got = capsys.readouterr().out
    jtable(rows)
    assert got == capsys.readouterr().out and "a" in got
    stream("x 1")
    assert capsys.readouterr().out == "\rx 1"
    assert progbar(3, 8) == jprogbar(3, 8) and progbar(0, 0) == jprogbar(0, 0)


def test_profiler_and_rtf(tmp_path):
    """``trace`` writes the profiler's Chrome trace with the program spans
    recorded in its block (and none from outside it) on the profiler's
    timeline: the ``aten::sum`` of the block lies inside the span around
    it. (The JAX package's ``Profiler``, ``Timer`` and ``RTFMeter`` have
    no port: the program spans replace them.)"""
    from mockingbird_tpu_torch import tracing
    from mockingbird_tpu_torch.train.profiler import trace
    tracing.clear()
    with trace(tmp_path / "prof"):
        torch.ones(4).sum()
        with tracing.span("tts_batch") as root:
            root.set("texts", 2)
            with tracing.span("pipeline.unpack"):
                torch.ones(8).sum()
    with trace(tmp_path / "later"):
        pass
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"tts_batch", "pipeline.unpack"}
    root, unpack = spans["tts_batch"], spans["pipeline.unpack"]
    assert root["args"]["texts"] == 2 and root["args"]["parent"] is None
    assert unpack["args"]["parent"] == root["args"]["id"] == unpack["args"]["call"]
    assert root["ts"] <= unpack["ts"] and unpack["ts"] + unpack["dur"] <= root["ts"] + root["dur"]
    sums = [e for e in events if e.get("name") == "aten::sum" and e.get("ph") == "X"]
    inside = [e for e in sums
              if unpack["ts"] <= e["ts"] and e["ts"] + e["dur"] <= unpack["ts"] + unpack["dur"]]
    before = [e for e in sums if e["ts"] + e["dur"] <= root["ts"]]
    assert inside and before and len(inside) + len(before) == len(sums)
    later = json.loads((tmp_path / "later" / "trace.json").read_text())["traceEvents"]
    assert not [e for e in later if e.get("cat") == "program_span"]
    tracing.clear()
