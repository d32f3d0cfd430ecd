"""Guards for what a machine with a card and no JAX needs of the port:

* every module of ``mockingbird_tpu_torch`` and ``chip_smoke.py`` imports in
  a process where ``jax``, ``flax``, ``orbax`` and ``mockingbird_tpu`` cannot
  be imported, and no source names them in an import statement;
* each committed export (read here through the JAX package's
  ``load_single``, which the card's machine cannot run) carries across into
  the full-width port modules with no missing or extra leaf;
* the entry points ask for ``cuda`` by default and raise without a card.
"""
import ast
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mockingbird_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mockingbird_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mockingbird_tpu")

BLOCKER = f"""
import importlib.abc, sys
BLOCKED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
"""


def _modules():
    names = ["mockingbird_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG)], "mockingbird_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    script = BLOCKER + f"""
import importlib, importlib.util
for name in {_modules()!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("ok", len({_modules()!r}))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_launch_children_and_workers_run_without_jax(tmp_path):
    """The processes ``launch`` starts, and the multi-process test worker,
    run with JAX blocked in every process (a ``sitecustomize`` on
    ``PYTHONPATH`` installs the blocker at each interpreter's start): two
    ranks of ``download-datasets --list`` under ``launch`` join their gloo
    group and report, and two worker ranks train the GE2E step."""
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = {k: v for k, v in __import__("os").environ.items() if not k.startswith("MB_")}
    env.update(PYTHONPATH=str(tmp_path), MB_RUN_REPORT="1", OMP_NUM_THREADS="1")
    probe = subprocess.run([sys.executable, "-c", "import jax"], env=env, capture_output=True,
                           text=True, timeout=60)
    assert probe.returncode != 0 and "blocked: jax" in probe.stderr
    run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", "cpu",
                          "launch", "--nprocs", "2", "--", "download-datasets", "unused",
                          "--list"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    reports = [__import__("json").loads(ln[len("RUN_REPORT "):])
               for ln in run.stdout.splitlines() if ln.startswith("RUN_REPORT ")]
    assert sorted((r["rank"], r["world"]) for r in reports) == [(0, 2), (1, 2)]
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests/_torch_multiproc_worker.py"),
                               __import__("json").dumps(dict(num_processes=2, process_id=i,
                                                             port=port, families=["ge2e"]))],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    for proc in procs:
        out, _ = proc.communicate(timeout=180)
        assert proc.returncode == 0 and "LOSSES " in out, out[-3000:]


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests/_torch_multiproc_worker.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, f"{f}:{node.lineno} imports {n}"


def _export(name):
    from mockingbird_tpu.train.checkpoint import load_single
    path = ROOT / "saved_models" / name
    if not path.exists():
        pytest.fail(f"committed export {path} is missing")
    return load_single(path)


def test_encoder_export_carries_across():
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoder
    from mockingbird_tpu_torch.weights import load_flax
    tree = _export("encoder_run/encoder.ckpt")
    model = load_flax(SpeakerEncoder(), tree["params"]["model"])
    w = tree["params"]["model"]["lstm_2"]["hg"]["kernel"]
    got = model.lstm_2.weight_hh_l0[512:768].T.detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(w, np.float32))


def test_tacotron_export_carries_across():
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.models.tacotron import Tacotron, tacotron_config
    from mockingbird_tpu_torch.weights import load_flax
    cfg = tacotron_config().merge(Config.from_json(
        ROOT / "saved_models/attention_run/synthesizer.json"))
    tree = _export("attention_run/synthesizer.ckpt")
    model = load_flax(Tacotron(cfg), tree)
    np.testing.assert_array_equal(
        model.postnet.bank_3.bnorm.running_var.numpy(),
        np.asarray(tree["batch_stats"]["postnet"]["bank_3"]["bnorm"]["var"], np.float32))


def test_wavernn_export_carries_across():
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.models.vocoder import WaveRNN, wavernn_config
    from mockingbird_tpu_torch.weights import load_flax
    cfg = Config(wavernn_config()).merge(Config.from_json(
        ROOT / "saved_models/wavernn_run/vocoder_wavernn.json"))
    tree = _export("wavernn_run/vocoder_wavernn.ckpt")
    model = load_flax(WaveRNN(cfg), tree)
    np.testing.assert_array_equal(model.rnn2.cell.bn.detach().numpy(),
                                  np.asarray(tree["params"]["rnn2"]["cell"]["hn"]["bias"],
                                             np.float32))


def test_weight_load_is_strict():
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoder
    from mockingbird_tpu_torch.weights import WeightMismatch, flatten_tree, load_flax
    tree = _export("encoder_run/encoder.ckpt")["params"]["model"]
    extra = dict(tree, stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(WeightMismatch, match="stray"):
        load_flax(SpeakerEncoder(), extra)
    missing = {k: v for k, v in tree.items() if k != "linear"}
    with pytest.raises(WeightMismatch, match="linear"):
        load_flax(SpeakerEncoder(), missing)
    with pytest.raises(WeightMismatch, match="shape"):
        load_flax(SpeakerEncoder(hidden_size=128), tree)
    assert len(flatten_tree(tree)) == 38


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Also the GE2E and ppg2mel trainers, which raise before they read any
    data, and the entry points of the serving slice: the emotion extractor
    and its preprocessor, the server (before it binds a port), the web
    toolbox's default factories, the subtitle renderer's pipeline backend
    and the CLI's global ``--device``."""
    import importlib
    from mockingbird_tpu_torch.cli.main import build_parser, main
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
    from mockingbird_tpu_torch.models.tacotron import Synthesizer, create_emotion_embeddings
    from mockingbird_tpu_torch.models.tacotron.emotion import EmotionExtractor
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder, load_vocoder
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
    from mockingbird_tpu_torch.serve import serve
    from mockingbird_tpu_torch.serve.toolbox import WebToolbox
    from mockingbird_tpu_torch.speak import PipelineBackend
    trainers = tuple(importlib.import_module(f"mockingbird_tpu_torch.models.{m}.train").train
                     for m in ("encoder", "ppg"))
    tb = WebToolbox()
    factories = (lambda: tb.pipeline, lambda: tb.vc, lambda: tb.get_vocoder("hifigan"),
                 lambda: tb.get_vocoder("wavernn"))
    entries = (SpeakerEncoderInference, Synthesizer, WaveRnnVocoder, load_vocoder,
               VoiceCloningPipeline, EmotionExtractor, create_emotion_embeddings, serve,
               WebToolbox, PipelineBackend) + trainers
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert build_parser().parse_args(["serve"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mockingbird_tpu_torch.resolve_device()
    for fn in tuple(f for f in entries if f is not WebToolbox) + factories:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            if fn is load_vocoder:
                fn("x/vocoder_wavernn.npz")
            elif fn in trainers:
                fn("run", tmp_path / "missing", tmp_path / "models")
            elif fn is create_emotion_embeddings:
                fn(tmp_path / "missing")
            elif fn is serve:
                fn(port=0, block=False)
            else:
                fn()
    for argv in (["tts", "x", "--ref", "r.wav"], ["emo", str(tmp_path / "missing")],
                 ["serve", "--port", "0"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert mockingbird_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert not list(tmp_path.iterdir())



def test_sampler_refuses_other_devices():
    from mockingbird_tpu_torch.ops.wavernn_sample import wavernn_sample
    t = torch.zeros(1, 1, 80, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavernn_sample({}, t, t, 0)


@pytest.mark.parametrize("entry", ["encoder", "synthesizer", "wavernn", "ppg2mel",
                                   "ppg_extractor", "make_voice_converter", "emotion",
                                   "emo_cli"])
def test_missing_weights_path_raises(entry, tmp_path):
    """A weights path that does not exist raises ``FileNotFoundError`` in
    every constructor that takes one (a typo must not give seeded noise);
    weights made from a seed come only from passing no path."""
    from mockingbird_tpu_torch.models.ppg import PPGExtractor, VoiceConverter
    from mockingbird_tpu_torch.models.tacotron import Synthesizer
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
    from mockingbird_tpu_torch.cli.main import main
    from mockingbird_tpu_torch.models.tacotron.emotion import EmotionExtractor
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline, make_voice_converter
    missing = tmp_path / "missing.npz"
    syn = tmp_path / "syn"
    (syn / "audio").mkdir(parents=True)
    np.save(syn / "audio" / "audio-a_1.npy", np.zeros(800, np.float32))
    (syn / "train.txt").write_text("audio-a_1.npy|mel-a_1.npy|embed-a_1.npy|800|3|x\n")
    make = {"encoder": lambda p: VoiceCloningPipeline(encoder_fpath=p, vocoder=object(),
                                                       verbose=False, device="cpu"),
            "synthesizer": lambda p: Synthesizer(p, verbose=False, device="cpu"),
            "wavernn": lambda p: WaveRnnVocoder(p, verbose=False, device="cpu"),
            "ppg2mel": lambda p: VoiceConverter(p, extractor=object(), encoder=object(),
                                                verbose=False, device="cpu"),
            "ppg_extractor": lambda p: PPGExtractor(p, verbose=False, device="cpu"),
            "make_voice_converter": lambda p: make_voice_converter(p, verbose=False,
                                                                   device="cpu"),
            "emotion": lambda p: EmotionExtractor(p, device="cpu"),
            "emo_cli": lambda p: main(["--device", "cpu", "emo", str(syn), "--weights",
                                       str(p)])}[entry]
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        make(missing)
    with pytest.raises(FileNotFoundError):
        make(str(missing))


def test_importing_the_port_leaves_tf32_alone():
    """The port sets no global precision flag: a caller gets PyTorch's
    defaults, or whatever it set itself, after importing every module.
    Both flags start from the opposite of their defaults here, so a module
    that set either to a fixed value would show."""
    script = f"""
import importlib, torch
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("medium")
for name in {_modules()!r}:
    importlib.import_module(name)
state = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.get_float32_matmul_precision())
assert state == (True, False, "medium"), state
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_smoke_turns_tf32_off_only_around_the_holds():
    """``chip_smoke.py`` times every path under PyTorch's defaults (what a
    caller of the port gets) and turns TF32 off only inside ``full_f32``,
    around the holds against plain versions and the parity checks, which
    restores both flags; no other statement of the script sets them."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with smoke.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    setters = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn) if isinstance(node, ast.Assign)
               for tgt in node.targets
               if isinstance(tgt, ast.Attribute) and tgt.attr == "allow_tf32"]
    assert set(setters) == {"full_f32"}, setters


def test_port_modules_of_the_flagship_path_are_guarded():
    """The modules this guard file's import test walks include every module
    of the HiFi-GAN path (a rename would drop one silently)."""
    names = set(_modules())
    for name in ("models.vocoder.hifigan", "models.vocoder.fregan", "models.vocoder.inference",
                 "dsp.mulaw", "dsp.stft", "dsp.logmmse", "text.long_text", "pipeline"):
        assert f"mockingbird_tpu_torch.{name}" in names, name


def test_gan_export_carries_across():
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.models.vocoder import Generator
    from mockingbird_tpu_torch.weights import load_flax
    cfg = Config.from_json(ROOT / "saved_models/gan_run/vocoder_hifigan.json")
    g = _export("gan_run/vocoder_hifigan.ckpt")["g"]
    model = load_flax(Generator(cfg), g)
    np.testing.assert_array_equal(
        model.resblock_1_2.convs1_2.scale.detach().numpy(),
        np.asarray(g["resblock_1_2"]["convs1_2"]["convs1_2_conv/kernel/scale"], np.float32))
    # flax's transposed-conv kernel (k, in, out), unflipped; torch's (in, out, k) flipped
    np.testing.assert_array_equal(
        model.ups_2.weight.detach().numpy(),
        np.flip(np.transpose(np.asarray(g["ups_2_conv"]["kernel"], np.float32), (1, 2, 0)), -1))


def test_weight_normed_npz_export_loads(tmp_path):
    """An ``.npz`` export (``flatten_tree``) splits flax's
    "<n>_conv/kernel/scale" key at its slashes; the strict load still finds
    every weight-norm gain, for HiFi-GAN and for VITS."""
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    from mockingbird_tpu_torch.weights import flatten_tree
    g = _export("gan_run/vocoder_hifigan.ckpt")["g"]
    np.savez(tmp_path / "vocoder_hifigan.npz", **flatten_tree({"g": g}))
    (tmp_path / "vocoder_hifigan.json").write_text(
        (ROOT / "saved_models/gan_run/vocoder_hifigan.json").read_text())
    voc = GanVocoder("hifigan", tmp_path / "vocoder_hifigan.npz", half=False, verbose=False,
                     device="cpu")
    assert voc.cfg.hop_size == 256
    np.testing.assert_array_equal(voc.model.conv_pre.scale.detach().numpy(),
                                  np.asarray(g["conv_pre"]["conv_pre_conv/kernel/scale"],
                                             np.float32))
    tree = _export("vits_run/synthesizer_vits.ckpt")
    np.savez(tmp_path / "synthesizer_vits.npz", **flatten_tree(tree))
    syn = VitsSynthesizer(tmp_path / "synthesizer_vits.npz", verbose=False, device="cpu",
                          cfg=Config.from_json(ROOT / "saved_models/vits_run/config.json"))
    gen = tree.get("g", tree.get("params", tree))
    np.testing.assert_array_equal(
        syn.model.dec.resblock_0_0.convs1_0.scale.detach().numpy(),
        np.asarray(gen["dec"]["resblock_0_0"]["convs1_0"]["convs1_0_conv/kernel/scale"],
                   np.float32))


def test_load_vocoder_dispatch(tmp_path):
    """``load_vocoder(None)`` gives HiFi-GAN at its stock config with seeded
    weights; a "hifigan" or "fregan" path that does not exist raises
    ``FileNotFoundError``, as a WaveRNN path does; ``GanVocoder`` asks for
    ``cuda`` by default."""
    from mockingbird_tpu_torch.models.vocoder import GanVocoder, load_vocoder
    voc = load_vocoder(None, verbose=False, device="cpu")
    assert isinstance(voc, GanVocoder) and voc.arch == "hifigan" and voc.half
    assert voc.cfg.upsample_rates == [5, 5, 4, 2] and hasattr(voc, "vocode_device")
    for name in ("vocoder_hifigan.npz", "vocoder_fregan.npz", "vocoder_wavernn.npz"):
        with pytest.raises(FileNotFoundError):
            load_vocoder(tmp_path / name, verbose=False, device="cpu")
    assert inspect.signature(GanVocoder).parameters["device"].default == "cuda"


def test_vc_entry_points_default_to_cuda(monkeypatch):
    """The voice-conversion entry points ask for ``cuda`` by default and
    raise without a card."""
    from mockingbird_tpu_torch.models.ppg import PPGExtractor, VoiceConverter
    from mockingbird_tpu_torch.pipeline import make_voice_converter
    entries = (VoiceConverter, PPGExtractor, make_voice_converter)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_port_modules_of_the_vc_path_are_guarded():
    """The modules this guard file's import test walks include every module
    of the voice-conversion path."""
    names = set(_modules())
    for name in ("models.ppg", "models.ppg.extractor", "models.ppg.ppg2mel",
                 "models.ppg.convert", "dsp.f0"):
        assert f"mockingbird_tpu_torch.{name}" in names, name


def test_ppg2mel_export_carries_across(tmp_path):
    """The committed trained ppg2mel export carries across into the
    full-width ``MelDecoderMOLv2`` (the width of its ``.json`` sidecar) with
    no missing or extra leaf, straight and through an ``.npz``; the strided
    convs and the postnet's BatchNorm statistics land where the flax tree
    has them."""
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.models.ppg import VoiceConverter
    from mockingbird_tpu_torch.models.ppg.ppg2mel import MelDecoderMOLv2, ppg2mel_config
    from mockingbird_tpu_torch.weights import flatten_tree, load_flax
    cfg = ppg2mel_config().merge(Config.from_json(ROOT / "saved_models/ppg_run/ppg2mel.json"))
    assert cfg == ppg2mel_config()
    tree = _export("ppg_run/ppg2mel.ckpt")
    model = load_flax(MelDecoderMOLv2(cfg), tree)
    np.testing.assert_array_equal(model.postnet.bn_out.running_var.numpy(),
                                  np.asarray(tree["batch_stats"]["postnet"]["bn_out"]["var"],
                                             np.float32))
    # flax's stride-2 conv kernel (k, in, out) → torch's (out, in, k)
    np.testing.assert_array_equal(
        model.bnf_prenet.down_1.weight.detach().numpy(),
        np.transpose(np.asarray(tree["params"]["bnf_prenet"]["down_1"]["kernel"], np.float32),
                     (2, 1, 0)))
    np.savez(tmp_path / "ppg2mel.npz", **flatten_tree(tree))
    vc = VoiceConverter(tmp_path / "ppg2mel.npz", extractor=object(), encoder=object(),
                        verbose=False, device="cpu")
    for name, t in model.state_dict().items():
        assert torch.equal(vc.model.state_dict()[name], t), name



def test_trainer_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The Tacotron trainer's entry points ask for ``cuda`` by default and
    raise without a card, before touching any file."""
    from mockingbird_tpu_torch.models.tacotron import (create_embeddings, preprocess_dataset,
                                                       run_gta_synthesis, train)
    calls = {train: ("run", tmp_path, tmp_path), run_gta_synthesis: ("run", tmp_path, tmp_path),
             preprocess_dataset: (tmp_path, tmp_path / "out"), create_embeddings: (tmp_path,)}
    for fn in calls:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
    assert not list(tmp_path.iterdir())


def test_port_modules_of_the_trainer_slice_are_guarded():
    """The modules this guard file's import test walks include every module
    of the Tacotron trainer and of WaveRNN's MOL mode."""
    names = set(_modules())
    for name in ("models.tacotron.train", "models.tacotron.dataset",
                 "models.tacotron.preprocess", "models.vocoder.distribution",
                 "train.checkpoint", "train.logging", "weights"):
        assert f"mockingbird_tpu_torch.{name}" in names, name


def test_port_modules_of_the_vocoder_trainers_are_guarded():
    """The modules this guard file's import test walks include every module
    of the GAN-vocoder and WaveRNN trainers."""
    names = set(_modules())
    for name in ("models.vocoder.dataset", "models.vocoder.gan_train",
                 "models.vocoder.wavernn_train", "models.vocoder.gan_losses",
                 "models.vocoder.fregan", "models.layers", "train.precision"):
        assert f"mockingbird_tpu_torch.{name}" in names, name


def test_vocoder_trainer_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The vocoder trainers ask for ``cuda`` by default and raise without a
    card, before touching any file."""
    import importlib
    gan = importlib.import_module("mockingbird_tpu_torch.models.vocoder.gan_train")
    wavernn = importlib.import_module("mockingbird_tpu_torch.models.vocoder.wavernn_train")
    for fn in (gan.train, wavernn.train):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (gan.train, wavernn.train):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn("run", tmp_path, tmp_path)
    assert not list(tmp_path.iterdir())


def test_port_modules_of_the_serving_slice_are_guarded():
    """The modules this guard file's import test walks include every module
    of the emotion extractor, the server, the CLI, ``speak`` and the
    profiler."""
    names = set(_modules())
    for name in ("models.wav2emo", "models.tacotron.emotion", "interop",
                 "interop.torch_weights", "serve", "serve.http", "serve.toolbox",
                 "serve.console", "cli", "cli.main", "cli.__main__", "speak", "speak.srt",
                 "speak.stretch", "speak.timeline", "speak.api_client", "train.profiler",
                 "interop.import_checkpoint", "interop.reference_loader", "datasets",
                 "parallel", "parallel.multihost", "parallel.mesh", "parallel.shardings"):
        assert f"mockingbird_tpu_torch.{name}" in names, name


def test_cli_help_runs_without_jax():
    """``python -m mockingbird_tpu_torch.cli --help`` in a process where
    ``jax``, ``flax``, ``orbax`` and ``mockingbird_tpu`` cannot be imported."""
    script = BLOCKER + """
import runpy
sys.argv = ["mockingbird_tpu_torch.cli", "--help"]
try:
    runpy.run_module("mockingbird_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "usage: mockingbird_tpu_torch" in out.stdout and "--device" in out.stdout
    for name in ("tts", "emo", "serve", "demo", "render-timeline", "train-vc",
                 "import-checkpoint", "download-datasets", "launch"):
        assert name in out.stdout, name
