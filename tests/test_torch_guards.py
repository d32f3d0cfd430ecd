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


def test_no_source_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    got = model.lstm_2.lstm.weight_hh_l0[512:768].T.detach().numpy()
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


def test_entry_points_default_to_cuda(monkeypatch):
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
    from mockingbird_tpu_torch.models.tacotron import Synthesizer
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder, load_vocoder
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
    entries = (SpeakerEncoderInference, Synthesizer, WaveRnnVocoder, load_vocoder,
               VoiceCloningPipeline)
    for fn in entries:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mockingbird_tpu_torch.resolve_device()
    for fn in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn("x/vocoder_wavernn.npz") if fn is load_vocoder else fn()
    assert mockingbird_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_sampler_refuses_other_devices():
    from mockingbird_tpu_torch.ops.wavernn_sample import wavernn_sample
    t = torch.zeros(1, 1, 80, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavernn_sample({}, t, t, 0)
