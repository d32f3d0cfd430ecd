"""A whole run (the look for a card skipped) with the timed path broken
underneath comes out not correct, once for each fault a cell can have: a
decoder step that returns its state unchanged, and an answer altered where
it is produced (a mel frame, a PCM sample, a sampled label). Half a batch
left out and the exchange between chips do not apply to inference on one
chip. And the control, the reference one precision lower in the program's
place, fails the check at a small size."""
import inspect
import time

import pytest
import torch

from benchmark import control
from benchmark.harness import runner
from benchmark.tests import tiny

H, W = "tts-hifigan.b128-f800", "tts-wavernn.b16-f800"


def _run(cell, texts=2):
    return runner.run_cell(cell, 2 ** 31 + 5, 0.1, False, time.perf_counter(), device="cpu",
                           override=tiny.override(cell, texts=texts))


def _state_unchanged(monkeypatch):
    from mockingbird_tpu_torch.models.tacotron.model import Tacotron
    step = Tacotron.decode_step
    signature = inspect.signature(step)

    def stuck(self, *args, **kwargs):
        _, out = step(self, *args, **kwargs)
        return signature.bind(self, *args, **kwargs).arguments["carry"], out
    monkeypatch.setattr(Tacotron, "decode_step", stuck)


def _mel_altered(monkeypatch):
    from mockingbird_tpu_torch.models.tacotron.inference import Synthesizer
    gen = Synthesizer.generate

    def altered(self, *args, **kwargs):
        mels, attn, n, done = gen(self, *args, **kwargs)
        mels = mels.clone()
        mels[0, 37] += 1.0
        return mels, attn, n, done
    monkeypatch.setattr(Synthesizer, "generate", altered)


def _pcm_altered(monkeypatch):
    from mockingbird_tpu_torch.models.vocoder.inference import GanVocoder
    vocode = GanVocoder.vocode_device

    def altered(self, *args, **kwargs):
        pcm = vocode(self, *args, **kwargs).clone()
        pcm[0, 1000:1100] = 20000
        return pcm
    monkeypatch.setattr(GanVocoder, "vocode_device", altered)


def _label_altered(monkeypatch):
    from mockingbird_tpu_torch.models.vocoder import wavernn
    sample = wavernn.wavernn_sample

    def altered(*args, **kwargs):
        labels = sample(*args, **kwargs).clone()
        labels[3, 100] = (labels[3, 100] + 7) % 32
        return labels
    monkeypatch.setattr(wavernn, "wavernn_sample", altered)


@pytest.mark.parametrize("cell,fault,breaks", [
    (H, _state_unchanged, "mel_err"), (H, _mel_altered, "mel_err"), (H, _pcm_altered, "pcm_err_excess"),
    (W, _state_unchanged, "mel_err"), (W, _label_altered, "label_gap"),
])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault, breaks):
    torch.manual_seed(0)
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert r["checks"][breaks]["value"] > r["checks"][breaks]["limit"], r["checks"]


@pytest.mark.parametrize("cell", [H, W])
def test_the_control_fails_the_check(cell):
    lines = control.run(cell, [11], [11], 1, "cpu", tiny.override(cell, texts=2))
    prog = next(x for x in lines if x["side"] == "program")
    ctrl = next(x for x in lines if x["side"] == "control")
    from benchmark.harness import registry
    limits = registry.cell(cell)["config"]["limits"]
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
