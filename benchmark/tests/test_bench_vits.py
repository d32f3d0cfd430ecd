"""The vits family (``families/vits.py``) on the CPU at small widths: the
port's ``Vits.infer`` against the plain reference (``reference/vits.py``)
on seeded weights written as a run writes them; the cell
``tts-vits.b32-f1000`` cut by ``tiny``, correct and reporting its metrics;
faults in the timed path that must each read past a limit; and the control,
the reference in bfloat16 in the program's place, failing the check."""
import math
import time

import pytest
import torch

from benchmark import control
from benchmark.families import vits as fam
from benchmark.harness import registry, runner, weights
from benchmark.reference.ops import Prec
from benchmark.reference.vits import Vits, infer
from benchmark.tests import tiny

CELL = "tts-vits.b32-f1000"
SEED = 2 ** 31 + 11
TEXTS = ["你好，欢迎使用语音克隆。", "ni3 hao3, shi4 jie4", "今天天气很好，我们去公园散步吧！"]


def _override(texts=3, steps=120):
    return tiny.override(CELL, texts=texts, steps=steps)


def test_port_infer_matches_the_reference(tmp_path):
    """Log-durations, durations and, teacher-forced on the port's
    durations, the waveform, on the same noise; float32 on both sides."""
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    cell = _override()
    cfg = cell["config"]
    paths = weights.write(cfg, SEED, tmp_path, "cpu")
    syn = VitsSynthesizer(paths["vits"], verbose=False, device="cpu")
    assert syn.cfg.hidden_channels == fam.TINY_VITS["hidden_channels"]
    t_text = fam.bucket(max(len(fam.ref_text.symbol_ids(t)) for t in TEXTS), fam.TEXT_BUCKET)
    ids, lengths, sid, emo = fam._inputs(TEXTS, t_text, cfg, "cpu")
    frames, inf = 150, cfg["inference"]
    gen = torch.Generator().manual_seed(5)
    dur_noise = torch.randn((len(TEXTS), t_text, 2), generator=gen)
    prior = torch.randn((len(TEXTS), frames, cfg["vits"]["inter_channels"]), generator=gen)
    with torch.no_grad():
        o, _, _, y_len = syn.model.infer(ids, lengths, sid, emo, inf["noise_scale"],
                                         inf["length_scale"], inf["noise_scale_w"], frames,
                                         dur_noise=dur_noise, prior_noise=prior)
        h, m_p, logs_p, mask = syn.model.enc_p(ids, lengths, emo)
        logw_port = syn.model.dp(h, mask, g=syn.model._speaker(sid), reverse=True,
                                 noise_scale=inf["noise_scale_w"], noise=dur_noise)[..., 0]
    net = Vits(weights.read(paths["vits"], "cpu"), cfg["vits"], Prec("float32"))
    logw, durations, counts, _ = infer(net, ids, lengths, sid, emo, dur_noise, prior, frames)
    real = mask[..., 0] > 0
    assert float(logw[real].abs().mean()) > 0.1
    torch.testing.assert_close(logw_port[real], logw[real], rtol=1e-5, atol=1e-5)
    w_ceil = torch.ceil(torch.exp(logw_port) * mask[..., 0])
    assert torch.equal(w_ceil, durations)
    _, _, forced_counts, wav = infer(net, ids, lengths, sid, emo, dur_noise, prior, frames,
                                     durations=w_ceil)
    assert torch.equal(forced_counts, y_len.long()) and int(y_len.min()) > 10
    hop = cfg["vits"]["hop_size"]
    for j, n in enumerate(y_len.tolist()):
        assert float(wav[j, :n * hop].abs().max()) > 1e-2
        torch.testing.assert_close(o[j, :n * hop], wav[j, :n * hop], rtol=0, atol=2e-5)


def _run(trace=False):
    return runner.run_cell(CELL, SEED, 0.1, trace, time.perf_counter(), device="cpu",
                           override=_override())


def test_the_cell_runs_small_and_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] % 3 == 0, r["checks"]
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert r["metrics"]["audio_s_per_s"]["value"] > 0
    assert set(r["checks"]) == {"logw_err", "dur_gap", "wav_err"}
    assert r["checks"]["logw_err"]["value"] < 1e-5 and r["checks"]["wav_err"]["value"] < 1e-4


def test_the_traced_cell_reports_the_vits_metrics():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"vits.decoder_peak_pct", "vits.front_ms_per_call",
                                 "vits.padded_frames_pct", "vits.host_ms_per_call"}
    assert 0 <= r["metrics"]["vits.padded_frames_pct"]["value"] < 100


def _coupling_skipped(monkeypatch):
    from mockingbird_tpu_torch.models.vits.model import ResidualCouplingBlock
    flows = ResidualCouplingBlock._flows
    monkeypatch.setattr(ResidualCouplingBlock, "_flows",
                        lambda self: (f for f in flows(self) if f is not self.coupling_1))


def _flip_dropped(monkeypatch):
    from mockingbird_tpu_torch.models.vits.model import ResidualCouplingBlock
    flows = ResidualCouplingBlock._flows
    monkeypatch.setattr(ResidualCouplingBlock, "_flows",
                        lambda self: (f for f in flows(self) if f is not self.flip_2))


def _duration_moved(monkeypatch):
    """One symbol's predicted duration one frame longer, where the
    duration predictor produces it."""
    from mockingbird_tpu_torch.models.vits.model import StochasticDurationPredictor
    forward = StochasticDurationPredictor.forward

    def moved(self, *args, **kwargs):
        logw = forward(self, *args, **kwargs).clone()
        logw[0, 3, 0] = torch.log(torch.exp(logw[0, 3, 0]) + 1.0)
        return logw
    monkeypatch.setattr(StochasticDurationPredictor, "forward", moved)


def _resblock_left_out(monkeypatch):
    from mockingbird_tpu_torch.models.vits.model import VitsGenerator
    forward = VitsGenerator.forward

    def without(self, x, g=None):
        block = self.resblock_1_0
        self.resblock_1_0 = torch.nn.Identity()
        try:
            return forward(self, x, g)
        finally:
            self.resblock_1_0 = block
    monkeypatch.setattr(VitsGenerator, "forward", without)


@pytest.mark.parametrize("fault,breaks", [
    (_coupling_skipped, "wav_err"), (_flip_dropped, "wav_err"),
    (_duration_moved, "dur_gap"), (_resblock_left_out, "wav_err"),
])
def test_a_broken_path_is_not_correct(monkeypatch, fault, breaks):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]
    check = r["checks"][breaks]
    assert check["value"] > check["limit"] or math.isinf(check["value"]), r["checks"]


def test_the_control_fails_the_check():
    lines = control.run(CELL, [11], [11], 1, "cpu", _override(texts=2))
    prog = next(x for x in lines if x["side"] == "program")
    ctrl = next(x for x in lines if x["side"] == "control")
    limits = registry.cell(CELL)["config"]["limits"]
    assert all(prog[k] <= v for k, v in limits.items()) and prog["failed"] == 0, prog
    assert any(ctrl[k] > v for k, v in limits.items()), ctrl
