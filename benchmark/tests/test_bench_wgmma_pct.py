"""The reader of ``k1.wgmma_pct`` on hand-made program spans: what lies
outside the window is left out, and a program that does not record the
attribute, or a cell without a WaveRNN, reads None."""
import pytest
import torch

from benchmark.harness import registry, runner
from mockingbird_tpu_torch import tracing

MS = 1_000_000


def test_wgmma_share_reads_the_launch_spans(monkeypatch):
    """``k1.wgmma_pct`` on hand-made ``k1.launch`` spans: 100 · Σ
    ``tensor_core`` over the launches inside the window; None where a span
    lacks the attribute (a program that does not record it), where no
    launch span lies in the window, and in a cell without a WaveRNN."""
    def run(name):
        cell = registry.cell(name)
        r = runner.Run(name, cell["config"], cell["traffic"], torch.device("cpu"), 1.0)
        r.spans = [("window", 0.1, 1.0, 100 * MS, 1000 * MS)]
        return r

    def launch(t0, **attrs):
        return tracing.Span("k1.launch", t0 * MS, (t0 + 50) * MS,
                            attrs=dict(F=186, T=2400, **attrs))
    read = registry.reader("k1.wgmma_pct").read
    wavernn = run("tts-wavernn.b16-f800")
    for found, want in (([launch(200, tensor_core=1), launch(400, tensor_core=1)], 100.0),
                        ([launch(200, tensor_core=1), launch(400, tensor_core=0),
                          launch(990, tensor_core=0)], 50.0),
                        ([launch(200, tensor_core=0)], 0.0),
                        ([launch(200, tensor_core=1), launch(400)], None),
                        ([launch(200), launch(400)], None),
                        ([launch(0, tensor_core=1)], None),
                        ([], None)):
        monkeypatch.setattr(tracing, "spans", lambda: list(found))
        assert read(wavernn) == (want if want is None else pytest.approx(want))
        for other in ("tts-hifigan.b128-f800", "tts-vits.b32-f1000"):
            assert read(run(other)) is None
