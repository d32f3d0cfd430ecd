"""The reader of ``hifigan.fused_pct`` on hand-made program spans: what
lies outside the window is left out, and a program that does not count the
convolutions, or a cell without a HiFi-GAN, reads None."""
import pytest
import torch

from benchmark.harness import registry, runner
from mockingbird_tpu_torch import tracing

MS = 1_000_000


def test_fused_share_reads_the_vocode_spans(monkeypatch):
    """``hifigan.fused_pct`` on hand-made ``hifigan.vocode`` spans: Σ
    ``fused_convs`` over Σ ``convs`` inside the window; None where a span
    lacks the attributes (a program that does not count them), where no
    vocode span lies in the window, and in a cell without a HiFi-GAN."""
    def run(name):
        cell = registry.cell(name)
        r = runner.Run(name, cell["config"], cell["traffic"], torch.device("cpu"), 1.0)
        r.spans = [("window", 0.1, 1.0, 100 * MS, 1000 * MS)]
        return r

    def vocode(t0, **attrs):
        return tracing.Span("hifigan.vocode", t0 * MS, (t0 + 50) * MS, attrs=attrs or None)
    read = registry.reader("hifigan.fused_pct").read
    flagship = run("tts-hifigan.b128-f800")
    for found, want in (([vocode(200, convs=59, fused_convs=59),
                          vocode(400, convs=59, fused_convs=59)], 100.0),
                        ([vocode(200, convs=59, fused_convs=59),
                          vocode(400, convs=59, fused_convs=0),
                          vocode(990, convs=59, fused_convs=0)], 50.0),
                        ([vocode(200, convs=59, fused_convs=0)], 0.0),
                        ([vocode(200, convs=59, fused_convs=59), vocode(400)], None),
                        ([vocode(200), vocode(400)], None),
                        ([vocode(0, convs=59, fused_convs=59)], None),
                        ([], None)):
        monkeypatch.setattr(tracing, "spans", lambda: list(found))
        assert read(flagship) == (want if want is None else pytest.approx(want))
        for other in ("tts-wavernn.b16-f800", "tts-vits.b32-f1000"):
            assert read(run(other)) is None
