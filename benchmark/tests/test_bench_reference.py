"""The reference against the port on the CPU at small widths, through a
whole run of each cell (``tts_batch`` on the fused and on the staged
branch): the seeded weights load strictly into the port, and every number
the check compares comes out at rounding level."""
import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests import tiny


@pytest.mark.parametrize("cell,texts", [("tts-hifigan.b128-f800", 3), ("tts-wavernn.b16-f800", 2)])
def test_a_small_run_is_correct(cell, texts):
    torch.manual_seed(0)
    r = runner.run_cell(cell, 2 ** 31 + 77, 0.1, False, time.perf_counter(), device="cpu",
                        override=tiny.override(cell, texts=texts))
    checks = r["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= texts, checks
    assert checks["mel_err"]["value"] < 1e-5
    if "pcm_err_excess" in checks:
        # the program's error against the float32 generator is no larger
        # than that of a plain bf16 computation (on the CPU it is smaller)
        assert checks["pcm_err_excess"]["value"] < 0.05
    else:
        assert checks["pcm_lsb"]["value"] == 0
        # the program samples with bf16 weights and activations, the
        # reference in float32: a label's score is off by bf16 rounding
        assert checks["label_gap"]["value"] < 1e-2
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
