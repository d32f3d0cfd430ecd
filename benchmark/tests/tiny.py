"""Small versions of the cells, for rehearsals and tests on the CPU: the
cell's family cuts the widths and the traffic (``tiny`` of
``benchmark/families/<family>.py``; sv2tts: every width cut, WaveRNN's
folds 500 samples wide, a few texts of 200 frames a call)."""
from __future__ import annotations

import copy

from benchmark.harness import registry


def override(name: str, texts: int = 3, steps: int = 200) -> dict:
    cell = registry.cell(name)
    cfg, mix = registry.family(cell["config"]).tiny(copy.deepcopy(cell["config"]),
                                                    copy.deepcopy(cell["traffic"]), texts, steps)
    return {"config": cfg, "traffic": mix}
