"""A model family joins the benchmark as new files and entries alone.

A copy of ``benchmark/`` and ``BENCHMARK.json`` gains a toy family
(``toy_family.py`` as ``families/toy.py``), its configuration, its mix and
one cell, as new files and two new entries; the copy's own harness then
runs the cell on the CPU in a process of its own, correct and reporting
``audio_s_per_s``, and not correct once an output sample is altered where
it is produced. Every metric reader, run on the toy's window, gives a
number or nothing and never raises. No file that was there changed.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import registry

CELL = "toy.b4"
CONFIG = {"name": "toy", "family": "toy", "source": "a toy for the benchmark's tests",
          "reduced": [], "toy": {"dim": 16, "hop": 200, "sample_rate": 16000},
          "limits": {"toy_lsb": 1}}
MIX = {"kind": "toy_closed", "texts_per_call": 4, "letters": [5, 40]}
CONFIG_ENTRY = {"name": "toy", "source": "https://example.org/toy",
                "file": "benchmark/configs/toy.json", "reduced": [], "why": "a toy family"}
CELL_ENTRY = {"name": CELL, "config": "toy", "traffic": "toy", "chips": 1,
              "why": "4 texts of 5-40 letters a call"}
# the readers that only the sv2tts family's cells give something to read
SV2TTS_ONLY = ("pipeline.", "tacotron.", "hifigan.", "k1", "wavernn.")

SCRIPT = r"""
import json, sys, time
root, repo = sys.argv[1], sys.argv[2]
sys.path[:0] = [root]
sys.path.append(repo)
import benchmark
assert benchmark.__file__.startswith(root), benchmark.__file__
from benchmark.harness import registry, runner
from benchmark.families import toy

def run(trace):
    return runner.run_cell("toy.b4", 2 ** 31 + 17, 0.2, trace, time.perf_counter(),
                           device="cpu")

out = {"sound": run(False)}
spec = registry.benchmark()
every = spec["end_to_end"] + spec["per_layer"]
metrics_of = registry.metrics_of
registry.metrics_of = lambda name, trace, spec=None: every
out["every_reader"] = run(True)
registry.metrics_of = metrics_of
forward = toy.Toy.forward

def altered(self, ids):
    pcm = forward(self, ids).clone()
    pcm[0, 5] = -32768 if pcm[0, 5] > 0 else 32767
    return pcm
toy.Toy.forward = altered
out["altered"] = run(False)
print(json.dumps(out))
"""


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(registry.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _hashes(root)
    bench = root / "benchmark"
    shutil.copy(bench / "tests" / "toy_family.py", bench / "families" / "toy.py")
    (bench / "configs" / "toy.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "toy.json").write_text(json.dumps(MIX))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(CONFIG_ENTRY)
    spec["workloads"].append(CELL_ENTRY)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(root), str(registry.ROOT)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, before, json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_toy_cell_runs_and_is_correct(copy):
    r = copy[2]["sound"]
    assert r["correct"], r["checks"]
    assert r["metrics"]["audio_s_per_s"]["value"] > 0
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert r["failed"] == 0 and r["attempted"] > 0 and r["attempted"] % 4 == 0
    assert r["checks"] == {"toy_lsb": {"value": r["checks"]["toy_lsb"]["value"], "limit": 1}}


def test_an_altered_sample_is_not_correct(copy):
    r = copy[2]["altered"]
    assert not r["correct"]
    assert r["checks"]["toy_lsb"]["value"] > r["checks"]["toy_lsb"]["limit"], r["checks"]


def test_every_reader_gives_a_number_or_nothing_in_another_family(copy):
    r = copy[2]["every_reader"]
    assert r["correct"], r["checks"]
    assert {"audio_s_per_s", "setup_s", "mfu_pct"} <= set(r["metrics"])
    assert not [m for m in r["metrics"] if m.startswith(SV2TTS_ONLY)], r["metrics"]


def test_adding_the_family_edited_no_file(copy):
    root, before, _ = copy
    after = _hashes(root)
    changed = sorted(k for k in before if after.get(k) != before[k])
    assert changed == ["BENCHMARK.json"]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    assert spec["configs"].pop() == CONFIG_ENTRY and spec["workloads"].pop() == CELL_ENTRY
    assert spec == registry.benchmark()
    added = sorted(set(after) - set(before))
    assert added == ["benchmark/configs/toy.json", "benchmark/families/toy.py",
                     "benchmark/traffic/toy.json"]


def test_a_configuration_without_a_family_names_its_file(tmp_path):
    spec = registry.benchmark()
    cfg = dict(json.loads((registry.ROOT / spec["configs"][0]["file"]).read_text()))
    del cfg["family"]
    path = tmp_path / "no_family.json"
    path.write_text(json.dumps(cfg))
    spec["configs"][0] = dict(spec["configs"][0], file=str(path))
    name = next(w["name"] for w in spec["workloads"] if w["config"] == spec["configs"][0]["name"])
    with pytest.raises(KeyError, match="no_family.json"):
        registry.cell(name, spec)
