"""``BENCHMARK.json`` keeps to the benchmark's contract: names, units and
free text in the allowed characters, the keys each entry may have, the
files it names, a reader for every metric and a limit for every number
the check compares."""
import json
import re

import pytest

from benchmark.harness import registry

SPEC = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATHS = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATHS.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(TEXT.match(w) for w in SPEC["command"])
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_unit_and_text():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert json.loads((registry.ROOT / c["file"]).read_text())["name"] == c["name"]
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"]) and w["config"] in names
        assert (registry.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (registry.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    all_names = names + [w["name"] for w in SPEC["workloads"]] + [m["name"] for m in metrics]
    assert len(all_names) == len(set(all_names))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in registry.metrics_of(cell, False, SPEC)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_of(cell, True, SPEC)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_configuration_has_a_limit_for_every_number(config):
    cfg = json.loads((registry.ROOT / next(c["file"] for c in SPEC["configs"]
                                           if c["name"] == config)).read_text())
    assert set(cfg["limits"]) == registry.family(cfg).numbers(cfg)
