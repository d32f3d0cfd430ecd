"""The benchmark measures the port only: nothing under ``benchmark/``
imports JAX, flax, orbax or the JAX package (compared by whole top-level
module name: the port's name begins with the JAX package's), the
reference imports nothing of the port, and no file reads the JAX
package's own benchmark scripts or records."""
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

BLOCKER = r'''
import importlib.abc, sys
BANNED = {"jax", "jaxlib", "flax", "orbax", "mockingbird_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
'''


def _run(body: str) -> subprocess.CompletedProcess:
    code = BLOCKER.replace("ROOT", repr(str(ROOT))) + body
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))


def test_every_module_imports_without_jax():
    body = r'''
import importlib, pathlib
root = pathlib.Path(ROOT) / "benchmark"
for f in sorted(root.rglob("*.py")):
    rel = f.relative_to(root.parent)
    if "tests" in rel.parts or "." in f.stem:
        continue
    importlib.import_module(".".join(rel.with_suffix("").parts).replace(".__init__", ""))
from benchmark.harness import registry
for m in registry.benchmark()["end_to_end"] + registry.benchmark()["per_layer"]:
    registry.reader(m["name"])
import mockingbird_tpu_torch.pipeline
seen = sorted({m.split(".")[0] for m in sys.modules} & BANNED)
assert not seen, seen
print("ok")
'''.replace("ROOT", repr(str(ROOT)))
    proc = _run(body)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


def test_reference_imports_nothing_of_the_port():
    body = r'''
import importlib, pathlib
for f in sorted((pathlib.Path(ROOT) / "benchmark" / "reference").glob("*.py")):
    importlib.import_module("benchmark.reference." + f.stem if f.stem != "__init__" else "benchmark.reference")
port = sorted(m for m in sys.modules if m.split(".")[0] == "mockingbird_tpu_torch")
assert not port, port
print("ok")
'''.replace("ROOT", repr(str(ROOT)))
    proc = _run(body)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-3000:]


def test_no_file_reads_the_jax_benchmark():
    pattern = re.compile(r"bench\.py|bench_train|chip_smoke|BENCH_r|BASELINE\.|scripts/")
    offenders = []
    for f in BENCH.rglob("*"):
        if f.is_file() and f.suffix in (".py", ".json") and f.name != Path(__file__).name:
            text = f.read_text(encoding="utf-8")
            code = "\n".join(line for line in text.splitlines()
                             if not line.lstrip().startswith("#"))
            for hit in pattern.finditer(code):
                line = code[:hit.start()].count("\n")
                # docstrings may name what a frozen copy was taken from
                if "open(" in code.splitlines()[line] or "Path(" in code.splitlines()[line]:
                    offenders.append(f"{f}:{line + 1}")
    assert not offenders, offenders


def test_run_exits_nonzero_without_a_card():
    code = (f"import sys; sys.argv = ['run.py', '--workload', 'tts-hifigan.b128-f800', "
            f"'--seed', '1', '--seconds', '1', '--trace', '0']\n"
            f"import torch; torch.cuda.is_available = lambda: False\n"
            f"sys.path.insert(0, {str(BENCH)!r})\n"
            f"import runpy; runpy.run_path({str(BENCH / 'run.py')!r}, run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode != 0
    assert proc.stdout.strip() == "", proc.stdout
