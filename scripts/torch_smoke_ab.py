"""Time chip_smoke.py's phases on several checkouts of the port, in turn, on
one card: each run is a fresh process in that checkout that builds the
kernels and runs the named phases (each ``phase_<name>(dev, tmp)``), so
two commits compare on the same machine in one call, in the order given
(parent, change, change, parent is the usual one).

    python scripts/torch_smoke_ab.py --trees PARENT CHANGE --order 0,1,1,0 \\
        --phases vits_train,tacotron_train --out chiprun_out/ab

Prints each run's phase wall times and the trainers' logged ``ms/step``
lines, then one table of phase seconds per run; each run's whole output
goes to ``<out>/run<i>_<tree>.log``. Imports no JAX.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import sys, tempfile
from pathlib import Path
import torch
import chip_smoke as cs
from mockingbird_tpu_torch.ops import build
dev = torch.device("cuda")
with cs.Phase("build"):
    for name in cs.KERNELS:
        build.build(name)
for name in sys.argv[1].split(","):
    with tempfile.TemporaryDirectory() as tmp:
        getattr(cs, "phase_" + name)(dev, Path(tmp))
"""

PHASE_LINE = re.compile(r"^== (.*): ([0-9.]+) s$")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkout roots")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into --trees (default: each once)")
    ap.add_argument("--phases", required=True, help="comma-separated phase names")
    ap.add_argument("--out", default="chiprun_out/ab")
    ap.add_argument("--timeout", type=int, default=900, help="seconds per run")
    args = ap.parse_args()
    trees = [Path(t).resolve() for t in args.trees]
    order = ([int(i) for i in args.order.split(",")] if args.order
             else list(range(len(trees))))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    table = []
    for i, k in enumerate(order):
        tree = trees[k]
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", RUN, args.phases], cwd=tree,
                             capture_output=True, text=True, timeout=args.timeout)
        wall = time.perf_counter() - t0
        log = out / f"run{i}_{tree.name}.log"
        log.write_text(run.stdout + "\n--- stderr ---\n" + run.stderr)
        times = {}
        print(f"== run {i}: {tree.name}, rc {run.returncode}, {wall:.2f} s (process included)")
        for line in run.stdout.splitlines():
            m = PHASE_LINE.match(line)
            if m:
                times[m.group(1)] = float(m.group(2))
                print("  " + line)
            elif "ms/step" in line or "ms per step" in line or "step without marks" in line:
                print("    " + line[:220])
        if run.returncode != 0:
            print(run.stderr[-3000:])
        table.append((f"run{i}:{tree.name}", times))
    names = list(dict.fromkeys(n for _, times in table for n in times))
    print("phase seconds | " + " | ".join(label for label, _ in table))
    for n in names:
        print(f"{n[:72]:72s} " + " ".join(f"{times.get(n, float('nan')):9.2f}"
                                           for _, times in table))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
