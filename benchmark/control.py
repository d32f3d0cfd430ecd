"""The control of the check that decides ``correct``, and the readings the
check's limits are set from:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For every seed of ``--seeds``: seeded weights and inputs as a run makes
them, the port's system, as many calls of the cell's own traffic as the
check judges, and the check's numbers for them (the program's readings).
For every seed of ``--control-seeds``: the plain reference put in the
program's place one precision below the configuration's makes the same
calls' outputs (the family's ``control_calls``), and the same check reads
them (the control's readings). One JSON line per seed and side on standard
output. Not part of the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import registry, system, weights  # noqa: E402

# PyTorch's defaults, under which the program runs; the reference turns
# TF32 off for the whole process
DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def program_calls(cfg, mix, seed, n_calls, device, paths, inputs):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = DEFAULT_TF32
    fam = registry.family(cfg)
    sut = fam.build(cfg, mix, paths, inputs, device, seed, system.Recorder(device, False))
    calls = [fam.call(sut, fam.draw(mix, seed, i), i) for i in range(n_calls)]
    del sut
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    run(args.workload, [int(s) for s in args.seeds.split(",") if s],
        [int(s) for s in args.control_seeds.split(",") if s])
    return 0


def run(name, seeds, control_seeds, n_calls=None, device="cuda", override=None):
    cell = registry.cell(name)
    cell.update(override or {})
    cfg, mix = cell["config"], cell["traffic"]
    fam = registry.family(cfg)
    n_calls = fam.CHECK_CALLS if n_calls is None else n_calls
    dev = torch.device(device)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        tmp = Path(tempfile.mkdtemp(prefix="control-"))
        try:
            paths = weights.write(cfg, seed, tmp, dev)
            inputs = fam.write_inputs(mix, seed, tmp)
            sides = []
            if seed in seeds:
                sides.append(("program", program_calls(cfg, mix, seed, n_calls, dev, paths, inputs)))
            if seed in control_seeds:
                sides.append(("control", fam.control_calls(cfg, mix, seed, n_calls, dev, paths,
                                                           inputs)))
            for side, calls in sides:
                numbers = fam.readings(cfg, mix, paths, dev, calls, seed)
                line = {"seed": seed, "side": side, "failed": fam.failed(cfg, mix, calls),
                        **numbers}
                print(json.dumps(line), flush=True)
                out.append(line)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
