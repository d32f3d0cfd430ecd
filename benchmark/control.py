"""The control of the check that decides ``correct``, and the readings the
check's limits are set from:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For every seed of ``--seeds``: seeded weights and voices as a run makes
them, the port's pipeline, as many calls of the cell's own traffic as the
check judges,
and the check's numbers for them (the program's readings). For every seed
of ``--control-seeds``: the plain reference put in the program's place one
precision below the configuration's (float32 parts in bfloat16, bfloat16
parts with float8 e4m3 products) makes the same calls' outputs, and the
same check reads them (the control's readings). One JSON line per seed and
side on standard output. Not part of the benchmark's runs.
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

from benchmark.harness import check, registry, system, traffic, weights  # noqa: E402
from benchmark.reference import audio, hifigan, wavernn  # noqa: E402

LOWER = {"float32": "bfloat16", "bfloat16": "float8"}
# PyTorch's defaults, under which the program runs; the reference turns
# TF32 off for the whole process
DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def program_calls(cfg, mix, seed, n_calls, device, paths, voices):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = DEFAULT_TF32
    rec = system.Recorder(device, False)
    pipe = system.build(cfg, paths, device, weights.seed_of(seed, 3), rec)
    kwargs = traffic.call_args(mix)
    calls = []
    for i in range(n_calls):
        texts = traffic.texts(mix, seed, i)
        voice = voices[traffic.voice_of(mix, seed, i)]
        n_l = len(rec.launches)
        pcm = pipe.tts_batch(texts, str(voice), **kwargs)
        calls.append(check.CallOut(texts, voice, pcm, rec.mels[-1], rec.launches[n_l:]))
    del pipe
    return calls


def control_calls(cfg, mix, seed, n_calls, device, paths, voices):
    """The calls' outputs from the reference at the lower precisions."""
    low = check.Reference(cfg, paths, device,
                          {k: LOWER[v] for k, v in cfg["precision"].items()})
    voc = cfg["vocoder"]
    steps = check.bucket(mix["tts_batch"]["steps"], 200)
    calls = []
    for i in range(n_calls):
        texts = traffic.texts(mix, seed, i)
        voice = voices[traffic.voice_of(mix, seed, i)]
        mels = low.tacotron(texts, voice, weights.seed_of(seed, 3), steps, None)
        if voc["arch"] == "hifigan":
            pcm = []
            for a in range(0, len(texts), 8):
                wav = hifigan.generate(low.w["vocoder"], voc, mels[a:a + 8], low.p["vocoder"])
                pcm += list(hifigan.to_pcm16(wav).cpu().numpy())
            calls.append(check.CallOut(texts, voice, pcm, mels))
            continue
        specs = [m.T.cpu().numpy() for m in mels]
        n_folds, group, t_bucket = low.wavernn_plan([s.shape[1] for s in specs])
        launches, pcm = [], []
        for start in range(0, len(specs), group):
            conds = [low.wavernn_cond(s, t_bucket) for s in specs[start:start + group]]
            m = torch.cat([c[0] for c in conds])
            a = torch.cat([c[1] for c in conds])
            labels = wavernn.run(low.w["vocoder"], voc, m, a, low.p["sampler"],
                                 low.noise(start, m.shape[0]))
            launches.append((start, labels.to(torch.int32)))
            lab = labels.reshape(-1, n_folds, labels.shape[-1]).cpu().numpy()
            for u, s in enumerate(specs[start:start + group]):
                pcm.append(audio.wavernn_pcm(lab[u], voc["gen_overlap_tpu"], voc["bits"],
                                             (s.shape[1] - 1) * voc["hop_size"],
                                             voc["hop_size"], voc["preemphasis"]))
        calls.append(check.CallOut(texts, voice, pcm, specs, launches))
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


def run(name, seeds, control_seeds, n_calls=check.TACOTRON_CALLS, device="cuda", override=None):
    cell = registry.cell(name)
    cell.update(override or {})
    cfg, mix = cell["config"], cell["traffic"]
    dev = torch.device(device)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        tmp = Path(tempfile.mkdtemp(prefix="control-"))
        try:
            paths = weights.write(cfg, seed, tmp, dev)
            voices = traffic.write_voices(mix, seed, tmp)
            sides = []
            if seed in seeds:
                sides.append(("program", program_calls(cfg, mix, seed, n_calls, dev, paths, voices)))
            if seed in control_seeds:
                sides.append(("control", control_calls(cfg, mix, seed, n_calls, dev, paths,
                                                       voices)))
            for side, calls in sides:
                ref = check.Reference(cfg, paths, dev)
                numbers = check.readings(ref, mix, calls, seed, weights.seed_of(seed, 3))
                line = {"seed": seed, "side": side, "failed": check.count_failed(cfg, mix, calls),
                        **numbers}
                print(json.dumps(line), flush=True)
                out.append(line)
                del ref
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
