"""Unified command-line interface of the port.

Port of ``mockingbird_tpu/cli/main.py``: the same subcommands, each calling
the port's counterpart, on the device of the global ``--device`` option
(``cuda`` by default; ``--device cpu`` for the CPU):

  python -m mockingbird_tpu_torch.cli preprocess <datasets_root> [--dataset ...]
  python -m mockingbird_tpu_torch.cli emo <syn_dir> [--weights ...]
  python -m mockingbird_tpu_torch.cli embed <syn_dir> [--encoder ...]
  python -m mockingbird_tpu_torch.cli encoder-preprocess <datasets_root> ...
  python -m mockingbird_tpu_torch.cli train-encoder <clean_dir> ...
  python -m mockingbird_tpu_torch.cli train-synth <syn_dir> ...
  python -m mockingbird_tpu_torch.cli train-vits <syn_dir> ...
  python -m mockingbird_tpu_torch.cli train-vocoder <syn_dir> --arch {hifigan,fregan,wavernn}
  python -m mockingbird_tpu_torch.cli gta <syn_dir> ...
  python -m mockingbird_tpu_torch.cli preprocess-vc <wav_dir> <out_dir>
  python -m mockingbird_tpu_torch.cli train-vc <vc_dir> ...
  python -m mockingbird_tpu_torch.cli tts "text" --ref ref.wav --out out.wav
  python -m mockingbird_tpu_torch.cli demo
  python -m mockingbird_tpu_torch.cli convert --ref ref.wav src1.wav src2.wav --out-dir out/
  python -m mockingbird_tpu_torch.cli serve [--port 8080]
  python -m mockingbird_tpu_torch.cli text-to-srt <text file> --out subs.srt
  python -m mockingbird_tpu_torch.cli render-timeline --srt subs.srt --out out.wav --ref ref.wav
  python -m mockingbird_tpu_torch.cli import-checkpoint --family vits --torch-ckpt G.pth --out vits
  python -m mockingbird_tpu_torch.cli download-datasets <datasets_root> [--list]
  python -m mockingbird_tpu_torch.cli launch --nprocs 2 -- train-vits <syn_dir> run1

``main`` starts a data-parallel run from the ``MB_*`` environment
(``parallel.multihost.initialize_from_env`` on the ``--device`` given:
NCCL on cards, gloo on the CPU); ``launch`` starts N such processes on this
host. Weights come from ``.npz`` exports; without a path, from a seed.
With ``MB_RUN_REPORT`` set, ``main`` prints after the command one line
``RUN_REPORT {"rank", "world", "launches"}``: the process's rank and each
kernel's launches in it.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _print_args(args: argparse.Namespace) -> None:
    """Pretty arg dump (`utils/argutils.py:22` parity)."""
    items = sorted(vars(args).items())
    width = max((len(k) for k, _ in items), default=0)
    print("Arguments:")
    for k, v in items:
        if k != "func":
            print(f"    {k:{width}}: {v}")
    print()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mockingbird_tpu_torch",
                                description="voice cloning on PyTorch and CUDA")
    p.add_argument("--hparams", type=str, default="",
                   help="comma-separated overrides, e.g. a=1,b.c=2")
    p.add_argument("--device", default="cuda",
                   help="torch device every subcommand runs on (default cuda; "
                        "cpu to run on the CPU)")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("preprocess", help="synthesizer dataset preprocessing (pre.py)")
    sp.add_argument("datasets_root", type=Path)
    sp.add_argument("-o", "--out_dir", type=Path, default=None)
    sp.add_argument("-d", "--dataset", default="aidatatang_200zh")
    sp.add_argument("-n", "--n_processes", type=int, default=8)
    sp.add_argument("-s", "--skip_existing", action="store_true")
    sp.set_defaults(func=cmd_preprocess)

    sp = sub.add_parser("emo", help="create emotion embeddings (pre.py --emotion_extract)")
    sp.add_argument("syn_dir")
    sp.add_argument("--weights", default=None,
                    help="wav2vec2 emotion weights: .npz export or torch checkpoint "
                         "(default: HF cache)")
    sp.set_defaults(func=cmd_emo)

    sp = sub.add_parser("embed", help="create speaker embeddings for a syn dir")
    sp.add_argument("syn_dir", type=Path)
    sp.add_argument("-e", "--encoder_model_fpath", type=Path, default=None)
    sp.set_defaults(func=cmd_embed)

    sp = sub.add_parser("encoder-preprocess", help="speaker-encoder corpus preprocessing")
    sp.add_argument("datasets_root", type=Path)
    sp.add_argument("-o", "--out_dir", type=Path, default=None)
    sp.add_argument("-d", "--datasets", default="librispeech_other",
                    help="comma list: librispeech_other,voxceleb1,voxceleb2,"
                         "aidatatang_200zh or any generic <name>")
    sp.add_argument("-s", "--skip_existing", action="store_true")
    sp.set_defaults(func=cmd_encoder_preprocess)

    sp = sub.add_parser("train-encoder")
    sp.add_argument("clean_data_root", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--total_steps", type=int, default=None)
    sp.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                    help="bf16 = mixed-precision compute (fp32 master params)")
    sp.set_defaults(func=cmd_train_encoder)

    sp = sub.add_parser("train-synth", help="train.py --type=synth")
    sp.add_argument("syn_dir", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--total_steps", type=int, default=None)
    sp.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                    help="bf16 = mixed-precision compute (fp32 master params)")
    sp.add_argument("--guided_attn", type=float, default=0.0,
                    help="guided-attention loss weight (0 = off, reference "
                         "parity; ~0.2 makes alignment emerge much earlier)")
    sp.set_defaults(func=cmd_train_synth)

    sp = sub.add_parser("train-vits", help="train.py --type=vits")
    sp.add_argument("syn_dir", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--batch_size", type=int, default=16)
    sp.add_argument("--total_steps", type=int, default=None)
    sp.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                    help="bf16 = mixed-precision compute (fp32 master params)")
    sp.add_argument("--log_every", type=int, default=10,
                    help="steps between log lines and scalars.jsonl records")
    sp.set_defaults(func=cmd_train_vits)

    sp = sub.add_parser("train-vocoder")
    sp.add_argument("syn_dir", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--arch", choices=("hifigan", "fregan", "wavernn"), default="hifigan")
    sp.add_argument("--ground_truth", action="store_true",
                    help="train on GT mels instead of GTA")
    sp.add_argument("--total_steps", type=int, default=None)
    sp.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                    help="bf16 = mixed-precision compute (fp32 master params)")
    sp.set_defaults(func=cmd_train_vocoder)

    sp = sub.add_parser("gta", help="ground-truth-aligned synthesis for vocoder finetune")
    sp.add_argument("syn_dir", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.set_defaults(func=cmd_gta)

    sp = sub.add_parser("preprocess-vc", help="PPG/f0/embed extraction (pre4ppg.py)")
    sp.add_argument("wav_dir", type=Path)
    sp.add_argument("out_dir", type=Path)
    sp.set_defaults(func=cmd_preprocess_vc)

    sp = sub.add_parser("train-vc", help="ppg2mel training")
    sp.add_argument("vc_dir", type=Path)
    sp.add_argument("run_id")
    sp.add_argument("-m", "--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--total_steps", type=int, default=None)
    sp.add_argument("--precision", choices=("fp32", "bf16"), default="bf16",
                    help="bf16 = mixed-precision compute (fp32 master params)")
    sp.set_defaults(func=cmd_train_vc)

    sp = sub.add_parser("tts", help="clone a voice (gen_voice.py)")
    sp.add_argument("text")
    sp.add_argument("--ref", type=Path, required=True, help="reference wav")
    sp.add_argument("--out", type=Path, default=Path("out.wav"))
    sp.add_argument("--encoder", type=Path, default=None)
    sp.add_argument("--synth", type=Path, default=None)
    sp.add_argument("--vocoder", type=Path, default=None)
    sp.add_argument("--synthesizer", choices=("tacotron", "vits"), default="tacotron")
    sp.add_argument("--style_idx", type=int, default=0)
    sp.add_argument("--griffin-lim", action="store_true")
    sp.set_defaults(func=cmd_tts)

    sp = sub.add_parser("demo", help="interactive voice-cloning REPL "
                                     "(archived_untest_files/demo_cli.py)")
    sp.add_argument("--encoder", type=Path, default=None)
    sp.add_argument("--synth", type=Path, default=None)
    sp.add_argument("--vocoder", type=Path, default=None)
    sp.add_argument("--out-dir", type=Path, default=Path("demo_output"))
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(func=cmd_demo)

    sp = sub.add_parser("convert", help="one-shot voice conversion (run.py)")
    sp.add_argument("sources", nargs="+", type=Path)
    sp.add_argument("--ref", type=Path, required=True)
    sp.add_argument("--out-dir", type=Path, default=Path("vc_out"))
    sp.add_argument("--ppg2mel", type=Path, default=None)
    sp.add_argument("--vocoder", type=Path, default=None)
    sp.set_defaults(func=cmd_convert)

    sp = sub.add_parser("import-checkpoint",
                        help="convert a reference/community torch checkpoint "
                             "into the port's .npz export (+ .json sidecar)")
    sp.add_argument("--family", required=True,
                    choices=["encoder", "tacotron", "wavernn", "hifigan",
                             "fregan", "vits", "ppg_extractor", "ppg2mel"])
    sp.add_argument("--torch-ckpt", type=Path, required=True)
    sp.add_argument("--out", type=Path, required=True)
    sp.add_argument("--config", type=Path, default=None,
                    help="optional json config overriding the family defaults")
    sp.set_defaults(func=cmd_import_checkpoint)

    sp = sub.add_parser("download-datasets",
                        help="fetch + verify + extract training corpora "
                             "(datasets_download/download.sh + extract.sh)")
    sp.add_argument("datasets_root", type=Path)
    sp.add_argument("--datasets", nargs="*", default=None,
                    help="subset of corpus names (default: all)")
    sp.add_argument("--mirror", default="default",
                    help="default|cn|eu|us or a custom base URL")
    sp.add_argument("--no-extract", action="store_true",
                    help="download + verify only")
    sp.add_argument("--list", action="store_true",
                    help="print the manifest and exit")
    sp.set_defaults(func=cmd_download_datasets)

    sp = sub.add_parser("text-to-srt",
                        help="plain text -> SRT with estimated timings "
                             "(skills/speak text_to_srt.py)")
    sp.add_argument("input", help="text file path, or '-' for stdin")
    sp.add_argument("--out", type=Path, required=True)
    sp.add_argument("--cps", type=float, default=4.0,
                    help="characters per second for duration estimation")
    sp.add_argument("--gap-ms", type=int, default=150)
    sp.add_argument("--start-offset-ms", type=int, default=0)
    sp.set_defaults(func=cmd_text_to_srt)

    sp = sub.add_parser("render-timeline",
                        help="SRT -> timeline-accurate speech "
                             "(skills/speak render_timeline.py)")
    sp.add_argument("--srt", type=Path, required=True)
    sp.add_argument("--out", type=Path, required=True)
    sp.add_argument("--voice-map", type=Path, default=None,
                    help="JSON: {default:{...}, segments:{'2-5':{...}}}")
    sp.add_argument("--backend", choices=("pipeline", "command", "http"),
                    default="pipeline")
    sp.add_argument("--ref", type=Path, default=None,
                    help="pipeline backend: default reference voice wav")
    sp.add_argument("--command", default=None,
                    help="command backend: external TTS CLI name")
    sp.add_argument("--base-url", default=None, help="http backend API base URL")
    sp.add_argument("--api-key", default="", help="http backend API key")
    sp.add_argument("--encoder", type=Path, default=None)
    sp.add_argument("--synth", type=Path, default=None)
    sp.add_argument("--vocoder", type=Path, default=None)
    sp.add_argument("--duration-mode", choices=("stretch", "pad_trim"),
                    default="stretch")
    sp.set_defaults(func=cmd_render_timeline)

    sp = sub.add_parser("serve", help="HTTP toolbox console + API (web.py / demo_toolbox.py)")
    sp.add_argument("--port", type=int, default=8080)
    sp.add_argument("--encoder", type=Path, default=None)
    sp.add_argument("--synth", type=Path, default=None)
    sp.add_argument("--vocoder", type=Path, default=None)
    sp.add_argument("--datasets_root", type=Path, default=None,
                    help="root for the dataset browser (demo_toolbox.py -d)")
    sp.add_argument("--models_dir", type=Path, default=Path("saved_models"))
    sp.add_argument("--seed", type=int, default=None)
    sp.set_defaults(func=cmd_serve)

    sp = sub.add_parser(
        "launch", help="spawn N local training processes connected through "
        "torch.distributed (the reference's mp.spawn, "
        "control/cli/vocoder_train.py:73-79); on several hosts run one process "
        "per card with MB_COORDINATOR/MB_NUM_PROCESSES/MB_PROCESS_ID instead")
    sp.add_argument("--nprocs", type=int, default=2)
    sp.add_argument("--port", type=int, default=0, help="coordinator port (0=auto)")
    sp.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="CLI command to run in each process, e.g. "
                         "train-vits <syn_dir> run1 --batch_size 16")
    sp.set_defaults(func=cmd_launch)

    return p


# -- command impls ----------------------------------------------------------

def cmd_preprocess(args):
    from ..models.tacotron.preprocess import preprocess_dataset
    out = args.out_dir or (args.datasets_root / "SV2TTS" / "synthesizer")
    preprocess_dataset(args.datasets_root, out, args.n_processes,
                       args.skip_existing, args.dataset, device=args.device)


def cmd_emo(args):
    from ..models.tacotron.preprocess import create_emotion_embeddings
    create_emotion_embeddings(args.syn_dir, weights_path=args.weights, device=args.device)


def cmd_embed(args):
    from ..models.tacotron.preprocess import create_embeddings
    create_embeddings(args.syn_dir, args.encoder_model_fpath, device=args.device)


def cmd_encoder_preprocess(args):
    from ..models.encoder import preprocess as ep
    out = args.out_dir or (args.datasets_root / "SV2TTS" / "encoder")
    known = {
        "librispeech_other": ep.preprocess_librispeech,
        "voxceleb1": ep.preprocess_voxceleb1,
        "voxceleb2": ep.preprocess_voxceleb2,
        "aidatatang_200zh": ep.preprocess_aidatatang_200zh,
    }
    for name in args.datasets.split(","):
        fn = known.get(name.strip())
        if fn:
            fn(args.datasets_root, out, args.skip_existing, device=args.device)
        else:
            ep.preprocess_generic(args.datasets_root, name.strip(), out, args.skip_existing,
                                  device=args.device)


def cmd_train_encoder(args):
    from ..models.encoder.train import train
    train(args.run_id, args.clean_data_root, args.models_dir,
          total_steps=args.total_steps, precision=args.precision, device=args.device)


def _hp_cfg(args, base_cfg):
    """Apply the global --hparams override string (reference
    `utils/hparams.py:63-89` semantics) onto a model config."""
    if getattr(args, "hparams", ""):
        base_cfg.parse(args.hparams)
    return base_cfg


def cmd_train_synth(args):
    from ..models.tacotron.model import tacotron_config
    from ..models.tacotron.train import train
    train(args.run_id, args.syn_dir, args.models_dir, total_steps=args.total_steps,
          precision=args.precision, guided_attn_weight=args.guided_attn,
          cfg=_hp_cfg(args, tacotron_config()), device=args.device)


def cmd_train_vits(args):
    from ..models.vits.model import vits_config
    from ..models.vits.train import train
    train(args.run_id, args.syn_dir, args.models_dir, batch_size=args.batch_size,
          total_steps=args.total_steps, precision=args.precision, log_every=args.log_every,
          cfg=_hp_cfg(args, vits_config()), device=args.device)


def cmd_train_vocoder(args):
    if args.arch == "wavernn":
        from ..models.vocoder.wavernn_train import train
        train(args.run_id, args.syn_dir, args.models_dir,
              ground_truth=args.ground_truth, total_steps=args.total_steps,
              precision=args.precision, device=args.device)
    else:
        from ..models.vocoder.gan_train import train
        train(args.run_id, args.syn_dir, args.models_dir, arch=args.arch,
              fine_tuning=not args.ground_truth, total_steps=args.total_steps,
              precision=args.precision, device=args.device)


def cmd_gta(args):
    from ..models.tacotron.train import run_gta_synthesis
    run_gta_synthesis(args.run_id, args.syn_dir, args.models_dir, device=args.device)


def cmd_preprocess_vc(args):
    from ..models.ppg import preprocess_vc_dataset
    preprocess_vc_dataset(args.wav_dir, args.out_dir, device=args.device)


def cmd_train_vc(args):
    from ..models.ppg.train import train
    train(args.run_id, args.vc_dir, args.models_dir, total_steps=args.total_steps,
          precision=args.precision, device=args.device)


def cmd_tts(args):
    from ..pipeline import VoiceCloningPipeline
    pipe = VoiceCloningPipeline(args.encoder, args.synth, args.vocoder,
                                synthesizer=args.synthesizer, device=args.device)
    rtf = pipe.tts_to_file(args.text, args.ref, args.out,
                           style_idx=args.style_idx,
                           use_griffin_lim=args.griffin_lim)
    print(f"Wrote {args.out} (RTF {rtf:.1f}x)")


def cmd_demo(args, _input=input, _print=print):
    """Interactive REPL mirroring the reference's demo_cli flow: pick a
    reference wav once, then type texts; each synthesis is written to
    out-dir (`archived_untest_files/demo_cli.py`)."""
    from ..pipeline import VoiceCloningPipeline
    args.out_dir.mkdir(parents=True, exist_ok=True)
    pipe = VoiceCloningPipeline(args.encoder, args.synth, args.vocoder,
                                seed=args.seed, device=args.device)
    _print("Interactive voice cloning. Ctrl-C or empty input to quit.")
    ref = _input("Reference wav path: ").strip()
    if not ref:
        return
    n = 0
    while True:
        try:
            text = _input("Text (hanzi or pinyin): ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not text:
            break
        import time as _time
        t0 = _time.time()
        wav = pipe.clone_voice(text, ref)[0]
        dt = _time.time() - t0
        out = args.out_dir / f"demo_{n:03d}.wav"
        from ..dsp import save_wav
        save_wav(wav, out, pipe.audio_cfg.sample_rate)
        _print(f"Wrote {out} ({len(wav)/pipe.audio_cfg.sample_rate:.1f}s audio "
               f"in {dt:.1f}s)")
        n += 1


def cmd_convert(args):
    from ..models.ppg import VoiceConverter
    from ..models.vocoder import load_vocoder
    vc = VoiceConverter(args.ppg2mel, device=args.device)
    vc.set_reference(args.ref)
    vocoder = load_vocoder(args.vocoder, device=args.device) if args.vocoder else None
    vc.convert_files(args.sources, args.out_dir, vocoder)


def cmd_import_checkpoint(args):
    from ..config import Config
    from ..interop.import_checkpoint import import_reference_checkpoint
    cfg = Config.from_json(args.config) if args.config else None
    import_reference_checkpoint(args.family, args.torch_ckpt, args.out, cfg)


def cmd_download_datasets(args):
    from .. import datasets
    if args.list:
        for spec in datasets.CORPORA.values():
            print(f"{spec.name:18s} SLR{spec.slr:<3d} {spec.archive:24s} "
                  f"sha256={spec.sha256[:12]}…  {spec.url(args.mirror)}")
        return
    datasets.acquire(args.datasets_root, names=args.datasets,
                     mirror=args.mirror, extract=not args.no_extract)


def cmd_text_to_srt(args):
    from .. import speak
    text = (sys.stdin.read() if args.input == "-"
            else Path(args.input).read_text(encoding="utf-8"))
    cues = speak.text_to_srt(text, args.out, chars_per_second=args.cps,
                             gap_ms=args.gap_ms,
                             start_offset_ms=args.start_offset_ms)
    print(f"wrote {len(cues)} cues -> {args.out} "
          f"(total {cues[-1].end_ms / 1000:.1f}s)" if cues
          else "no sentences found")


def cmd_render_timeline(args):
    from .. import speak
    voice_map = speak.load_voice_map(args.voice_map) if args.voice_map else {}
    if args.backend == "pipeline":
        if args.ref is not None:
            voice_map.setdefault("default", {}).setdefault(
                "reference_audio", str(args.ref))
        backend = speak.PipelineBackend(device=args.device, encoder_fpath=args.encoder,
                                        synthesizer_fpath=args.synth,
                                        vocoder_fpath=args.vocoder)
    elif args.backend == "command":
        if not args.command:
            raise SystemExit("--command is required for the command backend")
        backend = speak.CommandBackend(args.command)
    else:
        if not args.base_url:
            raise SystemExit("--base-url is required for the http backend")
        backend = speak.HttpBackend(
            speak.TtsApiClient(args.base_url, api_key=args.api_key))
    result = speak.render_timeline_file(
        args.srt, args.out, backend, voice_map_path=None,
        voice_map=voice_map, duration_mode=args.duration_mode,
        on_progress=lambda i, n: print(f"  cue {i}/{n}", flush=True))
    print(f"rendered {len(result.segments)} cues, "
          f"{result.duration_s:.2f}s -> {args.out}")


def cmd_serve(args):
    from ..serve.http import serve
    serve(port=args.port, encoder_fpath=args.encoder,
          synthesizer_fpath=args.synth, vocoder_fpath=args.vocoder,
          datasets_root=args.datasets_root, models_dir=args.models_dir,
          seed=args.seed, device=args.device)


def cmd_launch(args):
    """Local multi-process launcher: N copies of this CLI with the
    ``MB_COORDINATOR``/``MB_NUM_PROCESSES``/``MB_PROCESS_ID`` environment,
    each given this process's ``--device`` and ``--hparams`` (the command's
    own, placed before its subcommand, win); returns the largest exit code."""
    import os
    import socket
    import subprocess

    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        raise SystemExit("launch: give a CLI command after --, e.g. "
                         "launch --nprocs 2 -- train-vits syn run1")
    port = args.port
    if not port:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    procs = []
    for pid in range(args.nprocs):
        env = dict(os.environ,
                   MB_COORDINATOR=f"localhost:{port}",
                   MB_NUM_PROCESSES=str(args.nprocs),
                   MB_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", args.device,
             "--hparams", args.hparams] + cmd, env=env))
    rc = 0
    for p in procs:
        rc = max(rc, p.wait())
    raise SystemExit(rc)


def _run_report() -> None:
    """The ``RUN_REPORT`` line: this process's rank, the world, and each
    kernel's launches in this process. The ranks of ``launch`` share one
    stdout, so the line goes out in one ``write`` (atomic on a pipe) that
    starts on a line of its own, whatever another rank left unfinished."""
    import json
    import os

    from ..ops.monotonic_align import maximum_path_cuda
    from ..ops.wavernn_sample import wavernn_sample
    from ..parallel import multihost
    line = "\nRUN_REPORT " + json.dumps({
        "rank": multihost.process_index(), "world": multihost.process_count(),
        "launches": {"wavernn_sample": wavernn_sample.launches,
                     "wavernn_sample(time_major=False)": wavernn_sample.launches_fold_major,
                     "maximum_path": maximum_path_cuda.launches}}) + "\n"
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), line.encode())


def main(argv=None):
    import os

    from ..parallel import multihost
    parser = build_parser()
    args = parser.parse_args(argv)
    multihost.initialize_from_env(args.device)
    _print_args(args)
    try:
        return args.func(args)
    finally:
        if os.environ.get("MB_RUN_REPORT") and args.func is not cmd_launch:
            _run_report()
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
