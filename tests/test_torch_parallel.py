"""The port's data parallelism across processes (``parallel/``) against one
process, on the CPU over gloo: 2 ranks with half the batch each must train
to the losses 1 rank reaches on the whole batch (rtol 1e-5, the bound
``tests/test_multihost.py`` holds JAX's multi-process training to), for
all six trainer families; ``launch`` drives the VITS trainer through the
CLI; the batcher's shards, ``param_spec`` and ``make_mesh`` against the JAX
package's; ``shard_params`` on a 2-rank (data 1, model 2) mesh.

Every subprocess runs the port only (no JAX), one thread, with a timeout.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "_torch_multiproc_worker.py"
RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("MB_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _workers(num_processes, families, timeout=280):
    """Start ``num_processes`` workers (one group) → their LOSSES dicts."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(WORKER), json.dumps(dict(
            num_processes=num_processes, process_id=pid, port=port, families=list(families)))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT), env=_env())
        for pid in range(num_processes)], timeout


def _collect(procs, timeout):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")]
        assert line, f"no LOSSES line:\n{out[-2000:]}"
        outs.append(json.loads(line[0][len("LOSSES "):]))
    return outs


def two_ranks_match_one_rank(families):
    """3 steps of each family's own step function: 1 rank on the global
    batch, 2 gloo ranks on their rows of it, at ``RTOL``; both ranks report
    the same losses."""
    single, t1 = _workers(1, families)
    multi, t2 = _workers(2, families)
    (one,), (r0, r1) = _collect(single, t1), _collect(multi, t2)
    for fam in families:
        a, b = np.asarray(one[fam]), np.asarray(r0[fam])
        assert np.isfinite(a).all() and np.isfinite(b).all(), fam
        np.testing.assert_array_equal(r0[fam], r1[fam], err_msg=f"{fam}: ranks disagree")
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=f"{fam}: 1 rank {a}, 2 ranks {b}")


@pytest.mark.parametrize("families", [("tacotron", "ge2e", "wavernn", "ppg"), ("vits",)],
                         ids=["tacotron-ge2e-wavernn-ppg", "vits"])
def test_two_ranks_match_one_rank(families):
    """Covers the synchronised BatchNorms (Tacotron, WaveRNN and its running
    statistics, ppg2mel), the global masked counts (VITS KL and duration,
    guided attention, ppg2mel's MSE), the gathered GE2E loss and EER, and
    the global draws (dropout, zoneout, VITS noise and slices, strided as
    ``BucketBatcher`` deals rows), in float32. The GAN families are in
    ``test_torch_parallel_gan.py``."""
    two_ranks_match_one_rank(families)


def test_shard_params_on_two_ranks():
    """A (data 1, model 2) mesh of 2 gloo ranks: each leaf is placed as
    ``param_spec`` says (``Shard`` on its widest divisible dim, else
    ``Replicate``), the local shard has the rule's shape, and the shards
    make up the full tensor (checked in the worker)."""
    (r0, r1) = _collect(*_workers(2, ["shardings"]))
    assert r0 == r1
    got = {name: (placements, shape) for name, placements, shape in r0["shardings"]}
    assert got == {"dense/kernel": (["R", "S(0)"], [32, 32]),
                   "dense/bias": (["R", "R"], [32]),
                   "conv": (["R", "S(1)"], [5, 24, 40]),
                   "odd": (["R", "R"], [31, 67]),
                   "tall": (["R", "S(0)"], [100, 9]),
                   "small": (["R", "R"], [8, 8])}


# ---------------------------------------------------------------------------
# launch, through the CLI, on a tiny VITS corpus
# ---------------------------------------------------------------------------

VITS_HPARAMS = ("inter_channels=32,hidden_channels=32,filter_channels=64,n_heads=2,n_layers=2,"
                "upsample_rates=[4,4],upsample_kernel_sizes=[8,8],upsample_initial_channel=64,"
                "resblock_kernel_sizes=[3],resblock_dilation_sizes=[[1,3]],spec_channels=65,"
                "segment_size=128,hop_size=16,gin_channels=16,emotion_channels=8,"
                "n_fft=128,win_size=128,num_mels=20")


def _vits_corpus(root: Path, n: int = 8) -> None:
    rng = np.random.RandomState(0)
    (root / "audio").mkdir(parents=True)
    texts = ["ni3 hao3", "zai4 jian4", "xie4 xie4", "hello there", "good morning",
             "one two three", "shi4 jie4", "the end"]
    rows = []
    for i in range(n):
        frames = int(rng.randint(40, 60))
        t = np.arange(frames * 16) / 16000
        wav = (0.3 * np.sin(2 * np.pi * (150 + 25 * i) * t)
               + 0.01 * rng.randn(len(t))).astype(np.float32)
        name = f"audio-spk{i % 2}_{i:04d}.npy"
        np.save(root / "audio" / name, wav)
        rows.append(f"{name}|mel-{i}.npy|embed-{i}.npy|{frames}|1|{texts[i]}")
    (root / "train.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")


def _cli(args, timeout=240):
    run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", "cpu",
                          "--hparams", VITS_HPARAMS] + args, cwd=str(ROOT), env=_env(),
                         capture_output=True, text=True, timeout=timeout)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run


def _scalars(models: Path, run_id: str):
    return [json.loads(line) for line in
            (models / run_id / "logs_vits" / "scalars.jsonl").read_text().splitlines()]


def test_launch_two_ranks_trains_vits_as_one(tmp_path):
    """``cli launch --nprocs 2 -- train-vits`` (batch 2 per rank, the
    ``MB_*`` environment, gloo on the CPU) logs the losses that one
    ``train-vits`` process at batch 4 logs, step by step; rank 0 alone
    writes the logs and the checkpoint, and each rank reports its rank."""
    data = tmp_path / "data"
    _vits_corpus(data)
    common = ["--total_steps", "3", "--precision", "fp32", "--log_every", "1"]
    _cli(["train-vits", str(data), "one", "-m", str(tmp_path / "m1"), "--batch_size", "4"]
         + common)
    env_report = dict(_env(), MB_RUN_REPORT="1")
    run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", "cpu",
                          "--hparams", VITS_HPARAMS, "launch", "--nprocs", "2", "--",
                          "train-vits", str(data), "two", "-m", str(tmp_path / "m2"),
                          "--batch_size", "2"] + common,
                         cwd=str(ROOT), env=env_report, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    reports = sorted(json.loads(ln[len("RUN_REPORT "):])["rank"]
                     for ln in run.stdout.splitlines() if ln.startswith("RUN_REPORT "))
    assert reports == [0, 1]
    one, two = _scalars(tmp_path / "m1", "one"), _scalars(tmp_path / "m2", "two")
    assert [r["step"] for r in one] == [r["step"] for r in two] == [1, 2, 3]
    for a, b in zip(one, two):
        for k in ("train/gen", "train/disc", "train/mel", "train/dur", "train/kl"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=f"step {a['step']} {k}")
    assert sorted(p.name for p in (tmp_path / "m2" / "two" / "ckpt_vits").iterdir()) == ["4.pt"]


# ---------------------------------------------------------------------------
# the pieces against the JAX package's
# ---------------------------------------------------------------------------

class _FakeDataset:
    """``test_multihost.py::test_bucket_batcher_sharding``'s dataset."""
    cfg = type("C", (), {"hop_size": 16, "spec_channels": 5, "emotion_channels": 4})()
    cleaner_names = ["basic_cleaners"]

    def __init__(self):
        rng = np.random.RandomState(0)
        self.lengths = [int(rng.randint(40, 290)) for _ in range(24)]
        self.items = [(f"a{i}.npy", i % 3, "ni hao shi jie") for i in range(24)]

    def __getitem__(self, i):
        n = self.lengths[i]
        seq = np.arange(4 + i % 5, dtype=np.int32) + 1
        spec = np.full((n, 5), float(i), np.float32)
        wav = np.full((n * 16,), float(i), np.float32)
        return seq, spec, wav, i % 3, np.zeros((4,), np.float32)


def test_bucket_batcher_shards_equal_jax():
    """The port's ``BucketBatcher(num_shards, shard_index)`` deals each rank
    the rows JAX's deals it, batch for batch, and the union of the ranks'
    rows is the one-process batch (strided)."""
    from mockingbird_tpu.models.vits.train import BucketBatcher as JBatcher
    from mockingbird_tpu_torch.models.vits.train import BucketBatcher

    ds = _FakeDataset()
    for k in range(2):
        port = list(BucketBatcher(ds, 2, boundaries=(32, 300), seed=5, num_shards=2,
                                  shard_index=k))
        jax_ = list(JBatcher(ds, 2, boundaries=(32, 300), seed=5, num_shards=2, shard_index=k))
        assert len(port) == len(jax_) > 0
        for a, b in zip(port, jax_):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    shards = [list(BucketBatcher(ds, 2, boundaries=(32, 300), seed=5, num_shards=2,
                                 shard_index=k)) for k in range(2)]
    whole = list(BucketBatcher(ds, 4, boundaries=(32, 300), seed=5))
    for x0, x1, xw in zip(*shards, whole):
        ids = np.stack([x0["specs"][:, 0, 0], x1["specs"][:, 0, 0]], 1).reshape(-1)
        np.testing.assert_array_equal(ids, xw["specs"][:, 0, 0])


class _ShapeMesh:
    """A stand-in for a mesh: only ``.shape["model"]`` is read."""

    def __init__(self, model):
        self.shape = {"data": 1, "model": model}


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_spec_equals_jax(model):
    """``param_spec`` gives JAX's ``PartitionSpec`` for every leaf of a tree
    of shapes, at model-axis sizes 1, 2 and 4."""
    from mockingbird_tpu.parallel.shardings import param_spec as jspec
    from mockingbird_tpu_torch.parallel.shardings import param_spec

    shapes = [(), (7,), (1024,), (2048,), (64, 32), (32, 64), (31, 67), (200, 9), (5, 48, 40),
              (3, 3, 16, 8), (8, 8), (1000, 3), (12, 100), (2, 2, 1024), (6, 6, 6, 6)]
    mesh = _ShapeMesh(model)
    for shape in shapes:
        for min_size in (1, 1024):
            want = tuple(jspec((), np.zeros(shape), mesh, min_size))
            assert param_spec((), _Leaf(shape), mesh, min_size) == want, (shape, min_size)
            assert param_spec((), torch.zeros(shape), mesh, min_size) == want, (shape, min_size)


def test_mesh_and_batch_placement_without_a_group():
    """One process: a (1, 1) mesh, and every placement is the identity, as
    JAX's with one process; ``pad_to_multiple`` is JAX's."""
    from mockingbird_tpu.parallel.mesh import pad_to_multiple as jpad
    from mockingbird_tpu_torch.parallel import multihost
    from mockingbird_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple, shard_batch

    assert not multihost.is_initialized()
    assert multihost.initialize_from_env("cpu") is False
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    batch = {"a": np.arange(6).reshape(3, 2), "s": np.float32(2.0)}
    assert shard_batch(mesh, batch) is batch and shard_batch(None, batch) is batch
    assert multihost.shard_global_batch(batch) is batch
    assert multihost.assemble_local_batch(batch) is batch
    for n, m in ((0, 4), (5, 4), (8, 4), (9, 1), (13, 8)):
        assert pad_to_multiple(n, m) == jpad(n, m)
    x = torch.arange(4.0)
    with multihost.sharded():
        assert not multihost.active()
        assert multihost.all_gather(x) is x and multihost.all_reduce_mean(x) is x
        assert float(multihost.global_count(torch.tensor(0.0), minimum=1.0)) == 1.0
        g = torch.Generator().manual_seed(3)
        r = multihost.rand((5, 2), g)
    torch.testing.assert_close(r, torch.rand((5, 2), generator=torch.Generator().manual_seed(3)))
