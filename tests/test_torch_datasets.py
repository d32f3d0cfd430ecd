"""The port's copy of corpus acquisition (``mockingbird_tpu_torch/datasets.py``)
held to ``tests/test_datasets.py``'s six cases, all offline (the fetch is
injected, the archives are made in-process), and to the JAX package's
manifest and ``download-datasets --list``."""
import argparse
import dataclasses
import io
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest

from mockingbird_tpu import datasets as jdatasets
from mockingbird_tpu_torch import datasets


def _make_tar(entries, compress="gz"):
    """entries: {path: bytes | (nested tar dict)}"""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode=f"w:{compress}") as tar:
        for path, payload in entries.items():
            data = payload if isinstance(payload, bytes) else payload
            info = tarfile.TarInfo(path)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _spec_for(blob, **overrides):
    import hashlib
    base = dict(name="toy", slr=1, remote_file="toy.tgz", archive="toy.tgz",
                sha256=hashlib.sha256(blob).hexdigest())
    base.update(overrides)
    return datasets.CorpusSpec(**base)


def test_manifest_matches_reference_checksums():
    # datasets_download/datasets.sha256sum facts
    assert datasets.CORPORA["aidatatang_200zh"].sha256.startswith("0c0ace77")
    assert datasets.CORPORA["magicdata"].sha256.startswith("1d2647c6")
    assert datasets.CORPORA["aishell3"].sha256.startswith("be2507d4")
    assert datasets.CORPORA["data_aishell"].sha256.startswith("a4a0313c")
    # Mirror URL construction (datasets_download/US.txt facts).
    assert (datasets.CORPORA["magicdata"].url("us")
            == "https://us.openslr.org/resources/68/train_set.tar.gz")
    assert datasets.CORPORA["aishell3"].url("default").endswith(
        "/93/data_aishell3.tgz")


def test_download_verify_and_resume(tmp_path):
    blob = _make_tar({"toy/a.wav": b"x" * 100})
    spec = _spec_for(blob)
    sent = {}

    def fake_fetch(url, dest, resume_from, progress):
        sent["url"], sent["resume"] = url, resume_from
        mode = "ab" if resume_from else "wb"
        with open(dest, mode) as f:
            f.write(blob[resume_from:])

    out = datasets.download_corpus(spec, tmp_path, mirror="eu", fetch=fake_fetch)
    assert out.exists() and datasets.verify(out, spec)
    assert sent["url"].startswith("https://openslr.elda.org/")

    # Partial file triggers a ranged resume.
    out.write_bytes(blob[:37])
    datasets.download_corpus(spec, tmp_path, fetch=fake_fetch,
                             skip_existing=False)
    assert sent["resume"] == 37
    assert datasets.verify(tmp_path / "download" / "toy.tgz", spec)

    # Checksum mismatch keeps a .corrupt file and raises.
    def bad_fetch(url, dest, resume_from, progress):
        dest.write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        datasets.download_corpus(spec, tmp_path, fetch=bad_fetch,
                                 skip_existing=False)
    assert (tmp_path / "download" / "toy.tgz.corrupt").exists()


def test_extract_members_filter_and_into(tmp_path):
    blob = _make_tar({"train/s1/a.wav": b"A", "dev/s1/b.wav": b"B",
                      "test/s1/c.wav": b"C"})
    spec = _spec_for(blob, name="magictoy", members=["train"],
                     extract_into="magictoy")
    (tmp_path / "download").mkdir()
    (tmp_path / "download" / "toy.tgz").write_bytes(blob)
    out = datasets.extract_corpus(spec, tmp_path, log=lambda s: None)
    assert (out / "train" / "s1" / "a.wav").read_bytes() == b"A"
    assert not (out / "dev").exists() and not (out / "test").exists()


def test_extract_nested_tars_and_excludes(tmp_path):
    inner = _make_tar({"G0001/u1.wav": b"U1"})
    blob = _make_tar({
        "toy/corpus/train/G0001.tar.gz": inner,
        "toy/corpus/dev/skipme.txt": b"no",
    })
    spec = _spec_for(blob, exclude=["toy/corpus/dev/"],
                     nested_tars="toy/corpus/train/*.tar.gz")
    (tmp_path / "download").mkdir()
    (tmp_path / "download" / "toy.tgz").write_bytes(blob)
    out = datasets.extract_corpus(spec, tmp_path, log=lambda s: None)
    assert (tmp_path / "toy/corpus/train/G0001/u1.wav").read_bytes() == b"U1"
    # Inner tar removed after unpack; dev excluded.
    assert not list((tmp_path / "toy/corpus/train").glob("*.tar.gz"))
    assert not (tmp_path / "toy/corpus/dev").exists()
    # Idempotent skip on second call.
    assert datasets.extract_corpus(spec, tmp_path, log=lambda s: None) == out


def test_extract_rejects_traversal(tmp_path):
    blob = _make_tar({"../evil.txt": b"x"})
    spec = _spec_for(blob)
    (tmp_path / "download").mkdir()
    (tmp_path / "download" / "toy.tgz").write_bytes(blob)
    with pytest.raises(Exception):
        datasets.extract_corpus(spec, tmp_path, skip_existing=False,
                                log=lambda s: None)
    assert not (tmp_path.parent / "evil.txt").exists()


def test_acquire_end_to_end_with_fake_fetch(tmp_path, monkeypatch):
    blob = _make_tar({"toy/x.wav": b"X"})
    spec = _spec_for(blob)
    monkeypatch.setattr(datasets, "CORPORA", {"toy": spec})

    def fake_fetch(url, dest, resume_from, progress):
        dest.write_bytes(blob)

    out = datasets.acquire(tmp_path, mirror="cn", fetch=fake_fetch,
                           log=lambda s: None)
    assert out == [tmp_path / "toy"]
    assert (tmp_path / "toy" / "x.wav").read_bytes() == b"X"


def test_manifest_equals_jax():
    assert datasets.CORPORA.keys() == jdatasets.CORPORA.keys()
    for name, spec in datasets.CORPORA.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jdatasets.CORPORA[name]), name
        for mirror in ("default", "cn", "eu", "us", "https://example.org/base"):
            assert spec.url(mirror) == jdatasets.CORPORA[name].url(mirror), (name, mirror)
    assert datasets.MIRRORS == jdatasets.MIRRORS


def test_cli_list_prints_what_jax_prints(capsys):
    """``download-datasets --list``: the port's command prints JAX's lines,
    for each mirror; the subcommand runs from the port's CLI."""
    from mockingbird_tpu.cli.main import cmd_download_datasets as jcmd
    from mockingbird_tpu_torch.cli.main import cmd_download_datasets
    for mirror in ("default", "cn", "eu", "us"):
        args = argparse.Namespace(list=True, mirror=mirror, datasets=None, no_extract=False,
                                  datasets_root=Path("unused"))
        cmd_download_datasets(args)
        ours = capsys.readouterr().out
        jcmd(args)
        assert ours == capsys.readouterr().out and len(ours.splitlines()) == len(datasets.CORPORA)
    run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", "cpu",
                          "download-datasets", "unused", "--list", "--mirror", "eu"],
                         cwd=str(Path(__file__).resolve().parent.parent), capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    args.mirror = "eu"
    jcmd(args)
    want = capsys.readouterr().out
    assert run.stdout.endswith(want)
