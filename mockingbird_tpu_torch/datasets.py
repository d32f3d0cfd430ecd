"""Training-corpus acquisition: mirrors, checksums, extraction.

The port's own copy of ``mockingbird_tpu/datasets.py`` (framework-free): the
reference's ``datasets_download/`` (download.sh: aria2c mirror lists
CN/EU/US/default + sha256 verification; extract.sh: per-corpus tar rules
including nested per-speaker tar.gz unpacking and dev/test excludes),
rebuilt in-process: stdlib urllib with HTTP-Range resume instead of aria2c,
``tarfile`` instead of shelling out, and a typed manifest the CLI and tests
share. The network fetch is injectable (``fetch=``).
"""
from __future__ import annotations

import hashlib
import tarfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

MIRRORS: Dict[str, str] = {
    # openslr.org mirror hosts (datasets_download/{default,CN,EU,US}.txt)
    "default": "https://www.openslr.org/resources",
    "cn": "https://openslr.magicdatatech.com/resources",
    "eu": "https://openslr.elda.org/resources",
    "us": "https://us.openslr.org/resources",
}


@dataclass(frozen=True)
class CorpusSpec:
    """One downloadable training corpus."""
    name: str                 # local dataset directory name
    slr: int                  # openslr resource number
    remote_file: str          # filename on the mirror
    archive: str              # local archive name (download/<archive>)
    sha256: str
    members: Optional[List[str]] = None   # top-level members to extract (None=all)
    exclude: List[str] = field(default_factory=list)  # path substrings to skip
    nested_tars: Optional[str] = None     # glob (relative to extract root) of
                                          # inner per-speaker tar.gz to unpack
    extract_into: str = "."   # subdir of datasets root to extract into

    def url(self, mirror: str = "default") -> str:
        base = MIRRORS.get(mirror, mirror).rstrip("/")
        return f"{base}/{self.slr}/{self.remote_file}"


# datasets_download/datasets.sha256sum + extract.sh rules.
CORPORA: Dict[str, CorpusSpec] = {c.name: c for c in [
    CorpusSpec(
        name="aidatatang_200zh", slr=62, remote_file="aidatatang_200zh.tgz",
        archive="aidatatang_200zh.tgz",
        sha256="0c0ace77fe8ee77db8d7542d6eb0b7ddf09b1bfb880eb93a7fbdbf4611e9984b",
        exclude=["aidatatang_200zh/corpus/dev/", "aidatatang_200zh/corpus/test/"],
        nested_tars="aidatatang_200zh/corpus/train/*.tar.gz"),
    CorpusSpec(
        name="magicdata", slr=68, remote_file="train_set.tar.gz",
        archive="magicdata.tgz",
        sha256="1d2647c614b74048cfe16492570cc5146d800afdc07483a43b31809772632143",
        members=["train"], extract_into="magicdata"),
    CorpusSpec(
        name="aishell3", slr=93, remote_file="data_aishell3.tgz",
        archive="aishell3.tgz",
        sha256="be2507d431ad59419ec871e60674caedb2b585f84ffa01fe359784686db0e0cc",
        members=["train"], extract_into="aishell3"),
    CorpusSpec(
        name="data_aishell", slr=33, remote_file="data_aishell.tgz",
        archive="data_aishell.tgz",
        sha256="a4a0313cde0a933e0e01a451f77de0a23d6c942f4694af5bb7f40b9dc38143fe",
        nested_tars="data_aishell/wav/*.tar.gz",
        exclude=["dev/", "test/"]),
]}


def sha256_file(path: Union[str, Path], chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def verify(archive: Union[str, Path], spec: CorpusSpec) -> bool:
    return sha256_file(archive) == spec.sha256


# ── download ──────────────────────────────────────────────────────────

def _urllib_fetch(url: str, dest: Path, resume_from: int,
                  progress: Optional[Callable[[int], None]]) -> None:
    import urllib.request
    req = urllib.request.Request(url)
    mode = "wb"
    if resume_from > 0:
        req.add_header("Range", f"bytes={resume_from}-")
        mode = "ab"
    with urllib.request.urlopen(req) as resp:
        if resume_from > 0 and resp.status != 206:
            mode = "wb"  # server ignored Range; restart
        with open(dest, mode) as out:
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                out.write(block)
                if progress:
                    progress(len(block))


def download_corpus(spec: CorpusSpec, datasets_root: Union[str, Path],
                    mirror: str = "default",
                    fetch: Callable = _urllib_fetch,
                    progress: Optional[Callable[[int], None]] = None,
                    skip_existing: bool = True) -> Path:
    """Fetch one corpus archive with resume + checksum verification.

    Returns the verified archive path. Raises on checksum mismatch (the
    partial file is kept with a `.corrupt` suffix for inspection).
    """
    download_dir = Path(datasets_root) / "download"
    download_dir.mkdir(parents=True, exist_ok=True)
    dest = download_dir / spec.archive
    if dest.exists() and skip_existing and verify(dest, spec):
        return dest
    resume_from = dest.stat().st_size if dest.exists() else 0
    fetch(spec.url(mirror), dest, resume_from, progress)
    if not verify(dest, spec):
        corrupt = dest.with_suffix(dest.suffix + ".corrupt")
        dest.rename(corrupt)
        raise RuntimeError(
            f"{spec.name}: sha256 mismatch for {corrupt} "
            f"(expected {spec.sha256})")
    return dest


# ── extraction ────────────────────────────────────────────────────────

def _is_within(base: Path, target: Path) -> bool:
    try:
        target.resolve().relative_to(base.resolve())
        return True
    except ValueError:
        return False


def _safe_extract(tar: tarfile.TarFile, dest: Path,
                  want: Callable[[str], bool]) -> List[str]:
    """Extract members passing `want`, refusing path-traversal entries."""
    names: List[str] = []
    for member in tar:
        name = member.name
        if not want(name):
            continue
        if member.issym() or member.islnk():
            continue
        if not _is_within(dest, dest / name):
            raise RuntimeError(f"unsafe tar member path: {name}")
        tar.extract(member, dest, filter="data")
        names.append(name)
    return names


def extract_corpus(spec: CorpusSpec, datasets_root: Union[str, Path],
                   archive: Optional[Union[str, Path]] = None,
                   skip_existing: bool = True,
                   log: Callable[[str], None] = print) -> Path:
    """Unpack one corpus per extract.sh's rules: member filters, dev/test
    excludes, and nested per-speaker tar.gz unpacking (aidatatang/aishell)."""
    root = Path(datasets_root)
    archive = Path(archive) if archive else root / "download" / spec.archive
    out_dir = root / spec.name
    if out_dir.exists() and skip_existing and any(out_dir.iterdir()):
        log(f"{spec.name}: already extracted, skipping")
        return out_dir
    dest = root / spec.extract_into
    dest.mkdir(parents=True, exist_ok=True)

    def want(name: str) -> bool:
        if any(ex in name for ex in spec.exclude):
            return False
        if spec.members is not None:
            top = name.lstrip("./").split("/", 1)[0]
            return top in spec.members
        return True

    log(f"{spec.name}: extracting {archive.name}")
    with tarfile.open(archive, "r:*") as tar:
        _safe_extract(tar, dest, want)

    if spec.nested_tars:
        for inner in sorted(root.glob(spec.nested_tars)):
            with tarfile.open(inner, "r:*") as tar:
                _safe_extract(tar, inner.parent, want)
            inner.unlink()
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir


# ── orchestration ─────────────────────────────────────────────────────

def acquire(datasets_root: Union[str, Path], names: Optional[Sequence[str]] = None,
            mirror: str = "default", extract: bool = True,
            fetch: Callable = _urllib_fetch,
            log: Callable[[str], None] = print) -> List[Path]:
    """download.sh + extract.sh in one call. Idempotent via skip_existing."""
    specs = [CORPORA[n] for n in (names or CORPORA)]
    out: List[Path] = []
    for spec in specs:
        log(f"{spec.name}: downloading from {spec.url(mirror)}")
        archive = download_corpus(spec, datasets_root, mirror, fetch=fetch)
        log(f"{spec.name}: verified {archive.name}")
        if extract:
            out.append(extract_corpus(spec, datasets_root, archive, log=log))
        else:
            out.append(archive)
    return out
