"""``--download`` in the port (``data/download.py``, ``tools/real_data.py``)
against fake archives served over ``file://`` URLs, fully offline (the
port's copy of ``tests/test_download.py`` and of
``tests/test_real_data.py``): fetch, MD5 check, atomic landing and
extraction, a corrupt tarball fetched again, the non-zero local rank's wait,
CIFAR-100, and the end-to-end real-data gate on a tiny model. What the port
fetches and loads is the JAX package's, bit for bit."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import hashlib
import io
import json
import pickle
import tarfile

import numpy as np
import pytest
import torch

from tpu_ddp.data import cifar10 as jax_cifar10
from tpu_ddp.data.download import ensure_dataset as jax_ensure_dataset
from tpu_ddp_torch.data.cifar10 import (
    ensure_extracted,
    extracted_dataset_dir,
    load_cifar10,
    load_cifar100,
)
from tpu_ddp_torch.data.download import ensure_dataset


def _fake_cifar10_tar(path, rows=4):
    """A structurally real cifar-10-python.tar.gz of ``rows`` images a batch."""
    rng = np.random.default_rng(0)
    with tarfile.open(path, "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            blob = pickle.dumps({b"data": rng.integers(0, 256, (rows, 3072), dtype=np.uint8),
                                 b"labels": rng.integers(0, 10, rows).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def _md5(path):
    return hashlib.md5(open(path, "rb").read()).hexdigest()


def _served(tmp_path, rows=4):
    src = tmp_path / "served" / "cifar-10-python.tar.gz"
    src.parent.mkdir()
    _fake_cifar10_tar(src, rows)
    return src


def test_download_fetches_verifies_extracts_and_loads_as_jax(tmp_path):
    src = _served(tmp_path)
    dirs = {}
    for pkg, fn in (("port", ensure_dataset), ("jax", jax_ensure_dataset)):
        d = tmp_path / pkg
        fn(str(d), "cifar10", download=True, url=src.as_uri(), md5=_md5(src))
        assert (d / "cifar-10-python.tar.gz").is_file()
        assert (d / "cifar-10-batches-py" / "data_batch_1").is_file()
        dirs[pkg] = str(d)
    for train in (True, False):
        got = load_cifar10(dirs["port"], train=train)
        want = jax_cifar10.load_cifar10(dirs["jax"], train=train)
        assert got[0].shape == ((20 if train else 4), 32, 32, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_partial_extraction_is_never_reported_complete(tmp_path):
    data_dir = tmp_path / "data"
    partial = data_dir / "cifar-10-batches-py"
    partial.mkdir(parents=True)
    (partial / "data_batch_1").write_bytes(b"truncated-garbage")
    assert extracted_dataset_dir(str(data_dir), "cifar10") is None
    _fake_cifar10_tar(data_dir / "cifar-10-python.tar.gz")
    assert ensure_extracted(str(data_dir), "cifar10")
    imgs, _ = load_cifar10(str(data_dir), train=True)
    assert imgs.shape == (20, 32, 32, 3)
    assert not [p for p in data_dir.iterdir() if p.name.startswith(".extract")]


def test_extraction_is_atomic_rename(tmp_path, monkeypatch):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    _fake_cifar10_tar(data_dir / "cifar-10-python.tar.gz")
    real = tarfile.TarFile.extractall
    calls = {"n": 0}

    def dying_extractall(self, *a, **k):
        calls["n"] += 1
        real(self, *a, **k)
        if calls["n"] == 1:
            raise OSError("simulated crash after the files hit the disk")

    monkeypatch.setattr(tarfile.TarFile, "extractall", dying_extractall)
    with pytest.raises(OSError):
        ensure_extracted(str(data_dir), "cifar10")
    assert extracted_dataset_dir(str(data_dir), "cifar10") is None
    assert ensure_extracted(str(data_dir), "cifar10")


def test_download_rejects_checksum_mismatch(tmp_path):
    src = _served(tmp_path)
    data_dir = tmp_path / "data"
    with pytest.raises(IOError, match="checksum mismatch"):
        ensure_dataset(str(data_dir), "cifar10", download=True, url=src.as_uri(),
                       md5="0" * 32)
    assert not any(data_dir.glob("*.tar.gz*"))      # nothing half written


def test_noop_when_valid_tarball_already_present(tmp_path):
    dest = tmp_path / "cifar-10-python.tar.gz"
    _fake_cifar10_tar(dest)
    before = dest.read_bytes()
    ensure_dataset(str(tmp_path), "cifar10", download=True, url="file:///nonexistent",
                   md5=_md5(dest))
    assert dest.read_bytes() == before


def test_corrupt_existing_tarball_is_refetched(tmp_path):
    src = _served(tmp_path)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    bad = data_dir / "cifar-10-python.tar.gz"
    bad.write_bytes(src.read_bytes()[:100])          # an interrupted copy
    ensure_dataset(str(data_dir), "cifar10", download=True, url=src.as_uri(), md5=_md5(src))
    assert _md5(bad) == _md5(src)


def test_noop_when_extracted_in_a_loader_layout(tmp_path):
    src = tmp_path / "cifar-10-python.tar.gz"
    _fake_cifar10_tar(src)
    nested = tmp_path / "data" / "CIFAR-10"
    nested.mkdir(parents=True)
    with tarfile.open(src) as tf:
        tf.extractall(nested, filter="data")
    ensure_dataset(str(tmp_path / "data"), "cifar10", download=True,
                   url="file:///nonexistent", md5="0" * 32)
    assert not (tmp_path / "data" / "cifar-10-python.tar.gz").exists()


@pytest.mark.parametrize("download", [True, False])
def test_nonzero_local_rank_waits_for_rank_zero(tmp_path, monkeypatch, download):
    """Only local rank 0 (the launcher's ``LOCAL_RANK``) fetches and
    extracts; another rank waits for the extracted batches, not for a
    tarball, and times out loudly."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    _fake_cifar10_tar(tmp_path / "cifar-10-python.tar.gz")
    with pytest.raises(TimeoutError, match="local rank 1"):
        ensure_dataset(str(tmp_path), "cifar10", download=download,
                       url="file:///nonexistent", md5="0" * 32, wait_timeout=0.2)
    with tarfile.open(tmp_path / "cifar-10-python.tar.gz") as tf:
        tf.extractall(tmp_path, filter="data")
    ensure_dataset(str(tmp_path), "cifar10", download=download,
                   url="file:///nonexistent", md5="0" * 32, wait_timeout=5.0)


def test_cifar100_download_extract_load_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "served" / "cifar-100-python.tar.gz"
    src.parent.mkdir()
    with tarfile.open(src, "w:gz") as tf:
        for name, n in (("train", 8), ("test", 4)):
            blob = pickle.dumps({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                                 b"fine_labels": rng.integers(0, 100, n).tolist()})
            info = tarfile.TarInfo(f"cifar-100-python/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    ensure_dataset(str(tmp_path / "data"), "cifar100", download=True, url=src.as_uri(),
                   md5=_md5(src))
    imgs, labels = load_cifar100(str(tmp_path / "data"), train=True)
    assert imgs.shape == (8, 32, 32, 3) and labels.max() < 100


def test_no_download_leaves_the_loader_error_and_extracts_a_placed_tarball(tmp_path):
    ensure_dataset(str(tmp_path), "cifar10", download=False)
    with pytest.raises(FileNotFoundError, match="batches not found"):
        load_cifar10(str(tmp_path), train=True)
    _fake_cifar10_tar(tmp_path / "cifar-10-python.tar.gz")
    ensure_dataset(str(tmp_path), "cifar10", download=False)
    assert (tmp_path / "cifar-10-batches-py" / "data_batch_1").is_file()


def test_unknown_dataset_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown dataset"):
        ensure_dataset(str(tmp_path), "imagenet", download=True)


@pytest.fixture
def tiny_resnet18():
    """ResNet-18's structure at 4 filters, registered for the CLI (full
    width takes seconds a step on the CPU)."""
    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.models import resnet_family as family

    def build(num_classes=10, generator=None, image_size=32, dtype=torch.float32):
        return family.ResNet((2, 2, 2, 2), family._BasicBlock, num_classes=num_classes,
                             num_filters=4, generator=generator, dtype=dtype)

    MODEL_REGISTRY["tiny_resnet18"] = build
    yield "tiny_resnet18"
    del MODEL_REGISTRY["tiny_resnet18"]


@pytest.mark.parametrize("target,rc", [(0.0, 0), (1.01, 3)])
def test_real_data_flow_with_a_stub_source(tmp_path, monkeypatch, tiny_resnet18, target, rc):
    """Download, verify, extract, train the recipe through the port's CLI
    (the model swapped for the tiny one through ``--extra``), and gate: exit
    0 when the target is met, 3 on a miss (never a silent 0)."""
    from tpu_ddp_torch.tools.real_data import main

    monkeypatch.chdir(tmp_path)
    src = _served(tmp_path)
    got = main(["--data-dir", str(tmp_path / "data"), "--device", "cpu", "--epochs", "1",
                "--target", str(target), "--global-batch-size", "8",
                "--checkpoint-dir", str(tmp_path / "ck"), "--out", str(tmp_path / "s.json"),
                "--url", src.as_uri(), "--md5", _md5(src),
                "--extra", "--model", tiny_resnet18, "--prefetch-depth", "2"])
    assert got == rc
    summary = json.load(open(tmp_path / "s.json"))
    assert summary["passed"] == (rc == 0) and 0.0 <= summary["final_test_accuracy"] <= 1.0
    assert (tmp_path / "data" / "cifar-10-batches-py" / "data_batch_1").exists()
    assert (tmp_path / "ck" / "metrics.jsonl").exists()


def test_real_data_without_a_source_exits_2(tmp_path, capsys):
    from tpu_ddp_torch.tools.real_data import main

    rc = main(["--data-dir", str(tmp_path / "data"), "--device", "cpu",
               "--url", (tmp_path / "missing.tar.gz").as_uri(), "--md5", "0" * 32])
    assert rc == 2
    assert "real-data:" in capsys.readouterr().err
