"""The port's data layer against the JAX package's: the same seed gives
bit-identical arrays, sampler indices, batches and masks."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest

from tpu_ddp.data import cifar10 as jax_cifar10
from tpu_ddp.data import loader as jax_loader
from tpu_ddp_torch.data import cifar10, loader


def test_synthetic_cifar10_bit_identical():
    for seed in (0, 3):
        want = jax_cifar10.synthetic_cifar10(96, 10, seed)
        got = cifar10.synthetic_cifar10(96, 10, seed)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


def test_normalize_and_decode_bit_identical():
    """``normalize`` is the JAX numpy transform's copy; ``decode_normalize``
    runs the port's copy of the C++ codec, whose bits are the JAX package's
    codec's (g++ builds both here), within 1e-6 of the numpy transform."""
    from tpu_ddp import native as jax_native

    raw = np.random.default_rng(0).integers(0, 256, size=(5, 3072), dtype=np.uint8)
    hwc = raw.reshape(5, 3, 32, 32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(cifar10.normalize(hwc), jax_cifar10.normalize(hwc))
    assert jax_native.AVAILABLE
    np.testing.assert_array_equal(
        cifar10.decode_normalize(raw),
        jax_native.decode_normalize(raw, jax_cifar10.CIFAR10_MEAN, jax_cifar10.CIFAR10_STD))
    np.testing.assert_allclose(cifar10.decode_normalize(raw),
                               jax_cifar10.normalize(hwc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,ws,shuffle,epoch", [
    (10, 1, True, 0), (10, 3, True, 2), (17, 4, False, 0), (5, 8, True, 1)])
def test_shard_indices_bit_identical(n, ws, shuffle, epoch):
    kw = dict(shuffle=shuffle, seed=7, epoch=epoch)
    np.testing.assert_array_equal(loader.shard_indices(n, ws, **kw),
                                  jax_loader.shard_indices(n, ws, **kw))


@pytest.mark.parametrize("ws,exclude_pad,shuffle", [
    (1, False, True), (2, True, True), (3, False, False)])
def test_loader_batches_bit_identical(ws, exclude_pad, shuffle):
    """Includes a short last batch (wrap-padded, masked)."""
    images, labels = cifar10.synthetic_cifar10(45, 10, 1)
    kw = dict(world_size=ws, per_shard_batch=4, seed=5,
              exclude_sampler_pad=exclude_pad, shuffle=shuffle)
    port = loader.ShardedBatchLoader(images, labels, **kw)
    ref = jax_loader.ShardedBatchLoader(images, labels, **kw)
    assert len(port) == len(ref)
    short = False
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(port.epoch_batches(), ref.epoch_batches(), strict=True))
        assert len(pairs) == len(ref)
        for got, want in pairs:
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            short |= not want["mask"].all()
    assert short


@pytest.fixture
def native_codec():
    """Both packages decode through their copies of the C++ codec
    (``tpu_ddp/native``, ``tpu_ddp_torch/native``), which round the
    normalisation alike; the JAX package's numpy fallback differs in the
    last bit, so it must not be live."""
    from tpu_ddp import native

    assert native.AVAILABLE


def _write_batches(root, names, rows=3, seed=0):
    """CIFAR-10's python-pickle batches of ``rows`` random images each,
    under ``root/cifar-10-batches-py``."""
    import pickle

    rng = np.random.default_rng(seed)
    sub = root / "cifar-10-batches-py"
    sub.mkdir(parents=True)
    for name in names:
        d = {b"data": rng.integers(0, 256, size=(rows, 3072), dtype=np.uint8),
             b"labels": [int(x) for x in rng.integers(0, 10, size=rows)]}
        with open(sub / name, "wb") as f:
            pickle.dump(d, f)
    return sub


@pytest.mark.parametrize("nest", ["", "CIFAR-10"])
def test_tarball_only_dir_extracts_and_loads_as_jax(tmp_path, nest, native_codec):
    """A data dir holding only ``cifar-10-python.tar.gz`` (what torchvision
    leaves) is extracted and loaded; both packages give identical arrays."""
    import tarfile

    _write_batches(tmp_path / "src", [f"data_batch_{i}" for i in range(1, 6)]
                   + ["test_batch"])
    dirs = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg / nest
        d.mkdir(parents=True)
        (d / ".extract.tmp.notapid").mkdir()      # a stale temp dir to sweep
        with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
            tf.add(tmp_path / "src" / "cifar-10-batches-py", "cifar-10-batches-py")
        dirs.append(tmp_path / pkg)
    for train in (True, False):
        got = cifar10.load_cifar10(str(dirs[0]), train=train)
        want = jax_cifar10.load_cifar10(str(dirs[1]), train=train)
        assert got[0].shape == ((15 if train else 3), 32, 32, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    extracted = dirs[0] / nest / "cifar-10-batches-py"
    assert (extracted / "data_batch_5").is_file()
    assert sorted(p.name for p in (dirs[0] / nest).iterdir()) == [
        "cifar-10-batches-py", "cifar-10-python.tar.gz"]


def test_test_split_only_dir_loads_as_jax(tmp_path, native_codec):
    """No tarball and only ``test_batch``: the eval split loads as in the JAX
    package; the train split names its missing file."""
    _write_batches(tmp_path, ["test_batch"], rows=5, seed=1)
    got = cifar10.load_cifar10(str(tmp_path), train=False)
    want = jax_cifar10.load_cifar10(str(tmp_path), train=False)
    assert got[0].shape == (5, 32, 32, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        cifar10.load_cifar10(str(tmp_path), train=True)


def test_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        cifar10.load_cifar10(str(tmp_path))
