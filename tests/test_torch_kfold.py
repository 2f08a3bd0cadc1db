"""k-fold cross-validation in the port (``train/kfold.py``, ``--cv-mode``)
against the JAX package's ``tpu_ddp/train/kfold.py``: the same splits bit
for bit, ``run_kfold`` hands each fold the same train and validation rows,
and ``--cv-mode 2`` through the port's CLI trains both folds on disjoint
validation sets that together cover the train split, each on its own
``Trainer`` with no checkpoint, with each fold's health record in its own
directory."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest

from tpu_ddp.train import kfold as jax_kfold
from tpu_ddp_torch.cli import train as cli
from tpu_ddp_torch.train import kfold


@pytest.mark.parametrize("n,k,seed,shuffle", [
    (10, 2, 0, True), (17, 5, 3, True), (100, 3, 1, False), (7, 7, 2, True)])
def test_kfold_split_bit_identical(n, k, seed, shuffle):
    got = kfold.kfold_split(n, k, seed=seed, shuffle=shuffle)
    want = jax_kfold.kfold_split(n, k, seed=seed, shuffle=shuffle)
    assert len(got) == len(want) == k
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
    vals = np.concatenate([v for _, v in got])
    assert sorted(vals.tolist()) == list(range(n))


def test_kfold_split_needs_two_folds():
    with pytest.raises(ValueError, match="k must be >= 2"):
        kfold.kfold_split(10, 1)


class _Recorder:
    """A stand-in trainer: records its data, reports fixed metrics."""

    def __init__(self, train, val, fold, log):
        self.val = val
        log.append((fold, train, val))

    def run(self):
        return {"steps": 1}

    def evaluate(self):
        return float(len(self.val[1])), 0.5


def test_run_kfold_hands_each_fold_the_jax_rows():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(23, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=23).astype(np.int32)
    logs = {"port": [], "jax": []}
    got = kfold.run_kfold(images, labels, k=3, seed=4,
                          make_trainer=lambda t, v, f: _Recorder(t, v, f, logs["port"]))
    want = jax_kfold.run_kfold(images, labels, k=3, seed=4,
                               make_trainer=lambda t, v, f: _Recorder(t, v, f, logs["jax"]))
    assert got == want
    for (fp, tp, vp), (fj, tj, vj) in zip(logs["port"], logs["jax"], strict=True):
        assert fp == fj
        for a, b in zip(tp + vp, tj + vj):
            np.testing.assert_array_equal(a, b)


def test_cv_mode_two_folds_through_the_cli(tmp_path, monkeypatch):
    seen = []

    class Recording(cli.Trainer):
        def __init__(self, config, *, train_data=None, test_data=None):
            seen.append((config, train_data, test_data))
            super().__init__(config, train_data=train_data, test_data=test_data)

    monkeypatch.setattr(cli, "Trainer", Recording)
    out = cli.main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "96",
                    "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2", "--batch-size",
                    "16", "--kernels", "--cv-mode", "2", "--checkpoint-dir",
                    str(tmp_path / "ck"), "--health", "on", "--health-dir",
                    str(tmp_path / "health")])
    assert out["completed_folds"] == 2 and not out["preempted"]
    assert [r["fold"] for r in out["cv_results"]] == [0, 1]
    assert all(0.0 <= r["val_accuracy"] <= 1.0 for r in out["cv_results"])
    assert out["mean_val_accuracy"] == pytest.approx(
        np.mean([r["val_accuracy"] for r in out["cv_results"]]))
    assert len(seen) == 2
    from tpu_ddp_torch.train.trainer import load_dataset

    (images, labels), _ = load_dataset(seen[0][0])
    folds = jax_kfold.kfold_split(len(labels), 2, seed=0)
    for (_, train, test), (train_idx, val_idx) in zip(seen, folds):
        np.testing.assert_array_equal(test[0], images[val_idx])
        np.testing.assert_array_equal(test[1], labels[val_idx])
        np.testing.assert_array_equal(train[0], images[train_idx])
    assert sorted(np.concatenate([v for _, v in folds]).tolist()) == list(range(96))
    for fold, (config, train, test) in enumerate(seen):
        assert config.checkpoint_dir is None and not config.resume
        assert config.health_dir == str(tmp_path / "health" / f"fold{fold}")
        assert len(train[0]) + len(test[0]) == 96
    assert not (tmp_path / "ck").exists()
    assert (tmp_path / "health" / "fold0").is_dir() and (tmp_path / "health" / "fold1").is_dir()
