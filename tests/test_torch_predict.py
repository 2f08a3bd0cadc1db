"""Batch inference: ``train/steps.py::make_predict_step``,
``Trainer.predict``, the port's ``metrics/evaluation.py`` and the CLI's
``--dump-predictions``, ``--viz-predictions`` and ``--plot-curves``.

* The predict step's logits against the JAX ``make_predict_step`` on a
  1-device mesh, from the same weights and BatchNorm buffers after two JAX
  train steps: ``atol=1e-5`` (the forward's bound in
  ``tests/test_torch_models.py``).
* ``Trainer.predict`` returns the test set's rows without the padding, with
  the EMA shadow's logits under ``ema_decay``.
* ``evaluation.py`` against the JAX module on the same scores: bitwise.
* The CLI's dump has the JAX CLI's keys and one row a test image; the
  accuracy it implies is the trainer's final test accuracy; two ranks
  (through the launcher, from the same checkpoint, ``--eval-only``) dump the
  same rows as one rank once each row is mapped to its dataset index by the
  sampler's index stream; BCE dumps thresholded multi-hot rows and logs the
  mAP. ``--plot-curves`` and ``--viz-predictions`` write their PNGs.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.metrics import evaluation as jax_evaluation
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_predict_step as jax_make_predict_step
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import from_jax, load_into
from tpu_ddp_torch.cli.train import main
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.data.loader import ShardedBatchLoader
from tpu_ddp_torch.metrics import evaluation
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_predict_step
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MODEL = dict(n_chans1=8, n_blocks=2)
SMALL = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "400",
         "--n-chans1", "8", "--n-blocks", "2", "--log-every-epochs", "1"]
TEST_SIZE = 80                      # max(400 // 5, 64)


def test_predict_step_matches_jax():
    flax_model = FlaxNetResDeep(**MODEL)
    jax_tx = jax_make_optimizer(lr=5e-2, momentum=0.9)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_train = jax_make_train_step(flax_model, jax_tx, mesh, donate=False)
    images, labels = synthetic_cifar10(48, 10, seed=2)
    for i in range(2):
        sl = slice(i * 16, (i + 1) * 16)
        j_state, _ = j_train(j_state, {"image": images[sl], "label": labels[sl],
                                       "mask": np.ones(16, bool)})
    batch = {"image": np.array(images[32:]), "label": labels[32:], "mask": np.ones(16, bool)}
    want = np.asarray(jax_make_predict_step(flax_model, mesh)(j_state, batch))
    state = create_train_state(NetResDeep(**MODEL), make_optimizer(lr=5e-2), CPU)
    load_into(state, from_jax(*jax.device_get((j_state.params, j_state.batch_stats))))
    got = make_predict_step()(state, batch_to_device(batch, CPU))
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not state.model.training


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_trainer_predict_rows_and_ema(ema):
    data = synthetic_cifar10(40, 10, seed=3)
    trainer = Trainer(TrainConfig(device="cpu", n_chans1=4, n_blocks=1, per_shard_batch=16,
                                  epochs=1, ema_decay=ema), train_data=data)
    trainer.run()
    logits, labels = trainer.predict()
    assert logits.shape == (40, 10) and np.array_equal(labels, data[1])
    params = trainer.state.opt_state.ema if ema else None
    want = make_predict_step()(trainer.state, {"image": torch.as_tensor(data[0])}, params)
    np.testing.assert_allclose(logits, want.numpy(), rtol=0, atol=1e-6)
    if ema:
        plain = make_predict_step()(trainer.state, {"image": torch.as_tensor(data[0])})
        assert not np.allclose(logits, plain.numpy())
    trainer.close()


def test_evaluation_bitwise_jax():
    rng = np.random.default_rng(0)
    scores = rng.random((200, 6)).astype(np.float32)
    targets = (rng.random((200, 6)) < 0.3).astype(np.int32)
    targets[:, 4] = 0                                # a class with no positive
    for got, want in zip(evaluation.precision_recall_curve(scores[:, 0], targets[:, 0]),
                         jax_evaluation.precision_recall_curve(scores[:, 0], targets[:, 0])):
        assert np.array_equal(got, want)
    assert evaluation.average_precision(scores[:, 1], targets[:, 1]) \
        == jax_evaluation.average_precision(scores[:, 1], targets[:, 1])
    got = evaluation.mean_average_precision(scores, targets)
    want = jax_evaluation.mean_average_precision(scores, targets)
    assert got["mAP"] == want["mAP"]
    assert np.array_equal(got["per_class_ap"], want["per_class_ap"], equal_nan=True)
    assert np.array_equal(evaluation.multilabel_predictions(scores),
                          jax_evaluation.multilabel_predictions(scores))
    with pytest.raises(ValueError):
        evaluation.mean_average_precision(scores, targets[:, :3])


def _dump(path):
    with open(path) as f:
        return json.load(f)


def _dataset_rows(dump, world):
    """The dump's predictions and labels keyed by dataset index (the
    sampler's index stream of the test loader at ``world`` ranks)."""
    loader = ShardedBatchLoader(np.zeros((TEST_SIZE, 1)), np.zeros(TEST_SIZE),
                                world_size=world, per_shard_batch=32, shuffle=False,
                                exclude_sampler_pad=True)
    order = np.concatenate([i[m] for i, m in loader.epoch_index_batches(epoch=0)])
    assert sorted(order.tolist()) == list(range(TEST_SIZE))
    preds, labels = np.asarray(dump["predictions"]), np.asarray(dump["labels"])
    back = np.argsort(order)
    return preds[back], labels[back]


def test_cli_dump_one_and_two_ranks(tmp_path):
    ck = str(tmp_path / "ck")
    p1 = str(tmp_path / "p1.json")
    metrics = main(SMALL + ["--epochs", "1", "--checkpoint-dir", ck, "--dump-predictions", p1])
    d1 = _dump(p1)
    assert list(d1) == ["predictions", "labels"]
    assert len(d1["predictions"]) == len(d1["labels"]) == TEST_SIZE
    acc = float(np.mean(np.asarray(d1["predictions"]) == np.asarray(d1["labels"])))
    assert acc == pytest.approx(metrics["test_accuracy"], abs=1e-12)
    p2 = str(tmp_path / "p2.json")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
         "--", sys.executable, "-m", "tpu_ddp_torch.cli.train", *SMALL, "--eval-only",
         "--resume", "--checkpoint-dir", ck, "--dump-predictions", p2],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "predictions -> " in proc.stdout
    one, two = _dataset_rows(d1, 1), _dataset_rows(_dump(p2), 2)
    assert np.array_equal(one[1], two[1])
    assert np.array_equal(one[0], two[0])


def test_cli_bce_dump_is_multi_hot(tmp_path, capsys):
    path = str(tmp_path / "bce.json")
    metrics = main(SMALL + ["--epochs", "1", "--loss", "bce", "--num-classes", "5",
                            "--dump-predictions", path])
    out = capsys.readouterr().out
    assert re.search(r"^test mAP: [\d.]+$", out, re.M)
    assert math.isfinite(metrics["test_mAP"])
    d = _dump(path)
    preds = np.asarray(d["predictions"])
    assert preds.shape == np.asarray(d["labels"]).shape == (TEST_SIZE, 5)
    assert set(np.unique(preds)) <= {0, 1}


def test_cli_plot_curves_and_viz_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    png, viz = str(tmp_path / "curves.png"), str(tmp_path / "viz")
    main(SMALL + ["--epochs", "2", "--eval-each-epoch", "--plot-curves", png,
                  "--viz-predictions", viz])
    for path in (png, os.path.join(viz, "predictions.png"),
                 os.path.join(viz, "confusion_matrix.png")):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", path
