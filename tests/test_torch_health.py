"""The port's numerics flight recorder, host side and stats
(``tpu_ddp_torch/health/``), against the JAX package's
``tpu_ddp/health/`` on the same numpy inputs, and through the port's
trainer on the CPU.

* ``health_stats``: norms within ``rtol=1e-5`` of
  ``tpu_ddp.health.stats.health_stats`` (the port sums leaf norms squared,
  JAX each leaf's squares: float32 rounding apart), sentinels equal, on
  clean trees, a NaN, an infinity, a NaN loss and a finite tree whose norm
  overflows to inf (which must read finite on both sides);
* ``SkipGuard``: the old values back to the bit after a non-finite step
  (-0.0 and NaN included), the new ones left to the bit otherwise;
* the monitor: the spike detector, the one-shot dump, the JSONL records,
  and the port's run dir rendered to the same text by the port's summary
  and by ``tpu_ddp.health.summarize``;
* the trainer on poisoned data without shuffling: ``skip_step`` recovers
  with a dump of the poisoned step; ``halt`` drains, refuses a non-finite
  final save and keeps a finite one (a loss spike); ``warn`` with clean
  data is bitwise the run without health; bad modes and policies fail fast;
* ``--no-shuffle`` gives the JAX loader's order, and the CLI takes every
  ``--health*`` flag.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.data.loader import ShardedBatchLoader as JaxLoader
from tpu_ddp.health import stats as jax_stats
from tpu_ddp.health.summarize import summarize_health as jax_summarize
from tpu_ddp_torch.health import stats
from tpu_ddp_torch.health.monitor import HealthMonitor, SpikeDetector
from tpu_ddp_torch.health.summarize import summarize_health

NORMS = ("loss", "grad_norm", "param_norm", "update_norm", "update_ratio")
FLAGS = ("loss_finite", "grads_finite", "updates_finite", "all_finite")


def _trees(case):
    rng = np.random.default_rng(3)
    shapes = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,), "fc.weight": (5, 7)}
    grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    updates = {n: -1e-2 * g for n, g in grads.items()}
    loss = np.float32(2.5)
    if case == "nan_grad":
        grads["conv.bias"][1] = np.nan
    elif case == "inf_update":
        updates["fc.weight"][2, 3] = -np.inf
    elif case == "nan_loss":
        loss = np.float32(np.nan)
    elif case == "overflow":
        grads["fc.weight"][:] = 3e38           # finite, but the norm overflows
    return loss, grads, params, updates


def _same(got, want):
    """Port stats (tensors) against JAX's (arrays): norms rtol 1e-5 (NaN
    and inf where JAX has them), sentinels equal."""
    for k in NORMS + ("compress_error_norm",):
        if k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in FLAGS:
        assert bool(got[k]) == bool(want[k]), k
    assert set(got) == set(want)


@pytest.mark.parametrize("case", ["clean", "nan_grad", "inf_update", "nan_loss", "overflow"])
def test_health_stats_match_jax(case):
    loss, grads, params, updates = _trees(case)
    t = lambda tree: {n: torch.from_numpy(v.copy()) for n, v in tree.items()}  # noqa: E731
    j = lambda tree: {n: jnp.asarray(v) for n, v in tree.items()}  # noqa: E731
    want = jax_stats.health_stats(loss=jnp.asarray(loss), grads=j(grads), params=j(params),
                                  updates=j(updates), per_layer=True,
                                  compress_error_sq=jnp.float32(0.25))
    got = stats.health_stats(loss=torch.tensor(loss), grads=t(grads), params=t(params),
                             updates=t(updates), per_layer=True,
                             compress_error_sq=torch.tensor(0.25))
    _same(got, want)
    for group in ("grad_norm", "param_norm"):
        assert set(got["per_layer"][group]) == set(want["per_layer"][group])
        for name, w in want["per_layer"][group].items():
            np.testing.assert_allclose(float(got["per_layer"][group][name]), float(w),
                                       rtol=1e-5, err_msg=f"{group}/{name}")
    if case == "overflow":
        assert math.isinf(float(got["grad_norm"])) and bool(got["grads_finite"])
    # the tree helpers, and the stats from the old params' norms
    assert (float(stats.tree_nonfinite(t(grads))) == 0) == (
        float(jax_stats.tree_nonfinite(j(grads))) == 0)
    np.testing.assert_allclose(float(stats.tree_sq(t(params))),
                               float(jax_stats.tree_sq(j(params))), rtol=1e-5)
    for name, sq in stats.per_layer_sq(t(params)).items():
        np.testing.assert_allclose(float(sq), float(jax_stats.per_layer_sq(j(params))[name]),
                                   rtol=1e-5)
    again = stats.health_stats(loss=torch.tensor(loss), grads=t(grads), updates=t(updates),
                               param_norms=stats.leaf_norms(list(t(params).values())))
    assert torch.equal(again["param_norm"], got["param_norm"])


def test_nonfinite_leaves_counts_leaves_and_skips_empty():
    xs = [torch.tensor([1.0, float("nan")]), torch.zeros(0), torch.tensor([float("inf")]),
          torch.full((3,), 3e38), torch.tensor([float("-inf"), float("nan")])]
    assert float(stats.nonfinite_leaves(xs)) == 3.0
    assert float(stats.nonfinite_leaves(xs[1:2] + xs[3:4])) == 0.0


@pytest.mark.parametrize("ok", [True, False])
def test_skip_guard_selects_to_the_bit(ok):
    p = torch.tensor([-0.0, 1.5, float("nan")])
    count = torch.tensor(7, dtype=torch.int32)
    guard = stats.SkipGuard()
    guard.save("update", [p, count])
    snaps = guard._held["update"][1]
    old_p, old_count = p.clone(), count.clone()
    p.copy_(torch.tensor([2.0, float("nan"), -0.0]))
    count += 1
    new_p, new_count = p.clone(), count.clone()
    guard.select(torch.tensor(ok))
    want_p, want_count = (new_p, new_count) if ok else (old_p, old_count)
    assert torch.equal(p.view(torch.int32), want_p.view(torch.int32))
    assert torch.equal(count, want_count)
    guard.save("update", [p, count])        # the same tensors: the same buffers
    assert all(a is b for a, b in zip(guard._held["update"][1], snaps))


@pytest.mark.parametrize("lag", [False, True])
def test_health_feed_reads_each_step_once_in_order(lag):
    seen = []

    class Monitor:
        per_layer_stride = 2

        def on_step(self, step, host, batch_provider=None):
            seen.append((step, sorted(host), batch_provider()["x"].tolist()))
            return "halt" if not host["all_finite"] else "ok"

    feed = stats.HealthFeed(Monitor(), lag=lag)
    verdicts = []
    for step in range(3):
        h = stats.health_stats(loss=torch.tensor(1.0 if step != 1 else float("nan")),
                               grads={"w": torch.ones(3)}, params={"w": torch.ones(3)},
                               updates={"w": torch.ones(3)}, per_layer=True)
        verdicts.append(feed.push(step, h, {"x": torch.tensor([step])}))
    verdicts.append(feed.flush())
    assert [s for s, _, _ in seen] == [0, 1, 2]
    assert [b for _, _, b in seen] == [[0], [1], [2]]
    assert ["per_layer" in keys for _, keys, _ in seen] == [True, True, True]  # 1: tripped
    assert verdicts == (["ok", "ok", "halt", "ok"] if lag else ["ok", "halt", "ok", "ok"])


# -- the monitor and the summary -----------------------------------------


def _fake_stats(loss=1.0, finite=True):
    return {"loss": loss, "grad_norm": 2.0, "param_norm": 4.0, "update_norm": 0.02,
            "update_ratio": 0.005, "loss_finite": finite, "grads_finite": finite,
            "updates_finite": True, "all_finite": finite,
            "per_layer": {"grad_norm": {"fc.weight": 2.0}, "param_norm": {"fc.weight": 4.0}}}


def test_spike_detector_median_mad():
    det = SpikeDetector(window=64, threshold=10.0, warmup=20)
    r = np.random.RandomState(0)
    assert not any(det.observe(1.0 + 0.05 * r.randn()) for _ in range(40))
    assert det.observe(50.0)
    assert not det.observe(float("nan"))
    assert not det.observe(1.0)
    with pytest.raises(ValueError, match="window"):
        SpikeDetector(window=3)


def test_monitor_one_shot_dump_jsonl_and_summary_match_jax(tmp_path):
    run_dir = str(tmp_path)
    mon = HealthMonitor(run_dir=run_dir, policy="warn", per_layer_stride=2,
                        run_meta={"model": "toy"})
    for step in range(6):
        assert mon.on_step(step, _fake_stats(loss=1.0 + 0.01 * step)) == "ok"
    assert mon.on_step(6, _fake_stats(loss=float("nan"), finite=False),
                       batch_provider=lambda: {"image": np.zeros(2)}) == "warn"
    assert mon.on_step(7, _fake_stats(loss=float("nan"), finite=False)) == "warn"
    mon.close()
    assert mon.dumps_written == 1 and mon.anomaly_count == 2 and mon.nonfinite_steps == 2
    dump = os.path.join(run_dir, "anomalies", "step_00000006")
    assert os.listdir(os.path.join(run_dir, "anomalies")) == ["step_00000006"]
    assert sorted(os.listdir(dump)) == ["batch.npz", "health.json", "meta.json"]
    meta = json.load(open(os.path.join(dump, "meta.json")))
    assert (meta["schema_version"], meta["reason"], meta["config"]) == (1, "nonfinite",
                                                                       {"model": "toy"})
    records = [json.loads(line) for line in open(os.path.join(run_dir, "health-p0.jsonl"))]
    assert [r["type"] for r in records] == ["header"] + ["health"] * 8 + ["footer"]
    assert [r["step"] for r in records if "per_layer" in r] == [0, 2, 4, 6, 7]
    assert records[-1]["nonfinite_steps"] == 2
    out = summarize_health(run_dir)
    assert "non-finite: 2" in out and "!" in out and "step_00000006" in out
    assert out == jax_summarize(run_dir)


def test_summary_skew_line_and_no_writes_without_dir(tmp_path):
    for host, gn in enumerate((1.0, 1.0, 1.0, 9.0)):
        mon = HealthMonitor(run_dir=str(tmp_path), process_index=host)
        for step in range(8):
            mon.on_step(step, dict(_fake_stats(), grad_norm=gn))
        mon.close()
    out = summarize_health(str(tmp_path))
    assert "per-host skew: grad_norm" in out and "host 3" in out
    assert out == jax_summarize(str(tmp_path))
    quiet = HealthMonitor(policy="halt")
    assert quiet.on_step(0, _fake_stats(finite=False)) == "halt"
    quiet.close()
    with pytest.raises(ValueError, match="warn, skip_step, halt"):
        HealthMonitor(policy="explode")


def test_a_second_life_in_the_same_dir_keeps_the_first_record(tmp_path):
    from tpu_ddp_torch.health.monitor import next_incarnation

    for life in range(2):
        mon = HealthMonitor(run_dir=str(tmp_path),
                            incarnation=next_incarnation(str(tmp_path), 0))
        mon.on_step(life, _fake_stats())
        mon.close()
    assert sorted(os.listdir(tmp_path)) == ["health-p0.i1.jsonl", "health-p0.jsonl"]
    assert "steps: 2 (step 0..1)" in summarize_health(str(tmp_path))


def test_health_cli_entry(tmp_path, capsys):
    from tpu_ddp_torch.cli.main import main

    mon = HealthMonitor(run_dir=str(tmp_path))
    mon.on_step(0, _fake_stats())
    mon.close()
    assert main(["health", str(tmp_path)]) == 0
    assert "steps: 1" in capsys.readouterr().out
    assert main(["health", str(tmp_path / "missing")]) == 2


# -- the trainer end to end ----------------------------------------------

PER_SHARD = 4


def _poisoned(n_batches=6, poison=2, scale=None):
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(PER_SHARD * n_batches, 10, seed=0)
    images = np.array(images)
    rows = slice(poison * PER_SHARD, (poison + 1) * PER_SHARD)
    if scale is None:
        images[rows] = np.nan
    else:
        images[rows] *= scale
    return images, labels


def _config(**kw):
    from tpu_ddp_torch.train.trainer import TrainConfig

    base = dict(device="cpu", synthetic_data=True, synthetic_size=64, epochs=1,
                per_shard_batch=PER_SHARD, n_chans1=8, n_blocks=2, momentum=0.9,
                kernels=True, shuffle=False, log_every_epochs=1)
    base.update(kw)
    return TrainConfig(**base)


def _finite(trainer):
    return all(bool(torch.isfinite(p).all()) for p in trainer.state.params().values())


def test_trainer_skip_step_recovers_with_dump(tmp_path):
    from tpu_ddp_torch.train.trainer import Trainer

    run_dir = str(tmp_path / "run")
    trainer = Trainer(_config(health="on", health_policy="skip_step",
                              health_per_layer_stride=1, health_dir=run_dir),
                      train_data=_poisoned())
    trainer.run()
    trainer.close()
    assert _finite(trainer) and int(trainer.state.step) == 6
    assert trainer.health_monitor.nonfinite_steps == 1
    records = [json.loads(line) for line in open(os.path.join(run_dir, "health-p0.jsonl"))]
    steps = [r for r in records if r["type"] == "health"]
    assert len(steps) == 6 and "per_layer" in steps[0]
    assert "conv1.weight" in steps[0]["per_layer"]["grad_norm"]
    assert [r["step"] for r in steps if not r["all_finite"]] == [2]
    dump = os.path.join(run_dir, "anomalies", "step_00000002")
    assert sorted(os.listdir(dump)) == ["batch.npz", "health.json", "meta.json"]
    assert np.isnan(np.load(os.path.join(dump, "batch.npz"))["image"]).all()
    meta = json.load(open(os.path.join(dump, "meta.json")))
    assert meta["config"]["health_policy"] == "skip_step"
    assert "non-finite: 1" in summarize_health(run_dir)


def test_trainer_halt_refuses_nonfinite_final_save(tmp_path):
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(_config(health="on", health_policy="halt",
                              health_dir=str(tmp_path / "health"),
                              checkpoint_dir=str(tmp_path / "ckpt"),
                              checkpoint_every_epochs=100),
                      train_data=_poisoned())
    metrics = trainer.run()
    trainer.close()
    assert metrics.get("health_halted") is True
    assert int(trainer.state.step) == 3 and not _finite(trainer)
    assert trainer.checkpointer.latest_step() is None
    assert os.path.exists(tmp_path / "health" / "health-p0.jsonl")


def test_trainer_halt_keeps_finite_final_save(tmp_path):
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(_config(health="on", health_policy="halt", lr=1e-4,
                              checkpoint_dir=str(tmp_path / "ckpt"),
                              checkpoint_every_epochs=100),
                      train_data=_poisoned(n_batches=26, poison=24, scale=1e4))
    metrics = trainer.run()
    trainer.close()
    assert metrics.get("health_halted") is True
    assert trainer.health_monitor.spike_steps == 1
    assert trainer.health_monitor.nonfinite_steps == 0
    assert int(trainer.state.step) == 25 and _finite(trainer)
    assert trainer.checkpointer.latest_step() == 25


def test_trainer_warn_is_bitwise_health_off():
    from tpu_ddp_torch.train.trainer import Trainer

    off = Trainer(_config(seed=3, epochs=2, ema_decay=0.9))
    off.run()
    on = Trainer(_config(seed=3, epochs=2, ema_decay=0.9, health="on",
                         health_per_layer_stride=1))
    on.run()
    assert off.history["step_loss"] == on.history["step_loss"]
    for (name, a), b in zip(off.state.model.state_dict().items(),
                            on.state.model.state_dict().values()):
        assert torch.equal(a, b), name
    warn = Trainer(_config(health="on", health_policy="warn"), train_data=_poisoned())
    warn.run()
    assert not _finite(warn) and warn.health_monitor.nonfinite_steps >= 1


@pytest.mark.parametrize("kw,match", [
    (dict(health="loud"), "off, on"),
    (dict(health="on", health_policy="explode"), "warn, skip_step, halt"),
    (dict(health_per_layer_stride=-1), "health_per_layer_stride"),
    (dict(health_window=3), "health_window"),
])
def test_trainer_config_fails_fast(kw, match):
    with pytest.raises(ValueError, match=match):
        _config(**kw)


def test_no_shuffle_gives_the_jax_loaders_order():
    from tpu_ddp_torch.data.loader import ShardedBatchLoader
    from tpu_ddp_torch.train.trainer import Trainer

    images = np.arange(37 * 2, dtype=np.float32).reshape(37, 2)
    labels = np.arange(37)
    for world in (1, 3):
        mine = ShardedBatchLoader(images, labels, world_size=world, per_shard_batch=4,
                                  shuffle=False, seed=5)
        theirs = JaxLoader(images, labels, world_size=world, per_shard_batch=4,
                           shuffle=False, seed=5)
        for epoch in (1, 2):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(mine.epoch_batches()), list(theirs.epoch_batches())
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in ("image", "label", "mask"):
                    np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    trainer = Trainer(_config(), train_data=(np.zeros((40, 32, 32, 3), np.float32),
                                             np.arange(40) % 10))
    first = next(trainer.train_loader.epoch_batches(epoch=1, shard=0))
    np.testing.assert_array_equal(first["label"], np.arange(PER_SHARD))


def test_cli_takes_the_health_flags_and_no_shuffle():
    from tpu_ddp_torch.cli.train import build_parser, config_from_args

    c = config_from_args(build_parser().parse_args([
        "--device", "cpu", "--no-shuffle", "--health", "on", "--health-policy", "halt",
        "--health-per-layer-stride", "3", "--health-dir", "/x", "--health-window", "16",
        "--health-spike-threshold", "4.5"]))
    assert (c.shuffle, c.health, c.health_policy, c.health_per_layer_stride, c.health_dir,
            c.health_window, c.health_spike_threshold) == (False, "on", "halt", 3, "/x", 16, 4.5)
    d = config_from_args(build_parser().parse_args(["--device", "cpu"]))
    assert (d.shuffle, d.health, d.health_policy, d.health_per_layer_stride, d.health_dir,
            d.health_window, d.health_spike_threshold) == (True, "off", "warn", 0, None, 128, 10.0)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--health-policy", "explode"])
