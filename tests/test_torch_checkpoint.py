"""The port's checkpoints (``tpu_ddp_torch/checkpoint/``) and the state's
checkpoint layouts, against the JAX package.

(a) manifests both ways: a step the port commits verifies under the JAX
    ``verify_step`` and an orbax step the JAX ``Checkpointer`` commits under
    the port's; a flipped byte is refused by both with the same problems;
(b) ``Checkpointer``: the JAX tests of retries, refusal and fallback and
    ``save_as_only`` (``tests/test_chaos.py``, ``tests/test_keep_best.py``),
    same cases and assertions, plus retention, the duplicate-step guard and
    a background save's manifest;
(c) ``merge_params`` keeps and replaces the same leaves as the JAX one;
(d) ``--keep-best`` on the trainer: its config check, a torn metadata file,
    and the best checkpoint at the best accuracy (the JAX tests);
(e) the layouts at 2, 3 and 4 gloo ranks, from rows made from a numpy
    seed: ``deshard_residual`` against the JAX ``GradCompressor``'s on the
    stacked rows (bitwise at two ranks, ``rtol=1e-6`` at three and four,
    where XLA may sum in another order), ``shard_residual`` bitwise against
    the JAX function's rows, and ZeRO-1's ``deshard_state`` of shards cut
    from the JAX flat layout against the JAX ``deshard_opt_state``, bitwise;
(f) the CLI's checkpoint flags and refusals with the JAX messages, the
    JSONL records' keys against the JAX logger's, and the entry points.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.checkpoint import manifest as jax_manifest
from tpu_ddp_torch.checkpoint import manifest
from tpu_ddp_torch.checkpoint.convert import from_jax
from tpu_ddp_torch.checkpoint.manager import Checkpointer, merge_params
from tpu_ddp_torch.parallel import runtime as dist_runtime
from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
from tpu_ddp_torch.parallel.zero import Zero1Partition
from tpu_ddp_torch.train.optim import OptState, make_optimizer
from tpu_ddp_torch.train.state import (
    TrainState,
    checkpoint_state,
    copy_opt_state_,
    split_checkpoint,
)
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores, and at
    these sizes more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_state():
    return {"w": torch.arange(16, dtype=torch.float32),
            "b": torch.ones((4,), dtype=torch.float32)}


def _flip_byte(directory, step):
    root = os.path.join(directory, str(step))
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs]
    target = max(files, key=os.path.getsize)
    with open(target, "r+b") as f:
        f.seek(os.path.getsize(target) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 1]))


# ---- (a) manifests both ways ------------------------------------------------


def test_port_step_verifies_under_jax_manifest(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    ck.save(3, _tiny_state(), wait=True)
    assert jax_manifest.committed_steps(d) == [3]
    assert jax_manifest.verify_step(d, 3) == (True, [])
    assert manifest.verify_step(d, 3) == (True, [])
    with open(manifest.manifest_path(d, 3)) as f:
        record = json.load(f)
    assert set(record) == {"manifest_schema_version", "step", "n_files", "files"}
    _flip_byte(d, 3)
    got, want = manifest.verify_step(d, 3), jax_manifest.verify_step(d, 3)
    assert got[0] is False and got == want


def test_jax_step_verifies_under_port_manifest(tmp_path):
    from tpu_ddp.checkpoint import Checkpointer as JaxCheckpointer

    d = str(tmp_path / "ck")
    ck = JaxCheckpointer(d)
    ck.save(4, {"w": jnp.arange(4096, dtype=jnp.float32)}, wait=True)
    ck.close()
    assert manifest.committed_steps(d) == [4]
    assert manifest.verify_step(d, 4) == (True, [])
    assert manifest.latest_verified_step(d) == (4, [])
    _flip_byte(d, 4)
    got, want = manifest.verify_step(d, 4), jax_manifest.verify_step(d, 4)
    assert got[0] is False and got == want
    assert manifest.latest_verified_step(d)[0] is None


# ---- (b) Checkpointer ---------------------------------------------------------


def test_checkpointer_save_retry_counts_and_succeeds(tmp_path):
    calls = []

    def flake(step, attempt):
        if len(calls) < 2:
            calls.append((step, attempt))
            raise OSError("transient blob-store flake")

    ck = Checkpointer(str(tmp_path / "ck"), fault_hook=flake, save_retry_base_s=0.01)
    ck.save(3, _tiny_state(), wait=True)
    assert calls == [(3, 0), (3, 1)]  # attempts 0 and 1 flaked, 2 won
    assert ck.counters["save_retries"] == 2
    assert manifest.verify_step(str(tmp_path / "ck"), 3) == (True, [])
    ck.close()


def test_checkpointer_exhausted_retries_raise_only_on_wait(tmp_path):
    def always(step, attempt):
        raise OSError("dead disk")

    ck = Checkpointer(str(tmp_path / "ck"), fault_hook=always,
                      save_attempts=2, save_retry_base_s=0.01)
    # cadence save: recorded, swallowed, training must not die for it
    ck.save(3, _tiny_state())
    ck.wait_until_finished()
    assert ck.latest_step() is None
    assert ck.counters["save_failures"] == 1
    # final save: a silent drop would fake a clean exit, so it raises
    with pytest.raises(OSError, match="dead disk"):
        ck.save(4, _tiny_state(), wait=True)
    assert ck.counters["save_failures"] == 2
    # a final save at the step of a background save that fails still raises
    ck.save(5, _tiny_state())
    with pytest.raises(OSError, match="dead disk"):
        ck.save(5, _tiny_state(), wait=True)
    assert ck.counters["save_failures"] == 4
    assert ck.latest_step() is None
    assert os.listdir(str(tmp_path / "ck")) == []   # no temporary left
    ck.close()


def test_checkpointer_restore_refuses_corrupt_and_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    state = _tiny_state()
    ck.save(2, state, wait=True)
    ck.save(5, {"w": state["w"] * 2, "b": state["b"] * 2}, wait=True)
    assert manifest.committed_steps(d) == [2, 5]
    _flip_byte(d, 5)
    assert ck.verified_restore_step() == 2
    restored = ck.restore()
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(16, dtype=np.float32))
    # an EXPLICITLY requested corrupt step refuses loudly, with no fallback
    with pytest.raises(ValueError, match="REFUSED"):
        ck.restore(step=5)
    ck.close()


def test_retention_keeps_the_three_highest_steps(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    for step in (1, 2, 3, 4, 5):
        ck.save(step, {"w": torch.full((3,), float(step))}, wait=True)
    assert ck.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(os.path.join(d, "manifests"))) == [
        "step-3.json", "step-4.json", "step-5.json"]
    assert int(ck.restore()["w"][0]) == 5
    ck.close()


def test_duplicate_step_is_skipped(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    ck.save(6, {"w": torch.zeros(2)})
    ck.save(6, {"w": torch.ones(2)}, wait=True)   # the final save at the same step
    assert ck.counters["saves"] == 1
    assert torch.equal(ck.restore()["w"], torch.zeros(2))
    ck.close()


def test_background_save_is_manifested_after_wait(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    view = torch.arange(1000, dtype=torch.float32)[10:20]
    ck.save(1, {"v": view, "step": 1})           # background write
    ck.wait_until_finished()
    assert manifest.verify_step(d, 1) == (True, [])
    restored = ck.restore()
    assert torch.equal(restored["v"], view) and restored["step"] == 1
    # the view was saved alone, not with its 1000-element base
    assert restored["v"].untyped_storage().nbytes() == 40
    ck.close()


def test_interrupted_save_as_only_marker_shadows_stale_best(tmp_path, monkeypatch):
    state = {"w": torch.arange(4.0), "step": 0}
    best_dir = tmp_path / "best"
    ck = Checkpointer(str(best_dir))
    ck.save(12, {**state, "step": 12}, wait=True)
    # crash-window simulation: marker + save of the replayed OLDER best
    # landed, the process died before the delete loop and the marker clear
    monkeypatch.setattr(ck, "_delete", lambda s: None)
    monkeypatch.setattr(ck, "_clear_marker", lambda: None)
    ck.save_as_only(9, {**state, "step": 9})
    assert ck.all_steps() == [9, 12]
    assert json.load(open(best_dir / "only_step.json"))["step"] == 9
    ck.close()

    ck2 = Checkpointer(str(best_dir))
    assert ck2.all_steps() == [9, 12]
    assert ck2.latest_step() == 9
    assert ck2.restore()["step"] == 9
    # the next save_as_only completes the deferred sweep
    ck2.save_as_only(10, {**state, "step": 10})
    assert ck2.all_steps() == [10]
    assert not (best_dir / "only_step.json").exists()
    ck2.close()


# ---- (c) merge_params ---------------------------------------------------------


def test_merge_params_matches_jax():
    from tpu_ddp.checkpoint.manager import merge_params as jax_merge

    rng = np.random.default_rng(0)
    fresh = {"body.w": rng.standard_normal((3, 4)).astype(np.float32),
             "head.w": rng.standard_normal((10, 4)).astype(np.float32),
             "head.b": rng.standard_normal((10,)).astype(np.float32),
             "new.b": rng.standard_normal((2,)).astype(np.float32)}
    restored = {"body.w": rng.standard_normal((3, 4)).astype(np.float32),
                "head.w": rng.standard_normal((3, 4)).astype(np.float32),
                "head.b": rng.standard_normal((10,)).astype(np.float32),
                "gone.b": rng.standard_normal((5,)).astype(np.float32)}
    want = jax_merge(restored, fresh, verbose=False)
    got = merge_params({k: torch.from_numpy(v) for k, v in restored.items()},
                       {k: torch.from_numpy(v) for k, v in fresh.items()},
                       verbose=False)
    assert list(got) == list(fresh)
    for name in fresh:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    kept = [n for n in fresh if np.array_equal(got[n].numpy(), fresh[n])]
    assert kept == ["head.w", "new.b"]


# ---- (d) --keep-best ------------------------------------------------------------

KEEP = dict(device="cpu", synthetic_data=True, n_chans1=8, n_blocks=2,
            per_shard_batch=4)


def test_keep_best_requires_eval_and_checkpoint_dir(tmp_path):
    with pytest.raises(ValueError, match="keep-best"):
        Trainer(TrainConfig(keep_best=True, checkpoint_dir=str(tmp_path), **KEEP))
    with pytest.raises(ValueError, match="keep-best"):
        Trainer(TrainConfig(keep_best=True, eval_each_epoch=True, **KEEP))


def test_corrupt_best_metadata_tolerated_on_resume(tmp_path, caplog):
    ck = str(tmp_path / "ck")
    best_dir = os.path.join(ck, "best")
    os.makedirs(best_dir)
    with open(os.path.join(best_dir, "metadata.json"), "w") as f:
        f.write('{"step": 3, "test_acc')  # torn write
    with caplog.at_level(logging.WARNING):
        t = Trainer(TrainConfig(synthetic_size=64, epochs=1, eval_each_epoch=True,
                                checkpoint_dir=ck, keep_best=True, resume=True, **KEEP))
    assert t._best_acc == float("-inf")
    assert "unreadable best metadata" in caplog.text


def test_keep_best_tracks_argmax_accuracy(tmp_path):
    ck = str(tmp_path / "ck")
    t = Trainer(TrainConfig(synthetic_size=128, epochs=3, lr=0.05, seed=0,
                            log_every_epochs=1, eval_each_epoch=True,
                            checkpoint_dir=ck, checkpoint_every_epochs=1,
                            keep_best=True, **KEEP))
    t.run()
    t.close()
    accs = t.history["test_accuracy"]
    meta = json.load(open(os.path.join(ck, "best", "metadata.json")))
    assert meta["test_accuracy"] == pytest.approx(max(accs))
    best = Checkpointer(os.path.join(ck, "best"))
    assert best.latest_step() == meta["step"]
    assert best.restore()["step"] == meta["step"]


# ---- (e) the layouts against the JAX functions --------------------------------

#: 1-D leaves, so the JAX and port flat layouts coincide element for element;
#: the sizes pad at every rank count of the tests
TEMPLATE = {"a": {"bias": (7,)}, "b": {"scale": (33,)}, "c": {"bias": (64,)},
            "d": {"bias": (5,)}}
RECIPE = dict(optimizer="adamw", lr=1e-3, ema_decay=0.9, schedule="cosine",
              total_steps=10)


def _port_template():
    return {f"{k}.{'weight' if 'scale' in v else 'bias'}": torch.zeros(next(iter(v.values())))
            for k, v in TEMPLATE.items()}


def _layout_worker(rank, n, path):
    data = torch.load(path, weights_only=False)
    template = _port_template()
    comp = GradCompressor(GradCompression(error_feedback=True), template, n)
    res = comp.init_residual(torch.device("cpu"))
    for name, rows in data["rows"].items():
        res[name].copy_(rows[rank])
    desharded = comp.deshard_residual(res)
    tx = make_optimizer(zero1_axis="data", decay_mask={k: False for k in template},
                        **RECIPE)
    part = Zero1Partition(tx, template, n)
    shards = part.init_opt_state(template)
    for slot in ("mu", "nu", "ema"):
        for name, view in getattr(shards, slot).items():
            s = part.shard_size(name)
            view.copy_(data["flat"][slot][name][rank * s:(rank + 1) * s])
    shards.count.copy_(data["flat"]["count"])
    shards.sched_count.copy_(data["flat"]["sched_count"])
    state = TrainState(step=torch.zeros((), dtype=torch.int64),
                       model=torch.nn.Module(), opt_state=shards)
    full = part.deshard_state(state).opt_state
    torch.save({"residual": desharded,
                "opt": {s: getattr(full, s) for s in ("mu", "nu", "ema", "count",
                                                      "sched_count")}},
               os.path.join(os.path.dirname(path), f"rank{rank}.pt"))


@pytest.fixture(scope="module", params=[2, 3, 4], ids=["n2", "n3", "n4"])
def layouts(request, tmp_path_factory):
    """Rows and a flat ZeRO-1 optimizer state from a numpy seed, the JAX
    functions' results on them, and the port's from n gloo ranks."""
    from tpu_ddp.parallel.compression import GradCompression as JaxGC
    from tpu_ddp.parallel.compression import GradCompressor as JaxCompressor
    from tpu_ddp.parallel.zero import Zero1Partition as JaxZero1
    from tpu_ddp.train import make_optimizer as jax_make_optimizer

    n = request.param
    rng = np.random.default_rng(n)
    params = jax.tree.map(lambda s: jnp.zeros(s, jnp.float32), TEMPLATE,
                          is_leaf=lambda x: isinstance(x, tuple))
    jcomp = JaxCompressor(JaxGC(error_feedback=True), params, n)
    rows = jax.tree.map(lambda slot: rng.standard_normal((n, slot.padded)).astype(np.float32),
                        jcomp.slots, is_leaf=lambda x: hasattr(x, "padded"))
    jax_desharded = jcomp.deshard_residual(jax.tree.map(jnp.asarray, rows))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
    jax_sharded = jcomp.shard_residual(jax_desharded, mesh)

    jtx = jax_make_optimizer(zero1_axis="data", decay_mask=jax.tree.map(
        lambda p: False, params), **RECIPE)
    jpart = JaxZero1(jtx, params, n)
    flat_state = jtx.init(jpart.flatten(params))
    leaves, treedef = jax.tree_util.tree_flatten(flat_state)
    filled = []
    for leaf in leaves:
        if leaf.ndim:       # a flat-padded slot, its pad included
            filled.append(jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32)))
        else:
            filled.append(jnp.asarray(rng.integers(1, 9), leaf.dtype))
    flat_state = jax.tree_util.tree_unflatten(treedef, filled)
    jax_full = jpart.deshard_opt_state(flat_state)

    flat = from_jax({}, {}, jax.device_get(flat_state))["opt_state"]
    to_port = lambda tree: from_jax(jax.device_get(tree), {})["model"]  # noqa: E731
    path = str(tmp_path_factory.mktemp(f"layout{n}") / "data.pt")
    torch.save({"rows": to_port(rows),
                "flat": {"mu": flat.mu, "nu": flat.nu, "ema": flat.ema,
                         "count": flat.count, "sched_count": flat.sched_count}}, path)
    dist_runtime.spawn(_layout_worker, n, path, init_file=path + ".init", timeout=120)
    port = [torch.load(os.path.join(os.path.dirname(path), f"rank{r}.pt"))
            for r in range(n)]
    return dict(n=n, rows=to_port(rows), jax_desharded=to_port(jax_desharded),
                jax_sharded=to_port(jax_sharded),
                jax_full=from_jax({}, {}, jax.device_get(jax_full))["opt_state"],
                port=port)


def test_deshard_residual_matches_jax(layouts):
    for r, got in enumerate(layouts["port"]):
        for name, want in layouts["jax_desharded"].items():
            if layouts["n"] == 2:
                assert torch.equal(got["residual"][name], want), (r, name)
            else:
                np.testing.assert_allclose(got["residual"][name].numpy(),
                                           want.numpy(), rtol=1e-6, atol=0)


def test_shard_residual_matches_jax_rows(layouts):
    n = layouts["n"]
    comp = GradCompressor(GradCompression(error_feedback=True), _port_template(), n)
    for r in range(n):
        got = comp.shard_residual(layouts["jax_desharded"], rank=r)
        for name, want in layouts["jax_sharded"].items():
            assert torch.equal(got[name], want[r]), (r, name)
        assert comp._joined(got).data_ptr() == got[comp.names[0]].data_ptr()
    # a checkpoint's rows at this rank count give each rank its own row back
    rows = torch.stack([torch.cat([layouts["rows"][k][r] for k in comp.names])
                        for r in range(n)])
    for r in range(n):
        got = comp.shard_residual(layouts["jax_desharded"], rows=rows, rank=r)
        for name in comp.names:
            assert torch.equal(got[name], layouts["rows"][name][r])


def test_rows_of_another_rank_count_restore_as_their_sum(layouts):
    """A checkpoint of n ranks holds only their rows; a run at another rank
    count takes their sum through the rows' own layout (``desharded_rows``),
    the whole of it on rank 0."""
    n = layouts["n"]
    comp = GradCompressor(GradCompression(error_feedback=True), _port_template(), n)
    rows = torch.stack([torch.cat([layouts["rows"][k][r] for k in comp.names])
                        for r in range(n)])
    other = GradCompressor(GradCompression(error_feedback=True), _port_template(), n + 1)
    for name, want in layouts["jax_desharded"].items():
        got = other.desharded_rows(rows)[name]
        if n == 2:
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
    for r in range(n + 1):
        got = other.unflatten(other.shard_residual(None, rows=rows, rank=r))
        for name, total in comp.deshard_residual(None, rows).items():
            assert torch.equal(got[name], total if r == 0 else torch.zeros_like(total))
    with pytest.raises(ValueError, match="residual rows"):
        other.desharded_rows(rows[:, 1:])


def test_zero1_deshard_state_matches_jax(layouts):
    want = layouts["jax_full"]
    for r, got in enumerate(layouts["port"]):
        for slot in ("mu", "nu", "ema"):
            for name, t in getattr(want, slot).items():
                assert torch.equal(got["opt"][slot][name], t), (r, slot, name)
        for slot in ("count", "sched_count"):
            assert torch.equal(got["opt"][slot], getattr(want, slot)), (r, slot)


def test_checkpoint_layout_round_trip():
    opt = OptState(count=torch.tensor(3, dtype=torch.int32),
                   mu={"w": torch.ones(2)}, nu={"w": torch.full((2,), 2.0)})
    flat = checkpoint_state(7, {"w": torch.zeros(2), "bn.running_mean": torch.ones(1)},
                            opt, {"w": torch.full((2,), 0.5)}, torch.zeros(2, 4))
    assert sorted(flat) == ["grad_residual/w", "grad_residual_rows", "model/bn.running_mean",
                            "model/w", "opt/count", "opt/mu/w", "opt/nu/w", "step"]
    back = split_checkpoint(flat)
    assert back["step"] == 7 and set(back["model"]) == {"w", "bn.running_mean"}
    dst = OptState(count=torch.tensor(0, dtype=torch.int32),
                   mu={"w": torch.zeros(2)}, nu={"w": torch.zeros(2)})
    copy_opt_state_(dst, back["opt_state"])
    assert int(dst.count) == 3 and torch.equal(dst.nu["w"], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="does not match this run's"):
        copy_opt_state_(OptState(trace={"w": torch.zeros(2)}), back["opt_state"])


# ---- (f) CLI, logger and entry points ---------------------------------------


def test_checkpoint_flags_validated_with_jax_messages():
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig

    for kw in (dict(checkpoint_steps=5), dict(checkpoint_steps=-1)):
        with pytest.raises(ValueError) as want:
            JaxTrainConfig(**kw).validate()
        with pytest.raises(ValueError) as got:
            TrainConfig(**kw)
        assert str(got.value) == str(want.value)


def test_eval_only_needs_weights(tmp_path):
    from tpu_ddp_torch.cli.train import main

    with pytest.raises(SystemExit, match=re.escape(
            "--eval-only needs weights: --checkpoint-dir ... --resume, "
            "or --pretrained-dir ...")):
        main(["--device", "cpu", "--synthetic-data", "--eval-only"])
    with pytest.raises(SystemExit, match="no checkpoint found under"):
        main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
              "--n-chans1", "8", "--n-blocks", "2", "--eval-only", "--resume",
              "--checkpoint-dir", str(tmp_path / "empty")])


def test_jsonl_records_have_the_jax_keys(tmp_path):
    from tpu_ddp.metrics.logging import MetricLogger as JaxLogger
    from tpu_ddp_torch.metrics.logging import SCHEMA_VERSION, MetricLogger

    records = []
    for logger, name in ((JaxLogger(str(tmp_path / "jax.jsonl"), stdout=False), "jax.jsonl"),
                         (MetricLogger(str(tmp_path / "port.jsonl")), "port.jsonl")):
        logger.log(5, epoch=1, train_loss=0.5)
        logger.close()
        with open(tmp_path / name) as f:
            records.append(json.loads(f.readline()))
    assert records[0].keys() == records[1].keys()
    assert records[1]["schema_version"] == SCHEMA_VERSION == 1


def test_tensorboard_sink_is_lazy_and_refuses_without_the_package(tmp_path, monkeypatch):
    from tpu_ddp_torch.metrics.logging import MetricLogger

    MetricLogger().close()          # no --tensorboard-dir: nothing imported
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="--tensorboard-dir needs torch's SummaryWriter"):
        MetricLogger(tensorboard_dir=str(tmp_path / "tb"))


def test_main_plans_one_rank_a_card():
    from tpu_ddp_torch import main as entry

    assert entry.plan(["--epochs", "2"], 1) is None
    assert entry.plan(["--device", "cpu"], 4) is None
    cmd = entry.plan(["--epochs", "2", "--kernels"], 4)
    assert cmd == [sys.executable, "-m", "tpu_ddp_torch.cli.train", "--epochs", "2",
                   "--kernels"]


def test_main_no_ddp_defaults_to_batch_64(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.main_no_ddp", "--device", "cpu",
         "--synthetic-data", "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(r"^Epoch 1, Training loss \S+$", out.stdout, re.M)
    assert "[step 32] epoch=1" in out.stdout          # 2048 images / 64
    assert re.search(r"^final test accuracy: ", out.stdout, re.M)
