"""Resume on one rank: a run cut by a checkpoint and resumed with
``--resume`` gives the uninterrupted run's per-step losses and final params
BITWISE (the JAX ``tests/test_train.py::test_resume_continues_identically``
allows ``rtol=1e-6``; the port on the CPU gives equal bits), and resumes
from the JAX trainer's checkpoint.

(a) the JAX test's form, SGD: two epochs with ``--checkpoint-dir``, then
    ``--resume`` to four, against four uninterrupted;
(b) AdamW, cosine schedule, EMA, clip and ``--kernels`` (K1's plain version
    on the CPU): the schedule's length is ``--epochs``, so the cut run runs
    with four and dies at the start of epoch 3, after its epoch-2 save;
(c) mid-epoch: a run with ``--checkpoint-steps 30`` dies at step 75, and the
    resumed run skips exactly the 10 steps of epoch 2 the cut run trained;
(d) the error-feedback residual's tolerance in both directions, with the
    JAX trainer's warnings;
(e) a JAX ``Trainer`` run of two epochs with ``checkpoint_dir``, restored by
    the JAX ``Checkpointer``, carried over with ``checkpoint/convert.py``'s
    ``from_jax`` and saved by the port's ``Checkpointer``: the port resumes
    epochs 3-4 from it within ``rtol=1e-5`` of the JAX uninterrupted
    four-epoch run's epoch losses (``tests/test_torch_train_step.py``'s
    bound for the two frameworks' CPU convolutions).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import logging
import math

import numpy as np
import pytest
import torch

from tpu_ddp_torch.checkpoint.manager import Checkpointer
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=200, per_shard_batch=4,
            n_chans1=8, n_blocks=2, seed=0, log_every_epochs=1)
SPE = 50                              # steps an epoch: 200 images, batch 4
RECIPES = {
    "sgd": dict(),
    "adamw_cosine_ema_clip_k1": dict(optimizer="adamw", lr=1e-3, schedule="cosine",
                                     ema_decay=0.99, grad_clip_norm=1.0, kernels=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores, and at
    these sizes more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Killed(Exception):
    pass


class DieAt:
    """The loader, raising ``Killed`` when the run asks for its batch with
    global index ``at`` (the cut run's crash)."""

    def __init__(self, inner, at):
        self._inner, self._at, self._seen = inner, at, 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, *args, **kwargs):
        for batch in self._inner.epoch_batches(*args, **kwargs):
            if self._seen == self._at:
                raise Killed
            self._seen += 1
            yield batch


def _trainer(**kw):
    return Trainer(TrainConfig(**{**BASE, **kw}))


def _run(**kw):
    t = _trainer(**kw)
    t.run()
    t.close()
    return t


def _run_killed(at, **kw):
    # the shim wraps epoch_batches: the synchronous data path (the resumed
    # and uninterrupted runs take the default, the native ring)
    t = _trainer(**{**kw, "prefetch_depth": 0})
    t.train_loader = DieAt(t.train_loader, at)
    with pytest.raises(Killed):
        t.run()
    t.close()          # the cut run's in-flight save lands, as its writer's would
    return t


def _same_params(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def uninterrupted():
    return {name: _run(epochs=4, **kw) for name, kw in RECIPES.items()}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_resume_continues_identically(uninterrupted, recipe, tmp_path):
    full, kw = uninterrupted[recipe], RECIPES[recipe]
    ck = str(tmp_path / "ck")
    if recipe == "sgd":
        _run(epochs=2, checkpoint_dir=ck, **kw)
    else:
        _run_killed(2 * SPE, epochs=4, checkpoint_dir=ck, checkpoint_every_epochs=2, **kw)
    assert Checkpointer(ck).latest_step() == 2 * SPE
    resumed = _run(epochs=4, checkpoint_dir=ck, resume=True, **kw)
    assert resumed.resumed_step == 2 * SPE
    assert resumed.history["epoch"] == [3, 4]
    assert resumed.history["step_loss"] == full.history["step_loss"][2 * SPE:]
    assert resumed.history["train_loss"] == full.history["train_loss"][2:]
    assert _same_params(resumed, full)
    if recipe != "sgd":
        for slot in ("mu", "nu", "ema"):
            for name, t in getattr(full.state.opt_state, slot).items():
                assert torch.equal(getattr(resumed.state.opt_state, slot)[name], t)
        assert torch.equal(resumed.state.opt_state.sched_count,
                           full.state.opt_state.sched_count)


def test_mid_epoch_resume_skips_the_trained_prefix(uninterrupted, tmp_path, capsys):
    full = uninterrupted["sgd"]
    ck = str(tmp_path / "ck")
    _run_killed(75, epochs=4, checkpoint_dir=ck, checkpoint_steps=30)
    assert Checkpointer(ck).all_steps() == [30, 50, 60]
    capsys.readouterr()
    resumed = _run(epochs=4, checkpoint_dir=ck, resume=True, checkpoint_steps=30)
    out = capsys.readouterr().out
    assert "resumed from step 60" in out
    assert "mid-epoch resume: skipping the first 10 already-trained steps of epoch 2" in out
    assert resumed.history["step_loss"] == full.history["step_loss"][60:]
    assert resumed.history["epoch"] == [2, 3, 4]
    assert _same_params(resumed, full)


@pytest.mark.parametrize("direction", ["plain_into_ef", "ef_into_plain"])
def test_residual_tolerance(direction, tmp_path, caplog):
    ef = dict(grad_compress="int8", grad_compress_error_feedback=True)
    first, second = (({}, ef) if direction == "plain_into_ef" else (ef, {}))
    ck = str(tmp_path / "ck")
    _run(epochs=1, checkpoint_dir=ck, **first)
    with caplog.at_level(logging.WARNING):
        t = _trainer(epochs=2, checkpoint_dir=ck, resume=True, **second)
    if direction == "plain_into_ef":
        assert "starting the error-feedback residual from zero" in caplog.text
        assert all(torch.count_nonzero(v) == 0 for v in t.state.grad_residual.values())
    else:
        assert "residual this run does not use; discarding it" in caplog.text
        assert t.state.grad_residual is None
    assert t.resumed_step == SPE
    t.run()
    assert all(math.isfinite(x) for x in t.history["step_loss"])


def test_resume_from_the_jax_trainer_checkpoint(devices, tmp_path):
    import jax

    from tpu_ddp.checkpoint import Checkpointer as JaxCheckpointer
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
    from tpu_ddp.train.trainer import Trainer as JaxTrainer
    from tpu_ddp_torch.checkpoint.convert import from_jax
    from tpu_ddp_torch.train.state import checkpoint_state

    common = dict(synthetic_data=True, synthetic_size=200, per_shard_batch=4,
                  n_chans1=8, n_blocks=2, seed=0, momentum=0.9, n_devices=1,
                  prefetch_depth=0, log_every_epochs=1, checkpoint_every_epochs=2)
    jax_full = JaxTrainer(JaxTrainConfig(epochs=4, **common))
    jax_full.run()
    jax_ck = str(tmp_path / "jax_ck")
    jax_half = JaxTrainer(JaxTrainConfig(epochs=2, checkpoint_dir=jax_ck, **common))
    jax_half.run()
    restored = JaxCheckpointer(jax_ck).restore(jax_half.state)
    restored = jax.device_get(restored)
    assert int(restored.step) == 2 * SPE
    carried = from_jax(restored.params, restored.batch_stats, restored.opt_state)
    port_ck = str(tmp_path / "port_ck")
    Checkpointer(port_ck).save(int(restored.step), checkpoint_state(
        int(restored.step), carried["model"], carried["opt_state"]), wait=True)

    resumed = _run(epochs=4, checkpoint_dir=port_ck, resume=True, momentum=0.9)
    assert resumed.resumed_step == 2 * SPE and resumed.history["epoch"] == [3, 4]
    np.testing.assert_allclose(resumed.history["train_loss"],
                               jax_full.history["train_loss"][2:], rtol=1e-5)
