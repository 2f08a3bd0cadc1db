"""The trainer's loop over fused groups (``--steps-per-call``), the in-step
data path and accumulation, on one CPU rank (the JAX trainer's
``_epoch_stream`` :1439-1531 and its loop :2110-2130).

* ``--steps-per-call 4`` gives the per-step losses and params of single
  steps, bitwise, over epochs whose remainder (10 steps an epoch: two groups
  and two single steps) runs single; ``--checkpoint-steps 4`` saves once at
  each boundary a group crosses.
* Resume: a ``--steps-per-call 4 --checkpoint-steps 4`` run cut mid-epoch
  and resumed equals the uninterrupted run bitwise (losses and params); a
  group that straddles the resume point (a checkpoint of a run without
  fused groups) is replayed whole, as the JAX trainer replays it, so the run
  ends two steps later; ``--augment --mixup-alpha 0.2`` (with and without
  fused groups) cut and resumed equals the uninterrupted run bitwise, the
  draws being keyed on the step.
* The flight recorder under fused groups: one record a step, in order,
  the NaN batch's step alone non-finite and skipped under ``skip_step``,
  the per-layer norms on stride steps and the NaN step; under ``halt`` the
  run stops at the end of the call that tripped.
* ``--grad-accum-steps 2`` trains and its losses differ from the plain
  run's only as BatchNorm's microbatch statistics make them differ.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import math
import os

import numpy as np
import pytest
import torch

from tpu_ddp_torch.checkpoint.manager import Checkpointer
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer
from test_torch_resume import DieAt, Killed

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=40, per_shard_batch=4,
            n_chans1=6, n_blocks=2, seed=0, log_every_epochs=1, kernels=True,
            momentum=0.9)
SPE = 10                              # steps an epoch: 40 images, batch 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    t = Trainer(TrainConfig(**{**BASE, **kw}))
    t.run()
    t.close()
    return t


def _run_killed(at, **kw):
    # the shim wraps epoch_batches: the synchronous data path (the resumed
    # and uninterrupted runs take the default, the native ring)
    t = Trainer(TrainConfig(**{**BASE, **kw, "prefetch_depth": 0}))
    t.train_loader = DieAt(t.train_loader, at)
    with pytest.raises(Killed):
        t.run()
    t.close()
    return t


def _same_params(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def single():
    return _run(epochs=3)


def test_fused_groups_bitwise_single_steps(single, tmp_path):
    fused = _run(epochs=3, steps_per_call=4, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_steps=4, checkpoint_every_epochs=100)
    assert fused.steps_per_call == 4
    assert fused.history["step_loss"] == single.history["step_loss"]
    assert len(fused.history["step_loss"]) == 3 * SPE
    assert _same_params(fused, single)
    # calls end at 4, 8, 9, 10 | 14, 18, 19, 20 | 24, 28, 29, 30: a save where a
    # call crosses a multiple of 4, epoch 1's log save at 10, and the final one
    assert [s for s, _, _ in fused.save_ms] == [4, 8, 10, 14, 18, 20, 24, 28, 30]


def test_fused_resume_equals_uninterrupted(single, tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(steps_per_call=4, checkpoint_dir=ck, checkpoint_steps=4,
              checkpoint_every_epochs=100)
    _run_killed(2 * SPE + 7, epochs=3, **kw)         # inside epoch 3's second group
    assert Checkpointer(ck).latest_step() == 24
    resumed = _run(epochs=3, resume=True, **kw)
    assert resumed.resumed_step == 24
    assert resumed.history["step_loss"] == single.history["step_loss"][24:]
    assert _same_params(resumed, single)


def test_straddling_group_is_replayed(tmp_path):
    ck = str(tmp_path / "ck")
    _run_killed(7, epochs=2, checkpoint_dir=ck, checkpoint_steps=6,
                checkpoint_every_epochs=100)
    assert Checkpointer(ck).latest_step() == 6
    resumed = _run(epochs=2, resume=True, steps_per_call=4, checkpoint_dir=ck,
                   checkpoint_every_epochs=100)
    # group [4, 8) is replayed from step 6: 4 + 2 singles, then epoch 2
    assert len(resumed.history["step_loss"]) == 4 + 2 + SPE
    assert int(resumed.state.step) == 2 * SPE + 2


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_augment_mixup_resume_equals_uninterrupted(steps_per_call, tmp_path):
    kw = dict(augment=True, mixup_alpha=0.2, steps_per_call=steps_per_call)
    full = _run(epochs=3, **kw)
    assert all(math.isfinite(x) for x in full.history["step_loss"])
    plain = _run(epochs=1)
    assert full.history["step_loss"][:SPE] != plain.history["step_loss"]
    ck = str(tmp_path / "ck")
    _run_killed(SPE + 9, epochs=3, checkpoint_dir=ck, checkpoint_steps=4,
                checkpoint_every_epochs=100, **kw)
    step = Checkpointer(ck).latest_step()
    assert step in (16, 18)                   # single steps save at 16, groups at 18
    resumed = _run(epochs=3, resume=True, checkpoint_dir=ck, checkpoint_every_epochs=100,
                   **kw)
    assert resumed.history["step_loss"] == full.history["step_loss"][step:]
    assert _same_params(resumed, full)


def _records(run_dir):
    with open(os.path.join(run_dir, "health-p0.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["type"] == "health"]


class NanAt:
    """The train loader with its ``at``-th batch all NaN."""

    def __init__(self, inner, at):
        self._inner, self._at, self._seen = inner, at, 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, *args, **kwargs):
        for batch in self._inner.epoch_batches(*args, **kwargs):
            if self._seen == self._at:
                batch = dict(batch, image=np.full_like(batch["image"], np.nan))
            self._seen += 1
            yield batch


@pytest.mark.parametrize("policy", ["skip_step", "halt"])
def test_health_records_under_fused_groups(policy, tmp_path):
    run_dir = str(tmp_path / policy)
    t = Trainer(TrainConfig(**{**BASE, "epochs": 2, "steps_per_call": 4, "health": "on",
                               "health_policy": policy, "health_per_layer_stride": 3,
                               "health_dir": run_dir, "prefetch_depth": 0}))
    t.train_loader = NanAt(t.train_loader, 5)   # wraps the synchronous path
    out = t.run()
    t.close()
    recs = _records(run_dir)
    bad = [r["step"] for r in recs if not r["all_finite"]]
    if policy == "halt":
        # the call holding step 5 (steps 4..7) runs to its end on the poisoned
        # params (halt builds no guard), then the run stops
        assert bad == [5, 6, 7]
        assert out["health_halted"] and [r["step"] for r in recs] == list(range(8))
        assert int(t.state.step) == 8
        return
    assert bad == [5]
    assert [r["step"] for r in recs] == list(range(2 * SPE))
    assert [r["step"] for r in recs if "per_layer" in r] == [0, 3, 5, 6, 9, 12, 15, 18]
    assert all(torch.isfinite(p).all() for p in t.state.params().values())


def test_grad_accum_trains():
    plain, accum = _run(epochs=2), _run(epochs=2, grad_accum_steps=2)
    losses = accum.history["step_loss"]
    assert len(losses) == 2 * SPE and all(math.isfinite(x) for x in losses)
    assert losses != plain.history["step_loss"]
    assert np.allclose(losses[0], plain.history["step_loss"][0], rtol=0.2)
