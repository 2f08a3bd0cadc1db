"""Shared by the tests of the port's run-dir readers
(``tests/test_torch_ledger.py``, ``test_torch_curves.py``,
``test_torch_registry.py``, ``test_torch_cli_main.py``): small port runs on
the CPU that write run dirs, and the one mapping between the two packages'
outputs.

The runs are NetResDeep at ``n_chans1=8, n_blocks=2`` on 320 synthetic rows
at batch 32 (10 steps an epoch), one rank, ``--health on``, the JSONL trace
sink and step-cadence checkpoints. A killed life raises out of ``run`` as
the loader hands it batch ``kill_at``, after the step-``CHECKPOINT_STEPS``
checkpoint has committed, and writes nothing from then on: its telemetry
sinks are dropped before the raise unwinds the open spans, its watchdog
stops without a last heartbeat, and it is never closed, so no ``run_end``
lands. That is the trace a SIGKILL leaves. A hung life first stalls past the
hang watchdog's deadline, so its trace ends with ``watchdog_hang``.

The outputs differ in two names only: the port reads and writes
``torch_version`` where the JAX package has ``jax_version``, and its command
is ``tpu-ddp-torch`` where the JAX one is ``tpu-ddp``.
"""

import json
import time

CHECKPOINT_STEPS = 4
KILL_AT = 7

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=320, per_shard_batch=32,
            epochs=1, n_chans1=8, n_blocks=2, prefetch_depth=0, log_every_epochs=1,
            health="on", telemetry_sinks="jsonl", telemetry_snapshot_steps=3)


class Killed(Exception):
    pass


class _DieAt:
    """The train loader of ``trainer``, killing the life (module docstring)
    when the run asks for its batch ``at`` (counted over the run), once the
    step-``CHECKPOINT_STEPS`` checkpoint has committed; with ``stall_s`` it
    first sits that long."""

    def __init__(self, trainer, at, stall_s=0.0):
        self._trainer, self._inner = trainer, trainer.train_loader
        self._at, self._seen, self._stall = at, 0, stall_s
        self._ck = trainer.config.checkpoint_dir

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, *args, **kwargs):
        from tpu_ddp_torch.checkpoint.manifest import latest_verified_step

        for batch in self._inner.epoch_batches(*args, **kwargs):
            if self._seen == self._at:
                deadline = time.monotonic() + 60
                while latest_verified_step(self._ck)[0] != CHECKPOINT_STEPS:
                    assert time.monotonic() < deadline, "the checkpoint never committed"
                    time.sleep(0.01)
                time.sleep(self._stall)
                self._trainer.telemetry.sinks = []
                if self._trainer._watchdog is not None:
                    self._trainer._watchdog._stop.set()
                raise Killed
            self._seen += 1
            yield batch


def port_run(run_dir, *, kill_at=None, stall_s=0.0, **kw):
    """One life of the port's trainer writing ``run_dir`` (checkpoints under
    ``run_dir/ckpt``); returns the trainer. ``kill_at``: the life dies as
    it takes that batch (module docstring); ``stall_s`` > 0 with a watchdog
    deadline below it makes that death a hang."""
    import os

    from tpu_ddp_torch.telemetry import reset_default_registry
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    reset_default_registry()
    ck = os.path.join(run_dir, "ckpt")
    t = Trainer(TrainConfig(**{**BASE, "telemetry_dir": run_dir, "checkpoint_dir": ck,
                               "checkpoint_steps": CHECKPOINT_STEPS, **kw}))
    if kill_at is None:
        metrics = t.run()
        t.record_final_eval(accuracy=metrics.get("test_accuracy"))
        t.close()
        return t
    t.train_loader = _DieAt(t, kill_at, stall_s)
    try:
        t.run()
    except Killed:
        return t
    raise AssertionError("the life was not killed")


def incident(run_dir, **kw):
    """A life killed at ``KILL_AT``, then ``--resume``d to the end."""
    first = port_run(run_dir, kill_at=KILL_AT, **kw)
    time.sleep(0.2)                   # a restart gap for the ledger to book
    second = port_run(run_dir, resume=True, **kw)
    assert (first.incarnation, second.incarnation) == (0, 1)
    assert second.resumed_step == CHECKPOINT_STEPS
    return run_dir


def jax_names(obj):
    """The port's output with the command named as the JAX package names
    it (``tpu-ddp-torch`` -> ``tpu-ddp``), through a JSON round trip."""
    if isinstance(obj, str):
        return obj.replace("tpu-ddp-torch", "tpu-ddp")
    return json.loads(json.dumps(obj).replace("tpu-ddp-torch", "tpu-ddp"))


def _without(obj, key, found):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == key:
                found.append(v)
            else:
                out[k] = _without(v, key, found)
        return out
    if isinstance(obj, list):
        return [_without(v, key, found) for v in obj]
    return obj


def assert_same(port, jax_, torch_version=None, jax_version=None):
    """``port`` equals ``jax_`` once ``torch_version`` stands for
    ``jax_version``: equal with both keys taken out, every ``torch_version``
    the port wrote is the run's own (``torch_version``: None on a run dir
    the JAX package wrote) and every ``jax_version`` the JAX package wrote
    is ``jax_version``. Floats compare exactly."""
    port_versions, jax_versions = [], []
    p = _without(jax_names(port), "torch_version", port_versions)
    j = _without(json.loads(json.dumps(jax_)), "jax_version", jax_versions)
    assert p == j
    assert all(v == torch_version for v in port_versions), port_versions
    assert all(v == jax_version for v in jax_versions), jax_versions
    return port_versions, jax_versions


def header_meta(run_dir, name="trace-p0.jsonl"):
    import os

    with open(os.path.join(run_dir, name)) as f:
        return json.loads(f.readline())["run_meta"]
