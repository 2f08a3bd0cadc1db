"""``--lint-on-start``: the graph lint over the run's own step before the
first (``Trainer.lint_preflight``, the JAX ``lint_preflight``).

- The audit runs the step once on a synthetic batch and puts every state
  tensor, the RNG states and the launch counts back: a run with the flag
  gives bitwise the losses, params and optimizer state of the run without,
  for the plain step, the fused call (``--steps-per-call``, linted too as
  ``<label>+scan``), AdamW with clip and EMA, and the flight recorder's
  ``skip_step``.
- A violating step is refused with the JAX message's head, the state put
  back after the audit; ``raise_on_error=False`` returns the findings.
- ``--comms-monitor --lint-on-start`` is refused with the JAX message; the
  flag reaches the config as in the JAX CLI.
- Over two gloo ranks (the launcher): the int8 ring's run with the flag is
  bitwise the run without on each rank, and a violation on rank 1 alone
  refuses the launch on both (``parallel/runtime.py::agree_any``).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import subprocess
import sys

import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.train.trainer import COMMS_MONITOR_LINT_REFUSAL, TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT)

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=256, epochs=2,
            per_shard_batch=32, n_chans1=8, n_blocks=2, kernels=True, prefetch_depth=0,
            log_every_epochs=1)
RECIPES = {
    "sgd": dict(momentum=0.9),
    "scan": dict(momentum=0.9, steps_per_call=2),
    "adamw_clip_ema": dict(optimizer="adamw", lr=1e-3, grad_clip_norm=1.0, ema_decay=0.9),
    "skip_step": dict(momentum=0.9, health="on", health_policy="skip_step"),
}


def _state(trainer):
    out = {f"model/{k}": v.clone() for k, v in trainer.state.model.state_dict().items()}
    for section, name, t, _, _ in trainer.layout.leaves(trainer.state):
        out[f"{section}/{name}"] = t.detach().clone()
    return out


def _run(lint, **kw):
    ops.reset_launch_counts()
    trainer = Trainer(TrainConfig(lint_on_start=lint, **BASE, **kw))
    try:
        trainer.run()
        return trainer, list(trainer.history["step_loss"]), _state(trainer), ops.launch_counts()
    finally:
        trainer.close()


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_lint_on_start_is_bitwise(recipe, capsys):
    _, losses, state, launches = _run(False, **RECIPES[recipe])
    trainer, losses_l, state_l, launches_l = _run(True, **RECIPES[recipe])
    out = capsys.readouterr().out
    assert "tpu-ddp-torch lint: preflight (dp): clean" in out
    assert losses_l == losses and len(losses) == 16
    assert _same(state_l, state)
    assert launches_l == launches
    assert set(trainer.preflight_launches) == set(ops.KERNELS)


def _out_of_place(step):
    """``step`` with its update left in fresh tensors (the DON001 fault)."""
    def run(state, batch):
        state, metrics = step(state, batch)
        with torch.no_grad():
            for p in state.model.parameters():
                p.data = p.data.clone()
            state.opt_state.trace = {n: v.clone() for n, v in state.opt_state.trace.items()}
        return state, metrics
    return run


@pytest.mark.parametrize("scan", [False, True])
def test_preflight_refuses_a_violating_program(scan):
    trainer = Trainer(TrainConfig(**BASE, momentum=0.9, steps_per_call=2 if scan else 1))
    try:
        if scan:
            trainer.multi_step = _out_of_place(trainer.multi_step)
        else:
            trainer.train_step = _out_of_place(trainer.train_step)
        before = _state(trainer)
        with pytest.raises(RuntimeError, match="lint preflight refused the launch"):
            trainer.lint_preflight()
        assert _same(_state(trainer), before)
        findings = trainer.lint_preflight(raise_on_error=False)
        assert [(f.rule, f.program) for f in findings] == [
            ("DON001", "dp+scan" if scan else "dp")]
        assert _same(_state(trainer), before)
    finally:
        trainer.close()


def test_comms_monitor_refusal_is_the_jax_one(tmp_path):
    from tpu_ddp.train.trainer import TrainConfig as JaxConfig

    kw = dict(synthetic_data=True, comms_monitor=True, lint_on_start=True,
              telemetry_dir=str(tmp_path / "run"))
    with pytest.raises(ValueError) as port:
        TrainConfig(device="cpu", **kw)
    with pytest.raises(ValueError) as jax_:
        JaxConfig(**kw).validate()
    assert str(port.value) == str(jax_.value) == COMMS_MONITOR_LINT_REFUSAL


def test_the_flag_reaches_the_config_as_in_jax():
    from tpu_ddp.cli.train import build_parser as jax_parser
    from tpu_ddp_torch.cli import train as cli

    assert cli.config_from_args(cli.build_parser().parse_args(
        ["--lint-on-start"])).lint_on_start is True
    assert cli.build_parser().parse_args([]).lint_on_start is False
    assert jax_parser().parse_args([]).lint_on_start is False


RANK_SCRIPT = """
import json, sys
import torch
from tpu_ddp_torch.parallel import runtime
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

def config(lint):
    return TrainConfig(device="cpu", synthetic_data=True, synthetic_size=128, epochs=1,
                       per_shard_batch=16, n_chans1=8, n_blocks=2, kernels=True,
                       momentum=0.9, grad_compress="int8", prefetch_depth=0,
                       log_every_epochs=1, lint_on_start=lint)

runtime.initialize_distributed("cpu", "gloo")
rank, out = runtime.rank(), {}
for lint in (False, True):
    trainer = Trainer(config(lint))
    trainer.run()
    out[str(lint)] = list(trainer.history["step_loss"])
    out[str(lint) + "_w"] = [v.sum().item() for v in trainer.state.model.state_dict().values()]
    trainer.close()
trainer = Trainer(config(True))
if rank == 1:
    inner = trainer.train_step

    def out_of_place(state, batch):
        state, metrics = inner(state, batch)
        with torch.no_grad():
            for p in state.model.parameters():
                p.data = p.data.clone()
            state.opt_state.trace = {n: v.clone() for n, v in state.opt_state.trace.items()}
        return state, metrics

    trainer.train_step = out_of_place
try:
    trainer.run()
    out["refused"] = None
except RuntimeError as e:
    out["refused"] = str(e)
trainer.close()
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump(out, f)
runtime.shutdown()
"""


def test_two_ranks_agree(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANK_SCRIPT)
    rc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2", "--",
         sys.executable, str(script), str(tmp_path)],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert rc.returncode == 0, rc.stderr[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    for r, got in enumerate(ranks):
        assert got["True"] == got["False"] and len(got["False"]) == 4, r
        assert got["True_w"] == got["False_w"], r
        assert got["refused"] and "lint preflight refused the launch" in got["refused"], r
    assert "another rank's" in ranks[0]["refused"] and "another" not in ranks[1]["refused"]
