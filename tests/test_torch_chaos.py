"""The port's chaos injection (``tpu_ddp_torch/chaos/inject.py``) against the
JAX package's (``tpu_ddp/chaos/inject.py``), the JAX tests' hand-built cases
(``tests/test_chaos.py``) as the oracle:

- ``load_spec`` and the trainer config's ``--chaos``/``--comms-monitor``
  guards accept and refuse the same specs with the same messages;
- the fire-once contract across a restart, host targeting, ``data_stall``,
  ``comm_stall`` and ``save_io_flake``'s counts: both injectors fed the same
  calls leave the same ``chaos-state.json``;
- ``save_io_flake`` through the port's ``Checkpointer.fault_hook`` (the
  retries absorb it, a save whose every attempt fails raises when waited on);
- ``kill_host``'s exit code and ``capacity.json`` (``os._exit`` stubbed);
- ``checkpoint_corrupt`` on the port's checkpoints: the manifest refuses the
  corrupted step by name and ``restore`` falls back to the older one.
"""

import json
import os

import pytest
import torch

from tpu_ddp.chaos import inject as jax_inject
from tpu_ddp_torch.chaos import inject as port_inject
from tpu_ddp_torch.checkpoint import manifest
from tpu_ddp_torch.checkpoint.manager import Checkpointer


def _spec(tmp_path, faults, name="spec.json", **extra):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump({"chaos_schema_version": 1, "seed": 0, "faults": faults, **extra}, f)
    return path


GOOD = [
    {"kind": "kill_host", "step": 6, "survivors": 4},
    {"kind": "hang", "step": 5},
    {"kind": "checkpoint_corrupt", "step": 7, "await_step": 6},
    {"kind": "save_io_flake", "step": 2, "times": 2},
    {"kind": "data_stall", "step": 3, "stall_s": 0.5},
    {"kind": "data_stall", "step": 3, "stage": "gather", "batches": 2},
    {"kind": "comm_stall", "step": 4, "delay_s": 1.5, "hops": 2},
]

SPECS = {
    "good": (GOOD, {}),
    "unknown_kind": ([{"kind": "melt_down", "step": 1}], {}),
    "no_step": ([{"kind": "hang"}], {}),
    "negative_step": ([{"kind": "hang", "step": -1}], {}),
    "bad_process_index": ([{"kind": "hang", "step": 1, "process_index": -2}], {}),
    "flake_times": ([{"kind": "save_io_flake", "step": 1, "times": 0}], {}),
    "await_step": ([{"kind": "checkpoint_corrupt", "step": 1, "await_step": -1}], {}),
    "survivors": ([{"kind": "kill_host", "step": 1, "survivors": 0}], {}),
    "stall_s": ([{"kind": "data_stall", "step": 1, "stall_s": -1}], {}),
    "stage": ([{"kind": "data_stall", "step": 1, "stage": "decode"}], {}),
    "batches": ([{"kind": "data_stall", "step": 1, "stage": "index", "batches": 0}], {}),
    "delay_s": ([{"kind": "comm_stall", "step": 1, "delay_s": 0}], {}),
    "hops": ([{"kind": "comm_stall", "step": 1, "hops": 0}], {}),
    "empty": ([], {}),
    "not_an_object": ([7], {}),
    "future_schema": ([{"kind": "hang", "step": 1}], {"chaos_schema_version": 99}),
    "seed": ([{"kind": "hang", "step": 1}], {"seed": "x"}),
}


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "refused", str(e)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_load_spec_accepts_and_refuses_as_jax(tmp_path, case):
    faults, extra = SPECS[case]
    path = _spec(tmp_path, faults, **extra)
    port, jax_ = _outcome(lambda: port_inject.load_spec(path)), \
        _outcome(lambda: jax_inject.load_spec(path))
    assert port == jax_
    assert port[0] == ("ok" if case == "good" else "refused")


def _stall(kind, **kw):
    return {"kind": kind, "step": 1, **kw}


#: (config fields, chaos faults or None): the guards of --chaos and
#: --comms-monitor, accepted and refused
GUARDS = {
    "monitor_needs_telemetry": (dict(comms_monitor=True), None, False),
    "monitor_with_telemetry": (dict(comms_monitor=True), None, True),
    "chaos_needs_telemetry": ({}, [_stall("hang")], False),
    "chaos_bad_kind": ({}, [_stall("bogus")], True),
    "comm_stall_needs_monitor": ({}, [_stall("comm_stall")], True),
    "comm_stall_with_monitor": (dict(comms_monitor=True), [_stall("comm_stall")], True),
    "stage_stall_on_the_native_ring": ({}, [_stall("data_stall", stage="gather")], True),
    "stage_stall_staged": (dict(prefetch_batches=2), [_stall("data_stall", stage="gather")],
                           True),
    "stage_stall_synchronous": (dict(prefetch_depth=0),
                                [_stall("data_stall", stage="gather")], True),
    "whole_step_stall": ({}, [_stall("data_stall")], True),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_config_guards_as_jax(tmp_path, case):
    from tpu_ddp.train.trainer import TrainConfig as JaxConfig
    from tpu_ddp_torch.train.trainer import TrainConfig

    fields, faults, telemetry = GUARDS[case]
    kw = dict(fields, synthetic_data=True)
    if faults is not None:
        kw["chaos_spec"] = _spec(tmp_path, faults)
    if telemetry:
        kw["telemetry_dir"] = str(tmp_path / "run")
    port = _outcome(lambda: TrainConfig(**kw) and None)
    jax_ = _outcome(lambda: JaxConfig(**kw).validate() and None)
    assert port == jax_


def test_lint_refusal_message_as_jax(tmp_path):
    """The port keeps the JAX refusal of --comms-monitor with
    --lint-on-start word for word, for the day the lint is ported."""
    from tpu_ddp.train.trainer import TrainConfig as JaxConfig
    from tpu_ddp_torch.train.trainer import COMMS_MONITOR_LINT_REFUSAL

    jax_ = _outcome(lambda: JaxConfig(
        synthetic_data=True, comms_monitor=True, lint_on_start=True,
        telemetry_dir=str(tmp_path / "run")).validate())
    assert jax_ == ("refused", COMMS_MONITOR_LINT_REFUSAL)


def _pair(tmp_path, faults, **kw):
    """A port and a JAX injector on the same spec, each with a run dir."""
    path = _spec(tmp_path, faults)
    out = []
    for name, mod in (("port", port_inject), ("jax", jax_inject)):
        run_dir = str(tmp_path / name)
        os.makedirs(run_dir, exist_ok=True)
        out.append((run_dir, lambda mod=mod, run_dir=run_dir, **extra: mod.ChaosInjector(
            path, run_dir, **{**kw, **extra})))
    return out


def _state(run_dir):
    with open(os.path.join(run_dir, "chaos-state.json")) as f:
        return json.load(f)


def test_fire_once_across_a_restart_as_jax(tmp_path):
    states = []
    for run_dir, make in _pair(tmp_path, [{"kind": "data_stall", "step": 2, "stall_s": 0.0},
                                          {"kind": "hang", "step": 3, "hang_s": 0.0}]):
        inj = make()
        inj.on_step(1)
        assert inj._load_state()["fired"] == []
        inj.on_step(2)
        assert _state(run_dir)["fired"] == [0]
        again = make()                 # a resumed life past both triggers
        again.on_step(5)
        states.append(_state(run_dir))
    assert states[0] == states[1] == {"fired": [0, 1], "flake_remaining": {},
                                      "stall_remaining": {}}


@pytest.mark.parametrize("pid", [0, 3])
def test_faults_target_their_host_as_jax(tmp_path, pid):
    fired = []
    for run_dir, make in _pair(tmp_path, [{"kind": "data_stall", "step": 1,
                                           "process_index": 3, "stall_s": 0.0}]):
        inj = make(process_index=pid)
        inj.on_step(9)
        fired.append(inj._load_state()["fired"])
    assert fired[0] == fired[1] == ([0] if pid == 3 else [])


def test_hook_faults_count_down_as_jax(tmp_path):
    """comm_stall and the stage-targeted data_stall fire from their seams,
    once ``on_step`` has passed the step before the trigger; their counts
    persist across a restart."""
    faults = [{"kind": "comm_stall", "step": 3, "delay_s": 1e-3, "hops": 2, "axis": "data"},
              {"kind": "data_stall", "step": 2, "stage": "gather", "stall_s": 0.0,
               "batches": 1},
              {"kind": "save_io_flake", "step": 3, "times": 2}]
    states = []
    for run_dir, make in _pair(tmp_path, faults):
        inj = make()
        inj.on_step(1)
        inj.comm_stall_hook("data", 1)        # during step 2: not yet
        inj.data_stall_hook("gather")         # during step 2: due
        inj.data_stall_hook("gather")         # spent
        inj.on_step(2)
        inj.comm_stall_hook("model", 1)       # another axis
        inj.comm_stall_hook("data", 1)
        with pytest.raises(OSError, match="injected save IO failure"):
            inj.save_fault_hook(3, 0)
        again = make()
        again.on_step(2)
        again.comm_stall_hook("data", 2)
        again.comm_stall_hook("data", 1)      # spent
        with pytest.raises(OSError):
            again.save_fault_hook(3, 1)
        again.save_fault_hook(3, 2)           # spent: the save goes through
        assert again.wants_comm_stall() and again.wants_data_stall_stage()
        states.append(_state(run_dir))
    assert states[0] == states[1]
    assert sorted(states[0]["fired"]) == [0, 1, 2]


def test_save_io_flake_through_the_checkpointer(tmp_path):
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    inj = port_inject.ChaosInjector(
        _spec(tmp_path, [{"kind": "save_io_flake", "step": 3, "times": 2}]), run_dir)
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, fault_hook=inj.save_fault_hook, save_retry_base_s=0.01)
    ck.save(3, {"w": torch.arange(16.0)}, wait=True)
    assert ck.counters["save_retries"] == 2
    assert manifest.verify_step(d, 3) == (True, [])
    ck.close()
    # every attempt failing: a background save is dropped, a waited one raises
    os.makedirs(tmp_path / "run2")
    dead = port_inject.ChaosInjector(
        _spec(tmp_path, [{"kind": "save_io_flake", "step": 1, "times": 9}], "dead.json"),
        str(tmp_path / "run2"))
    ck = Checkpointer(str(tmp_path / "ck2"), fault_hook=dead.save_fault_hook,
                      save_attempts=2, save_retry_base_s=0.01)
    with pytest.raises(OSError, match="injected save IO failure"):
        ck.save(4, {"w": torch.arange(4.0)}, wait=True)
    ck.close()


def test_kill_host_exit_code_and_capacity_as_jax(tmp_path, monkeypatch):
    exits, caps = [], []
    monkeypatch.setattr(os, "_exit", lambda code: exits.append(code))
    for run_dir, make in _pair(tmp_path, [{"kind": "kill_host", "step": 6, "survivors": 4}]):
        make().on_step(6)
        with open(port_inject.capacity_file(run_dir)) as f:
            cap = json.load(f)
        caps.append({k: v for k, v in cap.items() if k != "wall_time"})
        assert _state(run_dir)["fired"] == [0]
    assert exits == [port_inject.KILL_EXIT_CODE, jax_inject.KILL_EXIT_CODE] == [137, 137]
    assert caps[0] == caps[1] == {"capacity_schema_version": 1, "devices": 4,
                                  "source": "chaos kill_host fault #0"}


def test_checkpoint_corrupt_is_refused_and_restore_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    ck.save(2, {"w": torch.arange(64.0)}, wait=True)
    ck.save(4, {"w": torch.arange(64.0) * 2}, wait=True)
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    inj = port_inject.ChaosInjector(
        _spec(tmp_path, [{"kind": "checkpoint_corrupt", "step": 5, "await_step": 4,
                          "timeout_s": 2}]), run_dir, checkpoint_dir=d)
    inj.on_step(5)
    verdict, problems = manifest.verify_step(d, 4)
    assert verdict is False and any("state.pt" in p for p in problems)
    assert ck.verified_restore_step() == 2
    assert torch.equal(ck.restore()["w"], torch.arange(64.0))
    with pytest.raises(ValueError, match="step 4 REFUSED"):
        ck.restore(step=4)
    ck.close()
    with pytest.raises(ValueError, match="needs a checkpoint dir"):
        port_inject.ChaosInjector(
            _spec(tmp_path, [{"kind": "checkpoint_corrupt", "step": 1}], "c.json"), run_dir)
