"""The port's elastic runtime (``tpu_ddp_torch/elastic/``) against the JAX
package's (``tpu_ddp/elastic/``), the JAX tests' cases
(``tests/test_elastic.py``) as the inputs:

- the restart policy, its budgets and its seeded backoff; ``plan_remesh``'s
  shrinks and refusals and ``fallback_from_tune``'s rank walk; the argv
  surgery; ``classify_exit`` and ``count_families``; ``read_capacity`` and
  ``resume_assessment``: each equal to its JAX counterpart on the same
  inputs;
- the supervisor loop with the JAX tests' scripted fake child
  (``FakeFleet``) run through both ``Supervisor`` classes in turn, in the
  same run dir: the same child argv, the same exit code and the same
  ``elastic.jsonl`` records, ``wall_time`` aside;
- the compressed ring at one rank (what a shrink to one rank runs): the
  port's and the JAX ring both hand the tensor back untouched, with a zero
  error;
- two ranks' ``kill_host`` faults firing at one step: both stay fired in
  the shared ``chaos-state.json``, so the resumed life does not re-fire its
  own;
- one real supervised run on the CPU: NetResDeep at two gloo ranks through
  ``python -m tpu_ddp_torch.cli.main elastic train``, both ranks lost at
  step 6 after the step-4 checkpoint, the run re-meshed to one rank and
  resumed from the verified step 4.

The outputs differ in the command's name (``tpu-ddp-torch`` for
``tpu-ddp``) and in DIA003's action.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
from test_elastic import FakeFleet, _fake_ckpt, _write_trace
from torch_readers import jax_names

import tpu_ddp.elastic as jax_elastic
import tpu_ddp_torch.elastic as port_elastic
from tpu_ddp.diagnose import rules as jax_rules
from tpu_ddp.elastic import supervisor as jax_sup
from tpu_ddp_torch.diagnose import rules as port_rules
from tpu_ddp_torch.elastic import supervisor as port_sup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("port", port_elastic, port_sup), ("jax", jax_elastic, jax_sup))


def _as_jax(obj):
    text = jax_names(json.dumps(obj)).replace(
        jax_names(port_rules.RULES["DIA003"]["action"]), jax_rules.RULES["DIA003"]["action"])
    return json.loads(text)


def _outcome(fn):
    try:
        out = fn()
    except (ValueError, port_elastic.RemeshRefusal, jax_elastic.RemeshRefusal) as e:
        return "refused", type(e).__name__, jax_names(str(e))
    if dataclasses.is_dataclass(out):
        out = out.to_json() if hasattr(out, "to_json") else dataclasses.asdict(out)
    return "ok", json.loads(json.dumps(out))


def _same(fn):
    """``fn(elastic_package, supervisor_module)`` gives the same outcome
    for the port and the JAX package; returns it."""
    port, jax_ = (_outcome(lambda m=m, s=s: fn(m, s)) for _, m, s in PACKAGES)
    assert port == jax_
    return port


def test_all_is_the_jax_all():
    assert port_elastic.__all__ == jax_elastic.__all__
    assert port_elastic.DEFAULT_BUDGETS == jax_elastic.DEFAULT_BUDGETS


# -- policy -----------------------------------------------------------------

POLICIES = {
    "killed_budget": ({"killed": 2}, ["killed"] * 3),
    "preempted_unbounded": (None, ["preempted"] * 50),
    "health_halt": (None, ["health_halt"]),
    "unknown_class": (None, ["exotic_future_class"] * 2),
    "independent_classes": ({"killed": 1, "hang": 1}, ["killed", "hang", "killed"]),
    "oom": (None, ["oom"] * 2),
    "hang": (None, ["hang"] * 4),
    "spawn_failure": (None, ["spawn_failure"] * 3),
}


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_restart_policy_as_jax(case):
    budgets, deaths = POLICIES[case]

    def decisions(m, _):
        policy = m.RestartPolicy(budgets, m.BackoffPolicy(base_s=1.0, seed=7))
        return [dataclasses.asdict(policy.decide(d)) for d in deaths]

    assert _same(decisions)[0] == "ok"


@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_jitter_as_jax(seed):
    def delays(m, _):
        out = []
        for base, cap, jitter in ((1.0, 60.0, 0.25), (0.5, 4.0, 0.0), (0.0, 60.0, 0.25)):
            b = m.BackoffPolicy(base_s=base, cap_s=cap, jitter_frac=jitter, seed=seed)
            out += [b.delay_s(k, n) for k in ("killed", "preempted", "oom")
                    for n in range(0, 9)]
        return out

    assert _same(delays)[0] == "ok"


@pytest.mark.parametrize("text", [None, "", "killed=9,hang=0", " killed = 3 , ,oom=2",
                                  "melted=1", "killed", "killed=x"])
def test_parse_budgets_as_jax(text):
    _same(lambda m, _: m.parse_budgets(text))


# -- re-mesh ----------------------------------------------------------------

REMESH = {
    "data_only": dict(n_devices=4, global_batch=64),
    "one_rank": dict(n_devices=1, global_batch=64),
    "keeps_model": dict(n_devices=4, parallelism="tp", mesh={"data": 4, "model": 2}),
    "keeps_sequence": dict(n_devices=6, parallelism="sp", mesh={"data": 2, "sequence": 2}),
    "data_axis_given": dict(n_devices=3, mesh={"data": 8}),
    "model_does_not_divide": dict(n_devices=3, parallelism="tp",
                                  mesh={"data": 4, "model": 2}),
    "batch_does_not_divide": dict(n_devices=3, global_batch=64),
    "no_survivors": dict(n_devices=0),
    "unknown_axis": dict(n_devices=4, mesh={"warp": 2}),
    "fallback_source": dict(n_devices=4, parallelism="tp", mesh={"model": 2},
                            source="fallback"),
}


@pytest.mark.parametrize("case", sorted(REMESH))
def test_plan_remesh_as_jax(case):
    out = _same(lambda m, _: m.plan_remesh(**REMESH[case]))
    if out[0] == "ok":
        _same(lambda m, _: m.plan_remesh(**REMESH[case]).mesh_arg())


def test_mesh_axes_are_the_ports_mesh_axes():
    from tpu_ddp_torch.elastic.remesh import MESH_AXES
    from tpu_ddp_torch.parallel.mesh import AXIS_ORDER

    assert MESH_AXES == AXIS_ORDER == jax_elastic.remesh.MESH_AXES


TUNE = {
    "walks_to_dp": [{"name": "tp_m2", "parallelism": "tp", "mesh": {"data": 4, "model": 2},
                     "per_shard_batch": 8},
                    {"name": "dp_plain", "parallelism": "dp", "mesh": {"data": 8},
                     "zero1": True, "grad_compress": "int8", "steps_per_call": 4,
                     "per_shard_batch": 8}],
    "none_fits": [{"name": "tp_m2", "parallelism": "tp", "mesh": {"data": 2, "model": 2}}],
    "status_skipped": [{"name": "bad", "status": "lint_failed", "mesh": {"data": 2}},
                       {"name": "ok", "status": "ok", "mesh": {"data": 2},
                        "grad_compress": "none"}],
    "empty": [],
    "not_a_list": {"x": 1},
}


@pytest.mark.parametrize("case", sorted(TUNE) + ["missing"])
@pytest.mark.parametrize("survivors,batch", [(3, None), (2, 64), (3, 64)])
def test_fallback_from_tune_as_jax(tmp_path, case, survivors, batch):
    path = str(tmp_path / "tune.json")
    if case != "missing":
        with open(path, "w") as f:
            json.dump({"tune_schema_version": 1, "ranked": TUNE[case]}, f)
    _same(lambda m, _: m.fallback_from_tune(path, n_devices=survivors, global_batch=batch))


# -- argv surgery, classification, capacity, recovery -----------------------

ARGS = ["--epochs", "2", "--n-devices", "8", "--mesh=data=8", "--resume", "--lr", "0.1",
        "--telemetry-dir", "/r", "--grad-compress", "int8", "--zero1", "--parallelism",
        "dp", "--steps-per-call", "4", "--checkpoint-dir", "--lr"]


def test_child_flag_value_and_strip_flag_as_jax():
    def flags(_, s):
        values = {f: s.child_flag_value(ARGS, f) for f in (
            "--n-devices", "--mesh", "--epochs", "--lr", "--checkpoint-dir", "--absent")}
        stripped = {f: s.strip_flag(list(ARGS), f, has)
                    for f, has in s._MANAGED_FLAGS.items()}
        return values, stripped, dict(s._MANAGED_FLAGS)

    assert _same(flags)[0] == "ok"


@pytest.mark.parametrize("resume", [False, True])
def test_rewrite_child_args_as_jax(resume):
    def rewrite(m, s):
        out = []
        for kw in REMESH.values():
            try:
                plan = m.plan_remesh(**kw)
            except m.RemeshRefusal:
                continue
            if plan.source == "fallback":
                plan.extra_flags = {"--zero1": "", "--grad-compress": "int8"}
            out.append(s.rewrite_child_args(ARGS, plan, resume=resume))
        return out

    assert _same(rewrite)[0] == "ok"


def test_classify_exit_and_count_families_as_jax(tmp_path):
    run_dir = str(tmp_path / "run")
    got = []
    for step, kw in enumerate([None, dict(run_end=False), dict(run_end=False, hang=True),
                               dict(run_end=True, preempt=True), dict(run_end=True)]):
        if kw is not None:
            _write_trace(run_dir, step - 1, **kw)
        got.append(_same(lambda _, s: [s.count_families(run_dir)] + [
            s.classify_exit(run_dir, prior) for prior in (max(step - 1, 0), step)])[1])
    assert got == [[0, None, None], [1, "killed", None], [2, "hang", None],
                   [3, "preempted", None], [4, "clean", None]]


def test_capacity_and_recovery_as_jax(tmp_path):
    path = str(tmp_path / "capacity.json")
    for content in (None, {"devices": 4}, {"devices": 0}, [4], "torn{"):
        if content is not None:
            with open(path, "w") as f:
                f.write(content if isinstance(content, str) else json.dumps(content))
        _same(lambda m, _: [m.read_capacity(path, default=d) for d in (None, 8)]
              + [m.read_capacity(None, default=2)])
    ckpt = tmp_path / "ckpt"
    _fake_ckpt(ckpt, 3)
    _fake_ckpt(ckpt, 6)
    target = ckpt / "6" / "data" / "a.bin"
    raw = bytearray(target.read_bytes())
    raw[7] ^= 4
    target.write_bytes(bytes(raw))
    out = _same(lambda m, _: [m.resume_assessment(str(ckpt)), m.resume_assessment(None)])
    assert out[1][0]["resume_step"] == 3


# -- the supervisor loop ------------------------------------------------------

BASE = ["--n-devices", "8", "--global-batch-size", "64"]


def _tune(tmp_path, ranked=({"name": "dp_z1", "parallelism": "dp", "mesh": {"data": 8},
                              "zero1": True},)):
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        json.dump({"ranked": list(ranked)}, f)
    return path


def _corrupt_ckpt(tmp_path):
    ckpt = tmp_path / "ckpt"
    _fake_ckpt(ckpt, 4)
    target = ckpt / "4" / "data" / "a.bin"
    raw = bytearray(target.read_bytes())
    raw[3] ^= 1
    target.write_bytes(bytes(raw))
    return ["--checkpoint-dir", str(ckpt)]


def _hung_ring(run_dir):
    with open(os.path.join(run_dir, "comms-health-p0.json"), "w") as f:
        json.dump({"comms_health_schema_version": 1, "process_index": 0,
                   "in_flight": {"key": "ring-all-reduce/s8/data", "kind": "ring-all-reduce",
                                 "dtype": "s8", "axis": "data", "hop": 1, "n_hops": 2},
                   "last_collective": None}, f)


#: name -> (child script, extra train args or a maker of them, policy
#: budgets, Supervisor keywords or a maker, a set-up of the run dir)
SCENARIOS = {
    "kill_remesh_clean": ([("killed", 137, 4), ("clean", 0, None)], BASE, None, {}, None),
    "budget_exhausted": ([("killed", 137, None)] * 3, BASE, {"killed": 1}, {}, None),
    "health_halt": ("halt", [], None, {}, None),
    "remesh_refused": ([("killed", 137, 3)], ["--n-devices", "8", "--parallelism", "tp",
                                              "--mesh", "data=4,model=2",
                                              "--global-batch-size", "64"], None, {}, None),
    "fallback_rescues": ([("killed", 137, 3), ("clean", 0, None)],
                         ["--n-devices", "8", "--parallelism", "tp", "--mesh",
                          "data=4,model=2"], None, lambda t: {"fallback_plan": _tune(t)},
                         None),
    "fallback_refused": ([("killed", 137, 3)],
                         ["--n-devices", "8", "--parallelism", "tp", "--mesh",
                          "data=4,model=2"], None, lambda t: {"fallback_plan": _tune(t, [
                              {"name": "tp_m4", "parallelism": "tp", "mesh": {"model": 4}}])},
                         None),
    "every_checkpoint_refused": ([("killed", 137, None)], _corrupt_ckpt, None, {}, None),
    "max_incarnations": ([("preempted", 0, None)] * 4, BASE, None,
                         {"max_incarnations": 3}, None),
    "hang_names_the_ring": ([("hang", 113, None), ("clean", 0, None)], BASE, None, {},
                            _hung_ring),
    "oom_twice": ([("oom", 1, None)] * 2, BASE, None, {}, None),
    "spawn_failure": ([(None, 1, None)] * 4, [], None, {}, None),
    "clean_trace_failed_process": ([("clean", 3, None), ("clean", 0, None)], [], None, {},
                                   None),
}


class _Halt:
    """A child that drains under ``--health-policy halt``."""

    def __init__(self, run_dir):
        self.run_dir, self.argv_log = run_dir, []

    def __call__(self, argv):
        self.argv_log.append(list(argv))
        _write_trace(self.run_dir, 0, run_end=True)
        with open(os.path.join(self.run_dir, "trace-p0.jsonl"), "a") as f:
            f.write(json.dumps({"type": "instant", "name": "health_halt_drain",
                                "ts_s": 2.9}) + "\n")
        return 0


class _Fleet(FakeFleet):
    """``FakeFleet``, with an ``oom`` child's trace ending in ``oom_abort``."""

    def __call__(self, argv):
        kind = self.script[0][0]
        rc = super().__call__(argv)
        if kind == "oom":
            name = ("trace-p0.jsonl" if self.next_incarnation == 1
                    else f"trace-p0.i{self.next_incarnation - 1}.jsonl")
            with open(os.path.join(self.run_dir, name), "a") as f:
                f.write(json.dumps({"type": "instant", "name": "oom_abort",
                                    "ts_s": 2.0}) + "\n")
        return rc


def _supervise(tmp_path, sup, elastic, case):
    script, extra, budgets, kw, setup = SCENARIOS[case]
    run_dir = str(tmp_path / "run")
    for d in (run_dir, str(tmp_path / "ckpt")):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(run_dir)
    if setup is not None:
        setup(run_dir)
    extra = extra(tmp_path) if callable(extra) else extra
    kw = kw(tmp_path) if callable(kw) else kw
    child = _Halt(run_dir) if script == "halt" else _Fleet(run_dir, script)
    s = sup.Supervisor(["--telemetry-dir", run_dir, *extra],
                       policy=elastic.RestartPolicy(budgets, elastic.BackoffPolicy(base_s=0.0)),
                       run_child=child, **kw)
    rc = s.run()
    records = [{k: v for k, v in d.items() if k != "wall_time"}
               for d in elastic.read_decisions(run_dir)]
    return rc, child.argv_log, records


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_supervisor_as_jax(tmp_path, case):
    jax_ = _supervise(tmp_path, jax_sup, jax_elastic, case)
    port = _supervise(tmp_path, port_sup, port_elastic, case)
    assert port[0] == jax_[0]
    assert port[1] == jax_[1]
    assert _as_jax(port[2]) == jax_[2]
    rc, argv, records = port
    events = [r["event"] for r in records]
    if case == "kill_remesh_clean":
        assert rc == 0 and events == ["launch", "restart", "exit"]
        assert argv[1][argv[1].index("--n-devices") + 1] == "4" and "--resume" in argv[1]
        restart = records[1]
        assert restart["exit_class"] == "killed" and restart["plan"]["n_devices"] == 4
        # the death's verdict: capacity dropped, and the life was killed
        assert restart["diagnose"]["rule"] == "DIA004"
        assert restart["diagnose"]["suspect"] == {"kind": "lost_host", "devices": 4}
    elif case == "hang_names_the_ring":
        assert records[1]["suspect_collective"]["key"] == "ring-all-reduce/s8/data"
        assert records[1]["diagnose"]["rule"] == "DIA002"
    elif case == "every_checkpoint_refused":
        assert rc == 1 and "no verifiable checkpoint" in records[-1]["reason"]
    else:
        assert events[-1] == ("exit" if rc == 0 else "stop")


def test_supervisor_requires_a_telemetry_dir_as_jax():
    with pytest.raises(SystemExit) as port:
        port_sup.Supervisor(["--epochs", "2"])
    with pytest.raises(SystemExit) as jax_:
        jax_sup.Supervisor(["--epochs", "2"])
    assert jax_names(str(port.value)) == str(jax_.value)
    assert port_sup.main(["--max-restarts", "melted=1", "train", "--telemetry-dir", "/r"]) == 2
    assert port_sup.main(["train", "--epochs", "2"]) == 2


def test_options_after_the_command(monkeypatch):
    """``elastic train [OPTIONS] -- TRAIN ARGS`` parses as ``elastic
    [OPTIONS] train TRAIN ARGS``."""
    seen = {}

    class Probe:
        def __init__(self, train_args, *, policy, **kw):
            seen.update(train_args=list(train_args), base=policy.backoff.base_s,
                        budget=policy.budgets["killed"], **kw)

        def run(self):
            return 0

    monkeypatch.setattr(port_sup, "Supervisor", Probe)
    for argv in (["--backoff-base", "0", "--max-restarts", "killed=2", "train", "--epochs",
                  "2", "--telemetry-dir", "/r"],
                 ["train", "--backoff-base", "0", "--max-restarts", "killed=2", "--",
                  "--epochs", "2", "--telemetry-dir", "/r"]):
        seen.clear()
        assert port_sup.main(argv) == 0
        assert seen["train_args"] == ["--epochs", "2", "--telemetry-dir", "/r"]
        assert (seen["base"], seen["budget"]) == (0.0, 2)


# -- what a shrink to one rank runs -------------------------------------------


def test_int8_ring_at_one_rank_as_jax():
    """A life re-meshed to one rank keeps ``--grad-compress int8``: the ring
    at one rank hands the gradient back untouched with a zero error, in
    both packages (no quantization, so K2 and K3 launch no time)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel.collectives import ring_all_reduce as jax_ring
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.parallel.collectives import ring_all_reduce as port_ring

    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    f = jax.shard_map(lambda v: jax_ring(v, "data", mode="int8", with_error=True),
                      mesh=mesh, in_specs=P("data"), out_specs=(P("data"), P("data")))
    jax_out, jax_err = f(jnp.asarray(x))
    ops.reset_launch_counts()
    out, err = port_ring(torch.from_numpy(x), mode="int8", with_error=True, kernels=True)
    assert np.array_equal(out.numpy(), np.asarray(jax_out))
    assert np.array_equal(out.numpy(), x)
    assert np.array_equal(err.numpy(), np.asarray(jax_err)) and not err.any()
    assert not any(ops.launch_counts().values())


def test_two_ranks_killed_at_one_step_both_stay_fired(tmp_path, monkeypatch):
    """Each rank's injector saves the shared fire-once state when its
    ``kill_host`` fires; the second save merges the first's, so the life
    resumed at one rank (rank 0) finds its own kill fired."""
    from tpu_ddp_torch.chaos import inject

    class Exit(Exception):
        pass

    def _exit(code):
        raise Exit(code)

    monkeypatch.setattr(inject.os, "_exit", _exit)
    spec = str(tmp_path / "spec.json")
    with open(spec, "w") as f:
        json.dump({"chaos_schema_version": 1, "faults": [
            {"kind": "kill_host", "step": 6, "survivors": 1, "process_index": r}
            for r in (0, 1)]}, f)
    run_dir = str(tmp_path / "run")
    ranks = [inject.ChaosInjector(spec, run_dir, process_index=r) for r in (0, 1)]
    for r in (1, 0):
        with pytest.raises(Exit):
            ranks[r].on_step(6)
    with open(os.path.join(run_dir, "chaos-state.json")) as f:
        assert json.load(f)["fired"] == [1, 0]
    resumed = inject.ChaosInjector(spec, run_dir, process_index=0)
    resumed.on_step(8)                       # fault 0 is fired: no exit
    with open(os.path.join(run_dir, "capacity.json")) as f:
        assert json.load(f)["devices"] == 1


# -- one real supervised run ----------------------------------------------------


def test_supervised_two_rank_run_resumes_at_one_rank(tmp_path):
    from tpu_ddp.ledger import build_ledger as jax_build, stitch_run as jax_stitch
    from tpu_ddp_torch.ledger import build_ledger, stitch_run
    from tpu_ddp_torch.ledger.stitch import discover_incarnations

    run_dir, ckpt, spec = (str(tmp_path / n) for n in ("run", "ckpt", "spec.json"))
    with open(spec, "w") as f:
        json.dump({"chaos_schema_version": 1, "faults": [
            {"kind": "kill_host", "step": 6, "survivors": 1, "process_index": r}
            for r in (0, 1)]}, f)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.main", "elastic", "train",
         "--backoff-base", "0", "--", "--device", "cpu", "--synthetic-data",
         "--synthetic-size", "320", "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2",
         "--kernels", "--grad-compress", "int8", "--n-devices", "2", "--global-batch-size",
         "32", "--telemetry-dir", run_dir, "--telemetry-sinks", "jsonl", "--checkpoint-dir",
         ckpt, "--checkpoint-steps", "4", "--chaos", spec],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    execs = [ln for ln in proc.stdout.splitlines() if ln.startswith("[elastic] exec: ")]
    assert len(execs) == 2
    assert "-m tpu_ddp_torch.cli.launch --nproc-per-node 2 " in execs[0]
    assert "tpu_ddp_torch.cli.launch" not in execs[1]
    assert execs[1].endswith("--n-devices 1 --resume")
    records = port_elastic.read_decisions(run_dir)
    assert [r["event"] for r in records] == ["launch", "restart", "exit"]
    restart = records[1]
    assert (restart["exit_class"], restart["plan"]["n_devices"]) == ("killed", 1)
    assert restart["recovery"] == {"resume_step": 4, "refused": [], "verified": True}
    assert restart["diagnose"]["rule"] == "DIA004"
    assert restart["diagnose"]["suspect"] == {"kind": "lost_host", "devices": 1}
    # one family a life (both ranks' traces in the first), the launcher's
    # lifecycle file beside them counted in none
    assert os.path.isfile(os.path.join(run_dir, "launch-n0.jsonl"))
    assert [(i, sorted(f)) for i, f in discover_incarnations(run_dir)] == [(0, [0, 1]),
                                                                           (1, [0])]
    with open(os.path.join(run_dir, "chaos-state.json")) as f:
        assert sorted(json.load(f)["fired"]) == [0, 1]
    for stitch, build in ((stitch_run, build_ledger), (jax_stitch, jax_build)):
        ledger = build(stitch(run_dir))
        assert [e.exit for e in ledger.incarnations] == ["killed", "clean"]
        assert [(e.first_step, e.executed_through) for e in ledger.incarnations] == [
            (0, 6), (4, 10)]
        assert abs(sum(ledger.categories.values()) - ledger.elapsed_s) <= 1e-6
    from tpu_ddp.diagnose.evidence import gather_evidence as jax_gather
    from tpu_ddp_torch.diagnose.evidence import gather_evidence as port_gather

    port_v = [v.to_json() for v in port_rules.diagnose(port_gather(run_dir))]
    jax_v = [v.to_json() for v in jax_rules.diagnose(jax_gather(run_dir))]
    assert _as_jax(port_v) == jax_v
    assert "DIA004" in [v["rule"] for v in port_v]
