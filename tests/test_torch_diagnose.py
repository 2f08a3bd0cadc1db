"""The port's diagnose engine (``tpu_ddp_torch/diagnose/``) against the JAX
package's (``tpu_ddp/diagnose/``), run side by side on the same run dirs:

- the JAX tests' fault matrix (``tests/test_diagnose.py``'s eleven
  fault fixtures over ``tpu_ddp.tools.monitor_demo.write_fleet``): the same
  ``rule_counts``, verdicts (rule, title, message, suspect, citations,
  cost, share), evidence sources, report text, ``--json`` artifact and
  exit code;
- the refusals (exit 2): a missing or empty run dir, future-schema
  artifacts of every family that has a schema;
- ``--against`` a registry the port wrote, the artifact recorded by the
  port's registry as kind ``diagnose`` and ``bench compare`` gating a
  fresh suspect class;
- the joins: ``watch --once`` names ``likely_cause``, ``goodput`` names the
  stall's cause, the category sum untouched;
- run dirs the port's trainer wrote on the CPU: a killed and resumed life
  (``tests/torch_readers.py``) and a two-rank ``--chaos`` run with a
  ``comm_stall`` past its watchdog deadline and a ``data_stall`` on the
  gather, before and after a watcher wrote its ``alerts.jsonl``.

The outputs differ in the command's name (``tpu-ddp-torch`` for
``tpu-ddp``; DIA003's action names ``tpu-ddp-torch-memplan``).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import pytest
from test_diagnose import (
    FAULT_MATRIX,
    _comm_stall,
    _data_stall,
    _future_comms,
    _future_health,
    _future_mem,
    _future_trace,
    _j,
    _jsonl,
)
from torch_readers import assert_same, incident, jax_names

from tpu_ddp.diagnose import cli as jax_cli
from tpu_ddp.diagnose import evidence as jax_evidence
from tpu_ddp.diagnose import rules as jax_rules
from tpu_ddp.tools.monitor_demo import write_fleet
from tpu_ddp_torch.diagnose import cli as port_cli
from tpu_ddp_torch.diagnose import evidence as port_evidence
from tpu_ddp_torch.diagnose import rules as port_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIA003 = jax_rules.RULES["DIA003"]["action"]
PORT_DIA003 = port_rules.RULES["DIA003"]["action"]


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _as_jax(obj):
    """The port's output as the JAX package words it: the command's name,
    and DIA003's action."""
    text = json.dumps(obj) if not isinstance(obj, str) else obj
    text = jax_names(text).replace(jax_names(PORT_DIA003), JAX_DIA003)
    return text if isinstance(obj, str) else json.loads(text)


def _diagnosed(run_dir, registry=None):
    """Both packages' evidence and verdicts on ``run_dir``, as JSON."""
    out = []
    for ev_mod, rules in ((port_evidence, port_rules), (jax_evidence, jax_rules)):
        ev = ev_mod.gather_evidence(run_dir, registry_dir=registry)
        verdicts = rules.diagnose(ev)
        out.append(({n: s.to_json() for n, s in ev.sources.items()},
                    [v.to_json() for v in verdicts], rules.rule_counts(verdicts)))
    return out


def assert_same_diagnosis(run_dir, registry=None):
    """Both packages give ``run_dir`` the same sources, verdicts and rule
    counts, and their CLIs the same exit code and output, text and
    ``--json``; returns the port's verdicts."""
    (p_src, p_ver, p_counts), (j_src, j_ver, j_counts) = _diagnosed(run_dir, registry)
    assert p_counts == j_counts
    assert _as_jax(p_ver) == j_ver
    assert _as_jax(p_src) == j_src
    extra = ["--against", registry] if registry else []
    for flags in ([], ["--json"]):
        rp, out_p, err_p = _cli(port_cli.main, [run_dir, *extra, *flags])
        rj, out_j, err_j = _cli(jax_cli.main, [run_dir, *extra, *flags])
        assert rp == rj == (1 if j_ver else 0)
        assert _as_jax(err_p) == err_j
        if flags:
            assert_same(_as_jax(json.loads(out_p)), json.loads(out_j))
        else:
            assert _as_jax(out_p) == out_j
    return p_ver


@pytest.mark.parametrize("fault,build,expected", FAULT_MATRIX,
                         ids=[f[0] for f in FAULT_MATRIX])
def test_fault_matrix_as_jax(tmp_path, fault, build, expected):
    run = str(tmp_path / fault)
    build(run)
    verdicts = assert_same_diagnosis(run)
    assert [v["rule"] for v in verdicts] == ([expected] if expected else [])
    for v in verdicts:
        assert v["title"] == jax_rules.RULES[v["rule"]]["title"]
        for c in v["citations"]:
            assert glob.glob(c["path"]) or os.path.exists(c["path"]), c


def test_rule_registry_as_jax():
    assert list(port_rules.RULES) == list(jax_rules.RULES) == [f"DIA00{i}" for i in range(1, 10)]
    for rule, spec in port_rules.RULES.items():
        assert spec["title"] == jax_rules.RULES[rule]["title"]
        assert jax_names(spec["action"]) == jax_rules.RULES[rule]["action"]
    assert port_evidence.SOURCE_NAMES == jax_evidence.SOURCE_NAMES
    assert port_evidence.DIAG_SCHEMA_VERSION == jax_evidence.DIAG_SCHEMA_VERSION == 1


def test_wedged_collective_suppresses_the_data_wedge_as_jax(tmp_path):
    run = str(tmp_path / "both")
    _comm_stall(run)
    _j(run, "data-health-p0.json", {
        "data_health_schema_version": 1, "process_index": 0, "step": 10, "stages": {},
        "in_flight": {"stage": "shard", "since_unix": 1000.0}})
    assert [v["rule"] for v in assert_same_diagnosis(run)] == ["DIA002"]


def _future_data(d):
    _j(d, "data-health-p0.json", {"data_health_schema_version": 99, "process_index": 0,
                                  "stages": {}, "in_flight": None})


def _future_alerts(d):
    write_fleet(d)
    _jsonl(d, "alerts.jsonl", [{"type": "header", "schema_version": 99}])


def _unrelated(d):
    _j(d, "notes.json", {"hello": 1})


REFUSALS = {
    "missing": None,
    "empty": lambda d: None,
    "unrelated_file": _unrelated,
    "future_trace": _future_trace,
    "future_health": _future_health,
    "future_mem": _future_mem,
    "future_comms": _future_comms,
    "future_data_health": _future_data,
    "future_alerts": _future_alerts,
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_exit_2_as_jax(tmp_path, case):
    from tpu_ddp.cli.main import main as jax_main
    from tpu_ddp_torch.cli.main import main as port_main

    run = str(tmp_path / "run")
    if REFUSALS[case] is not None:
        os.makedirs(run)
        REFUSALS[case](run)
    for flags in ([], ["--json"]):
        rp, out_p, err_p = _cli(port_main, ["diagnose", run, *flags])
        rj, out_j, err_j = _cli(jax_main, ["diagnose", run, *flags])
        assert rp == rj == 2 and out_p == out_j == ""
        assert err_p.startswith("tpu-ddp-torch diagnose: ")
        assert jax_names(err_p) == err_j
    if case in ("empty", "unrelated_file"):
        # every family named with its reason
        for name in port_evidence.SOURCE_NAMES:
            assert f"  {name}: " in err_p


def test_against_a_port_registry_as_jax(tmp_path):
    from tpu_ddp_torch.registry.store import record_artifact

    run = str(tmp_path / "run")
    _data_stall(run)
    art = tmp_path / "lint.json"
    art.write_text(json.dumps({"lint_schema_version": 1,
                               "programs": {"train_step": {"rule_counts": {}}}}))
    reg = str(tmp_path / "reg")
    record_artifact(reg, str(art))
    ev = port_evidence.gather_evidence(run, registry_dir=reg)
    assert ev.data("registry") == {"dir": reg, "n_entries": 1, "kinds": {"lint": 1}}
    assert not port_evidence.gather_evidence(run).source("registry").ok
    assert_same_diagnosis(run, registry=reg)
    assert_same_diagnosis(run, registry=str(tmp_path / "no_registry"))


def test_artifact_recorded_and_compared_as_jax(tmp_path):
    from tpu_ddp.cli.main import main as jax_main
    from tpu_ddp_torch.cli.main import main as port_main
    from tpu_ddp_torch.registry.store import record_artifact

    clean, faulty = str(tmp_path / "clean"), str(tmp_path / "faulty")
    write_fleet(clean)
    _data_stall(faulty)
    old, new = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    assert _cli(port_main, ["diagnose", clean, "--json", "--out", old])[0] == 0
    rc, out, _ = _cli(port_main, ["diagnose", faulty, "--json", "--out", new])
    assert rc == 1
    with open(new) as f:
        art = json.load(f)
    assert json.loads(out) == art
    assert art["diagnose_schema_version"] == 1
    assert art["diagnose"]["rule_counts"] == {"DIA001": 1}
    assert art["provenance"]["config_digest"] == "demo-fleet"
    entry = record_artifact(str(tmp_path / "reg"), new)
    assert entry.artifact_kind == "diagnose"
    assert entry.metrics.get("diagnose/count/lint/DIA001") == 1.0
    for (a, b), want in (((old, new), 1), ((new, old), 0)):
        rp, out_p, _ = _cli(port_main, ["bench", "compare", a, b])
        rj, out_j, _ = _cli(jax_main, ["bench", "compare", a, b])
        assert rp == rj == want
        assert "DIA001" in out_p and "DIA001" in out_j
        assert ("no regressions" in out_p) == ("no regressions" in out_j) == (want == 0)


def test_watch_once_likely_cause_as_jax(tmp_path):
    from tpu_ddp.monitor.watch import main as jax_watch
    from tpu_ddp_torch.monitor.watch import main as port_watch

    bad, clean = str(tmp_path / "bad"), str(tmp_path / "clean")
    write_fleet(bad, nan_host=2)
    write_fleet(clean)
    rp, out_p, _ = _cli(port_watch, [bad, "--once", "--json", "--no-alerts-file"])
    rj, out_j, _ = _cli(jax_watch, [bad, "--once", "--json", "--no-alerts-file"])
    cause = json.loads(out_p)["likely_cause"]
    assert rp == rj and cause["rule"] == "DIA006"
    assert set(cause) == {"rule", "title", "message", "suspect", "action"}
    assert jax_names(cause) == json.loads(out_j)["likely_cause"]
    rp, out_p, _ = _cli(port_watch, [clean, "--once", "--no-alerts-file"])
    rj, out_j, _ = _cli(jax_watch, [clean, "--once", "--no-alerts-file"])
    assert rp == rj == 0
    line = [ln for ln in out_p.splitlines() if ln.startswith("likely cause:")]
    assert line == ["likely cause: none (no suspect from the diagnose rules)"]
    assert line[0] in out_j.splitlines()


def test_goodput_stall_row_names_the_verdict_as_jax(tmp_path):
    from tpu_ddp.cli.main import main as jax_main
    from tpu_ddp_torch.cli.main import main as port_main

    run = str(tmp_path)
    _jsonl(run, "trace-p0.jsonl", [
        {"type": "header", "schema_version": 1, "epoch_unix": 1000.0},
        {"type": "span", "name": "compiled_step", "ts_s": 1.0, "dur_s": 0.5, "step": 0,
         "depth": 0},
        {"type": "instant", "name": "watchdog_hang", "ts_s": 8.0}])
    _j(run, "comms-health-p0.json", {
        "comms_health_schema_version": 1, "process_index": 0,
        "in_flight": {"key": "ring-all-reduce/s8/data", "kind": "ring-all-reduce",
                      "dtype": "s8", "axis": "data", "hop": 2, "n_hops": 6},
        "last_collective": "ring-all-reduce/s8/data"})
    rp, out_p, _ = _cli(port_main, ["goodput", run, "--json"])
    rj, out_j, _ = _cli(jax_main, ["goodput", run, "--json"])
    assert rp == rj == 0
    ledger = json.loads(out_p)["ledger"]
    assert ledger["category_seconds"]["stall"] > 0
    assert ledger["stall_attribution"]["rule"] == "DIA002"
    assert abs(sum(ledger["category_seconds"].values()) - ledger["elapsed_s"]) <= 1e-6
    assert jax_names(ledger["stall_attribution"]) == \
        json.loads(out_j)["ledger"]["stall_attribution"]
    rp, out_p, _ = _cli(port_main, ["goodput", run])
    assert rp == 0 and "DIA002" in out_p and "(tpu-ddp-torch diagnose)" in out_p


# -- run dirs the port's trainer wrote --------------------------------------


def test_port_incident_as_jax(tmp_path):
    """A killed and resumed life of the port: both packages give the same
    verdicts. One kill is no churn and no capacity file names a lost host,
    so the only rule that may fire is DIA001's starvation, where a loaded
    host's gather outlasts the tiny steps for over half the step loop."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = incident(str(tmp_path / "incident"), kernels=True)
    finally:
        torch.set_num_threads(n)
    assert {v["rule"] for v in assert_same_diagnosis(run)} <= {"DIA001"}


def _launch(argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2", "--",
         sys.executable, "-m", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_port_chaos_run_as_jax(tmp_path):
    """Two gloo ranks with ``--comms-monitor`` and the staged loader: a
    ``comm_stall`` on rank 0 past the watchdog deadline (no abort) and a
    ``data_stall`` on its gather. The stalled hop completes, so the health
    files end with nothing in flight and the life ends clean: DIA002 does
    not fire. Once a watcher with the run's comms bench has written its
    ``alerts.jsonl`` (COM001 on both ranks), DIA002 names the ring from the
    hang bundle; no DAT001 fired without a data baseline (DIA001 fires only
    if a loaded host starves the steps). Both packages agree at each
    point."""
    from tpu_ddp_torch.monitor.watch import main as port_watch

    run, spec, bench = (str(tmp_path / n) for n in ("run", "spec.json", "bench.json"))
    with open(spec, "w") as f:
        json.dump({"chaos_schema_version": 1, "faults": [
            {"kind": "comm_stall", "step": 3, "delay_s": 1.5, "hops": 1},
            {"kind": "data_stall", "step": 5, "stage": "gather", "stall_s": 0.3}]}, f)
    proc = _launch(["tpu_ddp_torch.cli.train", "--device", "cpu", "--synthetic-data",
                    "--synthetic-size", "512", "--epochs", "1", "--n-chans1", "8",
                    "--n-blocks", "2", "--kernels", "--grad-compress", "int8",
                    "--telemetry-dir", run, "--telemetry-sinks", "jsonl", "--comms-monitor",
                    "--prefetch-batches", "2", "--watchdog-deadline", "1", "--chaos", spec])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DIA002" not in {v["rule"] for v in assert_same_diagnosis(run)}
    proc = _launch(["tpu_ddp_torch.cli.main", "comms", "bench", "--device", "cpu", "--mesh",
                    "data=2", "--kinds", "ring-all-reduce", "--dtypes", "f32", "--ring-modes",
                    "int8", "--sizes", "4096,16384", "--reps", "2", "--out", bench])
    assert proc.returncode == 0, proc.stderr[-2000:]
    rc, out, _ = _cli(port_watch, [run, "--once", "--json", "--comms-baseline", bench])
    fired = sorted((a["rule"], a["host"]) for a in json.loads(out)["alerts"]
                   if a["rule"] in ("COM001", "DAT001"))
    assert rc == 1 and fired == [("COM001", 0), ("COM001", 1)]
    verdicts = {v["rule"]: v for v in assert_same_diagnosis(run)}
    assert verdicts["DIA002"]["suspect"] == {"collective": "ring-all-reduce/s8/data",
                                             "axis": "data", "hop": 1}
    # a loaded host may starve the tiny steps (DIA001), nothing else fires
    assert set(verdicts) <= {"DIA001", "DIA002"}
