"""The port's live fleet monitor (``tpu_ddp_torch/monitor/``) against the JAX
package's (``tpu_ddp/monitor/``) on the same inputs, all exact:

- ``render_openmetrics`` on one registry snapshot, ``host_skew``,
  ``flag_stragglers`` and ``alert_history``;
- the hand-built fleets of ``tests/test_monitor.py`` (a straggler and a lost
  host, a clean fleet, a finished run an hour later, a fused run's data-wait
  share, torn lines, a NaN host) through ``FleetAggregator.poll`` and
  ``AlertEngine.evaluate``, and its hand-built alert snapshots;
- the port's own run dir (``tests/torch_observatories.py``): the exporter's
  endpoints and ``POST /profile``'s answers during ``run()``, the
  aggregator and alert engine at one injected ``now``, and ``watch --once
  --json`` without its wall-clock fields, ``likely_cause`` included;
- the seven training flags' defaults against the JAX ``build_parser()``, and
  each guard's message against the JAX ``TrainConfig.validate``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import contextlib
import dataclasses
import io
import json
import os
import re

import pytest
from test_monitor import _host, _snap, write_fleet
from torch_observatories import drop_keys, http, observed_run

import tpu_ddp.monitor as jm
import tpu_ddp_torch.monitor as pm
from tpu_ddp.monitor.watch import main as jax_watch
from tpu_ddp_torch.monitor.watch import main as port_watch

NOW = 2_000_000_000.0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_dir = str(tmp_path_factory.mktemp("observed"))
        trainer, calls, metrics = observed_run(run_dir)
    finally:
        torch.set_num_threads(n)
    return run_dir, trainer, calls, metrics


SNAPSHOT = {
    "counters": {"train/steps": 12, "train/images": 384.0, "comm/grad bytes": 1.5e9},
    "gauges": {"memory/d0/bytes_in_use": 123456789, "eval/test_loss": float("nan"),
               "train/mfu": 0.25},
    "histograms": {"phase/compiled_step": {"count": 3, "p50": 0.01, "p95": 0.02,
                                           "sum": 0.035},
                   "phase/empty": {"count": 0}},
}


@pytest.mark.parametrize("labels", [None, {"host": "1", "run_id": 'a"b\\c', "mesh": "data=2"}])
def test_render_openmetrics_as_jax(labels):
    assert pm.render_openmetrics(SNAPSHOT, labels) == jm.render_openmetrics(SNAPSHOT, labels)
    meta = {"run_id": "r", "strategy": "dp", "mesh": {"data": 2, "model": 1},
            "process_index": 1}
    from tpu_ddp.monitor.exporter import run_meta_labels as jax_labels
    from tpu_ddp_torch.monitor.exporter import run_meta_labels

    assert run_meta_labels(meta, 3) == jax_labels(meta, 3)


P50S = [{}, {0: 1.0}, {0: 1.0, 1: 1.0, 2: 1.0, 3: 4.0}, {0: 0.01, 1: None, 2: 0.011},
        {0: 0.01, 1: 0.0101, 2: 0.0099, 3: 0.03, 4: 0.0102}, {0: 5.0, 1: 5.0, 2: 5.0}]


@pytest.mark.parametrize("case", range(len(P50S)))
def test_host_skew_and_flag_stragglers_as_jax(case):
    from tpu_ddp.monitor.aggregate import flag_stragglers as jax_flag
    from tpu_ddp_torch.monitor.aggregate import flag_stragglers

    p50 = P50S[case]
    assert pm.host_skew(p50) == jm.host_skew(p50)
    for k, hosts in ((5.0, 3), (1.0, 2)):
        assert flag_stragglers(p50, k=k, min_hosts=hosts) == jax_flag(p50, k=k, min_hosts=hosts)


def test_alert_history_as_jax():
    records = [
        {"type": "alert", "rule": "FLT001", "host": 1, "state": "firing", "wall_time": 10.0,
         "severity": "critical", "message": "lost", "step": 5},
        {"type": "alert", "rule": "DWT001", "host": 0, "state": "firing", "wall_time": 11.0},
        {"type": "alert", "rule": "FLT001", "host": 1, "state": "resolved", "wall_time": 40.0},
        {"type": "alert", "rule": "NUM002", "host": 2, "state": "resolved", "wall_time": 41.0},
        {"type": "header"},
    ]
    assert pm.alert_history(records) == jm.alert_history(records)
    assert pm.alert_history(records)[0]["duration_s"] == 30.0


def _fleet(tmp_path, case):
    """One of ``tests/test_monitor.py``'s fleets in ``tmp_path``; returns
    the ``now`` to poll at."""
    if case == "straggler_and_lost":
        return write_fleet(tmp_path, straggler_host=2, lost_host=3, now=NOW)
    if case == "clean":
        return write_fleet(tmp_path, now=NOW)
    if case == "finished":
        write_fleet(tmp_path, now=NOW)
        for host in range(4):
            with open(tmp_path / f"trace-p{host}.jsonl", "a") as f:
                f.write(json.dumps({"schema_version": 1, "type": "instant",
                                    "name": "run_end", "ts_s": 100.0, "pid": host,
                                    "tid": 1}) + "\n")
        return NOW + 3600
    if case == "nan_host":
        return write_fleet(tmp_path, nan_host=1, now=NOW)
    if case == "fused":
        with open(tmp_path / "trace-p0.jsonl", "w") as f:
            f.write(json.dumps({"schema_version": 1, "type": "header", "epoch_unix": 0.0,
                                "pid": 0}) + "\n")
            ts = 0.0
            for group in range(10):
                f.write(json.dumps({"schema_version": 1, "type": "span", "name": "data_wait",
                                    "ts_s": ts, "dur_s": 1.0, "pid": 0, "tid": 1}) + "\n")
                ts += 1.0
                f.write(json.dumps({"schema_version": 1, "type": "span",
                                    "name": "compiled_step", "ts_s": ts, "dur_s": 8.0,
                                    "pid": 0, "tid": 1, "step": group * 8,
                                    "attrs": {"steps": 8}}) + "\n")
                ts += 8.0
        return 1e12
    raise AssertionError(case)


def _both_polls(run_dir, now, polls=1, config=None):
    """Each package's aggregator and ``--once`` alert engine over
    ``run_dir``, ``polls`` times: the snapshots' and edges' JSON."""
    out = []
    for pkg in (pm, jm):
        agg = pkg.FleetAggregator(str(run_dir), config and pkg.MonitorConfig(**config))
        engine = pkg.AlertEngine(config and pkg.MonitorConfig(**config), actions=(),
                                 once=True)
        seen = []
        for _ in range(polls):
            snap = agg.poll(now=now)
            seen.append((snap.to_json(), [a.to_record() for a in engine.evaluate(snap)],
                         [a.to_record() for a in engine.active()]))
        out.append(json.loads(json.dumps(seen).replace("tpu-ddp-torch", "tpu-ddp")))
    return out


@pytest.mark.parametrize("case", ["straggler_and_lost", "clean", "finished", "nan_host",
                                  "fused"])
def test_hand_built_fleets_as_jax(tmp_path, case):
    now = _fleet(tmp_path, case)
    port, jax_ = _both_polls(tmp_path, now)
    assert port == jax_
    snap, edges, _ = port[0]
    if case == "straggler_and_lost":
        assert snap["stragglers"] == [2] and snap["lost"] == [3]
        assert {(e["rule"], e["host"]) for e in edges} == {("STR001", 2), ("FLT001", 3)}
    if case == "nan_host":
        assert {(e["rule"], e["host"]) for e in edges} == {("NUM002", 1)}


def test_incremental_tail_and_torn_lines_as_jax(tmp_path):
    now = write_fleet(tmp_path, n_hosts=3, n_steps=10, now=NOW)
    aggs = [pkg.FleetAggregator(str(tmp_path)) for pkg in (pm, jm)]
    path = tmp_path / "trace-p0.jsonl"
    steps = []
    for extra in ("", json.dumps({"schema_version": 1, "type": "span",
                                  "name": "compiled_step", "ts_s": 9.0, "dur_s": 0.01,
                                  "pid": 0, "tid": 1, "step": 42}) + "\n"
                  + '{"type": "span", "name": "compi',
                  'led_step", "ts_s": 9.1, "dur_s": 0.01, "pid": 0, "step": 43}\n'):
        with open(path, "a") as f:
            f.write(extra)
        snaps = [a.poll(now=now).to_json() for a in aggs]
        assert snaps[0] == snaps[1]
        steps.append(snaps[0]["fleet"]["step_max"])
    assert steps == [9, 42, 43]


def _edges(engine, snap):
    return [(a.rule, a.state, a.host, a.severity, a.message) for a in engine.evaluate(snap)]


@pytest.mark.parametrize("case", ["lost_then_resolved", "straggler_persistence",
                                  "dwt_capture_rate_limit"])
def test_hand_built_alert_snapshots_as_jax(tmp_path, case):
    """``tests/test_monitor.py``'s alert snapshots and
    ``tests/test_profiler.py``'s capture-action cases, each built in both
    packages' types."""
    import tpu_ddp.monitor.aggregate as ja

    results = []
    for pkg in (pm, jm):
        def host(i, **kw):
            base = _host(i, **kw)
            return pkg.HostSnapshot(**dataclasses.asdict(base))

        def snap(hosts, **kw):
            base = _snap([ja.HostSnapshot(**dataclasses.asdict(h)) for h in hosts], **kw)
            d = dataclasses.asdict(base)
            d["hosts"] = hosts
            return pkg.FleetSnapshot(**d)

        calls = []
        if case == "lost_then_resolved":
            engine = pkg.AlertEngine(pkg.MonitorConfig())
            lost = snap([host(0), host(1, lost=True, heartbeat_age_s=300.0)])
            seq = [lost, lost, snap([host(0), host(1)])]
        elif case == "straggler_persistence":
            engine = pkg.AlertEngine(pkg.MonitorConfig(straggler_persist_windows=3))
            s = snap([host(0), host(1), host(2, straggler=True,
                                             straggler_phases=["compiled_step"],
                                             phase_p50_s={"compiled_step": 0.03})])
            seq = [s, s, s, s]
        else:
            engine = pkg.AlertEngine(
                pkg.MonitorConfig(max_auto_profiles=1), run_dir=str(tmp_path),
                actions=("capture_profile",), once=True,
                profile_trigger=lambda **kw: calls.append(kw) or True)
            hosts = [pkg.HostSnapshot(host=h, data_wait_share=0.9 if h < 2 else 0.05)
                     for h in range(4)]
            seq = [pkg.FleetSnapshot(wall_time=1.0, run_dir=str(tmp_path), hosts=hosts,
                                     fleet={})]
        results.append(([_edges(engine, s) for s in seq], calls, engine.auto_profiles))
    assert results[0] == results[1]
    if case == "dwt_capture_rate_limit":
        assert len(results[0][1]) == 1 and results[0][2] == 1


def test_post_profile_trigger_reaches_its_rank_only(tmp_path):
    """Two ranks' exporters in one run dir, as two ranks on one card: each
    binds its own ephemeral port and writes its own endpoint file, and
    ``post_profile_trigger(host=r)`` arms rank r's capture alone."""
    from tpu_ddp_torch.profiler.capture import post_profile_trigger

    armed = {0: [], 1: []}
    exporters = []
    try:
        for r in (0, 1):
            exporters.append(pm.MonitorExporter(
                port=0, host="127.0.0.1", process_index=r, run_dir=str(tmp_path),
                profile_trigger=lambda r=r, **kw: armed[r].append(kw) or True).start())
        ports = [json.load(open(tmp_path / f"exporter-p{r}.json"))["port"] for r in (0, 1)]
        assert ports == [e.port for e in exporters] and ports[0] != ports[1]
        assert post_profile_trigger(str(tmp_path), host=1, steps=2, rule="STR001")
        assert armed[0] == [] and armed[1] == [{"steps": 2, "source": "alert",
                                                 "rule": "STR001", "host": 1}]
        assert post_profile_trigger(str(tmp_path), steps=3)
        assert len(armed[0]) == 1 and len(armed[1]) == 2
    finally:
        for e in exporters:
            e.close()


def test_exporter_without_a_capture_manager_answers_503():
    exporter = pm.MonitorExporter(port=0, host="127.0.0.1")
    try:
        assert exporter.arm_profile("steps=2", "127.0.0.1")[0] == 503
        assert exporter.healthz() == {"status": "no-watchdog"}
    finally:
        exporter._server.server_close()


def test_the_exporter_served_during_run(run):
    run_dir, trainer, calls, metrics = run
    assert metrics["steps"] == 10
    status, text = calls["metrics"]
    assert status == 200
    assert re.search(r'^tpu_ddp_train_steps_total\{[^}]*host="0"[^}]*\} 2$', text, re.M)
    assert "# TYPE tpu_ddp_memory_host_rss_bytes gauge" in text and text.endswith("# EOF\n")
    snap = json.loads(calls["snapshot.json"][1])
    assert calls["snapshot.json"][0] == 200
    assert snap["run_meta"]["run_id"] == trainer.run_meta["run_id"]
    assert snap["metrics"]["counters"]["train/steps"] == 2
    assert calls["healthz"][0] == 200
    health = json.loads(calls["healthz"][1])
    assert health["status"] == "ok" and health["last_step"] == 2
    assert health["deadline_s"] == 60.0
    # POST /profile: 429 while a window is active or armed, 400 on bad
    # steps, 403 from a remote peer, 200 when it arms
    assert [calls[k][0] for k in ("while_active", "steps_zero", "steps_text", "remote",
                                  "arm", "while_armed")] == [429, 400, 400, 403, 200, 429]
    assert json.loads(calls["arm"][1]) == {"armed": True, "steps": 1}
    assert trainer._exporter is None             # close() stopped it
    with pytest.raises(OSError):
        http("GET", f"http://127.0.0.1:{json.load(open(os.path.join(run_dir, 'exporter-p0.json')))['port']}/healthz")


def test_aggregator_and_alerts_on_the_port_run_as_jax(run):
    run_dir = run[0]
    port, jax_ = _both_polls(run_dir, NOW, polls=2)
    assert port == jax_
    snap = port[0][0]
    assert [h["host"] for h in snap["hosts"]] == [0]
    host = snap["hosts"][0]
    assert host["step"] == 10 and host["ended"] and not host["lost"]
    assert host["memory"]["host_rss_bytes"] > 0
    assert snap["run_id"] == run[1].run_meta["run_id"] and snap["strategy"] == "dp"
    assert len(snap["loss_series"]) == 10


WALL_CLOCK = {"wall_time", "heartbeat_age_s", "last_event_age_s", "run_age_s"}


def _watch(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("as_json", [True, False])
def test_watch_once_on_the_port_run_as_jax(run, as_json):
    run_dir = run[0]
    argv = [run_dir, "--once", "--no-alerts-file"] + (["--json"] if as_json else [])
    rp, out_p = _watch(port_watch, argv)
    rj, out_j = _watch(jax_watch, argv)
    assert rp == rj == 0
    if as_json:
        port, jax_ = json.loads(out_p), json.loads(out_j)
        assert jax_["likely_cause"] is None and port["likely_cause"] is None
        assert drop_keys(json.loads(out_p.replace("tpu-ddp-torch", "tpu-ddp")), WALL_CLOCK) \
            == drop_keys(jax_, WALL_CLOCK)
        assert [(p["trigger"], p["start_step"], p["end_step"]) for p in port["profiles"]] \
            == [("config", 1, 3), ("http", 4, 5)]
    else:
        age = re.compile(r"\b\d+[sm]\b")
        assert "\n\nlikely cause: none (no suspect from the diagnose rules)\n" in out_p
        assert age.sub("AGE", out_p.replace("tpu-ddp-torch", "tpu-ddp")) \
            == age.sub("AGE", out_j)


FLAGS = ("profile_dir", "profile_steps", "profile_window_steps", "profile_host_hz",
         "monitor_port", "monitor_bind", "monitor_allow_remote_trigger")


def test_flag_defaults_and_choices_as_jax():
    from tpu_ddp.cli.train import build_parser as jax_parser
    from tpu_ddp_torch.cli.train import build_parser, config_from_args

    actions = [{a.dest: a for a in p()._actions} for p in (build_parser, jax_parser)]
    for dest in FLAGS:
        port, jax_ = actions[0][dest], actions[1][dest]
        assert (port.option_strings, port.default, port.choices, port.type, port.nargs,
                port.const) == (jax_.option_strings, jax_.default, jax_.choices, jax_.type,
                                jax_.nargs, jax_.const), dest
    args = build_parser().parse_args(["--profile-steps", "2:6", "--monitor-port", "-1",
                                      "--monitor-bind", "127.0.0.1", "--profile-dir", "p",
                                      "--monitor-allow-remote-trigger", "--telemetry-dir",
                                      "t", "--profile-window-steps", "3",
                                      "--profile-host-hz", "50"])
    config = config_from_args(args)
    assert {f: getattr(config, f) for f in FLAGS} == {
        "profile_dir": "p", "profile_steps": "2:6", "profile_window_steps": 3,
        "profile_host_hz": 50.0, "monitor_port": -1, "monitor_bind": "127.0.0.1",
        "monitor_allow_remote_trigger": True}
    assert config.mem_sample_steps == 1


GUARDS = {
    "port_low": dict(monitor_port=-2),
    "port_high": dict(monitor_port=65536),
    "bad_window": dict(profile_steps="7:3", telemetry_dir="t"),
    "malformed_window": dict(profile_steps="a:b", telemetry_dir="t"),
    "window_without_telemetry": dict(profile_steps="1:3"),
    "window_steps": dict(profile_window_steps=0),
    "host_hz": dict(profile_host_hz=0.0),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_guards_raise_the_jax_messages(case):
    from tpu_ddp.train.trainer import TrainConfig as JaxConfig
    from tpu_ddp_torch.train.trainer import TrainConfig

    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**GUARDS[case]).validate()
    with pytest.raises(ValueError) as port_err:
        TrainConfig(**GUARDS[case])
    assert str(port_err.value) == str(jax_err.value)
