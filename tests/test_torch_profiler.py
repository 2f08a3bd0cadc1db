"""The port's anomaly profiler (``tpu_ddp_torch/profiler/``) against the JAX
package's (``tpu_ddp/profiler/``) on the same inputs, all exact:

- ``parse_profile_steps`` (windows and the refusals' messages),
  ``parse_folded``, ``top_frames``, ``frame_shares``, ``straggler_diff`` on
  ``tests/test_profiler.py``'s fleet shares, and ``per_op_attribution`` on
  its hand-built anatomy (an explicit chip, and a TPU kind both tables
  hold; a kind with no peak falls back to the port's card, not to v5e);
- the capture manager alone: a config window's bundle, which the JAX
  ``read_bundle_meta`` reads as the port's does; single flight and the
  capture cap; a window open at ``close()`` written truncated; one
  ``torch.profiler`` session at a time (a second arm is a note);
- the port's own run dir (``tests/torch_observatories.py``): the
  ``--profile-steps`` bundle and the live window's, each with its CPU
  ``torch.profiler`` trace, and ``profile --no-ops`` (the text and
  ``--json``) as the JAX command renders it; the ``--profile-dir`` epoch's
  trace and its ``profiler_trace_written`` instant.
"""

import json
import os
import threading
import time

import pytest
from test_profiler import _fleet_shares, _synthetic_anatomy
from torch_observatories import observed_run

import tpu_ddp.profiler.capture as jc
import tpu_ddp.profiler.device as jd
import tpu_ddp.profiler.host as jh
import tpu_ddp.profiler.report as jr
import tpu_ddp_torch.profiler.capture as pc
import tpu_ddp_torch.profiler.device as pd
import tpu_ddp_torch.profiler.host as ph
import tpu_ddp_torch.profiler.report as pr


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


@pytest.mark.parametrize("spec", [None, "", "3:7", " 10 : 20 ", "7:3", "5:5", "a:b", "3",
                                  "3:4:5", "-1:4"])
def test_parse_profile_steps_as_jax(spec):
    def parse(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(pc.parse_profile_steps) == parse(jc.parse_profile_steps)


FOLDED = ("MainThread;a (f.py:1);b (f.py:2) 30\n"
          "MainThread;a (f.py:1);c (f.py:3) 10\n"
          "worker;d (g.py:9) 10\n"
          "tpu-ddp-monitor-exporter;serve_forever (socketserver.py:235);"
          "select (selectors.py:415) 40\n"
          "\n"
          "torn-line-without-count\n"
          "MainThread;a (f.py:1);b (f.py:2) 5\n")


@pytest.mark.parametrize("include_idle", [False, True])
def test_folded_readers_as_jax(include_idle):
    folded = ph.parse_folded(FOLDED)
    assert folded == jh.parse_folded(FOLDED)
    assert folded["MainThread;a (f.py:1);b (f.py:2)"] == 35
    assert ph.top_frames(folded, n=3, include_idle=include_idle) == \
        jh.top_frames(folded, n=3, include_idle=include_idle)
    assert ph.frame_shares(folded, include_idle) == jh.frame_shares(folded, include_idle)


@pytest.mark.parametrize("flagged", [None, 0, 2, 7])
def test_straggler_diff_as_jax(flagged):
    shares = _fleet_shares()
    assert pr.straggler_diff(shares, flagged) == jr.straggler_diff(shares, flagged)
    assert pr.straggler_diff({0: {"a": 1.0}}) is None


@pytest.mark.parametrize("chip,kind", [("v4", "cpu"), (None, "TPU v5 lite"), ("v5p", None)])
@pytest.mark.parametrize("measured", [0.010, None])
def test_per_op_attribution_as_jax(chip, kind, measured):
    anatomy = dict(_synthetic_anatomy(), device_kind=kind)
    port = pd.per_op_attribution(anatomy, measured, chip)
    assert port == jd.per_op_attribution(anatomy, measured, chip)
    if measured:
        assert sum(r["attributed_s"] for r in port["ops"]) == pytest.approx(measured,
                                                                            rel=1e-12)


def test_per_op_attribution_falls_back_to_the_card():
    port = pd.per_op_attribution(_synthetic_anatomy(), 0.010)
    jax_ = jd.per_op_attribution(_synthetic_anatomy(), 0.010)
    assert (port["chip"], jax_["chip"]) == ("h100", "v5e")
    assert port["notes"][0] == jax_["notes"][0].replace("v5e", "h100")
    assert port["model_step_s"] == pytest.approx(
        1e9 / 989.4e12 + 2e8 / 3.35e12 + 1.8e6 / 4.5e11, rel=1e-12)
    assert pd.chip_spec("NVIDIA H100 80GB HBM3").key == "h100"
    assert pd.attribution_for_bundle({})["note"].startswith("per-op attribution unavailable")


def _drive(cm, tel, steps):
    for step in steps:
        with tel.span("compiled_step"):
            time.sleep(0.002)
        cm.on_step(step)


def test_capture_manager_bundle_read_by_both(tmp_path):
    from tpu_ddp_torch.telemetry import build_telemetry, reset_default_registry

    reset_default_registry()
    tel = build_telemetry(str(tmp_path), "jsonl", run_meta={"run_id": "t"})
    try:
        cm = pc.CaptureManager(str(tmp_path), window_steps=2, host_hz=400, telemetry=tel,
                               run_meta={"run_id": "t", "strategy": "dp"},
                               device_trace=False, max_captures=2)
        cm.arm_window(2, 5)
        assert cm.request(source="http") is False            # config window armed
        _drive(cm, tel, range(1, 7))
        assert cm.request(source="http") is True
        assert cm.request(source="http") is False            # single flight
        _drive(cm, tel, range(7, 10))
        assert cm.completed == 2 and cm.request() is False   # the cap
        snap = tel.registry.snapshot()
    finally:
        tel.close()
    bundles = pc.list_bundles(str(tmp_path))
    assert bundles == jc.list_bundles(str(tmp_path))
    assert [(b["trigger"], b["start_step"], b["end_step"]) for b in bundles] == \
        [("config", 2, 5), ("http", 7, 9)]
    for b in bundles:
        meta = pc.read_bundle_meta(b["path"])
        assert meta == jc.read_bundle_meta(b["path"])
        assert meta["sources"]["device"] == {"note": "device trace disabled"}
    meta = pc.read_bundle_meta(bundles[0]["path"])
    assert meta["trigger"] == {"source": "config", "rule": None, "host": None,
                               "requested_steps": 3}
    assert meta["measured_phases"]["compiled_step"]["count"] == 3
    assert snap["counters"]["profiler/captures_total"] == 2


def test_a_window_open_at_close_is_written_truncated(tmp_path):
    cm = pc.CaptureManager(str(tmp_path), window_steps=8, host_hz=400, device_trace=False)
    assert cm.request(steps=8)
    cm.on_step(3)
    cm.on_step(5)
    cm.close()
    meta = pc.read_bundle_meta(pc.list_bundles(str(tmp_path))[0]["path"])
    assert meta["note"] == "run ended mid-window; capture truncated"
    assert (meta["window"]["start_step"], meta["window"]["end_step"]) == (3, 5)
    with pytest.raises(ValueError):
        ph.HostSampler(hz=0)


def test_one_torch_profiler_session_at_a_time(tmp_path):
    """A capture window that overlaps another session (``--profile-dir``'s
    epoch) records the JAX note instead of a trace; its own trace works once
    the other has stopped."""
    first = pd.start_device_trace(str(tmp_path / "epoch"))
    try:
        assert first is None
        cm = pc.CaptureManager(str(tmp_path), host_hz=400)
        cm.request(steps=1)
        cm.on_step(1)
        cm.on_step(2)
    finally:
        assert pd.stop_device_trace() is None
    meta = pc.read_bundle_meta(pc.list_bundles(str(tmp_path))[0]["path"])
    assert meta["sources"]["device"] == {
        "note": "torch.profiler trace unavailable: a trace already running"}
    assert os.path.isfile(tmp_path / "epoch" / "trace.json")
    assert pd.stop_device_trace().endswith("no trace running")


def _busy(stop):
    while not stop.is_set():
        sum(range(1000))


def test_host_sampler_names_a_busy_thread():
    stop = threading.Event()
    worker = threading.Thread(target=_busy, args=(stop,), name="busy-worker", daemon=True)
    worker.start()
    sampler = ph.HostSampler(hz=250).start()
    time.sleep(0.3)
    sampler.stop()
    stop.set()
    worker.join(timeout=5)
    folded = ph.parse_folded(sampler.folded())
    assert sampler.samples > 10
    assert any(k.startswith("busy-worker;") and "_busy (test_torch_profiler.py" in k
               for k in folded)
    assert ph.top_frames(folded) == jh.top_frames(folded)


def test_the_run_wrote_two_bundles_and_the_epoch_trace(run):
    run_dir, trainer, _, metrics = run
    bundles = pc.list_bundles(run_dir)
    assert [(b["trigger"], b["start_step"], b["end_step"]) for b in bundles] == \
        [("config", 1, 3), ("http", 4, 5)]
    for b in bundles:
        meta = pc.read_bundle_meta(b["path"])
        assert meta == jc.read_bundle_meta(b["path"])
        assert meta["sources"]["device"] == {"trace_dir": "device"}
        with open(os.path.join(b["path"], "device", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::convolution" for e in events)
        assert os.path.getsize(os.path.join(b["path"], "host_stacks.folded")) > 0
        assert meta["run_meta"]["run_id"] == trainer.run_meta["run_id"]
        assert "torch_version" in meta["run_meta"]
    with open(os.path.join(run_dir, "trace-p0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    written = [r for r in records if r.get("name") == "profiler_trace_written"]
    assert [(r["attrs"]["epoch"], r["attrs"]["path"]) for r in written] == \
        [(2, os.path.abspath(os.path.join(run_dir, "epoch_trace")))]
    assert os.path.isfile(os.path.join(run_dir, "epoch_trace", "trace.json"))
    assert [r["name"] for r in records if r.get("name", "").startswith("profile_capture")] \
        == ["profile_capture_started", "profile_capture_written"] * 2
    final = records[-1]["attrs"]["counters"]
    assert final["profiler/captures_total"] == 2 and metrics["steps"] == 10
    assert pd._session is None


def _profile(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_profile_no_ops_on_the_port_run_as_jax(run, tmp_path, capsys):
    run_dir = run[0]
    port_json, jax_json = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    rp, out_p = _profile(pr.main, [run_dir, "--no-ops", "--json", port_json], capsys)
    rj, out_j = _profile(jr.main, [run_dir, "--no-ops", "--json", jax_json], capsys)
    assert rp == rj == 0
    assert out_p.replace(port_json, "J").replace("tpu-ddp-torch", "tpu-ddp") \
        == out_j.replace(jax_json, "J")
    assert json.load(open(port_json)) == json.load(open(jax_json))
    assert "trigger: config" in out_p and "device trace -> device/" in out_p
    # the per-op join is the JAX degrade shape in the port
    rp, out_p = _profile(pr.main, [run_dir, "--host", "0"], capsys)
    assert rp == 0 and "per-op attribution: note: per-op attribution unavailable" in out_p
    assert _profile(pr.main, [str(tmp_path)], capsys)[0] == 2
