"""The port's telemetry units against the JAX package's (``tpu_ddp.telemetry``):
the sinks' records for one scripted run of spans, instants, counters, gauges,
histograms and snapshots under the same fixed clock; registry snapshots and
percentiles on the same seeded samples; the naming grammar and
``next_incarnation``; the config digests; the inert ``NULL`` and the unknown
sink's message; the summarizer's text and JSON on the same run dirs; and the
hang watchdog's contract (``tests/test_telemetry.py``'s), its abort included."""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import tpu_ddp.telemetry as jt
import tpu_ddp_torch.telemetry as pt
from tpu_ddp.telemetry import summarize as jsum
from tpu_ddp.telemetry.events import Clock as JaxClock
from tpu_ddp_torch.telemetry import summarize as psum
from tpu_ddp_torch.telemetry.events import Clock as PortClock


def _fixed_clock(base):
    class Fixed(base):
        """A clock that ticks 1 ms a reading, from a fixed wall anchor."""

        def __init__(self):
            self.epoch_monotonic, self.epoch_unix, self.t = 0.0, 1.7e9, 0.0

        def now(self):
            self.t += 1e-3
            return self.t

    return Fixed()


RUN_META = {"run_id": "abc", "strategy": "dp", "mesh": {"data": 2, "model": 1},
            "config": {"model": "netresdeep"}}


def _script(tel):
    """One scripted stream of every event kind, nested spans included."""
    with tel.span("outer", step=3, kind="a"):
        with tel.span("inner"):
            tel.instant("marker", note="x")
        tel.count("train/steps", 2)
        tel.gauge("train/mfu").set(0.25)
        tel.histogram("custom").record(0.5)
    tel.current_step = 7
    with tel.span("compiled_step", steps=4):
        with tel.span("device_sync"):
            pass
    tel.emit_counters(name="counters_snapshot")
    tel.instant("eval", epoch=1, test_loss=0.5)
    tel.close()


def _run(mod, clock_base, tmp, summary):
    clock = _fixed_clock(clock_base)
    sinks = [mod.JsonlTraceSink(str(tmp / "trace-p1.jsonl"), clock=clock, process_index=1,
                                run_meta=RUN_META),
             mod.ChromeTraceSink(str(tmp / "trace-p1.trace.json"), process_index=1,
                                 run_meta=RUN_META),
             mod.TerminalSummarySink(stream=summary)]
    _script(mod.Telemetry(sinks, registry=mod.Registry(), process_index=1, clock=clock))
    jsonl = [json.loads(line) for line in open(tmp / "trace-p1.jsonl")]
    chrome = json.load(open(tmp / "trace-p1.trace.json"))["traceEvents"]
    return jsonl, chrome


def _without_times(rec):
    return {k: v for k, v in rec.items() if k not in ("ts_s", "dur_s", "ts", "dur")}


def _nesting(events):
    """Each complete event's (name, enclosing complete events' names)."""
    xs = [e for e in events if e["ph"] == "X"]
    return [(e["name"], sorted(o["name"] for o in xs if o is not e and o["ts"] <= e["ts"]
                               and e["ts"] + e["dur"] <= o["ts"] + o["dur"])) for e in xs]


def test_sinks_write_the_jax_records(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port_out, jax_out = io.StringIO(), io.StringIO()
    pj, pc = _run(pt, PortClock, tmp_path / "port", port_out)
    jj, jc = _run(jt, JaxClock, tmp_path / "jax", jax_out)
    assert [_without_times(r) for r in pj] == [_without_times(r) for r in jj]
    assert [r["type"] for r in pj] == ["header", "instant", "span", "span", "span", "span",
                                       "counters", "instant", "instant", "counters"]
    # the same fixed clock: the times agree too
    assert [r.get("ts_s") for r in pj] == [r.get("ts_s") for r in jj]
    assert [(e["name"], e["ph"], e.get("cat")) for e in pc] == \
        [(e["name"], e["ph"], e.get("cat")) for e in jc]
    assert [_without_times(e) for e in pc if e["ph"] != "M"] == \
        [_without_times(e) for e in jc if e["ph"] != "M"]
    assert _nesting(pc) == _nesting(jc)
    assert ("inner", ["outer"]) in _nesting(pc)
    assert port_out.getvalue() == jax_out.getvalue() and "device_sync" in port_out.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_percentiles_equal_jax(seed):
    rng = np.random.default_rng(seed)
    samples = rng.exponential(size=int(rng.integers(1, 500))).tolist()
    snaps = []
    for mod in (pt, jt):
        reg = mod.Registry()
        reg.counter("c").inc(3)
        reg.counter("c").inc(0.5)
        reg.gauge("g").set(samples[0])
        reg.gauge("unset")
        h = reg.histogram("h")
        for v in samples:
            h.record(v)
        reg.histogram("empty")
        snaps.append((reg.snapshot(), [h.percentile(p) for p in (0, 1, 50, 90, 95, 99, 100)]))
    assert snaps[0] == snaps[1]


def test_default_registry_is_process_wide_and_resets():
    reg = pt.default_registry()
    reg.counter("x").inc()
    assert pt.default_registry() is reg
    pt.reset_default_registry()
    assert pt.default_registry() is not reg
    assert "x" not in pt.default_registry().snapshot()["counters"]


@pytest.mark.parametrize("prefix", ["trace", "health", "mem", "data"])
def test_naming_grammar_equals_jax(prefix):
    for pid in (0, 3, 12):
        for inc in (0, 1, 7):
            for ext in ("jsonl", "trace.json"):
                name = pt.sink_file_name(prefix, pid, inc, ext)
                assert name == jt.sink_file_name(prefix, pid, inc, ext)
                assert pt.parse_sink_name(name) == jt.parse_sink_name(name)
                assert pt.parse_sink_name(name, "other") is None
            for kind in ("jsonl", "chrome"):
                name = pt.trace_file_name(pid, inc, kind)
                assert name == jt.trace_file_name(pid, inc, kind)
                assert pt.parse_trace_name(name) == jt.parse_trace_name(name)
    for bad in ("trace-p.jsonl", "trace-p0.i.jsonl", "Trace-p0.jsonl", "trace-p0.json",
                "heartbeat-p0.json", "trace-p0.jsonl.tmp"):
        assert pt.parse_sink_name(bad) == jt.parse_sink_name(bad) is None


def test_next_incarnation_equals_jax(tmp_path):
    assert pt.next_incarnation(str(tmp_path / "none"), 0) == 0
    assert pt.next_incarnation(None) == jt.next_incarnation(None) == 0
    for name in ("trace-p0.jsonl", "trace-p0.i1.trace.json", "trace-p1.i4.jsonl",
                 "health-p0.i9.jsonl", "data-p2.i3.jsonl", "trace-p2.jsonl.tmp.1"):
        (tmp_path / name).write_text("")
        for pid in range(4):
            assert pt.next_incarnation(str(tmp_path), pid) == \
                jt.next_incarnation(str(tmp_path), pid)
    assert [pt.next_incarnation(str(tmp_path), p) for p in range(3)] == [2, 5, 0]
    assert pt.next_incarnation(str(tmp_path), 0, prefix="health") == 10


CONFIGS = [
    {"seed": 3, "lr": 0.01, "per_shard_batch": 32, "n_devices": 8, "kernels": True,
     "telemetry_dir": "/x", "mesh": {"data": 8}, "model": "vit_s4"},
    {"seed": 0, "per_shard_batch": 16, "tuple": (1, 2), "nested": {"b": [1, 2.5], "a": None}},
    {},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["train", "nested", "empty"])
def test_config_digests_equal_jax(cfg):
    assert pt.config_digest(cfg) == jt.config_digest(cfg)
    for data_size in (None, 1, 4):
        assert pt.quality_digest(cfg, data_size=data_size) == \
            jt.quality_digest(cfg, data_size=data_size)
    assert pt.PROVENANCE_SCHEMA_VERSION == jt.PROVENANCE_SCHEMA_VERSION
    assert (pt.SCHEMA_VERSION, pt.RUN_META_SCHEMA_VERSION, pt.EVAL_POINT_SCHEMA_VERSION) == \
        (jt.SCHEMA_VERSION, jt.RUN_META_SCHEMA_VERSION, jt.EVAL_POINT_SCHEMA_VERSION) == (1, 1, 1)
    assert pt.git_provenance() == jt.git_provenance()


def test_null_is_inert_and_unknown_sink_raises_the_jax_message(tmp_path):
    tel = pt.build_telemetry(None)
    assert tel is pt.NULL and not tel.enabled
    before = pt.default_registry().snapshot()
    with tel.span("anything"):
        tel.instant("x")
        tel.count("never")
        tel.emit_counters()
    tel.close()
    assert pt.default_registry().snapshot() == before
    with pytest.raises(ValueError) as port_err:
        pt.build_telemetry(str(tmp_path), sinks="jsonl,bogus")
    with pytest.raises(ValueError) as jax_err:
        jt.build_telemetry(str(tmp_path), sinks="jsonl,bogus", jax_hooks=False)
    assert str(port_err.value) == str(jax_err.value)
    assert pt.DEFAULT_SINKS == jt.DEFAULT_SINKS
    assert pt.HANG_EXIT_CODE == jt.HANG_EXIT_CODE == 113


def _write_trace(path, spans, pid=0, header=True):
    with open(path, "w") as f:
        if header:
            f.write(json.dumps({"schema_version": 1, "type": "header",
                                "epoch_unix": 0.0, "pid": pid}) + "\n")
        for step, (name, dur) in enumerate(spans):
            f.write(json.dumps({"schema_version": 1, "type": "span", "name": name,
                                "ts_s": step * 0.1, "dur_s": dur, "pid": pid, "tid": 1,
                                "depth": 0, "step": step}) + "\n")
        f.write(json.dumps({"schema_version": 1, "type": "counters", "name": "counters",
                            "ts_s": 9.0, "pid": pid, "tid": 1,
                            "attrs": {"counters": {"train/steps": len(spans)},
                                      "gauges": {"train/mfu": 0.5}, "histograms": {}}}) + "\n")


def test_summarizer_equals_jax_and_tolerates_a_torn_line(tmp_path):
    for host, ms in enumerate([10.0, 10.0, 10.0, 31.0]):
        _write_trace(tmp_path / f"trace-p{host}.jsonl",
                     [("compiled_step", ms / 1e3)] * 10 + [("data_wait", 0.002)] * 3, host)
    _write_trace(tmp_path / "trace-p0.i1.jsonl", [("compiled_step", 0.02)], 0)
    with open(tmp_path / "trace-p3.jsonl", "a") as f:
        f.write('{"schema_version": 1, "type": "span", "na')     # a crash, torn
    out = psum.summarize(str(tmp_path))
    assert out == jsum.summarize(str(tmp_path))
    assert "per-host skew: compiled_step" in out and "host 3" in out and "21.00ms" in out
    assert psum.find_trace_files(str(tmp_path)) == jsum.find_trace_files(str(tmp_path))
    assert psum.summarize_json(str(tmp_path)) == jsum.summarize_json(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        psum.find_trace_files(str(tmp_path / "nope"))


def test_summarize_entry_point(tmp_path, capsys):
    from tpu_ddp_torch.cli.main import main

    _write_trace(tmp_path / "trace-p0.jsonl", [("compiled_step", 0.01)] * 5)
    assert main(["trace", "summarize", str(tmp_path)]) == 0
    assert "compiled_step" in capsys.readouterr().out
    assert main(["trace", "summarize", "--json", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["type"] == "trace_summary"
    assert main(["trace", "summarize", str(tmp_path / "nope")]) == 2


class _Capture:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


def test_watchdog_fires_on_a_stalled_step(tmp_path):
    dumps, cap = [], _Capture()
    tel = pt.Telemetry([cap], registry=pt.Registry())
    wd = pt.HangWatchdog(0.15, heartbeat_dir=str(tmp_path), telemetry=tel,
                         on_hang=dumps.append, poll_interval=0.02).start()
    try:
        wd.beat(step=12)
        time.sleep(0.5)                       # the stalled step
    finally:
        wd.stop()
    assert wd.fired and wd.fire_count == 1    # one dump a stall
    assert "thread" in dumps[0] and "tpu_ddp_torch watchdog" in dumps[0]
    assert json.load(open(tmp_path / "heartbeat-p0.json"))["step"] == 12
    assert (tmp_path / "hang-p0.log").exists()
    assert any(e.name == "watchdog_hang" for e in cap.events)
    assert tel.registry.counter("watchdog/hangs").value == 1


def test_watchdog_silent_on_a_healthy_run():
    wd = pt.HangWatchdog(0.3, poll_interval=0.02).start()
    try:
        for step in range(6):
            wd.beat(step)
            time.sleep(0.03)
    finally:
        wd.stop()
    assert not wd.fired


def test_watchdog_heartbeat_freshness_contract(tmp_path):
    from tpu_ddp_torch.telemetry.watchdog import heartbeat_age_seconds, read_heartbeat

    wd = pt.HangWatchdog(0.3, heartbeat_dir=str(tmp_path), poll_interval=10.0)
    path = str(tmp_path / "heartbeat-p0.json")
    wd.beat(step=1)
    rec = read_heartbeat(path)
    assert rec["step"] == 1 and rec["pid"] > 0 and heartbeat_age_seconds(rec) < 5.0
    wd.beat(step=2)                           # inside the 1 s rate limit
    assert read_heartbeat(path)["step"] == 1
    wd._last_file_write -= 2.0
    wd.beat(step=3)
    assert read_heartbeat(path)["step"] == 3
    assert wd.seconds_since_beat() < 0.3 and not wd.is_stale()
    wd._last_beat -= 0.5
    assert wd.is_stale()
    wd.beat(step=4)
    assert not wd.is_stale()
    wd.beat(step=5)
    wd.stop()                                 # the last step, past the limiter
    assert read_heartbeat(path)["step"] == 5
    assert read_heartbeat(str(tmp_path / "absent.json")) is None
    assert heartbeat_age_seconds(None) is None


def test_watchdog_abort_exits_with_the_hang_code(tmp_path):
    code = ("import time, tpu_ddp_torch.telemetry as t; "
            f"w = t.HangWatchdog(0.1, heartbeat_dir={str(tmp_path)!r}, poll_interval=0.02, "
            "abort_on_hang=True).start(); w.beat(4); time.sleep(20)")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          timeout=30)
    assert proc.returncode == 113
    assert b"--watchdog-abort escalation" in proc.stderr
    assert json.load(open(tmp_path / "heartbeat-p0.json"))["step"] == 4


@pytest.mark.parametrize("seed", [0, 7, -3, 2**63 + 5])
def test_native_row_digests_equal_the_jax_batch_digest(seed):
    """The native prefetcher's per-row keyed BLAKE2b (``native/blake2b.h``),
    folded by ``xor_row_digests``, is the JAX ``batch_digest`` of the rows
    it gathered: rows shorter and longer than a block, partial masks, and a
    job of over 1 MiB that the gather fans out over threads."""
    from tpu_ddp.datapath.audit import batch_digest
    from tpu_ddp_torch.datapath.audit import xor_row_digests
    from tpu_ddp_torch.native.prefetch import BatchPrefetcher

    rng = np.random.default_rng(seed % 1000)
    for shape, sizes in (((32, 32, 3), (1, 32, 128)), ((5,), (3, 40))):
        images = rng.standard_normal((200,) + shape).astype(np.float32)
        labels = rng.integers(0, 10, 200).astype(np.int32)
        with BatchPrefetcher(images, labels, max_batch=128, depth=2, digest_seed=seed) as pf:
            for n in sizes:
                idx = rng.integers(0, 200, n)
                mask = rng.random(n) < 0.7
                pf.submit(idx)
                _, _, slot = pf.acquire()
                got = xor_row_digests(pf.row_digests(slot, n), mask)
                pf.release(slot)
                assert got == batch_digest(images[idx], labels[idx], mask, seed=seed)
