"""The port's memory truth loop (``tpu_ddp_torch/memtrack/``) against the JAX
package's (``tpu_ddp/memtrack/``) on the same inputs:

- ``is_resource_exhausted`` on ``tests/test_memtrack.py``'s exceptions and on
  the real ``torch.cuda.OutOfMemoryError`` (whose "CUDA out of memory" the
  JAX pattern's "out of memory" matches); the sampler's stride over fused
  steps; a postmortem bundle either package writes, read by both; the
  MEM001 fleets of ``tests/test_memtrack.py`` through both aggregators and
  alert engines (exact, at one injected ``now``);
- the port's run dirs: one with every observatory on
  (``tests/torch_observatories.py``), whose CPU memory record (the JAX keys,
  ``bytes_in_use`` null, source ``none``) both packages' ``measured_summary``
  and ``mem --json --no-plan`` read to the same result (``torch_version``
  standing for ``jax_version``); and one whose step raises
  ``torch.cuda.OutOfMemoryError`` at step 3: its ``oom/step_2-p0/`` bundle,
  ``memory/oom_events`` and ``oom_abort``, the life both packages'
  ``goodput`` book as ``oom``, and ``mem``'s exit 1;
- ``quality_digest``: unchanged by the eight new config fields.
"""

import contextlib
import dataclasses
import io
import json
import os

import pytest
import torch
from test_memtrack import _fleet_dir
from torch_observatories import BASE, observed_run

import tpu_ddp.memtrack.postmortem as jp
import tpu_ddp.memtrack.reconcile as jr
import tpu_ddp.memtrack.report as jrep
import tpu_ddp_torch.memtrack.postmortem as pp
import tpu_ddp_torch.memtrack.reconcile as pr
import tpu_ddp_torch.memtrack.report as prep
from tpu_ddp_torch.memtrack.sampler import MemorySampler

OOM_AT = 3


class _OomAt:
    """A train step that raises the allocator's exception on its
    ``OOM_AT``-th call, as a card that cannot fit the step does."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __call__(self, state, batch):
        self.calls += 1
        if self.calls == OOM_AT:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
                "capacity of 79.11 GiB of which 1.02 GiB is free.")
        return self.inner(state, batch)


def _oom_run(run_dir):
    from tpu_ddp_torch.telemetry import reset_default_registry
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    reset_default_registry()
    keep = ("device", "synthetic_data", "synthetic_size", "per_shard_batch", "n_chans1",
            "n_blocks", "telemetry_sinks")
    t = Trainer(TrainConfig(**{k: BASE[k] for k in keep}, epochs=1, telemetry_dir=run_dir))
    t.train_step = _OomAt(t.train_step)
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            t.run()
        counters = t.telemetry.registry.snapshot()["counters"]
    finally:
        t.close()
    return counters


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tmp_path_factory.mktemp("memtrack")
        clean, oom = str(root / "clean"), str(root / "oom")
        observed_run(clean)
        counters = _oom_run(oom)
    finally:
        torch.set_num_threads(n)
    return {"clean": clean, "oom": oom, "oom_counters": counters}


EXCEPTIONS = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 68719476736 "
                 "bytes"),
    RuntimeError("Allocation of 1234 bytes failed"),
    MemoryError("out of memory"),
    RuntimeError("failed to allocate request for 2.5GiB"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB"),
    ValueError("shape mismatch (4, 3) vs (4, 5)"),
    RuntimeError("simulated hard kill"),
    KeyError("missing"),
]


@pytest.mark.parametrize("i", range(len(EXCEPTIONS)))
def test_is_resource_exhausted_as_jax(i):
    exc = EXCEPTIONS[i]
    assert pp.is_resource_exhausted(exc) == jp.is_resource_exhausted(exc) == (i < 5)


def test_sampler_stride_crosses_fused_steps(tmp_path):
    sampler = MemorySampler(str(tmp_path), device="cpu", every=3)
    try:
        for step in (2, 4, 6, 8):
            sampler._next_wall = 0.0
            sampler.on_step(step)
        assert [r["step"] for r in sampler.recent()] == [2, 4, 6]
        rec = sampler.recent()[0]
        assert rec["devices"] == [{"d": 0, "kind": "cpu", "bytes_in_use": None,
                                   "peak_bytes_in_use": None, "bytes_limit": None,
                                   "source": "none"}]
        assert rec["host_rss_bytes"] > 0
    finally:
        sampler.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_postmortem_read_by_both(tmp_path, writer):
    write = (pp if writer == "port" else jp).write_postmortem
    err = torch.cuda.OutOfMemoryError("CUDA out of memory.")
    path = write(str(tmp_path), step=7, process_index=1, incarnation=2, error=err,
                 samples=[{"type": "mem", "step": 7}], config_snapshot={"seed": 0},
                 run_meta={"run_id": "r"})
    assert path == os.path.join(str(tmp_path), "oom", "step_7-p1")
    assert write(str(tmp_path), step=7, process_index=1) == path       # one-shot
    port, jax_ = pp.list_postmortems(str(tmp_path)), jp.list_postmortems(str(tmp_path))
    for m in port + jax_:
        m.pop("wall_time")
    assert port == jax_
    assert port[0]["error_type"] == "OutOfMemoryError" and port[0]["samples"][0]["step"] == 7
    assert pp.attach_plan(path) is None


@pytest.mark.parametrize("fracs,config", [([0.5, 0.5, 0.95, 0.5], {}),
                                          ([0.5, 0.6, 0.5, 0.55], {}),
                                          ([0.99], {"mem_limit_frac": 0.0})])
def test_mem001_fleets_as_jax(tmp_path, fracs, config):
    import time

    import tpu_ddp.monitor as jm
    import tpu_ddp_torch.monitor as pm

    run_dir = _fleet_dir(tmp_path, fracs)
    now = time.time()
    out = []
    for pkg in (pm, jm):
        cfg = pkg.MonitorConfig(**config)
        agg = pkg.FleetAggregator(run_dir, cfg)
        engine = pkg.AlertEngine(cfg, run_dir=run_dir, actions=(), once=True)
        polls = []
        for _ in range(2):
            snap = agg.poll(now=now)
            polls.append((snap.to_json(), [a.to_record() for a in engine.evaluate(snap)]))
        out.append(json.loads(json.dumps(polls).replace("tpu-ddp-torch", "tpu-ddp")))
    assert out[0] == out[1]
    fired = [(e["rule"], e["host"]) for e in out[0][0][1]]
    assert fired == ([("MEM001", 2)] if fracs[2:3] == [0.95] else [])
    assert out[0][1][1] == []                    # edge-triggered


def test_the_cpu_memory_record_read_by_both(dirs):
    clean = dirs["clean"]
    with open(os.path.join(clean, "mem-p0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records[0]["type"] == "header" and records[0]["mem_schema_version"] == 1
    assert "torch_version" in records[0]["run_meta"]
    mem = records[1:]
    steps = [r["step"] for r in mem]       # one a step, less where the duty cycle gates
    assert steps and steps == sorted(set(steps)) and set(steps) <= set(range(1, 11))
    assert all(r["devices"][0]["bytes_in_use"] is None and
               r["devices"][0]["source"] == "none" for r in mem)
    port, jax_ = pr.measured_summary(clean), jr.measured_summary(clean)
    assert port == jax_
    assert port["high_water_bytes"] is None and port["hosts"][0]["source"] == "none"
    assert port["hosts"][0]["samples"] == len(mem)
    rec = pr.reconcile(clean)
    assert rec["planned"] is None and rec["measured_high_water_bytes"] is None
    assert rec["notes"] == [
        "static plan unavailable: the port has no static plan of a recorded run yet "
        "(analysis/ and tools/memplan.py are not ported)", pr.CPU_DEGRADATION_NOTE]
    assert not rec["calibratable"] and rec["chip"] == "cpu"


def _mem(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _versionless(art):
    prov = art.get("provenance") or {}
    return prov.pop("torch_version", None), prov.pop("jax_version", None)


@pytest.mark.parametrize("which", ["clean", "oom"])
def test_mem_json_no_plan_as_jax(dirs, which):
    run_dir = dirs[which]
    rp, out_p = _mem(prep.main, [run_dir, "--json", "--no-plan"])
    rj, out_j = _mem(jrep.main, [run_dir, "--json", "--no-plan"])
    assert rp == rj == (1 if which == "oom" else 0)
    port, jax_ = json.loads(out_p), json.loads(out_j)
    assert _versionless(port) == (torch.__version__, None)
    assert _versionless(jax_) == (None, None)
    assert port == jax_
    assert port["type"] == "memtrack" and port["mem"]["oom_count"] == (which == "oom")
    rp, text = _mem(prep.main, [run_dir, "--no-plan"])
    rj, text_j = _mem(jrep.main, [run_dir, "--no-plan"])
    assert rp == rj and text.replace("tpu-ddp-torch", "tpu-ddp") == text_j


def test_the_oom_bundle_instant_and_ledger(dirs):
    from tpu_ddp.ledger.report import main as jax_goodput
    from tpu_ddp_torch.ledger.report import main as port_goodput

    oom = dirs["oom"]
    assert os.listdir(os.path.join(oom, "oom")) == [f"step_{OOM_AT - 1}-p0"]
    meta = pp.list_postmortems(oom)[0]
    assert meta["error_type"] == "OutOfMemoryError" and meta["step"] == OOM_AT - 1
    assert "CUDA out of memory" in meta["error"]
    steps = [s["step"] for s in meta["samples"]]
    assert steps[-1] == OOM_AT - 1 and set(steps) <= {1, 2}  # the last one at death
    assert meta["config"]["telemetry_dir"] == oom and meta["run_meta"]["incarnation"] == 0
    assert dirs["oom_counters"]["memory/oom_events"] == 1
    with open(os.path.join(oom, "trace-p0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    aborts = [r for r in records if r.get("name") == "oom_abort"]
    assert len(aborts) == 1 and aborts[0]["step"] == OOM_AT - 1
    assert aborts[0]["attrs"]["bundle"] == os.path.join(oom, "oom", f"step_{OOM_AT - 1}-p0")
    for main in (port_goodput, jax_goodput):
        rc, out = _mem(main, [oom, "--json"])
        assert rc == 0
        assert [e["exit"] for e in json.loads(out)["ledger"]["incarnations"]] == ["oom"]


def test_quality_digest_unchanged_by_the_new_fields():
    from tpu_ddp_torch.telemetry import quality_digest
    from tpu_ddp_torch.train.trainer import TrainConfig

    new = dict(profile_dir="p", profile_steps="1:3", profile_window_steps=3,
               profile_host_hz=50.0, monitor_port=-1, monitor_bind="127.0.0.1",
               monitor_allow_remote_trigger=True, mem_sample_steps=0)
    plain = dataclasses.asdict(TrainConfig(telemetry_dir="t"))
    observed = dataclasses.asdict(TrainConfig(telemetry_dir="t", **new))
    before = {k: v for k, v in plain.items() if k not in new}
    assert quality_digest(observed) == quality_digest(plain) == quality_digest(before)
    assert quality_digest(dict(plain, lr=0.1)) != quality_digest(plain)
