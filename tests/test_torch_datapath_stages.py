"""The port's data-path observatory (``tpu_ddp_torch/datapath/``: ``stages``,
``model``, ``microbench``, ``audit``'s reader, ``report_run``, ``cli``)
against the JAX package's, which is the oracle:

- ``stage_baselines`` on the same artifacts;
- a ``StageMonitor`` fed the same stage sequence writes what the JAX one
  writes, and the JAX ``read_data_health`` / ``suspect_stage_from_files``
  read it the same;
- the port loader with an observer reports the JAX loader's stage sequence,
  byte counts included, on the same data and seed;
- ``data bench --device cpu``: the JAX artifact's keys, both registries
  classify it ``data``, ``bench compare`` of it against itself is clean;
- a stage-targeted ``data_stall`` on a port run: the JAX alert engine
  raises exactly DAT001 against the port's bench, and both ``data report``s
  call the stalled stage dominant;
- ``data audit`` agrees with the JAX ``audit_digests`` on a killed and
  resumed port run, and a mutated digest fails closed naming its step.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
from torch_readers import incident

from tpu_ddp.datapath import model as jax_model
from tpu_ddp.datapath import stages as jax_stages
from tpu_ddp_torch.datapath import model as port_model
from tpu_ddp_torch.datapath import stages as port_stages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCHES = {
    "full": {"data": {"per_image_s": 1e-5, "stages": {
        "index": {"batches_per_s": 1e5}, "gather": {"batches_per_s": 3e3},
        "augment": {"batches_per_s": 0.0}, "h2d": {"batches_per_s": 7e2}}}},
    "bare_record": {"stages": {"shard": {"batches_per_s": 12.5}, "collate": {}}},
    "no_stages": {"data": {"per_image_s": 2e-6}},
    "not_data": {"comms": {}},
}


@pytest.mark.parametrize("case", sorted(BENCHES))
def test_stage_baselines_as_jax(case):
    art = BENCHES[case]
    assert port_model.stage_baselines(art) == jax_model.stage_baselines(art)


def test_data_model_from_sources_as_jax(tmp_path):
    paths = []
    for i, rate in enumerate((1e3, 4e3, 2e3)):
        path = tmp_path / f"b{i}.json"
        path.write_text(json.dumps({"type": "data", "data": {
            "per_image_s": rate * 1e-8, "batch_time_s": 1 / rate, "global_batch": 64,
            "stages": {"gather": {"batches_per_s": rate}, "index": {"batches_per_s": 9e4}}}}))
        paths.append(str(path))
    port = port_model.data_model_from_sources(paths).to_json()
    assert port == jax_model.data_model_from_sources(paths).to_json()
    assert port["dominant_stage"] == "gather"


#: (call, stage, seconds, bytes) sequences the two monitors hear
SEQUENCES = {
    "a_batch": [("step", 1), ("enter", "index"), ("exit", "index", 1e-4, 16),
                ("enter", "gather"), ("exit", "gather", 2e-3, 4096),
                ("enter", "collate"), ("exit", "collate", 1e-5, 4100)],
    "wedged": [("step", 3), ("enter", "index"), ("exit", "index", 1e-4, 16),
               ("enter", "gather")],
}


def _feed(mod, run_dir, seq):
    mon = mod.StageMonitor(run_dir, process_index=1, min_write_interval_s=0.0)
    for call in seq:
        if call[0] == "step":
            mon.set_step(call[1])
        elif call[0] == "enter":
            mon.stage_enter(call[1])
        else:
            mon.stage_exit(*call[1:])
    return mon


def _stable(rec):
    """A health record without its wall-clock fields."""
    rec = json.loads(json.dumps(rec))
    rec.pop("updated_unix")
    for view in rec["stages"].values():
        view.pop("window_span_s")
    if rec["in_flight"]:
        rec["in_flight"].pop("since_unix")
    return rec


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_stage_monitor_files_read_by_jax(tmp_path, case):
    read = {}
    for name, mod in (("port", port_stages), ("jax", jax_stages)):
        run_dir = str(tmp_path / name)
        os.makedirs(run_dir)
        _feed(mod, run_dir, SEQUENCES[case])
        rec = jax_stages.read_data_health(jax_stages.data_health_file(run_dir, 1))
        suspect = jax_stages.suspect_stage_from_files(run_dir)
        suspect.pop("since_unix")
        read[name] = (_stable(rec), suspect)
    assert read["port"] == read["jax"]
    assert read["port"][1]["stage"] == "gather"
    assert port_stages.STAGES == jax_stages.STAGES


class Recorder:
    def __init__(self):
        self.calls = []

    def stage_enter(self, stage):
        self.calls.append(("enter", stage))

    def stage_exit(self, stage, seconds, nbytes):
        assert seconds >= 0
        self.calls.append(("exit", stage, nbytes))


def test_loader_observer_sequence_as_jax():
    from tpu_ddp.data.loader import ShardedBatchLoader as JaxLoader
    from tpu_ddp_torch.data.loader import ShardedBatchLoader

    rng = np.random.default_rng(0)
    images = rng.random((100, 8, 8, 3), dtype=np.float32)
    labels = rng.integers(0, 10, 100).astype(np.int32)
    seqs, batches = [], []
    for cls in (ShardedBatchLoader, JaxLoader):
        rec = Recorder()
        loader = cls(images, labels, world_size=2, per_shard_batch=16, seed=3,
                     process_index=1, process_count=2, observer=rec)
        batches.append(list(loader.epoch_batches(1)))
        seqs.append(rec.calls)
    assert seqs[0] == seqs[1]
    assert [c[1] for c in seqs[0][:10:2]] == list(port_stages.HOST_STAGES)
    for a, b in zip(*batches):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()
                if k not in ("stages", "rows", "provenance", "skipped")}
    return None


def test_data_bench_artifact_as_jax(tmp_path):
    from tpu_ddp.analysis.regress import main as jax_compare
    from tpu_ddp.datapath.microbench import bench_artifact, run_stage_bench
    from tpu_ddp.registry.store import _artifact_kind as jax_kind
    from tpu_ddp_torch.cli.main import main as port_main
    from tpu_ddp_torch.registry.store import _artifact_kind as port_kind

    path = str(tmp_path / "bench.json")
    rc, out = _cli(port_main, ["data", "bench", "--device", "cpu", "--n", "256", "--batch",
                               "32", "--reps", "2", "--out", path])
    assert rc == 0 and "skipped h2d: --device cpu: no card to copy to" in out
    with open(path) as f:
        port = json.load(f)
    stages, skipped, headline = run_stage_bench(n=256, per_shard_batch=32, reps=2, h2d=False)
    jax_ = bench_artifact(stages, skipped, headline, n=256, per_shard_batch=32, reps=2)
    assert _keys(port) == _keys(jax_)
    assert set(port["data"]["stages"]) == set(jax_["data"]["stages"]) == set(
        port_stages.HOST_STAGES)
    assert set(port["data"]["rows"]) == set(jax_["data"]["rows"])
    assert port["data"]["skipped"] == [{"stage": "h2d",
                                        "error": "--device cpu: no card to copy to"}]
    assert port_kind(port) == jax_kind(port) == "data"
    assert port_model.stage_baselines(port).keys() == set(port_stages.HOST_STAGES)
    assert _cli(port_main, ["bench", "compare", path, path])[0] == 0
    assert _cli(jax_compare, [path, path])[0] == 0


def _run(run_dir, spec, **kw):
    from tpu_ddp_torch.telemetry import reset_default_registry
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    reset_default_registry()
    t = Trainer(TrainConfig(device="cpu", synthetic_data=True, synthetic_size=192,
                            epochs=1, n_chans1=16, n_blocks=2, telemetry_dir=run_dir,
                            telemetry_sinks="jsonl", chaos_spec=spec, **kw))
    try:
        t.run()
    finally:
        t.close()
    return t


#: the rules that judge the observatories' health files
HEALTH_RULES = ("COM001", "DAT001")


@pytest.mark.parametrize("path", [dict(prefetch_depth=0), dict(prefetch_batches=2)],
                         ids=["synchronous", "staged"])
def test_stage_stall_fires_dat001_and_names_the_stage(tmp_path, path):
    """Six steps, the gather stalled in each batch from step 2 on
    (``batches``: 5), so the stall stays inside the stage monitor's 5 s
    window however long a loaded host makes the run. The data
    wait itself may also fire DWT001; of the health-file rules DAT001 alone
    fires. DAT001 names the stage whose rate fell furthest below its bench,
    which on a loaded host may be a sub-millisecond stage carrying the
    monitor's file writes; the report's totals name the stalled gather."""
    from tpu_ddp.datapath.report import report_run as jax_report
    from tpu_ddp.monitor.watch import main as jax_watch
    from tpu_ddp_torch.datapath.report import report_run

    run_dir = str(tmp_path / "run")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"chaos_schema_version": 1, "faults": [
        {"kind": "data_stall", "step": 2, "stage": "gather", "stall_s": 0.2,
         "batches": 5}]}))
    _run(run_dir, str(spec), **path)
    bench = str(tmp_path / "bench.json")
    from tpu_ddp_torch.cli.main import main as port_main

    assert _cli(port_main, ["data", "bench", "--device", "cpu", "--n", "192", "--batch",
                            "32", "--reps", "2", "--out", bench])[0] == 0
    rc, out = _cli(jax_watch, [run_dir, "--once", "--json", "--no-alerts-file",
                               "--data-baseline", bench])
    fired = [(a["rule"], a["host"]) for a in json.loads(out)["alerts"]
             if a["state"] == "firing" and a["rule"] in HEALTH_RULES]
    assert rc == 1 and fired == [("DAT001", 0)]
    for report in (report_run, jax_report):
        rec = report(run_dir)
        assert rec["ok"] and rec["dominant_stage"] == "gather"


def test_data_audit_as_jax_and_fails_closed(tmp_path):
    from tpu_ddp.datapath.audit import audit_digests as jax_audit
    from tpu_ddp_torch.cli.main import main as port_main
    from tpu_ddp_torch.datapath.audit import audit_digests

    run_dir = incident(str(tmp_path / "incident"), epochs=1)
    port = audit_digests(run_dir)
    assert port == jax_audit(run_dir)
    assert port["ok"] and port["incarnations"] == [0, 1] and port["steps_compared"] == 3
    assert _cli(port_main, ["data", "audit", run_dir])[0] == 0
    # flip one recorded digest of the resumed life: the audit names the step
    path = os.path.join(run_dir, "data-p0.i1.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    step = min(r["step"] for r in recs if r["type"] == "digest")
    for r in recs:
        if r.get("step") == step:
            r["digest"] = f"{int(r['digest'], 16) ^ 1:016x}"
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    bad = audit_digests(run_dir)
    assert bad == jax_audit(run_dir)
    assert not bad["ok"] and bad["pairs"][0]["first_diverging_step"] == step
    rc, out = _cli(port_main, ["data", "audit", run_dir])
    assert rc == 1 and f"FAIL at step {step}" in out
    assert _cli(port_main, ["data", "audit", str(tmp_path)])[0] == 2
