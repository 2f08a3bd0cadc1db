"""The port's trainer telemetry against the JAX trainer's on one config:
NetResDeep (``n_chans1=8, n_blocks=2``) on synthetic data, one rank and one
JAX CPU device, two epochs of five steps, a checkpoint each epoch and
``--health on``, both through their CLIs with ``--telemetry-dir``. The JAX
summarizer reads the port's run dir; the step phases, the counters, the
eval points and the data digests equal the JAX run's; the run header has
the JAX keys (torch's and CUDA's versions in place of jax's); the losses
are bitwise those of the same port run without telemetry; a resumed run
writes the next incarnation's files and leaves the first life's whole.
Then one short run a step family (fused, accumulating, ``--zero1``,
``--zero3``, ``--grad-compress``, sp, tp, pp and ep), each on one rank in
this process (a mesh of size-1 axes runs the family's step), carries the
three step phases and ``train/steps``."""

import json
import os

import pytest

import tpu_ddp.telemetry as jt
import tpu_ddp_torch.telemetry as pt
from tpu_ddp.telemetry.summarize import summarize_json

STEP_PHASES = {"data_wait", "compiled_step", "device_sync"}
COUNTERS = ("train/steps", "train/images", "loader/batches", "checkpoint/saves",
            "checkpoint/completed", "health/nonfinite_steps")


def _argv(tmp, name, telemetry=True, epochs=2, *extra):
    argv = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "40",
            "--batch-size", "8", "--epochs", str(epochs), "--n-chans1", "8",
            "--n-blocks", "2", "--kernels", "--eval-each-epoch", "--log-every-epochs", "1",
            "--checkpoint-dir", str(tmp / f"ck_{name}"), "--checkpoint-every-epochs", "1",
            "--health", "on", "--watchdog-deadline", "300", *extra]
    return argv + (["--telemetry-dir", str(tmp / name)] if telemetry else [])


def _port(argv):
    from tpu_ddp_torch.cli import train as cli

    pt.reset_default_registry()
    return cli.run(argv)[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from tpu_ddp.cli.train import main as jax_main

    tmp = tmp_path_factory.mktemp("tel")
    jax.config.update("jax_platforms", "cpu")
    jt.reset_default_registry()
    jax_main(_argv(tmp, "jax") + ["--n-devices", "1"])
    port = _port(_argv(tmp, "port"))
    plain = _port(_argv(tmp, "plain", telemetry=False))
    first = {n: (tmp / "port" / n).read_bytes() for n in os.listdir(tmp / "port")
             if n.endswith(".jsonl")}
    _port(_argv(tmp, "port", True, 3, "--resume"))
    return tmp, port, plain, first


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_the_jax_summarizer_reads_the_port_run_dir(runs):
    tmp = runs[0]
    whole = summarize_json(str(tmp / "port"))         # both lives
    port = summarize_json(str(tmp / "port" / "trace-p0.jsonl"))
    jax_ = summarize_json(str(tmp / "jax"))
    assert set(port["phases"]) >= STEP_PHASES | {"h2d", "epoch_metrics_fetch", "eval",
                                                 "checkpoint"}
    # the port's loader runs the JAX loader's five stages, augment included
    assert set(port["phases"]) == set(jax_["phases"])
    assert set(whole["phases"]) == set(port["phases"]) | {"checkpoint_restore"}
    assert port["run_meta"]["strategy"] == jax_["run_meta"]["strategy"] == "dp"


def _first_life(tmp, name):
    """The counters and eval points of the run's first life (the resumed
    life's files are left out)."""
    files = [str(tmp / name / "trace-p0.jsonl")]
    from tpu_ddp.telemetry.summarize import eval_points, last_counters, read_records

    records = read_records(files)
    snap = last_counters(records)[0]
    return {**snap["counters"], **snap["gauges"]}, eval_points(records), records


def test_counters_and_eval_points_equal_the_jax_run(runs):
    tmp = runs[0]
    port, port_evals, _ = _first_life(tmp, "port")
    jax_, jax_evals, _ = _first_life(tmp, "jax")
    assert {k: port.get(k) for k in COUNTERS} == {k: jax_.get(k) for k in COUNTERS}
    assert port["train/steps"] == 10 and port["train/images"] == 80
    assert port["checkpoint/saves"] == 2 and port["loader/batches"] == 24
    assert [(p["step"], p["epoch"], p["final"]) for p in port_evals] == \
        [(p["step"], p["epoch"], p["final"]) for p in jax_evals] == \
        [(5, 1, False), (10, 2, False), (10, None, True)]
    for key in ("eval/final_test_accuracy", "eval/test_loss", "train/steps_per_sec",
                "goodput/fraction", "memory/host_rss_bytes", "health/grad_norm",
                "throughput/images_per_sec_per_chip"):
        assert key in port and key in jax_


def test_every_step_carries_the_three_phases(runs):
    _, _, records = _first_life(runs[0], "port")
    by_step = {}
    for r in records:
        if r["type"] == "span" and r["name"] in STEP_PHASES:
            by_step.setdefault(r["step"], set()).add(r["name"])
    assert sorted(s for s, names in by_step.items() if names == STEP_PHASES) == list(range(10))
    assert not any(r["type"] == "instant" and r["name"] == "watchdog_hang" for r in records)
    assert [r["name"] for r in records if r["type"] == "counters"][0] == "counters_baseline"
    assert records[-1]["type"] == "counters" and records[-2]["name"] == "run_end"


def test_data_digests_equal_the_jax_run(runs):
    tmp = runs[0]
    port = _records(tmp / "port" / "data-p0.jsonl")
    jax_ = _records(tmp / "jax" / "data-p0.jsonl")
    assert port[1:] == jax_[1:] and len(port) == 11
    drop = lambda h: {k: v for k, v in h.items() if k != "run_id"}  # noqa: E731
    assert drop(port[0]) == drop(jax_[0])


def test_heartbeat_header_and_chrome_trace(runs):
    tmp = runs[0]
    assert json.load(open(tmp / "port" / "heartbeat-p0.json"))["step"] == 15  # the resumed life's
    port = runs[3]["trace-p0.jsonl"].decode().splitlines()[0]
    header = json.loads(port)["run_meta"]
    jax_header = _records(tmp / "jax" / "trace-p0.jsonl")[0]["run_meta"]
    assert set(header) == (set(jax_header) - {"jax_version"}) | {"torch_version", "cuda_version"}
    assert header["incarnation"] == 0
    for key in ("device_kind", "mesh", "strategy", "n_devices", "process_count",
                "run_meta_schema_version"):
        assert header[key] == jax_header[key], key
    assert header["mesh"] == {"data": 1, "pipeline": 1, "expert": 1, "sequence": 1, "model": 1}
    assert header["run_id"] == pt.config_digest(header["config"])
    events = json.load(open(tmp / "port" / "trace-p0.trace.json"))["traceEvents"]
    assert STEP_PHASES <= {e["name"] for e in events if e["ph"] == "X"}


def test_losses_bitwise_those_without_telemetry(runs):
    _, port, plain, _ = runs
    assert port["step_losses"] == plain["step_losses"] and len(port["step_losses"]) == 10
    assert port["mfu"] is None                     # no peak on the CPU


def test_a_resumed_run_writes_the_next_incarnation(runs):
    tmp, _, _, first = runs
    names = set(os.listdir(tmp / "port"))
    assert {"trace-p0.i1.jsonl", "trace-p0.i1.trace.json", "health-p0.i1.jsonl",
            "data-p0.i1.jsonl"} <= names
    for name, data in first.items():               # the first life is whole
        assert (tmp / "port" / name).read_bytes() == data
    resumed = _records(tmp / "port" / "trace-p0.i1.jsonl")
    assert resumed[0]["run_meta"]["incarnation"] == 1
    assert any(r["type"] == "span" and r["name"] == "checkpoint_restore" for r in resumed)
    digests = _records(tmp / "port" / "data-p0.i1.jsonl")
    assert [d["step"] for d in digests[1:]] == list(range(10, 15))
    whole = summarize_json(str(tmp / "port"))
    assert whole["files"] == ["trace-p0.jsonl", "trace-p0.i1.jsonl"]


NETRESDEEP = ["--synthetic-size", "32", "--batch-size", "8", "--n-chans1", "8",
              "--n-blocks", "2", "--kernels"]
VIT = ["--synthetic-size", "16", "--batch-size", "8", "--model", "vit_s4",
       "--optimizer", "adamw", "--lr", "1e-3"]
FAMILIES = {
    "fused": NETRESDEEP + ["--steps-per-call", "2"],
    "accumulating": NETRESDEEP + ["--grad-accum-steps", "2"],
    "zero1": NETRESDEEP + ["--zero1"],
    "zero3": NETRESDEEP + ["--zero3"],
    "grad_compress": NETRESDEEP + ["--grad-compress", "int8"],
    "sp": VIT + ["--parallelism", "sp", "--mesh", "data=1,sequence=1"],
    "tp": VIT + ["--parallelism", "tp", "--mesh", "data=1,model=1"],
    "pp": VIT + ["--parallelism", "pp", "--mesh", "data=1,pipeline=1", "--microbatches", "2"],
    "ep": ["--synthetic-size", "16", "--batch-size", "8", "--model", "vit_moe_s4",
           "--optimizer", "adamw", "--lr", "1e-3", "--parallelism", "ep",
           "--mesh", "data=1,expert=1"],
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_step_family_carries_the_step_phases(family, tmp_path):
    run_dir = tmp_path / family
    metrics = _port(["--device", "cpu", "--synthetic-data", "--epochs", "1",
                     "--log-every-epochs", "1", *FAMILIES[family],
                     "--telemetry-dir", str(run_dir), "--telemetry-sinks", "jsonl"])
    records = _records(run_dir / "trace-p0.jsonl")
    steps = {r["step"] for r in records if r["type"] == "span" and r["name"] == "device_sync"}
    for phase in STEP_PHASES:
        assert {r["step"] for r in records if r["type"] == "span" and r["name"] == phase} \
            >= steps, phase
    assert len(steps) == (2 if family == "fused" else metrics["steps"])
    assert records[-1]["attrs"]["counters"]["train/steps"] == metrics["steps"]
    if family == "grad_compress":
        assert records[-1]["attrs"]["counters"]["comm/grad_bytes_on_wire"] == 0
