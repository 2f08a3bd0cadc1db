"""The port's goodput ledger (``tpu_ddp_torch/ledger``) and elastic decision
log (``tpu_ddp_torch/elastic/recovery.py``) against the JAX package's, on the
same run dirs: the ledger's JSON equal once ``torch_version`` stands for
``jax_version`` (floats exactly equal: the arithmetic is the same stdlib
arithmetic) and the rendered text equal.

Run dirs (``tests/torch_readers.py``): a port run killed at step 7 after
its step-4 checkpoint committed and resumed to the end (two lives, killed
then clean), a clean port run, a port run whose first life hung past the
watchdog's deadline before it died, and one clean run of the JAX trainer.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import os
import shutil

import pytest
import torch
from torch_readers import (
    CHECKPOINT_STEPS,
    KILL_AT,
    assert_same,
    header_meta,
    incident,
    jax_names,
    port_run,
)

import tpu_ddp.elastic.recovery as jrec
import tpu_ddp.ledger as jl
import tpu_ddp_torch.elastic.recovery as prec
import tpu_ddp_torch.ledger as pl
from tpu_ddp.analysis import regress as jreg
from tpu_ddp_torch.analysis import regress as preg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    import jax

    from tpu_ddp.cli.train import main as jax_main
    from tpu_ddp.telemetry import reset_default_registry

    root = tmp_path_factory.mktemp("ledger")
    out = {"incident": incident(str(root / "incident")),
           "clean": port_run(str(root / "clean")).config.telemetry_dir}
    hang = str(root / "hang")
    port_run(hang, kill_at=6, stall_s=1.0, watchdog_deadline_seconds=0.2)
    port_run(hang, resume=True)
    out["hang"] = hang
    jax.config.update("jax_platforms", "cpu")
    reset_default_registry()
    out["jax"] = str(root / "jax")
    jax_main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
              "--batch-size", "32", "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2",
              "--health", "on", "--telemetry-dir", out["jax"], "--telemetry-sinks", "jsonl",
              "--n-devices", "1", "--log-every-epochs", "1"])
    reset_default_registry()
    return out


def _versions(run_dir):
    meta = header_meta(run_dir)
    return meta.get("torch_version"), meta.get("jax_version")


def _ledgers(run_dir):
    return (pl.build_ledger(pl.stitch_run(run_dir)),
            jl.build_ledger(jl.stitch_run(run_dir)))


@pytest.mark.parametrize("name", ["incident", "clean", "hang", "jax"])
def test_ledger_json_and_text_equal_jax(dirs, name):
    port, jax_ = _ledgers(dirs[name])
    art, text = pl.ledger_json(port), pl.render_ledger(port)
    jax_art, jax_text = jl.ledger_json(jax_), jl.render_ledger(jax_)
    assert_same(art, jax_art, *_versions(dirs[name]))
    assert jax_names(text) == jax_text


def test_kill_and_resume_ledger(dirs):
    port, _ = _ledgers(dirs["incident"])
    first, second = port.incarnations
    assert (first.exit, second.exit) == ("killed", "clean")
    assert first.executed_through == KILL_AT
    assert second.first_step == CHECKPOINT_STEPS
    assert second.replayed_steps == port.replayed_steps == KILL_AT - CHECKPOINT_STEPS
    assert second.restart_gap_before_s > 0
    assert port.categories["restart_gap"] > 0 and port.categories["replayed"] > 0
    assert abs(sum(port.categories.values()) - port.elapsed_s) <= 1e-6
    assert port.checkpoint_count >= 1 and port.n_failures == 1
    # the port compiles no step: the JAX category is there, at 0 s
    assert port.categories["compile"] == 0.0
    art = pl.ledger_json(port)["ledger"]
    assert art["category_seconds"]["compile"] == 0.0
    assert art["exit_counts"] == {"killed": 1, "clean": 1}
    assert art["torch_version"] == torch.__version__ and "jax_version" not in art
    # effective throughput discounts the replayed steps' images
    assert port.replayed_images == (KILL_AT - CHECKPOINT_STEPS) * 32
    assert port.recommendation is not None


def test_clean_run_books_no_restart(dirs):
    port, _ = _ledgers(dirs["clean"])
    assert [e.exit for e in port.incarnations] == ["clean"]
    for cat in ("restart_gap", "replayed", "stall", "compile"):
        assert port.categories[cat] == 0.0
    assert port.mtbf_s is None and port.recommendation is None
    assert abs(sum(port.categories.values()) - port.elapsed_s) <= 1e-6


def test_a_hang_life_gives_a_ledger(dirs):
    """The port's watchdog wrote ``watchdog_hang`` and the life died without
    ``run_end``: classified ``hang``, its quiet tail up to the watchdog's
    instant (the deadline, 0.2 s, past its last beat) booked as stall, and
    no hang-forensics note (the port writes no bundle until ``comms/``)."""
    port, _ = _ledgers(dirs["hang"])
    assert [e.exit for e in port.incarnations] == ["hang", "clean"]
    assert port.categories["stall"] > 0.1
    assert not any("forensics" in n for n in port.notes)
    assert port.incarnations[1].replayed_steps == 6 - CHECKPOINT_STEPS


def test_the_port_reads_a_jax_run_dir(dirs):
    port, jax_ = _ledgers(dirs["jax"])
    assert [e.exit for e in port.incarnations] == ["clean"]
    assert port.torch_version is None and jax_.jax_version == header_meta(
        dirs["jax"])["jax_version"]


def test_elastic_decisions_join_the_ledger(dirs, tmp_path):
    run_dir = str(tmp_path / "supervised")
    shutil.copytree(dirs["incident"], run_dir)
    prec.append_decision(run_dir, {"event": "launch", "incarnation": 0,
                                   "plan": {"n_devices": 1}})
    jrec.append_decision(run_dir, {
        "event": "restart", "incarnation": 1, "exit_class": "killed", "attempt": 1,
        "backoff_s": 0.25, "plan": {"n_devices": 1, "mesh": {"data": 1}},
        "recovery": prec.resume_assessment(os.path.join(run_dir, "ckpt"))})
    with open(os.path.join(run_dir, "elastic.jsonl"), "a") as f:
        f.write('{"torn": ')           # a supervisor killed mid-write
    assert prec.read_decisions(run_dir) == jrec.read_decisions(run_dir)
    assert len(prec.read_decisions(run_dir)) == 2
    port, jax_ = _ledgers(run_dir)
    art = pl.ledger_json(port)
    assert len(art["ledger"]["elastic"]["decisions"]) == 2
    assert_same(art, jl.ledger_json(jax_), *_versions(run_dir))
    text = pl.render_ledger(port)
    assert "restart -> incarnation 1" in text
    assert jax_names(text) == jl.render_ledger(jax_)


def test_resume_assessment_equals_jax(dirs, tmp_path):
    ck = os.path.join(dirs["incident"], "ckpt")
    assert prec.resume_assessment(ck) == jrec.resume_assessment(ck)
    assert prec.resume_assessment(ck)["verified"] is True
    assert prec.resume_assessment(None) == jrec.resume_assessment(None)
    empty = str(tmp_path / "empty_ckpt")
    os.makedirs(empty)
    assert prec.resume_assessment(empty) == jrec.resume_assessment(empty)
    assert prec.resume_assessment(empty)["resume_step"] is None


@pytest.mark.parametrize("pair", [("clean", "incident"), ("incident", "clean"),
                                  ("incident", "incident"), ("clean", "hang")])
def test_compare_goodput_artifacts_equal_jax(dirs, pair):
    old, new = (pl.ledger_json(_ledgers(dirs[n])[0]) for n in pair)
    port = preg.compare(preg.normalize_artifact(old), preg.normalize_artifact(new))
    assert port == jreg.compare(jreg.normalize_artifact(old), jreg.normalize_artifact(new))
    if pair == ("clean", "incident"):
        joined = "\n".join(port["regressions"])
        assert "badput/restart_gap" in joined and "exits/killed" in joined
    if pair[0] == pair[1]:
        assert port["regressions"] == []


@pytest.mark.parametrize("inputs", [
    dict(checkpoint_cost_s=2.0, mtbf_s=400.0, steps_per_sec=2.0, current_interval_s=120.0),
    dict(checkpoint_cost_s=2.0, mtbf_s=400.0, current_interval_s=5.0),
    dict(checkpoint_cost_s=2.0, mtbf_s=400.0, current_interval_s=42.0),
    dict(checkpoint_cost_s=0.013, mtbf_s=3.7, steps_per_sec=61.0),
    dict(checkpoint_cost_s=None, mtbf_s=10.0),
    dict(checkpoint_cost_s=1.0, mtbf_s=None),
])
def test_advisor_equals_jax(inputs):
    assert pl.recommend_interval(**inputs) == jl.recommend_interval(**inputs)
    assert pl.mtbf_seconds(100.0, 3) == jl.mtbf_seconds(100.0, 3)
    assert pl.young_daly_interval(2.0, 400.0) == jl.young_daly_interval(2.0, 400.0) == 40.0
