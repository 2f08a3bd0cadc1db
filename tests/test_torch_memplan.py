"""The memory planner (``tpu_ddp_torch/tools/memplan.py``) and the plan of
a recorded run (``memtrack/postmortem.py``), against the JAX package.

- ``plan()`` on the CPU (the live-tensor tracker; one step of NetResDeep
  at full width, batch 32, four ranks as rank 0 of a fake group): the JAX
  report's keys; its ``zero1``/``zero3`` sections are the JAX
  ``Zero1Partition``/``Zero3Partition.accounting()`` of the same model's
  Flax params (``prefetch_buffer_bytes`` apart: the block order differs
  by design, ``parallel/zero.py``), its ``grad_compress`` section the JAX
  ``wire_bytes_table``; ``argument_bytes - donated_bytes ==
  expected_non_donated_bytes`` exactly; the JAX guards and messages; the
  out-of-memory verdict and the exit 1 of a configuration that does not fit.
- ``plan_for_run_meta`` on a CPU run dir: the JAX keys, ``peak = argument +
  temp``, the largest tensors at the peak; ``attach_plan`` writes
  ``plan.json`` atomically, which the JAX reader reads; ``mem`` shows the
  planned side, and imports neither torch nor numpy once ``plan.json``
  is there; a card run read without a card is the analyze refusal; a
  rebuild that runs out of memory is the plan's verdict, and ``mem`` still
  exits 1 with its report.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tpu_ddp.memtrack.postmortem as jp
import tpu_ddp.tools.memplan as jax_memplan
import tpu_ddp_torch.memtrack.postmortem as pp
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel.compression import wire_bytes_table as jax_wire_bytes_table
from tpu_ddp.parallel.zero import Zero1Partition as JaxZero1Partition
from tpu_ddp.parallel.zero import Zero3Partition as JaxZero3Partition
from tpu_ddp.train import make_optimizer as jax_make_optimizer
from tpu_ddp_torch.memtrack import reconcile as pr
from tpu_ddp_torch.memtrack.reconcile import read_run_meta
from tpu_ddp_torch.tools import memplan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
#: the JAX report's keys (``tpu_ddp/tools/memplan.py``)
JAX_KEYS = {"memplan_schema_version", "model", "parallelism", "zero1", "zero3",
            "grad_compress", "mesh", "image_size", "num_classes", "per_shard_batch",
            "n_devices", "compute_dtype", "remat", "grad_accum_steps", "device_kind",
            "per_device", "donation", "hbm_bytes", "fits", "hbm_fraction"}


@pytest.fixture(scope="module")
def plans():
    return {layout: memplan.plan("netresdeep", 32, compute_dtype="float32", remat=False,
                                 device="cpu", chip="h100", n_devices=N, grad_compress=True,
                                 **({layout: True} if layout != "dp" else {}))
            for layout in ("dp", "zero1", "zero3")}


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxNetResDeep()
    return model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
                      train=False)["params"]


def _param_bytes(params):
    return sum(int(np.prod(p.shape)) * 4 for p in jax.tree.leaves(params))


@pytest.mark.parametrize("layout", ["dp", "zero1", "zero3"])
def test_report_keys_and_accounting(plans, layout):
    rep = plans[layout]
    assert JAX_KEYS <= set(rep) and rep["memplan_schema_version"] == 1
    assert rep["parallelism"] == {"dp": "dp", "zero1": "dp+zero1", "zero3": "dp+zero3"}[layout]
    pd = rep["per_device"]
    assert set(pd) == {"argument_bytes", "output_bytes", "temp_bytes", "est_peak_bytes"}
    assert pd["est_peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"]
    assert pd["temp_bytes"] > 0 and rep["fits"] is True and rep["source"] == "tracker"
    assert rep["hbm_bytes"] == 80_000_000_000
    assert rep["hbm_fraction"] == round(pd["est_peak_bytes"] / rep["hbm_bytes"], 4)
    don = rep["donation"]
    assert don["argument_bytes"] - don["donated_bytes"] == don["expected_non_donated_bytes"]
    assert don["undonated_output_bytes"] == 0
    assert don["expected_non_donated_bytes"] == 32 * (32 * 32 * 3 * 4 + 4 + 1)
    assert rep["top_buffers"] and rep["top_buffers"][0]["bytes"] == max(
        b["bytes"] for b in rep["top_buffers"])
    assert rep["notes"] == []


def test_zero_sections_are_the_jax_accounting(plans, flax_params):
    tx = jax_make_optimizer(lr=1e-1, momentum=0.9, zero1_axis="data")
    want1 = JaxZero1Partition(tx, flax_params, N).accounting()
    want1["params_bytes_per_device"] = _param_bytes(flax_params)
    assert plans["zero1"]["zero1"] == want1 and plans["zero1"]["zero3"] is None
    want3 = JaxZero3Partition(tx, flax_params, N).accounting()
    want3["params_bytes_per_device"] = want3["params_bytes_per_device_sharded"]
    got3 = dict(plans["zero3"]["zero3"])
    assert got3.pop("prefetch_buffer_bytes") > 0
    want3.pop("prefetch_buffer_bytes")
    assert got3 == want3 and plans["zero3"]["zero1"] is None


@pytest.mark.parametrize("layout", ["dp", "zero1", "zero3"])
def test_grad_compress_section_is_the_jax_table(plans, flax_params, layout):
    assert plans[layout]["grad_compress"] == jax_wire_bytes_table(flax_params, N, block=256)


@pytest.mark.parametrize("kw", [dict(parallelism="tp", zero1=True),
                                dict(parallelism="fsdp", zero3=True),
                                dict(zero1=True, zero3=True)])
def test_guards_are_the_jax_ones(kw):
    with pytest.raises(ValueError) as port:
        memplan.plan("netresdeep", 32, compute_dtype="float32", remat=False, device="cpu",
                     **kw)
    with pytest.raises(ValueError) as jax_:
        jax_memplan.plan("netresdeep", 32, compute_dtype="float32", remat=False,
                         topology="v5e:2x2", n_devices=None, **kw)
    assert str(port.value) == str(jax_.value)


@pytest.mark.parametrize("kw,msg", [
    (dict(parallelism="pp", remat=True), "--remat/--grad-accum-steps are not supported"),
    (dict(n_devices=0), "n_devices must be >= 1, got 0"),
    (dict(image_size=224), "the port's trainer trains 32x32 images"),
])
def test_guards_the_jax_planner_checks_later(kw, msg):
    kw = {"remat": False, **kw}
    with pytest.raises(ValueError, match=msg):
        memplan.plan("netresdeep", 32, compute_dtype="float32", device="cpu", **kw)


def test_out_of_memory_is_a_verdict(monkeypatch, capsys):
    """A planning step that runs out of device memory: ``fits`` false, the
    bytes reached a lower bound in a note, and the CLI exits 1."""
    import tpu_ddp_torch.analysis.lint as lint

    def oom(prog, live=None, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(lint, "audit_program", oom)
    rep = memplan.plan("netresdeep", 32, compute_dtype="float32", remat=False, device="cpu")
    assert rep["fits"] is False and rep["donation"] is None
    assert rep["per_device"]["est_peak_bytes"] == rep["tracked"]["argument_bytes"] > 0
    assert "ran out of device memory" in rep["notes"][0]
    with pytest.raises(SystemExit) as exit_:
        memplan.main(["--device", "cpu"])
    assert exit_.value.code == 1
    assert "DOES NOT FIT" in capsys.readouterr().err


def test_the_cli_exit_codes(monkeypatch, tmp_path, capsys):
    out = tmp_path / "plan.json"
    assert memplan.main(["--device", "cpu", "--chip", "h100", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["fits"] is True
    import dataclasses

    import tpu_ddp_torch.analysis.roofline as roofline

    monkeypatch.setitem(roofline.CHIP_SPECS, "h100",
                        dataclasses.replace(roofline.CHIP_SPECS["h100"], hbm_bytes=1000))
    with pytest.raises(SystemExit) as exit_:
        memplan.main(["--device", "cpu", "--chip", "h100"])
    assert exit_.value.code == 1
    assert "DOES NOT FIT" in capsys.readouterr().err


# -- the plan of a recorded run ------------------------------------------------

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    out = str(tmp_path_factory.mktemp("memplan_run") / "run")
    trainer = Trainer(TrainConfig(device="cpu", synthetic_data=True, synthetic_size=128,
                                  epochs=1, per_shard_batch=32, n_chans1=8, n_blocks=2,
                                  kernels=True, prefetch_depth=0, log_every_epochs=1,
                                  telemetry_dir=out))
    try:
        trainer.run()
    finally:
        trainer.close()
    return out


def test_plan_for_run_meta_on_a_cpu_run(run_dir):
    plan = pp.plan_for_run_meta(read_run_meta(run_dir))
    assert set(plan) == {"argument_bytes", "temp_bytes", "output_bytes", "peak_bytes",
                         "top_buffers"}
    assert plan["peak_bytes"] == plan["argument_bytes"] + plan["temp_bytes"] > 0
    assert plan["argument_bytes"] >= 32 * 32 * 32 * 3 * 4            # the batch's images
    rows = plan["top_buffers"]
    assert len(rows) == 10 and all(
        set(r) == {"name", "op", "dtype", "shape", "bytes"} for r in rows)
    assert [r["bytes"] for r in rows] == sorted((r["bytes"] for r in rows), reverse=True)
    rec = pr.reconcile(run_dir)
    assert rec["planned"] == plan and rec["measured_over_planned"] is None
    assert rec["notes"] == [pr.CPU_DEGRADATION_NOTE]


def test_attach_plan_writes_plan_json(run_dir):
    meta = read_run_meta(run_dir)
    bundle = pp.write_postmortem(run_dir, step=3, error=torch.cuda.OutOfMemoryError(
        "CUDA out of memory."), run_meta=meta)
    plan = pp.attach_plan(bundle)
    assert plan == pp.plan_for_run_meta(meta)
    assert sorted(os.listdir(bundle)) == ["meta.json", "plan.json", "run_meta.json",
                                          "samples.jsonl"]
    assert pp.attach_plan(bundle) == plan                   # idempotent
    assert jp.list_postmortems(run_dir)[0]["plan"] == plan   # the JAX reader's


def test_mem_shows_the_plan_stdlib_only(run_dir):
    """With the bundle's ``plan.json`` present, ``mem`` joins it and imports
    neither torch nor numpy."""
    if not os.path.isdir(os.path.join(run_dir, "oom")):
        test_attach_plan_writes_plan_json(run_dir)
    code = ("import sys, json, io, contextlib\n"
            "from tpu_ddp_torch.cli.main import main\n"
            "out = io.StringIO()\n"
            "with contextlib.redirect_stdout(out):\n"
            f"    rc = main(['mem', {run_dir!r}, '--json'])\n"
            "art = json.loads(out.getvalue())\n"
            "print(json.dumps({'rc': rc, 'planned': art['mem']['planned'], "
            "'oom_plan': art['oom'][0]['plan'], "
            "'imported': [m for m in ('torch', 'numpy') if m in sys.modules]}))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    assert res["rc"] == 1 and res["imported"] == []
    with open(os.path.join(run_dir, "oom", "step_3-p0", "plan.json")) as f:
        plan = json.load(f)
    assert res["planned"] == res["oom_plan"] == plan


def test_mem_on_a_rebuild_out_of_memory(run_dir, tmp_path, monkeypatch, capsys):
    """A run that ran out of memory may run out again when ``mem`` rebuilds
    its step: that is the plan's verdict (``fits`` false, no peak, a note),
    written to ``plan.json``, and ``mem`` still exits 1 with its report."""
    import shutil

    import tpu_ddp_torch.analysis.lint as lint
    from tpu_ddp_torch.memtrack import report as prep

    def oom(prog, live=None, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    run = str(tmp_path / "run")
    shutil.copytree(run_dir, run, ignore=shutil.ignore_patterns("oom"))
    bundle = pp.write_postmortem(run, step=3, error=torch.cuda.OutOfMemoryError(
        "CUDA out of memory."), run_meta=read_run_meta(run))
    monkeypatch.setattr(lint, "audit_program", oom)
    assert prep.main([run]) == 1
    text = capsys.readouterr().out
    assert "DOES NOT FIT" in text and "static plan: the rebuilt step ran out of device memory" in text
    with open(os.path.join(bundle, "plan.json")) as f:
        plan = json.load(f)
    assert plan["fits"] is False and plan["peak_bytes"] is None
    assert plan["peak_lower_bound_bytes"] is None          # no allocator off the card
    assert plan["top_buffers"] and plan["top_buffers"][0]["bytes"] > 0
    assert pr.reconcile(run)["measured_over_planned"] is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal of a host without a card")
def test_a_card_run_is_refused_without_a_card(run_dir, tmp_path):
    meta = dict(read_run_meta(run_dir))
    meta["config"] = dict(meta["config"], device="cuda")
    with pytest.raises(ValueError, match="recorded on cuda, no card here"):
        pp.plan_for_run_meta(meta)
    bundle = pp.write_postmortem(str(tmp_path), step=1, run_meta=meta)
    assert pp.attach_plan(bundle) is None
    assert not os.path.exists(os.path.join(bundle, "plan.json"))


def test_the_script_is_registered():
    import re

    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        scripts = dict(re.findall(r'^([a-z-]+) = "([\w.:]+)"$', f.read(), flags=re.M))
    assert scripts["tpu-ddp-torch-memplan"] == "tpu_ddp_torch.tools.memplan:main"
    assert scripts["tpu-ddp-memplan"] == "tpu_ddp.tools.memplan:main"
