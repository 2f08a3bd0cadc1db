"""``tpu-ddp-torch analyze`` and the four joins that read its anatomy.

- ``render_report`` is the JAX one on the same anatomy, roofline,
  fingerprint and join; ``join_measurements`` is the JAX one on a trace
  without ``device_sync`` spans, and adds each step's ``device_sync`` to its
  dispatch where they are (the port's step: ``analysis/explain.py``).
- Static mode: every strategy at four ranks passes its fingerprint, into one
  ``programs`` artifact; tp at eight ranks too; a tp axis wider than the
  tiny ViT's two heads raises, and an unknown strategy exits 2.
- Run-dir mode on a traced port run (NetResDeep ``n_chans1=8, n_blocks=2``
  on two gloo ranks under the launcher, the int8 ring with ``--kernels``,
  ``--comms-monitor``, a capture window over steps 3-5): the JAX payload's
  keys, the fingerprint, the measured step, the refusals.
- The four joins on that run dir: ``comms exposure`` over two gloo ranks
  (its share in [0, 1], then joined by ``analyze``), ``watch --roofline``,
  the profiler's per-op table and ``comms forensics``' program order.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import importlib
import json
import os
import subprocess
import sys

import pytest

import tpu_ddp.analysis.hlo as jax_hlo
import tpu_ddp_torch.analysis.anatomy as port_hlo
from tpu_ddp.analysis.roofline import roofline as jax_roofline
from tpu_ddp_torch.analysis.roofline import roofline as port_roofline

# the JAX ``analysis`` package exports ``explain``'s ``main`` under other names
jax_explain = importlib.import_module("tpu_ddp.analysis.explain")
port_explain = importlib.import_module("tpu_ddp_torch.analysis.explain")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT)


def _anatomy(mod, **kw):
    rec = dict(strategy="custom", model="toy", device_kind="TPU v5 lite",
               mesh={"data": 2, "model": 1}, n_devices=2, per_shard_batch=8,
               compute_dtype="float32", flops=3.2e12, bytes_accessed=4.1e9,
               argument_bytes=3 << 20, output_bytes=3 << 20, temp_bytes=5 << 20,
               generated_code_bytes=None, fusion_count=0, hlo_ops={"mm": 4},
               collectives=[mod.Collective(kind="all-reduce", dtype="f32", axis="data",
                                           count=2, group_size=2, payload_bytes=8_000_000,
                                           wire_bytes=8_000_000)],
               program_order=["all-reduce/f32/data/g2"] * 2)
    rec.update(kw)
    return mod.StepAnatomy(**rec)


JOINED = {"step_p50_s": 0.012, "roofline_fraction": 0.75, "mfu": 0.27, "mfu_vs": "v5e",
          "comm_share_of_step": 0.01, "measured_comm_share": 0.2, "exposed_comm_s": 0.0024,
          "data_wait_share": 0.05}


@pytest.mark.parametrize("joined", [None, JOINED], ids=["static", "joined"])
@pytest.mark.parametrize("fp", [None, {"ok": True, "strategy": "dp", "missing": [],
                                       "unexpected": []},
                                {"ok": False, "strategy": "ep", "missing": ["all-to-all"],
                                 "unexpected": ["collective-permute"]}],
                         ids=["nofp", "ok", "fail"])
def test_render_report_is_the_jax_one(fp, joined):
    port = port_explain.render_report(_anatomy(port_hlo), port_roofline(_anatomy(port_hlo)),
                                      fp, joined)
    jax_ = jax_explain.render_report(_anatomy(jax_hlo),
                                     jax_roofline(_anatomy(jax_hlo)), fp, joined)
    assert port == jax_.replace("tpu-ddp comms", "tpu-ddp-torch comms")


def _trace(run_dir, spans):
    """A hand-written trace: a header, then ``(name, dur_s, step, attrs)``."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "trace-p0.jsonl"), "w") as f:
        f.write(json.dumps({"type": "header", "schema_version": 1, "epoch_unix": 1.0,
                            "run_meta": {"strategy": "dp", "config": {}}}) + "\n")
        for i, (name, dur, step, attrs) in enumerate(spans):
            rec = {"schema_version": 1, "type": "span", "name": name, "ts_s": float(i),
                   "dur_s": dur, "pid": 0, "tid": 0, "depth": 0, "step": step}
            if attrs:
                rec["attrs"] = attrs
            f.write(json.dumps(rec) + "\n")


def _joins(run_dir):
    got = []
    for hlo, explain, rl in ((port_hlo, port_explain, port_roofline),
                             (jax_hlo, jax_explain, jax_roofline)):
        a = _anatomy(hlo)
        got.append(explain.join_measurements(a, rl(a), run_dir))
    return got


def test_join_measurements_is_the_jax_one_plus_the_device_wait(tmp_path):
    calls = [("data_wait", 0.002, 0, None), ("h2d", 0.001, 0, None),
             ("compiled_step", 0.010, 0, None), ("compiled_step", 0.030, 1, {"steps": 3}),
             ("compiled_step", 0.011, 4, None)]
    _trace(str(tmp_path / "bare"), calls)
    port, jax_ = _joins(str(tmp_path / "bare"))
    extra = port["phases"]["compiled_step"].pop("with_device_sync_p50_s")
    assert port == jax_ and extra == jax_["step_p50_s"] == 0.010
    synced = calls[:3] + [("device_sync", 0.004, 0, None)] + calls[3:4] + [
        ("device_sync", 0.006, 1, None)] + calls[4:] + [("device_sync", 0.002, 4, None)]
    _trace(str(tmp_path / "synced"), synced)
    port, jax_ = _joins(str(tmp_path / "synced"))
    assert jax_["step_p50_s"] == 0.010
    assert port["step_p50_s"] == pytest.approx(0.013)      # (0.010, 0.012, 0.013)
    assert port["roofline_fraction"] == pytest.approx(jax_["roofline_fraction"] * 10 / 13)
    assert port["data_wait_share"] == jax_["data_wait_share"]


def test_static_all_strategies_at_four_ranks(tmp_path, capsys):
    path = str(tmp_path / "all.json")
    assert port_explain.main(["--strategy", "all", "--n-devices", "4", "--device", "cpu",
                              "--chip", "h100", "--json", path]) == 0
    out = capsys.readouterr().out
    assert out.count("fingerprint: OK") == len(port_explain.STRATEGIES)
    with open(path) as f:
        art = json.load(f)
    assert sorted(art["programs"]) == sorted(port_explain.STRATEGIES)
    assert "torch_version" in art["provenance"]
    for rec in art["programs"].values():
        assert rec["fingerprint"]["ok"] and rec["roofline"]["chip"] == "h100"
    # a tensor-parallel rank holds whole heads: the tiny ViT's 2 cannot
    # split 4 ways
    assert port_explain.main(["--strategy", "tp", "--n-devices", "8", "--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="whole heads"):
        port_explain.anatomy_for_strategy("tp", n_devices=4, axis_size=4, device="cpu")
    assert port_explain.main(["--strategy", "bogus", "--device", "cpu"]) == 2


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    """A traced two-rank port run (module docstring)."""
    run_dir = str(tmp_path_factory.mktemp("analyze") / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2", "--",
         sys.executable, "-m", "tpu_ddp_torch.cli.train", "--device", "cpu",
         "--synthetic-data", "--synthetic-size", "256", "--epochs", "1", "--n-chans1", "8",
         "--n-blocks", "2", "--n-devices", "2", "--global-batch-size", "32",
         "--prefetch-depth", "0", "--grad-compress", "int8", "--kernels", "--comms-monitor",
         "--profile-steps", "3:5", "--telemetry-dir", run_dir, "--telemetry-sinks", "jsonl"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return run_dir


def test_run_dir_mode(run2, tmp_path, capsys):
    path = str(tmp_path / "an.json")
    assert port_explain.main([run2, "--device", "cpu", "--chip", "h100", "--json", path]) == 0
    out = capsys.readouterr().out
    assert "fingerprint: OK (grad_compress" in out and "measured (telemetry join):" in out
    with open(path) as f:
        art = json.load(f)
    assert set(art) == {"anatomy", "roofline", "fingerprint", "kernel_candidates",
                        "provenance", "run_meta", "measured"}
    a = art["anatomy"]
    assert (a["strategy"], a["n_devices"], a["mesh"]["data"]) == ("grad_compress", 2, 2)
    assert {c["kind"] for c in a["collectives"]} >= {"collective-permute", "all-gather"}
    step = art["measured"]["phases"]["compiled_step"]
    assert art["measured"]["step_p50_s"] == step["with_device_sync_p50_s"] > 0
    assert 0 < art["measured"]["roofline_fraction"]
    assert [k["kernel"] for k in art["kernel_candidates"]] == [
        "fused_dequant", "fused_quant", "fused_update"]
    # a mismatched --strategy is refused, as in JAX
    assert port_explain.main([run2, "--device", "cpu", "--strategy", "tp"]) == 2
    assert "refusing" in capsys.readouterr().out
    with pytest.raises(ValueError, match="steps_per_call"):
        port_explain.run_meta_config({"strategy": "dp", "config": {"steps_per_call": 2}},
                                     "cpu")


def test_exposure_over_two_gloo_ranks_joins_analyze(run2, capsys):
    from tpu_ddp_torch.comms.exposure import check_exposure, read_exposure

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2", "--",
         sys.executable, "-m", "tpu_ddp_torch.cli.main", "comms", "exposure", run2,
         "--device", "cpu", "--reps", "3"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("comms exposure: grad_compress on 2 devices (cpu)") == 1
    rec = read_exposure(run2)
    assert 0.0 <= rec["measured_comm_share"] <= 1.0
    assert rec["t_full_s"] > 0 and rec["t_stripped_s"] > 0 and rec["n_devices"] == 2
    meta = port_explain.read_run_meta(run2)
    a = port_explain.anatomy_for_run_meta(meta, "cpu")
    joined = port_explain.join_measurements(a, port_roofline(a, "h100"), run2)
    assert joined["measured_comm_share"] == rec["measured_comm_share"]
    # the JAX refusals: one process for a two-rank run, a family that
    # shards compute, a run of one rank
    from tpu_ddp_torch.comms.cli import main as comms_main

    capsys.readouterr()
    assert comms_main(["exposure", run2, "--device", "cpu"]) == 2
    assert "only 1 launched" in capsys.readouterr().err
    for bad, match in (({"strategy": "tp", "mesh": {"data": 2}}, "replicated compute"),
                       ({"strategy": "dp", "mesh": {"data": 1}}, "single device"),
                       ({"strategy": "dp", "mesh": {"data": 2}}, "launch exactly 2")):
        with pytest.raises(ValueError, match=match):
            check_exposure(bad, 4 if match.startswith("launch") else 1)


def test_watch_roofline_joins_the_rebuilt_step(run2, capsys):
    from tpu_ddp_torch.monitor import watch

    rl = watch.roofline_view(run2)
    assert "note" not in rl and rl["flops_per_step_device"] > 0
    assert (rl["chip"], rl["bound"], rl["predicted_step_s"]) == ("cpu", "unknown", None)
    assert rl["rebuilt_on"] == "cpu"
    assert watch.main([run2, "--once", "--roofline", "--json"]) in (0, 1)
    report = json.loads(capsys.readouterr().out)
    assert report["roofline"]["flops_per_step_device"] == rl["flops_per_step_device"]
    # the join divides by the port's step: dispatch + device wait
    report = {"snapshot": {"fleet": {"phase_p50_s": {"compiled_step": 0.004,
                                                     "device_sync": 0.006}}}}
    watch._join_roofline(report, {"predicted_step_s": 0.005, "flops_per_step_device": 2e9,
                                  "peak_bf16_flops": 1e12})
    assert report["roofline"]["roofline_fraction"] == pytest.approx(0.5)
    assert report["roofline"]["mfu"] == pytest.approx(0.2)


def test_profiler_per_op_table_from_the_rebuilt_step(run2):
    from tpu_ddp_torch.profiler.device import attribution_for_bundle

    bundles = os.path.join(run2, "profiles")
    name = sorted(n for n in os.listdir(bundles) if n.endswith("-p0"))[0]
    with open(os.path.join(bundles, name, "meta.json")) as f:
        meta = json.load(f)
    ops = attribution_for_bundle(meta, chip="h100")
    assert "note" not in ops and (ops["chip"], ops["rebuilt_on"]) == ("h100", "cpu")
    names = {r["op"] for r in ops["ops"]}
    assert {"compute (fused math)", "hbm traffic", "collective-permute/s8/data/g2",
            "all-gather/s8/data/g2"} <= names
    assert sum(r["attributed_s"] for r in ops["ops"]) == pytest.approx(ops["measured_step_s"])


def test_a_card_run_is_rebuilt_on_the_card_or_not_at_all(run2, monkeypatch, capsys):
    """A run recorded on the card is never rebuilt on the CPU, where each
    kernel's plain version would be counted op by op: without a card the
    joins degrade with the JAX notes, ``analyze`` refuses, and another
    device than the recorded one is refused."""
    import tpu_ddp_torch.analysis.explain as explain
    from tpu_ddp_torch.comms.forensics import join_schedule
    from tpu_ddp_torch.monitor import watch
    from tpu_ddp_torch.profiler.device import attribution_for_bundle

    meta = port_explain.read_run_meta(run2)
    card = {**meta, "config": {**meta["config"], "device": "cuda"}}
    monkeypatch.setattr(explain, "read_run_meta", lambda run_dir: card)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert watch.roofline_view(run2) == {
        "note": "roofline join unavailable: recorded on cuda, no card here"}
    assert attribution_for_bundle({"run_meta": card}) == {
        "note": "per-op attribution unavailable: recorded on cuda, no card here"}
    assert join_schedule(run2) is None
    assert port_explain.main([run2]) == 2
    assert "recorded on cuda, no card here" in capsys.readouterr().out
    with pytest.raises(ValueError, match="recorded on cpu: a rebuild on cuda"):
        port_explain.run_meta_config(meta, "cuda")


def test_forensics_program_order_from_the_rebuilt_step(run2):
    from tpu_ddp_torch.comms.forensics import join_schedule, match_program_order

    order = join_schedule(run2)
    meta = port_explain.read_run_meta(run2)
    assert order == port_explain.anatomy_for_run_meta(meta).program_order
    assert order[1:3] == ["collective-permute/s8/data/g2", "all-gather/s8/data/g2"]
    suspect = {"kind": "ring-all-reduce", "dtype": "s8", "axis": "data"}
    assert match_program_order(suspect, order) == {
        "index": 1, "entry": "collective-permute/s8/data/g2"}
    assert join_schedule(os.path.join(run2, "missing")) is None
