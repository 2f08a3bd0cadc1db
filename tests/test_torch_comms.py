"""The port's comms observatory (``tpu_ddp_torch/comms/``: ``model``,
``forensics``, ``microbench``, ``cli``) against the JAX package's, which is
the oracle (its hand-built cases from ``tests/test_comms.py``):

- ``fit_alpha_beta``, ``axis_baselines``, the link model's lookup and
  ``comms_model_for_chip`` on the same numbers;
- a ``HopMonitor`` fed the same hop sequence writes what the JAX one writes,
  read back by the JAX ``read_health`` and ``suspect_from_files``; the hang
  bundle the JAX ``write_hang_bundle`` writes from the same files;
  ``match_program_order``;
- ``comms bench`` on two gloo CPU ranks: the JAX artifact's keys, both
  registries classify it ``comms``, ``bench compare`` of it against itself
  is clean, the int8 ring moves fewer wire bytes than f32 at equal payload,
  ``comms calibrate`` reads it; ``exposure`` refuses by name, ``forensics``
  gives the JAX exit codes and output;
- a chaos ``comm_stall`` on two gloo ranks under ``--comms-monitor``: the
  JAX alert engine raises exactly COM001 against the port's bench on each
  rank, and the hang bundles name the stalled ring; past
  ``--watchdog-deadline`` with ``--watchdog-abort`` the job exits 113 and
  both goodput ledgers book the life ``hang`` with the suspect in its notes.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from tpu_ddp.comms import forensics as jax_forensics
from tpu_ddp.comms import model as jax_model
from tpu_ddp_torch.comms import forensics as port_forensics
from tpu_ddp_torch.comms import model as port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FITS = {
    "line": ([1e3, 1e4, 1e5, 1e6], [1e-4 + x / 1e9 for x in (1e3, 1e4, 1e5, 1e6)]),
    "tilted_down": ([1e3, 1e6], [2e-3, 1e-3]),
    "negative_intercept": ([1e3, 2e3], [1e-3, 3e-3]),
    "noisy": ([4096, 16384, 65536, 4096], [1.1e-4, 1.6e-4, 4.1e-4, 0.9e-4]),
    "length_mismatch": ([1.0, 2.0], [1.0]),
    "one_payload": ([4096.0, 4096.0], [1e-3, 2e-3]),
}


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "refused", str(e)


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_alpha_beta_as_jax(case):
    xs, ys = FITS[case]
    port = _outcome(lambda: port_model.fit_alpha_beta(xs, ys).to_json())
    jax_ = _outcome(lambda: jax_model.fit_alpha_beta(xs, ys).to_json())
    assert port == jax_


BASELINES = {
    "rings_win": {"links": {
        "all-reduce/f32/data": {"achieved_bw_bytes_per_s": 9e9},
        "ring-all-reduce/s8/data": {"achieved_bw_bytes_per_s": 5e8},
        "ring-all-reduce/f32/data": {"achieved_bw_bytes_per_s": 4e8},
        "all-gather/f32/model": {"achieved_bw_bytes_per_s": 2e9}}},
    "malformed": {"links": {"bad-key": {"achieved_bw_bytes_per_s": 1.0},
                            "all-reduce/f32/data": {"achieved_bw_bytes_per_s": -1},
                            "ring-reduce-scatter/s8/data": "x"}},
    "no_links": {"chip": "cpu"},
    "not_a_record": [1, 2],
}


@pytest.mark.parametrize("case", sorted(BASELINES))
def test_axis_baselines_as_jax(case):
    rec = BASELINES[case]
    assert port_model.axis_baselines(rec) == jax_model.axis_baselines(rec)


LOOKUPS = [("all-reduce", "f32", "data"), ("all-reduce", "s8", "data"),
           ("all-reduce", "f32", "unknown"), ("all-reduce", "s8", "all"),
           ("all-reduce", "f32", "model"), ("all-gather", "f32", "data")]


def test_link_model_lookup_as_jax():
    links = {"all-reduce/f32/data": (1e-5, 4e9, 2), "all-reduce/bf16/data": (1e-5, 1e9, 2)}
    got = []
    for mod in (port_model, jax_model):
        model = mod.LinkModel(chip="cpu", links={k: mod.AlphaBeta(*v)
                                                 for k, v in links.items()})
        got.append([(ab.to_json() if (ab := model.lookup(*k)) else None,
                     model.time_for(*k, 2e6, count=4)) for k in LOOKUPS])
    assert got[0] == got[1]


def _art(tmp_path, name, device_kind, links):
    path = tmp_path / name
    path.write_text(json.dumps({"type": "comms", "comms_schema_version": 1, "comms": {
        "chip": device_kind, "device_kind": device_kind, "n_devices": 2, "links": links}}))
    return str(path)


def test_comms_model_for_chip_as_jax(tmp_path):
    link = {"alpha_s": 1e-5, "beta_bytes_per_s": 1e9, "samples": 4}
    other = {"alpha_s": 2e-5, "beta_bytes_per_s": 3e9, "samples": 6}
    arts = [_art(tmp_path, "a.json", "cpu", {"ring-all-reduce/s8/data": link}),
            _art(tmp_path, "b.json", "cpu", {"ring-all-reduce/s8/data": other,
                                             "all-reduce/f32/data": other}),
            _art(tmp_path, "h100.json", "NVIDIA H100 80GB HBM3",
                 {"all-gather/f32/data": link})]
    models = [mod.comms_model_for_chip("cpu", sources=arts) for mod in (port_model, jax_model)]
    assert [(m.chip, m.source, m.samples, m.links_json()) for m in models][0] == \
        [(m.chip, m.source, m.samples, m.links_json()) for m in models][1]
    assert set(models[0].links) == {"ring-all-reduce/s8/data", "all-reduce/f32/data"}
    port_rec = port_model.model_from_comms_record(json.load(open(arts[0]))["comms"])
    jax_rec = jax_model.model_from_comms_record(json.load(open(arts[0]))["comms"])
    assert port_rec.links_json() == jax_rec.links_json() and port_rec.chip == jax_rec.chip
    # the one chip table (analysis/roofline.py): the H100, and the JAX rows,
    # where no evidence applies, as the JAX model answers
    assert port_model.comms_model_for_chip("h100", sources=arts).links_json() == {
        "all-gather/f32/data": {**link, "samples": 4}}
    v5e = [mod.comms_model_for_chip("v5e", sources=arts) for mod in (port_model, jax_model)]
    assert [(m.chip, bool(m), m.links_json()) for m in v5e] == [("v5e", False, {})] * 2
    for mod in (port_model, jax_model):
        with pytest.raises(ValueError, match="unknown chip"):
            mod.comms_model_for_chip("not-a-chip", sources=arts)


#: hop sequences: (kind, dtype, axis, hop, n_hops, wire_bytes), or a step
HOPS = {
    "completed": [("step", 4), ("ring-all-reduce", "s8", "data", 1, 2, 4004),
                  ("ring-all-reduce", "s8", "data", 2, 2, 4004)],
    "in_flight": [("step", 7), ("ring-all-reduce", "s8", "data", 1, 2, 4004),
                  ("ring-all-reduce", "s8", "data", 2, 2, 4004),
                  ("ring-reduce-scatter", "f32", "data", 1, 3, 8192)],
}


def _feed(mod, run_dir, seq, faults):
    mon = mod.HopMonitor(run_dir, process_index=1, n_devices=1, min_write_interval_s=0.0,
                         fault_hook=lambda axis, hop: faults.append((axis, hop)))
    for call in seq:
        if call[0] == "step":
            mon.set_step(call[1])
            continue
        kind, dtype, axis, hop, n_hops, wire = call
        mon.on_hop(0.0, kind=kind, dtype=dtype, axis=axis, hop=hop, n_hops=n_hops,
                   wire_bytes=wire)
    return mon


def _stable(rec):
    rec = dict(rec)
    for key in ("updated_unix", "axis_bw", "window_span_s"):
        rec.pop(key)
    return rec


@pytest.mark.parametrize("case", sorted(HOPS))
def test_hop_monitor_files_read_by_jax(tmp_path, case):
    read = {}
    for name, mod in (("port", port_forensics), ("jax", jax_forensics)):
        run_dir = str(tmp_path / name)
        os.makedirs(run_dir)
        faults = []
        _feed(mod, run_dir, HOPS[case], faults)
        health = jax_forensics.read_health(run_dir)
        read[name] = ([_stable(h) for h in health], jax_forensics.suspect_from_files(run_dir),
                      faults)
    assert read["port"] == read["jax"]
    assert read["port"][1]["source"] == ("in_flight" if case == "in_flight"
                                         else "last_collective")


def test_hang_bundle_as_jax(tmp_path):
    from tpu_ddp_torch.datapath.stages import StageMonitor

    run_dir = str(tmp_path / "port")
    os.makedirs(run_dir)
    _feed(port_forensics, run_dir, HOPS["in_flight"][:3], [])
    StageMonitor(run_dir, process_index=1).stage_enter("gather")
    with open(os.path.join(run_dir, "heartbeat-p1.json"), "w") as f:
        json.dump({"step": 7, "wall_time": 1.0, "process_index": 1}, f)
    shutil.copytree(run_dir, tmp_path / "jax")
    dump = "File .../tpu_ddp_torch/parallel/collectives.py, line 1, in ring_all_reduce_flat"
    port = port_forensics.write_hang_bundle(run_dir, process_index=1, dump_text=dump)
    jax_ = jax_forensics.write_hang_bundle(str(tmp_path / "jax"), process_index=1,
                                           dump_text=dump)
    assert port == jax_
    with open(os.path.join(run_dir, "hang-forensics-p1.json")) as f:
        assert json.load(f) == port
    assert port["suspect_collective"]["key"] == "ring-all-reduce/s8/data"
    assert port["suspect_stage"]["stage"] == "gather" and port["stack_mentions_ring"]
    assert jax_forensics.suspect_from_files(run_dir) == port["suspect_collective"]
    assert port_forensics.join_schedule(run_dir) is None


ORDER = ["all-gather/f32/data/g4", "collective-permute/s8/data/g4", "all-reduce/f32/data/g4"]
MATCHES = {
    "ring": {"kind": "ring-all-reduce", "dtype": "int8", "axis": "data"},
    "stock": {"kind": "all-reduce", "dtype": "f32", "axis": "data"},
    "absent": {"kind": "all-to-all", "dtype": "f32", "axis": "data"},
    "none": None,
}


@pytest.mark.parametrize("case", sorted(MATCHES))
def test_match_program_order_as_jax(case):
    suspect = MATCHES[case]
    assert port_forensics.match_program_order(suspect, ORDER) == \
        jax_forensics.match_program_order(suspect, ORDER)


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _launch(tmp_path, argv, nproc=2, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", str(nproc),
         "--", sys.executable, "-m", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """``comms bench`` on two gloo CPU ranks, every kind, f32 and s8."""
    path = str(tmp_path_factory.mktemp("bench") / "comms.json")
    proc = _launch(tmp_path_factory, [
        "tpu_ddp_torch.cli.main", "comms", "bench", "--device", "cpu", "--mesh", "data=2",
        "--dtypes", "f32,s8", "--ring-modes", "f32,int8", "--sizes", "4096,16384,16385",
        "--reps", "2", "--out", path])
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(path) as f:
        return path, json.load(f), proc.stdout


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items() if k not in ("links", "rows", "provenance")}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return None


def test_comms_bench_artifact_as_jax(bench, tmp_path):
    import jax

    from tpu_ddp.analysis.regress import main as jax_compare
    from tpu_ddp.comms.microbench import bench_artifact, run_sweeps
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.registry.store import _artifact_kind as jax_kind
    from tpu_ddp_torch.cli.main import main as port_main
    from tpu_ddp_torch.registry.store import _artifact_kind as port_kind

    path, art, out = bench
    mesh = create_mesh(MeshSpec(data=2), jax.devices()[:2])
    sweeps, skipped = run_sweeps(mesh, kinds=("all-reduce", "ring-all-reduce"),
                                 dtypes=("f32",), ring_modes=("int8",), sizes=(4096, 16384, 16385),
                                 reps=1)
    jax_ = json.loads(json.dumps(bench_artifact(mesh, sweeps, skipped, reps=1)))
    assert _keys(art) == _keys(jax_)
    assert art["comms"]["mesh"] == jax_["comms"]["mesh"]
    assert art["comms"]["skipped"] and all(s["size"] == 16385 for s in art["comms"]["skipped"])
    links = set(art["comms"]["links"])
    assert links == {f"{k}/{d}/data" for k in ("all-reduce", "reduce-scatter", "all-gather",
                                               "all-to-all", "collective-permute")
                     for d in ("f32", "s8")} | {f"ring-{k}/{d}/data" for k in (
                         "all-reduce", "reduce-scatter") for d in ("f32", "s8")}
    assert set(next(iter(art["comms"]["links"].values()))) == set(
        next(iter(jax_["comms"]["links"].values())))
    assert port_kind(art) == jax_kind(art) == "comms"
    assert port_model.axis_baselines(art["comms"]) == jax_model.axis_baselines(art["comms"])
    # the int8 ring moves fewer wire bytes than f32 at equal payload
    wire = {(r["kind"], r["dtype"], r["size"]): r["wire_bytes"] for r in art["comms"]["sweeps"]}
    for kind in ("ring-all-reduce", "ring-reduce-scatter"):
        for size in (4096, 16384):
            assert wire[(kind, "s8", size)] < wire[(kind, "f32", size)] / 3
    assert _cli(port_main, ["bench", "compare", path, path])[0] == 0
    assert _cli(jax_compare, [path, path])[0] == 0
    assert "comms bench: chip cpu (2 devices" in out
    rc, text, _ = _cli(port_main, ["comms", "calibrate", "--chip", "cpu", path, "--json"])
    assert rc == 0 and set(json.loads(text)["links"]) == links


def test_comms_cli_exit_codes_as_jax(tmp_path):
    from tpu_ddp.comms.cli import main as jax_comms
    from tpu_ddp_torch.cli.main import main as port_main

    # a dir with no trace: refused (exit 2), as the JAX exposure refuses it
    rc, out, err = _cli(port_main, ["comms", "exposure", str(tmp_path), "--device", "cpu"])
    assert rc == 2 and err.startswith("tpu-ddp-torch comms exposure: ") and not out
    hung = str(tmp_path / "hung")
    os.makedirs(hung)
    _feed(port_forensics, hung, HOPS["in_flight"], [])
    quiet = str(tmp_path / "quiet")
    os.makedirs(quiet)
    with open(os.path.join(quiet, "comms-health-p0.json"), "w") as f:
        json.dump({"comms_health_schema_version": 1, "in_flight": None}, f)
    future = str(tmp_path / "future")
    os.makedirs(future)
    with open(os.path.join(future, "hang-forensics-p0.json"), "w") as f:
        json.dump({"hang_forensics_schema_version": 9}, f)
    for run_dir, want in ((hung, 0), (quiet, 1), (future, 2), (str(tmp_path / "none"), 2),
                          (str(tmp_path), 2)):
        for extra in ([], ["--json"]):
            port = _cli(port_main, ["comms", "forensics", run_dir, *extra])
            jax_ = _cli(jax_comms, ["forensics", run_dir, *extra])
            assert port[0] == jax_[0] == want
            assert (port[1], port[2].replace("tpu-ddp-torch", "tpu-ddp")) == jax_[1:]


def _spec(path, *faults):
    with open(path, "w") as f:
        json.dump({"chaos_schema_version": 1, "faults": list(faults)}, f)
    return str(path)


def _train(tmp_path, name, *extra):
    run_dir = str(tmp_path / name)
    return run_dir, _launch(tmp_path, [
        "tpu_ddp_torch.cli.train", "--device", "cpu", "--synthetic-data", "--synthetic-size",
        "512", "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2", "--kernels",
        "--grad-compress", "int8", "--telemetry-dir", run_dir, "--comms-monitor",
        "--telemetry-sinks", "jsonl", *extra])


def test_comm_stall_fires_com001_and_names_the_ring(bench, tmp_path):
    from tpu_ddp.monitor.watch import main as jax_watch

    spec = _spec(tmp_path / "spec.json", {"kind": "comm_stall", "step": 3, "delay_s": 1.5,
                                          "hops": 1})
    run_dir, proc = _train(tmp_path, "run", "--chaos", spec, "--watchdog-deadline", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    rc, out, _ = _cli(jax_watch, [run_dir, "--once", "--json", "--no-alerts-file",
                                  "--comms-baseline", bench[0]])
    # of the rules that judge the observatories' health files, COM001
    # alone fires, on both ranks
    fired = [(a["rule"], a["host"]) for a in json.loads(out)["alerts"]
             if a["state"] == "firing" and a["rule"] in ("COM001", "DAT001")]
    assert rc == 1 and sorted(fired) == [("COM001", 0), ("COM001", 1)]
    for r in range(2):
        with open(os.path.join(run_dir, f"hang-forensics-p{r}.json")) as f:
            suspect = json.load(f)["suspect_collective"]
        assert (suspect["kind"], suspect["dtype"], suspect["axis"]) == (
            "ring-all-reduce", "s8", "data")
    with open(os.path.join(run_dir, "chaos-state.json")) as f:
        assert json.load(f)["fired"] == [0]


def test_comm_stall_past_the_deadline_is_a_hang(tmp_path):
    from tpu_ddp.ledger.stitch import stitch_run as jax_stitch
    from tpu_ddp_torch.ledger.stitch import stitch_run

    spec = _spec(tmp_path / "spec.json", {"kind": "comm_stall", "step": 3, "delay_s": 4,
                                          "hops": 1})
    run_dir, proc = _train(tmp_path, "run", "--chaos", spec, "--watchdog-deadline", "1",
                           "--watchdog-abort")
    assert proc.returncode == 113, proc.stderr[-2000:]
    note = ("incarnation 0: hang forensics suspect collective ring-all-reduce/s8/data "
            "(evidence: in_flight)")
    for stitch in (stitch_run, jax_stitch):
        run = stitch(run_dir)
        assert [i.exit for i in run.incarnations] == ["hang"]
        assert note in run.incarnations[0].notes
