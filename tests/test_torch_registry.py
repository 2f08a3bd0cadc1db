"""The port's perf registry (``tpu_ddp_torch/registry``) and ``bench
compare`` (``tpu_ddp_torch/analysis/regress.py``) against the JAX package's:
one ``registry.jsonl`` that either package records into and either reads;
the same trend findings and auto-selected baselines on a registry with a
planted drift; the same gate verdicts on pairs of artifacts; and the same
exit codes and output from the two ``registry`` and ``bench compare``
commands. Outputs equal once ``torch_version`` stands for ``jax_version``
and ``tpu-ddp-torch`` for ``tpu-ddp``.

The trace-summary, ledger and curve artifacts come from one clean port run
on the CPU (``tests/torch_readers.py``); the rest are the JAX
``tests/test_registry.py`` families, built by hand.
"""

import copy
import json
import os

import pytest
import torch
from torch_readers import _without, jax_names, port_run

import tpu_ddp.registry.cli as jcli
import tpu_ddp.registry.store as jstore
import tpu_ddp.registry.trend as jtrend
import tpu_ddp_torch.registry.cli as pcli
import tpu_ddp_torch.registry.store as pstore
import tpu_ddp_torch.registry.trend as ptrend
from tpu_ddp.analysis import regress as jreg
from tpu_ddp_torch.analysis import regress as preg

CLEAN_COMMIT = "c" * 40
CLEAN_HISTORY = [9000, 9010, 8995, 9002, 9008, 8998, 9005, 9001]
STORES = {"port": pstore, "jax": jstore}


def _prov(digest, commit=CLEAN_COMMIT, dirty=False, device_kind="cpu"):
    return {"config_digest": digest, "git_commit": commit, "git_dirty": dirty,
            "device_kind": device_kind}


def _bench(value=1000.0, digest="cfgbench01", commit=CLEAN_COMMIT, dirty=False):
    return {"metric": "resnet50_bf16_train_images_per_sec_per_chip", "value": value,
            "unit": "images/sec/chip", "mfu": 0.33,
            "rows": {"compute_bound_resnet50_bf16": {"value": value, "mfu": 0.33}},
            "provenance": _prov(digest, commit, dirty, "TPU v5 lite")}


def _analyze(extra_collective=False):
    inv = {"all-reduce/f32/data/g4": {"count": 2, "payload_bytes": 1 << 20,
                                      "group_size": 4}}
    if extra_collective:
        inv["all-gather/f32/data/g4"] = {"count": 1, "payload_bytes": 4096, "group_size": 4}
    return {"anatomy": {"strategy": "dp", "model": "netresdeep", "device_kind": "cpu",
                        "flops": 1e9, "bytes_accessed": 1 << 24, "inventory": inv},
            "roofline": {"bound": "hbm"},
            "run_meta": {"run_id": "run0000001", "device_kind": "cpu", "strategy": "dp",
                         "git_commit": CLEAN_COMMIT, "git_dirty": False},
            "provenance": _prov("run0000001")}


@pytest.fixture(scope="module")
def run_artifacts(tmp_path_factory):
    """The clean port run's ``trace summarize --json``, ``goodput --json``
    and ``curves --json`` artifacts."""
    from tpu_ddp_torch.curves import curve_artifact, extract_curve
    from tpu_ddp_torch.ledger import build_ledger, ledger_json, stitch_run
    from tpu_ddp_torch.telemetry.summarize import summarize_json

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    run_dir = str(tmp_path_factory.mktemp("registry") / "run")
    try:
        port_run(run_dir, epochs=2, eval_each_epoch=True)
    finally:
        torch.set_num_threads(n)
    return {"trace_summary": summarize_json(run_dir),
            "goodput_ledger": ledger_json(build_ledger(stitch_run(run_dir))),
            "curves": curve_artifact(extract_curve(run_dir)),
            "torch_version": torch.__version__}


def _families(run_artifacts):
    return {
        "bench": _bench(),
        "analyze": _analyze(),
        "watch_snapshot": {"schema_version": 2, "alerts": [],
                           "snapshot": {"run_id": "run0000001", "device_kind": "cpu",
                                        "fleet": {"steps_per_sec": 12.5}}},
        "aot": {"topology": "v5e:2x4", "device_kind": "TPU v5 lite",
                "provenance": _prov("cfgaot0001", device_kind="TPU v5 lite"),
                "programs": {"dp_netresdeep_b32x8": {
                    "ok": True, "argument_size_in_bytes": 1 << 20,
                    "inventory": {"all-reduce/f32/data/g8": {
                        "count": 1, "payload_bytes": 2048, "group_size": 8}}}}},
        "lint": {"lint_schema_version": 1, "provenance": _prov("cfglint001"),
                 "programs": {"dp": {"strategy": "dp", "rule_counts": {"DON001": 0}},
                              "source": {"rule_counts": {}}}},
        **{k: run_artifacts[k] for k in ("trace_summary", "goodput_ledger", "curves")},
    }


FAMILIES = ["bench", "analyze", "watch_snapshot", "aot", "lint", "trace_summary",
            "goodput_ledger", "curves"]


def _write(tmp_path, name, payload):
    path = tmp_path / name
    path.write_text(json.dumps(payload))
    return str(path)


@pytest.mark.parametrize("family", FAMILIES)
def test_entries_recorded_by_either_package_equal(run_artifacts, tmp_path, family):
    """The same artifact recorded by each package: equal entries (the entry
    id digests the stamp, so it differs exactly where the stamp carries a
    version), each read back alike by both packages' ``read_entries``."""
    path = _write(tmp_path, f"{family}.json", _families(run_artifacts)[family])
    entries = {}
    for name, store in STORES.items():
        reg = str(tmp_path / f"reg_{name}")
        entry = store.record_artifact(reg, path, now=1000.0, note=family)
        assert entry.artifact_kind == family and entry.metrics
        # each package reads the other's registry.jsonl to the same entries
        assert ([e.to_record() for e in pstore.read_entries(reg)]
                == [e.to_record() for e in jstore.read_entries(reg)]
                == [entry.to_record()])
        entries[name] = entry.to_record()
    port, jax_ = (dict(entries[n]) for n in ("port", "jax"))
    ids = port.pop("entry_id"), jax_.pop("entry_id")
    # the stamp: the port takes the artifact's torch_version, the JAX
    # package its jax_version (which a port artifact does not carry)
    stamped = port["provenance"].get("torch_version")
    assert stamped in (None, run_artifacts["torch_version"])
    assert (stamped is None) == (family not in ("trace_summary", "goodput_ledger", "curves"))
    assert "jax_version" not in jax_["provenance"]
    strip = lambda e: _without(_without(e, "torch_version", []), "jax_version", [])  # noqa: E731
    assert jax_names(strip(port)) == strip(jax_)
    assert (ids[0] == ids[1]) == (stamped is None)


def _history(mod, values, *, digest="cfgAAAAAAA", chip="TPU v5 lite", dirty=False,
             metric="program/measured/value"):
    return [mod.RegistryEntry(entry_id=f"e{i:012d}", recorded_at=1000.0 + i,
                              artifact_kind="bench", artifact_path=None,
                              config_digest=digest, device_kind=chip,
                              provenance={"git_commit": f"{i:040x}", "git_dirty": dirty},
                              programs={}, metrics={metric: float(v)})
            for i, v in enumerate(values)]


def _planted(mod, case):
    """(entries, TrendConfig or None) for one planted history (the JAX
    ``tests/test_registry.py`` trend cases)."""
    if case == "clean":
        return _history(mod, CLEAN_HISTORY), None
    if case == "throughput_drop_10pct":
        return _history(mod, CLEAN_HISTORY + [8100]), None
    if case == "size_growth":
        return _history(mod, [100, 101, 100, 99, 100, 100, 130],
                        metric="prog/size/temp_bytes"), None
    if case == "count_increase":
        return _history(mod, [2, 3], metric="dp/count/inventory/all-reduce/f32/data/g4"), None
    if case == "count_decrease":
        return _history(mod, [3, 2], metric="dp/count/inventory/all-reduce/f32/data/g4"), None
    if case == "count_first_appearance":
        entries = _history(mod, [1.0, 1.0], metric="goodput/quality/goodput_fraction")
        entries[1].metrics["goodput/count/badput/restart_gap"] = 1.0
        return entries, None
    if case == "dirty_drift":
        return _history(mod, CLEAN_HISTORY + [8100], dirty=True), None
    if case == "digests_apart":
        return (_history(mod, CLEAN_HISTORY, digest="cfgA000000")
                + _history(mod, [100.0], digest="cfgB000000")), None
    return _history(mod, [9000, 9000, 8100]), mod.TrendConfig(min_history=4)


TREND_CASES = {"clean": [], "throughput_drop_10pct": ["REG001"], "size_growth": ["REG002"],
               "count_increase": ["REG003"], "count_decrease": [],
               "count_first_appearance": ["REG003"], "dirty_drift": ["REG001", "REG004"],
               "digests_apart": [], "short_history": []}


@pytest.mark.parametrize("case", sorted(TREND_CASES))
def test_trend_findings_equal_jax(case):
    port = ptrend.trend_findings(*_planted(ptrend, case))
    jax_ = jtrend.trend_findings(*_planted(jtrend, case))
    assert jax_names([f.to_json() for f in port]) == [f.to_json() for f in jax_]
    assert jax_names([f.render() for f in port]) == [f.render() for f in jax_]
    assert sorted(f.rule for f in port) == TREND_CASES[case]


def test_trend_over_a_recorded_registry_equals_jax(tmp_path):
    """A registry the two packages record into by turns, with a 10% drop at
    the last commit: the same REG001 from both, on the same entry."""
    reg = str(tmp_path / "reg")
    for i, v in enumerate(CLEAN_HISTORY + [8100]):
        store = pstore if i % 2 else jstore
        store.record_artifact(reg, _write(tmp_path, f"h{i}.json",
                                          _bench(float(v), commit=f"{i:040x}")),
                              now=1000.0 + i)
    port = ptrend.trend_findings(pstore.read_entries(reg))
    jax_ = jtrend.trend_findings(jstore.read_entries(reg))
    assert jax_names([f.to_json() for f in port]) == [f.to_json() for f in jax_]
    assert [f.rule for f in port] == ["REG001", "REG001"]   # value and the bench row
    assert {f.entry_id for f in port} == {pstore.read_entries(reg)[-1].entry_id}


SELECT_CASES = {
    "newest_clean_match": dict(config_digest="cfgAAAAAAA", device_kind="TPU v5 lite"),
    "empty": dict(config_digest="x", device_kind="cpu"),
    "no_digest": dict(config_digest=None, device_kind="cpu"),
    "digest_mismatch": dict(config_digest="nomatch000", device_kind="TPU v5 lite"),
    "chip_mismatch": dict(config_digest="cfgAAAAAAA", device_kind="TPU v6e"),
    "kind_mismatch": dict(config_digest="cfgAAAAAAA", device_kind="TPU v5 lite",
                          artifact_kind="analyze"),
    "dirty_only": dict(config_digest="cfgAAAAAAA", device_kind="TPU v5 lite"),
    "dirty_allowed": dict(config_digest="cfgAAAAAAA", device_kind="TPU v5 lite",
                          allow_dirty=True),
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_baseline_equals_jax(case):
    def select(mod):
        entries = [] if case == "empty" else _history(
            mod, CLEAN_HISTORY, dirty=case.startswith("dirty"))
        entry, refusal = mod.select_baseline(entries, **SELECT_CASES[case])
        return entry and entry.entry_id, refusal

    port, jax_ = select(pstore), select(jstore)
    assert jax_names(port[1]) == jax_[1] and port[0] == jax_[0]
    assert (port[0] is not None) == (case in ("newest_clean_match", "dirty_allowed"))


def test_compare_trace_summaries_equal_jax(run_artifacts):
    old = run_artifacts["trace_summary"]
    new = copy.deepcopy(old)
    for ph in new["phases"].values():
        ph["p50_s"] = ph["p50_s"] * 3
    for a, b in ((old, old), (old, new), (new, old)):
        port = preg.compare(preg.normalize_artifact(a), preg.normalize_artifact(b))
        assert port == jreg.compare(jreg.normalize_artifact(a), jreg.normalize_artifact(b))
        assert port["regressions"] == []        # wall clock never gates
        assert preg.render(port, "a", "b") == jreg.render(port, "a", "b")
    # the registry trends what compare only reports
    metrics = pstore.extract_metrics(preg.normalize_artifact(new))
    assert metrics == jstore.extract_metrics(jreg.normalize_artifact(new))
    assert "trace_summary/wall/phase/compiled_step_p50_s" in metrics


def _run_both(main_p, main_j, argv, capsys):
    rp = main_p(argv)
    out_p = capsys.readouterr()
    rj = main_j(argv)
    out_j = capsys.readouterr()
    return rp, rj, out_p, out_j


def test_registry_cli_equals_jax(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    for i, v in enumerate(CLEAN_HISTORY + [8100]):
        pstore.record_artifact(reg, _write(tmp_path, f"h{i}.json",
                                           _bench(float(v), commit=f"{i:040x}")),
                               now=1000.0 + i)
    old = _write(tmp_path, "old.json", _analyze())
    new = _write(tmp_path, "new.json", _analyze(extra_collective=True))
    pstore.record_artifact(reg, old, now=2000.0)
    pstore.record_artifact(reg, new, now=2001.0)
    cases = {("list",): 0, ("list", "--json"): 0, ("list", "--json", "--full"): 0,
             ("show", "#0"): 0, ("show", "zzz"): 2, ("trend",): 1, ("trend", "--json"): 1,
             ("trend", "--metric", "inventory"): 1,
             ("trend", "--metric", "value", "--min-history", "9"): 0, ("diff", "#-2", "#-1"): 1,
             ("diff", "#-2", "#-2"): 0, ("diff", "#0", "zzz"): 2}
    for sub, want in cases.items():
        rp, rj, out_p, out_j = _run_both(pcli.main, jcli.main, ["--registry", reg, *sub],
                                         capsys)
        assert rp == rj == want, sub
        assert jax_names(out_p.out) == out_j.out, sub
    rp, rj, _, _ = _run_both(pcli.main, jcli.main,
                             ["--registry", reg, "record", str(tmp_path / "missing.json")],
                             capsys)
    assert rp == rj == 2
    future = tmp_path / "future"
    future.mkdir()
    (future / "registry.jsonl").write_text(json.dumps(
        {"registry_schema_version": 99, "type": "registry_entry"}) + "\n")
    for sub in (["list"], ["trend"], ["show", "#0"], ["diff", "#0", "#1"]):
        rp, rj, out_p, _ = _run_both(pcli.main, jcli.main, ["--registry", str(future), *sub],
                                     capsys)
        assert rp == rj == 2 and "newer" in out_p.err


def test_bench_compare_equals_jax(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    pstore.record_artifact(reg, _write(tmp_path, "base.json", _analyze()))
    ok = _write(tmp_path, "cand.json", _analyze())
    bad = _write(tmp_path, "cand_bad.json", _analyze(extra_collective=True))
    stranger = _write(tmp_path, "stranger.json", _bench(digest="nomatch000"))
    cases = {("--against", reg, ok): 0, ("--against", reg, bad): 1,
             ("--against", reg, stranger): 2, ("--against", reg, ok, ok): 2,
             (ok, ok): 0, (ok, bad): 1, (bad, ok): 0, (ok,): 2,
             (ok, str(tmp_path / "missing.json")): 2, ("--tolerance", "0.5", ok, bad): 1}
    for argv, want in cases.items():
        rp, rj, out_p, out_j = _run_both(preg.main, jreg.main, list(argv), capsys)
        assert rp == rj == want, argv
        assert jax_names(out_p.out) == out_j.out, argv
    assert os.path.isfile(os.path.join(reg, pstore.REGISTRY_FILE))
    assert (pstore.REGISTRY_FILE, pstore.REGISTRY_SCHEMA_VERSION, pstore.REGISTRY_ENV) == (
        jstore.REGISTRY_FILE, jstore.REGISTRY_SCHEMA_VERSION, jstore.REGISTRY_ENV)
