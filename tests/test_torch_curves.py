"""The port's learning curves (``tpu_ddp_torch/curves``) against the JAX
package's, on the same inputs: the extracted curve, its artifact, the seed
band, the CRV findings, the A/B diff and the ``curves`` command, equal once
``torch_version`` stands for ``jax_version`` and ``tpu-ddp-torch`` for
``tpu-ddp``.

Run dirs (``tests/torch_readers.py``), two epochs with an evaluation each:
``--kernels`` killed at step 7 and resumed (the stitched curve), the same
recipe and seed without ``--kernels``, uninterrupted, and a second seed of
that recipe. On the CPU K1's wrapper takes its plain version and the resume
is bitwise, so the overlay-parity verdict between the first two is a pass
with a drift of exactly 0.0. The CRV rules are held on hand-built curves
(the JAX ``tests/test_curves.py`` cases), not on training trajectories.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import json
import math
import os

import pytest
import torch
from torch_readers import assert_same, header_meta, incident, jax_names, port_run

import tpu_ddp.curves as jc
import tpu_ddp.curves.report as jreport
import tpu_ddp.registry.store as jstore
import tpu_ddp_torch.curves as pc
import tpu_ddp_torch.curves.report as preport
import tpu_ddp_torch.registry.store as pstore
from tpu_ddp.analysis import regress as jreg
from tpu_ddp_torch.analysis import regress as preg

RECIPE = dict(epochs=2, eval_each_epoch=True, momentum=0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("curves")
    out = {"incident": incident(str(root / "incident"), kernels=True, **RECIPE)}
    for name, seed in (("plain", 0), ("seed1", 1)):
        out[name] = str(root / name)
        port_run(out[name], seed=seed, **RECIPE)
    return out


def _torch_version(run_dir):
    return header_meta(run_dir)["torch_version"]


@pytest.mark.parametrize("name,stride", [("incident", 1), ("plain", 1), ("incident", 3)])
def test_extract_equals_jax(dirs, name, stride):
    port = pc.extract_curve(dirs[name], stride=stride)
    assert_same(port, jc.extract_curve(dirs[name], stride=stride),
                _torch_version(dirs[name]))
    assert jax_names(preport.render_curve(port)) == jreport.render_curve(
        jc.extract_curve(dirs[name], stride=stride))


def test_the_stitched_curve_has_each_step_once(dirs):
    c = pc.extract_curve(dirs["incident"])
    assert c["incarnations"] == 2
    assert c["steps"] == list(range(20)) and c["total_steps"] == 20
    assert all(math.isfinite(v) for v in c["loss"])
    assert c["quality_digest"] == pc.extract_curve(dirs["plain"])["quality_digest"]
    assert c["run_id"] != pc.extract_curve(dirs["plain"])["run_id"]
    assert isinstance(c["final_eval_accuracy"], float)


def test_overlay_parity_kernels_against_plain(dirs):
    a, b = (pc.extract_curve(dirs[n]) for n in ("incident", "plain"))
    port = pc.diff_curves(a, b)
    assert port["verdict"] == "pass" and port["regressions"] == []
    assert port["max_loss_drift"] == 0.0 and port["raw_max_loss_drift"] == 0.0
    assert port["final_eval_loss_delta"] == 0.0
    ja, jb = (jc.extract_curve(dirs[n]) for n in ("incident", "plain"))
    assert port == jc.diff_curves(ja, jb)
    assert jax_names(pc.render_diff(port, "A", "B")) == jc.render_diff(port, "A", "B")
    seeds = pc.diff_curves(b, pc.extract_curve(dirs["seed1"]))
    assert seeds == jc.diff_curves(jb, jc.extract_curve(dirs["seed1"]))
    assert any("seeds differ" in n for n in seeds["notes"])


def test_artifact_equals_jax_and_round_trips(dirs, tmp_path):
    port = pc.curve_artifact(pc.extract_curve(dirs["incident"]))
    jax_ = jc.curve_artifact(jc.extract_curve(dirs["incident"]))
    assert_same(port, jax_, _torch_version(dirs["incident"]))
    assert port["provenance"]["config_digest"] == port["curve"]["quality_digest"]
    path = tmp_path / "c.json"
    path.write_text(json.dumps(port))
    assert pc.load_curve(str(path)) == jc.load_curve(str(path)) == port["curve"]
    port["curves_schema_version"] += 1
    path.write_text(json.dumps(port))
    for load in (pc.load_curve, jc.load_curve):
        with pytest.raises(ValueError, match="newer than"):
            load(str(path))


def _curve(mod, loss, *, steps=None, quality="qd0", run_id="r0", acc=None, seed=0, **over):
    """The JAX test's hand-built curve record (``tests/test_curves.py``)."""
    curve = {
        "curves_schema_version": mod.CURVES_SCHEMA_VERSION,
        "run_dir": f"/synthetic/{run_id}", "run_id": run_id, "quality_digest": quality,
        "seed": seed, "strategy": "dp", "device_kind": "cpu", "stride": 1,
        "incarnations": 1, "total_steps": len(loss),
        "steps": steps if steps is not None else list(range(len(loss))),
        "loss": list(loss), "grad_norm": [1.0] * len(loss), "nonfinite_steps": 0,
        "eval_points": [],
        "final_train_loss": next((v for v in reversed(loss)
                                  if isinstance(v, (int, float)) and math.isfinite(v)), None),
        "final_eval_loss": None, "final_eval_accuracy": acc, "target_loss": None,
        "time_to_target_steps": None, "notes": [],
    }
    curve.update(over)
    return curve


def _trio(mod):
    return [_curve(mod, [2.0 - 0.05 * s + jitter for s in range(20)], run_id=f"base{i}",
                   acc=acc, seed=i)
            for i, (jitter, acc) in enumerate(((0.0, 0.80), (0.02, 0.82), (-0.02, 0.78)))]


_BASE = [2.0 - 0.05 * s for s in range(20)]


def _with(seq, at, values):
    seq = list(seq)
    seq[at:at + len(values)] = values
    return seq


#: name -> (trio edit, candidate loss, candidate fields, the rules it trips)
CRV_CASES = {
    "clean": (None, _BASE, dict(acc=0.80), []),
    "crv001_final_below_band": (None, _BASE, dict(acc=0.10), ["CRV001"]),
    "crv001_missing_metric": (None, _BASE, dict(), ["CRV001"]),
    "crv002_three_points_out": (None, _with(_BASE, 10, [4.0] * 3), dict(acc=0.80), ["CRV002"]),
    "crv002_two_points_quiet": (None, _with(_BASE, 10, [4.0] * 2), dict(acc=0.80), []),
    "crv003_slower_to_target": (None, _BASE[:19] + [1.06] * 11 + [1.0], dict(acc=0.80),
                                ["CRV003"]),
    "crv004_nonfinite": (None, _with(_BASE, 7, [float("nan")]),
                         dict(acc=0.80, nonfinite_steps=1), ["CRV004"]),
    "nan_accuracy_baseline": ("nan_acc", _BASE, dict(acc=0.80), []),
}


def _judged(mod, case):
    edit, loss, fields, _ = CRV_CASES[case]
    trio = _trio(mod)
    if edit == "nan_acc":
        trio[1]["final_eval_accuracy"] = float("nan")
    band = mod.build_band(trio)
    fields = dict(fields)
    cand = _curve(mod, loss, run_id="cand", acc=fields.pop("acc", None), **fields)
    findings = mod.judge_curve(cand, band)
    judged = {k: cand[k] for k in ("target_loss", "time_to_target_steps", "rule_counts")}
    return band, findings, judged


@pytest.mark.parametrize("case", sorted(CRV_CASES))
def test_crv_rules_equal_jax(case):
    pband, pfind, pjudged = _judged(pc, case)
    jband, jfind, jjudged = _judged(jc, case)
    assert dataclasses.asdict(pband) == dataclasses.asdict(jband)
    assert jax_names([f.to_json() for f in pfind]) == [f.to_json() for f in jfind]
    assert jax_names([f.render() for f in pfind]) == [f.render() for f in jfind]
    assert pjudged == jjudged
    want = CRV_CASES[case][3]
    assert [f.rule for f in pfind] == want or (want == ["CRV004"]
                                               and "CRV004" in {f.rule for f in pfind})
    if case == "nan_accuracy_baseline":
        assert pband.final["metric"] == "final_train_loss"


@pytest.mark.parametrize("refusal", ["too_few", "mixed_digests", "disjoint_steps",
                                     "min_runs_one"])
def test_band_refusals_equal_jax(refusal):
    def attempt(mod):
        trio = _trio(mod)
        if refusal == "too_few":
            return mod.build_band(trio[:2])
        if refusal == "mixed_digests":
            return mod.build_band(trio[:2] + [_curve(mod, [2.0] * 20, quality="other")])
        if refusal == "disjoint_steps":
            return mod.build_band(trio[:2] + [_curve(mod, [2.0] * 20,
                                                     steps=list(range(100, 120)))])
        return mod.BandConfig(min_runs=1).validate()

    with pytest.raises(ValueError) as port:
        attempt(pc)
    with pytest.raises(ValueError) as jax_:
        attempt(jc)
    assert jax_names(str(port.value)) == str(jax_.value)


@pytest.mark.parametrize("pair", ["nonfinite_asymmetry", "disjoint", "drifted"])
def test_diff_equals_jax_on_hand_built_pairs(pair):
    def run(mod):
        a = _curve(mod, [2.0] * 10)
        if pair == "nonfinite_asymmetry":
            b = _curve(mod, [2.0] * 10, run_id="r1", nonfinite_steps=1)
        elif pair == "disjoint":
            b = _curve(mod, [2.0] * 10, steps=list(range(50, 60)))
        else:
            b = _curve(mod, [2.0 + 0.02 * s for s in range(10)], seed=1,
                       final_eval_loss=1.0)
            a["final_eval_loss"] = 1.2
        try:
            return mod.diff_curves(a, b, tolerance=0.05)
        except ValueError as e:
            return str(e)

    port, jax_ = run(pc), run(jc)
    assert port == jax_
    if pair != "disjoint":
        assert port["verdict"] == "fail"


def _record_curves(mod, reg, curves, now=1000.0):
    for i, c in enumerate(curves):
        path = os.path.join(reg, f"src{i}.json")
        with open(path, "w") as f:
            json.dump(mod.curve_artifact(dict(c)), f)
        mod_store = pstore if mod is pc else jstore
        mod_store.record_artifact(reg, path, now=now + i)


def test_band_from_registry_equals_jax(tmp_path):
    reg = str(tmp_path / "reg")
    os.makedirs(reg)
    _record_curves(pc, reg, _trio(pc))
    cases = [dict(quality_digest="qd0", device_kind="cpu", allow_dirty=True),
             dict(quality_digest="qd0", device_kind="cpu", allow_dirty=True,
                  exclude_run_id="base0"),
             dict(quality_digest="feedfeed00", device_kind="cpu", allow_dirty=True),
             dict(quality_digest=None, device_kind="cpu")]
    for kw in cases:
        pband, prefusal = pc.band_from_registry(reg, **kw)
        jband, jrefusal = jc.band_from_registry(reg, **kw)
        assert (pband and dataclasses.asdict(pband)) == (jband and dataclasses.asdict(jband))
        assert jax_names(prefusal) == jrefusal
    band, _ = pc.band_from_registry(reg, quality_digest="qd0", device_kind="cpu",
                                    allow_dirty=True)
    assert band.n_runs == 3
    empty = pc.band_from_registry(str(tmp_path / "none"), quality_digest="x", device_kind="cpu")
    assert empty[0] is None and "empty" in empty[1]


def test_compare_gates_curve_artifacts_equal_jax():
    band = pc.build_band(_trio(pc))
    good = _curve(pc, _BASE, run_id="good", acc=0.80)
    bad = _curve(pc, _with(_BASE, 10, [4.0] * 3), run_id="bad", acc=0.70)
    for c in (good, bad):
        pc.judge_curve(c, band)
    old, new = pc.curve_artifact(good), pc.curve_artifact(bad)
    for a, b in ((old, new), (new, old), (old, old)):
        port = preg.compare(preg.normalize_artifact(a), preg.normalize_artifact(b))
        assert port == jreg.compare(jreg.normalize_artifact(a), jreg.normalize_artifact(b))
    forward = preg.compare(preg.normalize_artifact(old), preg.normalize_artifact(new))
    assert any("lint/CRV002" in r for r in forward["regressions"])


def _both(argv, capsys):
    """(port exit code, stdout), (JAX exit code, stdout) of the curves CLI."""
    rp = preport.main(argv)
    out_p = capsys.readouterr().out
    rj = jreport.main(argv)
    out_j = capsys.readouterr().out
    return (rp, out_p), (rj, out_j)


def test_curves_cli_equals_jax(dirs, tmp_path, capsys):
    (rp, out_p), (rj, out_j) = _both([dirs["plain"]], capsys)
    assert rp == rj == 0 and jax_names(out_p) == out_j and "eval history" in out_p
    for argv in ([str(tmp_path / "nope")],
                 [dirs["plain"], "--against", str(tmp_path / "empty_reg")],
                 ["diff", dirs["plain"], str(tmp_path / "nope")]):
        (rp, _), (rj, _) = _both(argv, capsys)
        assert rp == rj == 2, argv
    (rp, out_p), (rj, out_j) = _both(["diff", dirs["incident"], dirs["plain"]], capsys)
    assert rp == rj == 0 and jax_names(out_p) == out_j and "verdict: PASS" in out_p
    # a seed band of the recipe's other runs: the plain run judged against it
    reg = str(tmp_path / "reg")
    for name in ("incident", "seed1"):
        art = tmp_path / f"{name}.json"
        art.write_text(json.dumps(pc.curve_artifact(pc.extract_curve(dirs[name]))))
        pstore.record_artifact(reg, str(art))
    argv = [dirs["plain"], "--against", reg, "--allow-dirty", "--min-runs", "2", "--json"]
    (rp, out_p), (rj, out_j) = _both(argv, capsys)
    assert rp == rj
    assert_same(json.loads(out_p), json.loads(out_j), _torch_version(dirs["plain"]))
    assert json.loads(out_p)["band"]["n_runs"] == 2
