"""``tpu-ddp-torch ops`` and its cost model against the JAX package's.

- ``fit_cost_line``, ``KernelCost``/``OpsModel`` savings and
  ``ops_model_for_chip`` equal the JAX ones on the same artifacts (the
  oracles: ``tests/test_fused_kernels.py::test_ops_model_assembly_signed_savings``
  and the signed pricing of ``test_kernel_twin_shares_program_and_prices_signed``);
  the port's table also knows the H100, which the JAX one does not;
- ``ops bench --device cpu`` at 256 and 512 elements, one repetition: every
  kernel's parity holds bitwise (on the CPU each wrapper takes its plain
  version), the artifact has the JAX artifact's keys (built by the JAX
  ``bench_artifact`` from the same rows) plus its CPU note, and
  ``registry record`` and ``bench compare``'s reader take it as kind
  ``ops``; ``--corrupt <kernel>`` exits 1 naming the kernel;
- ``ops calibrate`` on that artifact reads the three kernels' lines, and
  exits 2 on an unknown chip.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json

import pytest

import tpu_ddp.ops.model as jax_model
import tpu_ddp_torch.ops.model as port_model
from tpu_ddp_torch.ops.cli import main as ops_main

SIZES = "256,512"


def _ops_artifact(chip="cpu", parity_ok=True, xla_slope=3e-9):
    """``tests/test_fused_kernels.py::_ops_artifact``."""
    return {
        "type": "ops", "ops_schema_version": 1,
        "ops": {
            "chip": chip, "device_kind": chip, "backend": "cpu",
            "parity_ok": parity_ok,
            "kernels": {
                "fused_update": {
                    "fused": {"alpha_s": 1e-5, "s_per_elem": 1e-9, "samples": 2},
                    "xla": {"alpha_s": 2e-5, "s_per_elem": xla_slope, "samples": 2},
                    "parity_ok": parity_ok,
                },
            },
        },
    }


@pytest.mark.parametrize("xs,ys", [([1000.0, 2000.0], [1e-4, 1.5e-4]),
                                   ([1.0, 2.0, 4.0], [3.0, 2.0, 1.0]),
                                   ([10.0, 20.0, 30.0], [1e-3, 4e-3, 2e-3])])
def test_fit_cost_line_is_the_jax_fit(xs, ys):
    assert port_model.fit_cost_line(xs, ys).to_json() == jax_model.fit_cost_line(xs, ys).to_json()
    for mod in (port_model, jax_model):
        with pytest.raises(ValueError):
            mod.fit_cost_line([1.0, 1.0], [1.0, 2.0])


def test_ops_model_assembly_is_the_jax_one(tmp_path):
    paths = {}
    for name, kw in (("ops", {}), ("slow", {"xla_slope": 5e-10}), ("bad", {"parity_ok": False}),
                     ("h100", {"chip": "NVIDIA H100 80GB HBM3"})):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(_ops_artifact(**kw), f)
    for chip, srcs in (("cpu", ["ops"]), ("cpu", ["slow"]), ("cpu", ["bad"]),
                       ("cpu", ["ops", "slow", "bad"]), ("v5e", ["ops"])):
        got = [mod.ops_model_for_chip(chip, sources=[paths[s] for s in srcs])
               for mod in (port_model, jax_model)]
        assert [(m.chip, m.source, m.samples, m.kernels_json(), bool(m)) for m in got][0] == \
            [(m.chip, m.source, m.samples, m.kernels_json(), bool(m)) for m in got][1]
        for n, count in ((1_000_000, 1), (1_000_000, 3), (4096, 2)):
            assert got[0].savings_s("fused_update", n, count) == \
                got[1].savings_s("fused_update", n, count)
    # signed: the slow line prices negative, a parity failure prices None
    slow = port_model.ops_model_for_chip("cpu", sources=[paths["slow"]])
    assert slow.savings_s("fused_update", 1_000_000) < 0
    assert port_model.ops_model_for_chip(
        "cpu", sources=[paths["bad"]]).savings_s("fused_update", 1_000_000) is None
    # the port's chip table knows the card; the JAX one refuses it
    h100 = port_model.ops_model_for_chip("h100", sources=list(paths.values()))
    assert h100.chip == "h100" and set(h100.kernels) == {"fused_update"}
    with pytest.raises(ValueError, match="unknown chip"):
        jax_model.ops_model_for_chip("h100", sources=[paths["h100"]])
    with pytest.raises(ValueError, match="unknown chip"):
        port_model.ops_model_for_chip("warp drive")


@pytest.mark.parametrize("fused_slope", [1e-10, 5e-10])
def test_signed_pricing_is_the_jax_one(fused_slope):
    models = []
    for mod in (port_model, jax_model):
        kc = mod.KernelCost(fused=mod.CostLine(alpha_s=0.0, s_per_elem=fused_slope, samples=2),
                            xla=mod.CostLine(alpha_s=0.0, s_per_elem=2e-10, samples=2))
        models.append(mod.OpsModel(chip="v5e", kernels={"fused_update": kc},
                                   source="synthetic", samples=4))
    got = [m.savings_s("fused_update", 1_000_000, count=3) for m in models]
    assert got[0] == got[1] and (got[0] > 0) == (fused_slope < 2e-10)
    assert models[0].kernels_json() == models[1].kernels_json()
    assert models[0].savings_s("missing", 10) is None


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ops") / "ops.json")
    assert ops_main(["bench", "--device", "cpu", "--sizes", SIZES, "--reps", "1",
                     "--out", path]) == 0
    with open(path) as f:
        return path, json.load(f)


def test_cpu_bench_artifact_has_the_jax_keys(artifact):
    from tpu_ddp.ops.microbench import bench_artifact as jax_artifact

    _, art = artifact
    ops = art["ops"]
    assert ops["parity_ok"] and ops["parity_failures"] == [] and ops["skipped"] == []
    assert (ops["backend"], ops["chip"], ops["device_kind"]) == ("cpu", "cpu", "cpu")
    assert sorted(ops["kernels"]) == ["fused_dequant", "fused_quant", "fused_update"]
    assert "plain version" in ops["note"]
    rows = {r["kernel"]: r for r in ops["sweeps"]}
    for name, row in rows.items():
        keys = {"kernel", "elements", "fused_s", "xla_s", "parity_ok"}
        assert set(row) == keys | ({"variant"} if name == "fused_update" else set())
    want = jax_artifact(ops["sweeps"], ops["skipped"], reps=1)
    assert set(art) == set(want)
    assert set(ops) == set(want["ops"]) | {"note"}
    assert set(art["provenance"]) - {"torch_version"} == \
        set(want["provenance"]) - {"jax_version"}
    assert ops["kernels"] == want["ops"]["kernels"] and ops["rows"] == want["ops"]["rows"]


def test_registry_and_compare_take_the_port_artifact(artifact, tmp_path, capsys):
    from tpu_ddp_torch.analysis.regress import normalize_artifact
    from tpu_ddp_torch.registry.cli import main as registry_main
    from tpu_ddp_torch.registry.store import read_entries

    path, art = artifact
    assert set(normalize_artifact(art)) == {"ops"}
    reg = str(tmp_path / "reg")
    assert registry_main(["--registry", reg, "record", path]) == 0
    entries = read_entries(reg)
    assert [e.artifact_kind for e in entries] == ["ops"]


def test_calibrate_reads_the_three_lines(artifact, capsys):
    path, _ = artifact
    capsys.readouterr()
    assert ops_main(["calibrate", "--chip", "cpu", path, "--json"]) == 0
    model = json.loads(capsys.readouterr().out)
    assert model["chip"] == "cpu" and sorted(model["kernels"]) == [
        "fused_dequant", "fused_quant", "fused_update"]
    assert ops_main(["calibrate", "--chip", "h100", path]) == 0
    assert "no applicable evidence" in capsys.readouterr().out
    assert ops_main(["calibrate", "--chip", "warp drive", path]) == 2
    assert "unknown chip" in capsys.readouterr().err


@pytest.mark.parametrize("kernel", ["fused_update", "fused_quant"])
def test_corrupt_exits_1_naming_the_kernel(kernel, capsys):
    capsys.readouterr()
    assert ops_main(["bench", "--device", "cpu", "--sizes", SIZES, "--reps", "1",
                     "--kernels", f"{kernel},fused_dequant", "--corrupt", kernel]) == 1
    err = capsys.readouterr().err
    assert f"PARITY GATE FAILED for kernel(s) {kernel} " in err


def test_only_an_unknown_kernel_is_skipped(capsys):
    from tpu_ddp_torch.ops.microbench import run_sweeps

    import torch

    sweeps, skipped = run_sweeps(kernels=("fused_dequant", "nope"), sizes=(256, 512), reps=1,
                                 device=torch.device("cpu"))
    assert skipped == [{"kernel": "nope", "error": "unknown bench kernel 'nope'"}]
    assert [r["kernel"] for r in sweeps] == ["fused_dequant"] * 2
