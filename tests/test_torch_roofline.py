"""The port's one chip table and its roofline against the JAX package's.

- ``chip_spec`` on every JAX device-kind string and key gives the JAX row
  (the port's table is the JAX one with the ``h100`` row first);
- ``roofline()`` on the same hand-built anatomies (the toy of
  ``tests/test_analysis.py``: compute, hbm and ici each a known time) gives
  the JAX report, ``to_json`` equal: both overlaps, with and without a
  measured comms model, a CPU device kind, a chip override and an unknown
  chip;
- the three tables the port kept before (``profiler/device.py``,
  ``comms/model.py``, ``metrics/mfu.py``) read the one.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import importlib

import pytest

import tpu_ddp.analysis.hlo as jax_hlo
import tpu_ddp.comms.model as jax_comms
import tpu_ddp_torch.analysis.anatomy as port_hlo
import tpu_ddp_torch.comms.model as port_comms

# the packages' ``analysis`` export a ``roofline`` function by that name
jax_rl = importlib.import_module("tpu_ddp.analysis.roofline")
port_rl = importlib.import_module("tpu_ddp_torch.analysis.roofline")

KINDS = ["TPU v5 lite", "TPU v5p", "TPU v5", "TPU v4", "TPU v3", "TPU v2", "TPU v6 lite",
         "TPU v6e", "Trillium", "TPU v5litepod", "cpu", "CPU", "warp drive", "", None,
         *jax_rl.CHIP_SPECS]


@pytest.mark.parametrize("kind", KINDS, ids=repr)
def test_chip_spec_is_the_jax_row(kind):
    port, jax_ = port_rl.chip_spec(kind), jax_rl.chip_spec(kind)
    assert (port and dataclasses.asdict(port)) == (jax_ and dataclasses.asdict(jax_))
    assert port_rl.hbm_bytes_per_chip(kind or "") == jax_rl.hbm_bytes_per_chip(kind or "")


def test_the_h100_row_comes_first():
    spec = port_rl.chip_spec("NVIDIA H100 80GB HBM3")
    assert spec is port_rl.CHIP_SPECS["h100"] is port_rl.chip_spec("h100")
    assert (spec.peak_bf16_flops, spec.hbm_bytes, spec.hbm_bw, spec.ici_bw, spec.ici_links) == (
        989.4e12, 80_000_000_000, 3.35e12, 4.5e11, 18)
    assert list(port_rl.CHIP_SPECS)[1:] == list(jax_rl.CHIP_SPECS)
    assert port_rl._KIND_PATTERNS[1:] == jax_rl._KIND_PATTERNS
    assert port_rl.peak_flops_per_chip("cpu") is None
    assert port_rl.ROOFLINE_SCHEMA_VERSION == jax_rl.ROOFLINE_SCHEMA_VERSION


def _anatomy(mod, coll_mod, **overrides):
    base = dict(
        strategy="dp", model="toy", device_kind="TPU v5 lite",
        mesh={"data": 8}, n_devices=8, per_shard_batch=8,
        compute_dtype="bfloat16",
        flops=197e12 * 1e-3,          # 1 ms of v5e compute
        bytes_accessed=8.1e11 * 5e-4,  # 0.5 ms of v5e memory
        argument_bytes=1 << 20, output_bytes=1 << 20, temp_bytes=2 << 20,
        generated_code_bytes=None, fusion_count=3, hlo_ops={},
        collectives=[coll_mod.Collective(
            kind="all-reduce", dtype="f32", axis="data", count=1, group_size=8,
            payload_bytes=45_000_000, wire_bytes=int(2 * 7 / 8 * 45_000_000))],
    )
    base.update(overrides)
    return mod.StepAnatomy(**base)


_LINKS = {"chip": "v5e", "device_kind": "TPU v5 lite",
          "links": {"all-reduce/f32/data": {"alpha_s": 2e-5, "beta_bytes_per_s": 3e10,
                                            "samples": 4}}}

#: (anatomy overrides, roofline args, comms model on)
CASES = {
    "toy_overlapped": ({}, {}, False),
    "toy_serial": ({}, {"overlap": "serial"}, False),
    "compute_bound_on_v5p": ({"collectives": [], "bytes_accessed": 8.1e11 * 1e-5},
                             {"chip": "v5p"}, False),
    "cpu_no_peak": ({"device_kind": "cpu"}, {}, False),
    "cpu_as_v5e": ({"device_kind": "cpu"}, {"chip": "v5e"}, False),
    "cpu_as_v4": ({"device_kind": "cpu"}, {"chip": "v4"}, False),
    "unknown_chip": ({}, {"chip": "warp drive"}, False),
    "no_flops": ({"flops": None, "bytes_accessed": None}, {}, False),
    "comms_model": ({}, {}, True),
    "comms_model_serial": ({}, {"overlap": "serial"}, True),
    "comms_model_cpu": ({"device_kind": "cpu"}, {}, True),
}


@pytest.mark.parametrize("case", CASES)
def test_roofline_is_the_jax_report(case):
    overrides, kw, with_model = CASES[case]
    kw = dict(kw)
    chip = kw.pop("chip", None)
    reports = []
    for hlo, rl, comms in ((port_hlo, port_rl, port_comms), (jax_hlo, jax_rl, jax_comms)):
        model = comms.model_from_comms_record(_LINKS) if with_model else None
        reports.append(rl.roofline(_anatomy(hlo, hlo, **overrides), chip, comms_model=model,
                                   **kw).to_json())
    assert reports[0] == reports[1]


def test_roofline_refuses_an_unknown_overlap():
    with pytest.raises(ValueError, match="overlap must be"):
        port_rl.roofline(_anatomy(port_hlo, port_hlo), overlap="sideways")


def test_the_old_tables_read_the_one():
    from tpu_ddp_torch.metrics import mfu
    from tpu_ddp_torch.profiler import device

    assert device.chip_spec is port_rl.chip_spec
    assert device.CHIP_SPECS is port_rl.CHIP_SPECS and device.ChipSpec is port_rl.ChipSpec
    assert mfu.peak_flops_per_chip is port_rl.peak_flops_per_chip
    assert mfu.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": port_rl.CHIP_SPECS["h100"].peak_bf16_flops}
    for kind in KINDS[:-len(jax_rl.CHIP_SPECS)]:
        assert port_comms._chip_key(kind) == jax_comms._chip_key(kind)
    assert port_comms._chip_key("NVIDIA H100 80GB HBM3") == "h100"
