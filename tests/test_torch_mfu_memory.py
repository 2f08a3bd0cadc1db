"""MFU and the memory gauges against the JAX package's.

``flops_per_step`` (one forward and backward counted on the ``meta``
device) within 10% of XLA's ``compiled_flops`` of the JAX train step (SGD,
forward, backward and update) on the same model and batch: NetResDeep at
``n_chans1=8, n_blocks=2`` and ViT-S/4's widths at depth 2 with full
attention. ``mfu`` and ``record_mfu`` work out as the JAX ones with the same
stub peak; ``peak_flops_per_chip`` is None on the CPU. The gauge writer
``publish_memory_gauges`` writes the JAX one's gauges for the same samples,
and ``record_memory_gauges`` on the CPU writes the JAX package's CPU set
less the gauges the JAX package derives from accounting its live arrays
(``memory/d<i>/bytes_in_use``, ``memory/bytes_in_use_max``,
``memory/bytes_in_use_total``, ``memory/high_water_bytes`` and
``memory/peak_bytes_in_use_max``): the port writes ``memory/host_rss_bytes``
alone there."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import logging
import types

import jax
import numpy as np
import pytest
import torch

import tpu_ddp.metrics.mfu as jax_mfu
import tpu_ddp_torch.metrics.mfu as port_mfu
from tpu_ddp.models.resnet import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.telemetry.registry import Registry as JaxRegistry
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.metrics.memory import publish_memory_gauges, record_memory_gauges
from tpu_ddp_torch.models import MODEL_REGISTRY, ViT
from tpu_ddp_torch.telemetry import Registry
from tpu_ddp_torch.train.trainer import Trainer, TrainConfig, build_model

VIT_DEPTH2 = dict(patch_size=4, hidden_dim=192, depth=2, num_heads=3)


def _jax_flops(model, rows):
    tx = jax_make_optimizer(lr=1e-2)
    state = jax_create_train_state(model, tx, jax.random.key(0))
    step = jax_make_train_step(model, tx, create_mesh(MeshSpec(data=1), jax.devices()[:1]),
                               donate=False)
    batch = {"image": np.zeros((rows, 32, 32, 3), np.float32),
             "label": np.zeros(rows, np.int32), "mask": np.ones(rows, bool)}
    return jax_mfu.compiled_flops(step, state, batch)


@pytest.mark.parametrize("name", ["netresdeep", "vit_s4_depth2"])
def test_flops_per_step_within_10pct_of_xla(devices, name, monkeypatch):
    if name == "netresdeep":
        config, rows = TrainConfig(device="cpu", n_chans1=8, n_blocks=2), 32
        want = _jax_flops(FlaxNetResDeep(n_chans1=8, n_blocks=2), rows)
    else:
        def vit_depth2(num_classes, generator, image_size, dtype, **_):
            return ViT(**VIT_DEPTH2, num_classes=num_classes, generator=generator,
                       image_size=image_size, dtype=dtype)

        monkeypatch.setitem(MODEL_REGISTRY, "vit_s4", vit_depth2)
        config, rows = TrainConfig(device="cpu", model="vit_s4", attention="flash"), 8
        want = _jax_flops(FlaxViT(**VIT_DEPTH2, num_classes=10), rows)
    # the trainer counts a flash run on a copy built with full attention
    full = dataclasses.replace(config, attention="full")
    got = port_mfu.flops_per_step(lambda: build_model(full), rows)
    assert want and got and abs(got / want - 1.0) < 0.10, (got, want)
    # a model group's rank is charged its share
    assert port_mfu.flops_per_step(lambda: build_model(full), rows, share=0.5) == got / 2


def test_failed_flop_count_is_logged_not_hidden(monkeypatch, caplog):
    """On a card with a known peak, a FLOP count that fails leaves MFU None
    and says so in the log; without a peak nothing is counted."""
    def broken(*_, **__):
        raise RuntimeError("meta build failed")

    monkeypatch.setattr(port_mfu, "flops_per_step", broken)
    trainer = types.SimpleNamespace(config=TrainConfig(device="cpu"), device="cpu",
                                    data_size=1, world_size=1)
    with caplog.at_level(logging.WARNING):
        assert Trainer._compute_mfu(trainer, 10, 1.0) is None
    assert not caplog.records           # no peak on the CPU: nothing counted
    monkeypatch.setattr(port_mfu, "peak_flops_per_chip", lambda device=None: 4e12)
    with caplog.at_level(logging.WARNING):
        assert Trainer._compute_mfu(trainer, 10, 1.0) is None
    assert any("MFU not computed" in r.getMessage() and r.exc_info for r in caplog.records)


def test_mfu_and_record_mfu_as_jax(monkeypatch):
    monkeypatch.setattr(jax_mfu, "peak_flops_per_chip", lambda device=None: 4e12)
    monkeypatch.setattr(port_mfu, "peak_flops_per_chip", lambda device=None: 4e12)
    for flops, rate in [(1e9, 10.0), (3.3e11, 2.5), (None, 1.0), (1e9, 0.0), (1e9, -1.0)]:
        assert port_mfu.mfu(flops, rate) == jax_mfu.mfu(flops, rate)
    assert port_mfu.mfu(1e9, 10.0) == 1e10 / 4e12
    port, jax_ = Registry(), JaxRegistry()
    for value in (None, 0.37):
        port_mfu.record_mfu(port, value)
        jax_mfu.record_mfu(jax_, value)
        assert port.snapshot() == jax_.snapshot()
    assert port.snapshot()["gauges"] == {"train/mfu": 0.37}


def test_peak_is_none_on_the_cpu():
    assert port_mfu.peak_flops_per_chip(torch.device("cpu")) is None
    assert port_mfu.peak_flops_per_chip("cpu") is None
    if not torch.cuda.is_available():
        assert port_mfu.peak_flops_per_chip() is None
    assert port_mfu.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989.4e12}


SAMPLES = [
    [],
    [{"d": 0, "bytes_in_use": 100, "peak_bytes_in_use": 250, "bytes_limit": 1000}],
    [{"d": 0, "bytes_in_use": 100, "peak_bytes_in_use": None, "bytes_limit": None},
     {"d": 1, "bytes_in_use": 300, "peak_bytes_in_use": 310, "bytes_limit": 800}],
]


def test_publish_memory_gauges_as_jax():
    from tpu_ddp.memtrack.sampler import publish_memory_gauges as jax_publish

    port, jax_ = Registry(), JaxRegistry()
    for samples in SAMPLES + [SAMPLES[1]]:        # the high-water stays monotone
        publish_memory_gauges(port, samples, rss=12345)
        jax_publish(jax_, samples, rss=12345)
        assert port.snapshot() == jax_.snapshot()
    assert port.snapshot()["gauges"]["memory/high_water_bytes"] == 310


def test_cpu_memory_gauges_are_the_jax_set_less_the_live_array_ones():
    from tpu_ddp.metrics.memory import record_memory_gauges as jax_record

    port, jax_ = Registry(), JaxRegistry()
    record_memory_gauges(port, torch.device("cpu"))
    live_array = jax.device_put(np.ones(16, np.float32), jax.devices()[0])
    jax_record(jax_)
    del live_array
    jax_names = set(jax_.snapshot()["gauges"])
    live = {"memory/bytes_in_use_max", "memory/bytes_in_use_total",
            "memory/high_water_bytes", "memory/peak_bytes_in_use_max"}
    live |= {n for n in jax_names if n.startswith("memory/d") and n.endswith("/bytes_in_use")}
    assert "memory/d0/bytes_in_use" in live and live <= jax_names
    assert set(port.snapshot()["gauges"]) == jax_names - live == {"memory/host_rss_bytes"}
    assert port.snapshot()["gauges"]["memory/host_rss_bytes"] > 0
