"""Telemetry on the card: the memory gauges against ``torch.cuda.memory_stats``,
``train/mfu`` written by a traced run on a card with a known peak, and the
``device_sync`` fence waiting for the step's own stream. These need an
NVIDIA GPU and nvcc and skip without them; run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json

import pytest
import torch

from tpu_ddp_torch.metrics.memory import record_memory_gauges
from tpu_ddp_torch.metrics.mfu import PEAK_BF16_FLOPS
from tpu_ddp_torch.telemetry import Registry, reset_default_registry

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_memory_gauges_read_the_allocator(cuda):
    torch.cuda.reset_peak_memory_stats()
    keep = torch.empty(1 << 20, device=cuda)
    del_me = torch.empty(1 << 22, device=cuda)
    del del_me
    reg = Registry()
    record_memory_gauges(reg, cuda)
    stats = torch.cuda.memory_stats(cuda)
    g = reg.snapshot()["gauges"]
    d = torch.cuda.current_device()
    assert g[f"memory/d{d}/bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert g["memory/high_water_bytes"] == torch.cuda.max_memory_allocated(cuda)
    assert g["memory/bytes_limit_per_device"] == torch.cuda.get_device_properties(d).total_memory
    assert g["memory/fragmentation_bytes"] >= 4 * (1 << 22) - 4 * (1 << 20)
    assert g["memory/host_rss_bytes"] > 0
    del keep


def test_traced_run_writes_mfu_and_fences_on_the_step_stream(cuda, tmp_path, monkeypatch):
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    if torch.cuda.get_device_name() not in PEAK_BF16_FLOPS:
        pytest.skip("no bfloat16 peak for this card")
    fenced = []
    record = torch.cuda.Event.record

    def watched(event, stream=None):
        fenced.append(stream)
        return record(event, stream)

    traced = Trainer._traced_step

    def step(self, loss, *args):
        monkeypatch.setattr(torch.cuda.Event, "record", watched)
        try:
            return traced(self, loss, *args)
        finally:
            monkeypatch.setattr(torch.cuda.Event, "record", record)

    monkeypatch.setattr(Trainer, "_traced_step", step)
    reset_default_registry()
    metrics = cli.main(["--synthetic-data", "--synthetic-size", "256", "--epochs", "2",
                        "--kernels", "--telemetry-dir", str(tmp_path)])
    assert 0 < metrics["mfu"] < 1
    last = [json.loads(line) for line in open(tmp_path / "trace-p0.jsonl")][-1]
    assert last["attrs"]["gauges"]["train/mfu"] == metrics["mfu"]
    assert len(fenced) == metrics["steps"]
    assert all(s == torch.cuda.current_stream() for s in fenced)
