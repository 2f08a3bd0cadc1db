"""The live observatories on the card: the memory sampler's records against
``torch.cuda.memory_stats``, a capture window's ``torch.profiler`` trace
naming K1's kernel once a step, and a real allocator failure classified by
``is_resource_exhausted``. These need an NVIDIA GPU and nvcc and skip without
them; run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_observatories_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os

import pytest
import torch

from tpu_ddp_torch.memtrack.postmortem import is_resource_exhausted
from tpu_ddp_torch.memtrack.sampler import MemorySampler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_sampler_reads_the_allocator(cuda, tmp_path):
    keep = torch.empty(1 << 20, device=cuda)
    sampler = MemorySampler(str(tmp_path), device=cuda)
    try:
        rec = sampler.sample(1)
    finally:
        sampler.close()
    d = torch.cuda.current_device()
    (dev,) = rec["devices"]
    assert dev["source"] == "memory_stats" and dev["d"] == d
    assert dev["bytes_limit"] == torch.cuda.get_device_properties(d).total_memory
    assert keep.numel() * 4 <= dev["bytes_in_use"] <= dev["peak_bytes_in_use"] \
        <= dev["bytes_limit"]


def test_a_capture_window_traces_k1_once_a_step(cuda, tmp_path):
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.telemetry import reset_default_registry

    reset_default_registry()
    run_dir = str(tmp_path / "run")
    ops.reset_launch_counts()
    _, metrics = cli.run(["--device", "cuda", "--synthetic-data", "--synthetic-size", "256",
                          "--epochs", "1", "--batch-size", "32", "--kernels",
                          "--telemetry-dir", run_dir, "--profile-steps", "2:5"])
    assert ops.launch_counts()["fused_update"] == metrics["steps"] == 8
    bundle = os.path.join(run_dir, "profiles", "step_2-p0")
    with open(os.path.join(bundle, "meta.json")) as f:
        assert json.load(f)["sources"]["device"] == {"trace_dir": "device"}
    with open(os.path.join(bundle, "device", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("cat") == "kernel" and "fused_update_kernel" in e.get("name", "")
               for e in events) == 3


def test_a_real_allocation_failure_is_classified(cuda):
    free, _ = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * free, dtype=torch.uint8, device=cuda)
    assert is_resource_exhausted(err.value)
