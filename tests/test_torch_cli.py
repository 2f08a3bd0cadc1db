"""The port's CLI: a short CPU run prints the reference's log lines with
finite losses, and without ``--device cpu`` it refuses to run where there
is no GPU. The launcher runs it on two CPU ranks, ends the job with a
failing rank's code, and imports neither torch nor jax; the compression
flags are validated with the JAX package's messages."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_ddp_torch.cli import launch
from tpu_ddp_torch.cli.train import build_parser, main
from tpu_ddp_torch.parallel import runtime as dist_runtime
from tpu_ddp_torch.runtime import resolve_device
from tpu_ddp_torch.train.trainer import TrainConfig

ROOT = Path(__file__).resolve().parents[1]

SMALL = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "256",
         "--epochs", "2", "--n-chans1", "8", "--n-blocks", "2",
         "--eval-each-epoch", "--log-every-epochs", "1"]


@pytest.mark.parametrize("extra", [["--kernels"], []])
def test_cli_cpu_run_prints_reference_lines(capsys, extra):
    metrics = main(SMALL + extra)
    out = capsys.readouterr().out
    losses = [float(x) for x in
              re.findall(r"^Epoch \d+, Training loss (\S+)$", out, re.M)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert re.search(r"^training time: [\d.]+ seconds$", out, re.M)
    final = re.search(r"^final test accuracy: ([\d.]+), test loss: (\S+)$",
                      out, re.M)
    assert final and math.isfinite(float(final.group(2)))
    assert metrics["steps"] == 16
    assert math.isfinite(metrics["test_loss"])


def test_cli_defaults_match_jax_cli():
    from tpu_ddp.cli.train import build_parser as jax_build_parser

    port = vars(build_parser().parse_args([]))
    ref = vars(jax_build_parser().parse_args([]))
    for key, value in port.items():
        if key not in ("device", "dist_backend"):   # the port's own flags
            assert ref[key] == value, key
    assert port["dist_backend"] is None
    assert port["device"] == "cuda"
    for key in ("checkpoint_dir", "checkpoint_every_epochs", "checkpoint_steps",
                "resume", "keep_best", "eval_only", "jsonl", "tensorboard_dir"):
        assert key in port, key


def test_compute_dtype_and_remat_parse_into_the_config():
    """``--compute-dtype`` (float32 by default, or bfloat16) and ``--remat``
    reach ``TrainConfig`` as the JAX CLI's do; another dtype is refused."""
    from tpu_ddp_torch.cli.train import config_from_args

    config = config_from_args(build_parser().parse_args([]))
    assert config.compute_dtype == "float32" and config.remat is False
    config = config_from_args(build_parser().parse_args(
        ["--compute-dtype", "bfloat16", "--remat"]))
    assert config.compute_dtype == "bfloat16" and config.remat is True
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--compute-dtype", "float16"])
    with pytest.raises(ValueError, match="unknown compute dtype"):
        TrainConfig(compute_dtype="float16")


def test_cuda_is_the_default_and_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--synthetic-data", "--synthetic-size", "64", "--epochs", "1"])
    with pytest.raises(ValueError, match="unknown device"):
        resolve_device("auto")
    assert resolve_device("cpu") == torch.device("cpu")


def _launch(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_two_cpu_ranks_int8_ring():
    proc = _launch(["--nproc-per-node", "2", "--", sys.executable, "-m",
                    "tpu_ddp_torch.cli.train", "--device", "cpu",
                    "--synthetic-data", "--synthetic-size", "128", "--epochs", "1",
                    "--n-chans1", "8", "--n-blocks", "2", "--kernels",
                    "--grad-compress", "int8", "--grad-compress-error-feedback"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    epochs = re.findall(r"^Epoch 1, Training loss (\S+)$", proc.stdout, re.M)
    assert len(epochs) == 1 and math.isfinite(float(epochs[0]))   # rank 0 alone
    assert len(re.findall(r"^final test accuracy", proc.stdout, re.M)) == 1
    assert "images/sec/rank" in proc.stdout


def test_launcher_ends_the_job_with_a_failing_rank_code():
    child = ("import os, sys, time\n"
             "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)")
    proc = _launch(["--nproc-per-node", "2", "--", sys.executable, "-c", child],
                   timeout=60)
    assert proc.returncode == 3


def test_launcher_plans_ranks_and_env_like_the_jax_launcher():
    from tpu_ddp.cli import launch as jax_launch

    for args in ((1, 2, 0), (2, 4, 1)):
        assert launch.plan_ranks(*args) == jax_launch.plan_ranks(*args)
    env = launch.child_env({}, master="127.0.0.1:1234", world_size=4, rank=3,
                           local_rank=1, nproc_per_node=2)
    assert env == {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1234",
                   "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
                   "LOCAL_WORLD_SIZE": "2"}
    assert launch.wants_kernel_build(["python", "x", "--kernels"])
    assert not launch.wants_kernel_build(["python", "x", "--kernels", "--device", "cpu"])
    assert not launch.wants_kernel_build(["python", "x"])


def test_launcher_imports_neither_torch_nor_jax():
    code = ("import sys, tpu_ddp_torch.cli.launch, tpu_ddp_torch.ops._build; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.stdout.strip() == "[]", out.stderr


@pytest.mark.parametrize("kw", [
    dict(grad_compress_error_feedback=True),
    dict(grad_compress="int8", grad_compress_block=0),
    dict(grad_compress="fp8"),
])
def test_compression_flags_validated_with_jax_messages(kw):
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig

    with pytest.raises(ValueError) as want:
        JaxTrainConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        TrainConfig(**kw)
    assert str(got.value) == str(want.value)


def test_single_rank_needs_no_process_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist_runtime.initialize_distributed("cpu") is False
    assert dist_runtime.world_size() == 1 and dist_runtime.is_primary_process()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="partial launcher environment"):
        dist_runtime.initialize_distributed("cpu")


def test_nccl_rank_without_its_own_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        dist_runtime.rank_device("cuda", "nccl")
    assert dist_runtime.rank_device("cuda", "gloo") == torch.device("cuda", 0)
    assert dist_runtime.rank_device("cpu", "gloo") == torch.device("cpu")
    assert dist_runtime.default_backend("cuda") == "nccl"
    assert dist_runtime.default_backend("cpu") == "gloo"


def test_launcher_rendezvous_ports_lie_below_the_ephemeral_range():
    """The launcher's rendezvous port is drawn from ``_PORTS``, below the
    kernel's ephemeral range (where ``bind`` on port 0 and outgoing
    connections take theirs), and binds when picked."""
    import socket

    from tpu_ddp_torch.cli.launch import _PORTS, pick_free_port

    ports = {pick_free_port() for _ in range(20)}
    assert all(_PORTS[0] <= p < _PORTS[1] <= 32768 for p in ports)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", ports.pop()))
