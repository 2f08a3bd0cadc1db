"""The new families through the port's CLI on 4 gloo CPU ranks
(``python -m tpu_ddp_torch.cli.launch --nproc-per-node 4 -- python -m
tpu_ddp_torch.cli.train ...``), as a user starts them (the JAX
``test_cli_train_checkpoint_resume_eval``, ``tests/test_strategy.py:92``):

* ``--mesh data=2,model=2 --model vit_s4 --attention flash --kernels``
  (K4-K6 and K1 take their plain versions on the CPU), one epoch with a
  checkpoint, then ``--resume`` to a second, the final evaluation and
  ``--dump-predictions`` (every test row once);
* ``--mesh data=2,model=2 --model netresdeep`` (channel rules);
* ``--parallelism fsdp --model resnet18`` (a ResNet-family member at its
  own width, two steps);
* ``--parallelism fsdp_tp --mesh data=2,model=2 --model vit_s4``;
* ``--parallelism sp --mesh data=2,sequence=2 --zero1 --grad-compress int8
  --grad-compress-error-feedback --kernels`` (K1, K2 and K3's plain
  versions).

Each run's losses are finite and its final test accuracy is printed.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "32",
        "--global-batch-size", "16", "--log-every-epochs", "1", "--prefetch-depth", "0"]
RUNS = {
    "tp_vit": ["--mesh", "data=2,model=2", "--model", "vit_s4", "--attention", "flash",
               "--kernels", "--optimizer", "adamw", "--lr", "1e-3"],
    "tp_cnn": ["--mesh", "data=2,model=2", "--model", "netresdeep", "--n-chans1", "8",
               "--n-blocks", "2", "--kernels", "--momentum", "0.9"],
    "fsdp_resnet": ["--parallelism", "fsdp", "--model", "resnet18", "--kernels"],
    "fsdp_tp_vit": ["--parallelism", "fsdp_tp", "--mesh", "data=2,model=2", "--model",
                    "vit_s4", "--kernels", "--grad-clip-norm", "1.0"],
    "sp_overlays": ["--parallelism", "sp", "--mesh", "data=2,sequence=2", "--model", "vit_s4",
                    "--zero1", "--grad-compress", "int8", "--grad-compress-error-feedback",
                    "--kernels", "--sp-flash"],
}


def _launch(args, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "4", "--",
         sys.executable, "-m", "tpu_ddp_torch.cli.train", *BASE, *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _losses(out):
    return [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if line.startswith("Epoch ") and "Training loss" in line]


@pytest.mark.parametrize("run", ["tp_cnn", "fsdp_resnet", "fsdp_tp_vit", "sp_overlays"])
def test_cli_family_trains(run):
    out = _launch(RUNS[run] + ["--epochs", "1"])
    losses = _losses(out)
    assert len(losses) == 1 and all(map(lambda x: x == x and abs(x) < 1e3, losses)), out
    assert "final test accuracy" in out


def test_cli_tp_checkpoint_resume_eval(tmp_path):
    ck = str(tmp_path / "ck")
    first = _launch(RUNS["tp_vit"] + ["--epochs", "1", "--checkpoint-dir", ck,
                                      "--checkpoint-every-epochs", "1"])
    assert "final test accuracy" in first
    steps = max(int(p) for p in os.listdir(ck) if p.isdigit())
    dump = str(tmp_path / "p.json")
    second = _launch(RUNS["tp_vit"] + ["--epochs", "2", "--checkpoint-dir", ck,
                                       "--checkpoint-every-epochs", "1", "--resume",
                                       "--dump-predictions", dump])
    assert f"resumed from step {steps}" in second
    assert max(int(p) for p in os.listdir(ck) if p.isdigit()) == 2 * steps
    with open(dump) as f:
        got = json.load(f)
    assert len(got["predictions"]) == len(got["labels"]) == 64
