"""The port's CLI: a short CPU run prints the reference's log lines with
finite losses, and without ``--device cpu`` it refuses to run where there
is no GPU."""

import math
import re

import pytest
import torch

from tpu_ddp_torch.cli.train import build_parser, main
from tpu_ddp_torch.runtime import resolve_device

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
        if key != "device":
            assert ref[key] == value, key
    assert port["device"] == "cuda"


def test_cuda_is_the_default_and_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--synthetic-data", "--synthetic-size", "64", "--epochs", "1"])
    with pytest.raises(ValueError, match="unknown device"):
        resolve_device("auto")
    assert resolve_device("cpu") == torch.device("cpu")
