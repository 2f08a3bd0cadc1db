"""``python -m tpu_ddp_torch.main``: data-parallel training over every
visible card, the port's counterpart of the root ``main.py`` and of the
reference's ``main.py`` (``mp.spawn`` and DDP over all local GPUs).

With several cards it starts one rank a card through the launcher
(``cli/launch.py::run_job``, over NCCL, the default backend on ``cuda``),
each running ``python -m tpu_ddp_torch.cli.train`` with every flag given
here; with one card, or ``--device cpu``, it trains in this process. With
no flags it trains NetResDeep on CIFAR-10 with the reference recipe (SGD lr
1e-2, batch 32 a rank, 99 epochs). SIGTERM and SIGINT reach every rank
(the launcher forwards them), which drain and checkpoint; ``--resume``
continues.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from tpu_ddp_torch.cli.launch import run_job, runs_on_cpu


def plan(argv: Sequence[str], device_count: int) -> Optional[List[str]]:
    """The command each rank runs, one a card, or None to train in this
    process (one card or none, or ``--device cpu``; without a card the CLI
    itself refuses ``--device cuda``)."""
    if runs_on_cpu(argv) or device_count <= 1:
        return None
    return [sys.executable, "-m", "tpu_ddp_torch.cli.train", *argv]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from tpu_ddp_torch.cli.train import main as train_main

    argv = list(sys.argv[1:] if argv is None else argv)
    n = torch.cuda.device_count()
    cmd = plan(argv, n)
    if cmd is None:
        train_main(argv)
        return 0
    return run_job(cmd, nproc_per_node=n)


if __name__ == "__main__":
    sys.exit(main())
