"""One torch thread a process for the port's tests.

Every ``tests/test_torch_*.py`` imports this module first (pinned by
``tests/test_torch_imports.py``). The suite runs under ``pytest-xdist``
with several workers on a host of a few cores, and each worker's torch
would otherwise start an intra-op pool as wide as the host: the workers'
pools together then spin many times more threads than there are cores,
and a test that takes seconds alone takes minutes. One thread a process
keeps each worker, and each gloo rank a test spawns, on its own core.

``torch.set_num_threads(1)`` caps this process; ``OMP_NUM_THREADS=1``,
set only where the environment does not already name a count, reaches the
processes the tests start (the launcher's ranks, ``subprocess`` runs of
the CLIs). No test's inputs, cases or tolerances change.
"""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)
