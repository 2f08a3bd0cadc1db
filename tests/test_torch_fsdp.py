"""FSDP and FSDP x TP in the port (``parallel/tensor_parallel.py``:
``Zero3Partition`` over the data group, alone or over each rank's
tensor-parallel leaves) against the JAX package's ``make_fsdp_train_step``
(data=4) and ``make_fsdp_tp_train_step`` (data=2 x model=2), on 4 gloo CPU
ranks: the ViT (patch 8, hidden 64, depth 2, 4 heads) under both,
NetResDeep under fsdp, its BatchNorm over the global batch, the ViT under
fsdp with ``--remat`` and under fsdp_tp with the flight recorder (per-layer
norms; the stats against the JAX step's, ``rtol=1e-5``, as
``tests/test_torch_health_steps.py`` checks them). Two SGD steps
from the JAX init, the first batch partly masked; the cases, tolerances
and helpers are ``tests/test_torch_tensor_parallel.py``'s: losses within
1e-4 (ViT) and 5e-4 (NetResDeep), params gathered after two steps within
``atol=1e-5, rtol=1e-4``, every rank's equal to the bit.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest

from test_torch_tensor_parallel import check_case, run_build


FSDP_CASES = ["vit", "netresdeep", "vit_remat"]
FSDP_TP_CASES = ["vit", "vit_health"]


@pytest.fixture(scope="module")
def fsdp_runs(devices, tmp_path_factory):
    return run_build("fsdp", FSDP_CASES, devices, tmp_path_factory)


@pytest.fixture(scope="module")
def fsdp_tp_runs(devices, tmp_path_factory):
    return run_build("fsdp_tp", FSDP_TP_CASES, devices, tmp_path_factory)


@pytest.mark.parametrize("case", FSDP_CASES)
def test_fsdp_step_matches_jax(fsdp_runs, case):
    check_case(case, *fsdp_runs)


@pytest.mark.parametrize("case", FSDP_TP_CASES)
def test_fsdp_tp_step_matches_jax(fsdp_tp_runs, case):
    check_case(case, *fsdp_tp_runs)
