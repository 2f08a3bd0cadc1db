"""The GSPMD families' update against the JAX package's on a data=2 x
model=2 grid of gloo CPU ranks: tp (``make_tp_train_step``) and fsdp_tp
(``make_fsdp_tp_train_step``), the ViT (patch 8, hidden 64, depth 2, 4
heads) and NetResDeep (n_chans1 8, 2 tied blocks), under AdamW with weight
decay, an EMA of the params and a clip norm (0.05) low enough to trigger,
the port's update through K1 (its plain version on the CPU). The clip's
norm is the global one over the cut leaves, each replicated leaf counted
once; SGD with momentum, weight decay, the EMA and the same clip
(``sgd_clip``) is the sharper check of it, since its step scales with the
norm where Adam's mostly does not. Two steps from the JAX init, the first
batch partly masked; losses, params, BatchNorm's running stats and the
optimizer state (Adam's moments or the trace, and the EMA shadow) are held
to the JAX step's with the tolerances and helpers of
``tests/test_torch_tensor_parallel.py``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest

from test_torch_tensor_parallel import check_case, run_build

TP_CASES = ["vit_adamw", "netresdeep_adamw", "vit_sgd_clip"]
FSDP_TP_CASES = ["vit_adamw", "netresdeep_adamw", "netresdeep_sgd_clip"]


@pytest.fixture(scope="module")
def tp_runs(devices, tmp_path_factory):
    return run_build("tp", TP_CASES, devices, tmp_path_factory)


@pytest.fixture(scope="module")
def fsdp_tp_runs(devices, tmp_path_factory):
    return run_build("fsdp_tp", FSDP_TP_CASES, devices, tmp_path_factory)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_update_matches_jax(tp_runs, case):
    check_case(case, *tp_runs)


@pytest.mark.parametrize("case", FSDP_TP_CASES)
def test_fsdp_tp_update_matches_jax(fsdp_tp_runs, case):
    check_case(case, *fsdp_tp_runs)
