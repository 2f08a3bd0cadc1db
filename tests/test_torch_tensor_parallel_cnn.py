"""Tensor parallelism of the conv families in the port
(``parallel/tensor_parallel.py``'s ``CNN_TP_RULES``) against the JAX
package's ``make_tp_train_step`` with ``has_batch_stats``, on a data=2 x
model=2 grid of gloo CPU ranks: NetResDeep (n_chans1 8, 2 tied blocks) and
a ResNet-family member (stages (1, 1), 8 filters, basic blocks), every
conv out-channel-cut, BatchNorm over the global batch. The cases, the
batches (the first one partly masked), the tolerances (losses 5e-4, params
and running stats ``atol=1e-5, rtol=1e-4``) and the helpers are
``tests/test_torch_tensor_parallel.py``'s.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest

from test_torch_tensor_parallel import check_case, run_build

CNN_CASES = ["netresdeep", "resnet"]


@pytest.fixture(scope="module")
def tp_runs(devices, tmp_path_factory):
    return run_build("tp", CNN_CASES, devices, tmp_path_factory)


@pytest.mark.parametrize("case", CNN_CASES)
def test_cnn_tp_step_matches_jax(tp_runs, case):
    check_case(case, *tp_runs)
