"""``--optimizer lamb`` under the GSPMD families against the JAX package's
steps on 4 gloo CPU ranks: tp and fsdp_tp (data=2 x model=2) and fsdp
(data=4), the ViT (patch 8, hidden 64, depth 2, 4 heads) and NetResDeep
(n_chans1 8, 2 tied blocks), with weight decay, the EMA and a clip norm
(0.05) that triggers. GSPMD takes lamb's trust ratio ``||p|| / ||u||`` over
whole leaves; the port sums each leaf's squares over the ranks that hold
its pieces (``train/optim.py``'s ``leaf_sums``), so every rank scales its
piece of a cut leaf, or its FSDP shard, by the whole leaf's ratio. Two
steps from the JAX init, the first batch partly masked; losses, params,
running stats, Adam's moments and the EMA shadow within the tolerances of
``tests/test_torch_tensor_parallel.py``, whose helpers these are (the ViT's
``qkv`` biases held to a bound there: their trust ratio follows a gradient
that is rounding noise).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest

from test_torch_tensor_parallel import check_case, run_build

CASES = ["vit_lamb", "netresdeep_lamb"]


@pytest.fixture(scope="module", params=["tp", "fsdp", "fsdp_tp"])
def runs(request, devices, tmp_path_factory):
    return run_build(request.param, CASES, devices, tmp_path_factory)


@pytest.mark.parametrize("case", CASES)
def test_lamb_matches_jax(runs, case):
    check_case(case, *runs)
