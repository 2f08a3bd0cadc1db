"""NetResDeep in the PyTorch port against the Flax model: param counts,
train- and eval-mode logits and the BatchNorm running stats on weights
carried across by ``tpu_ddp_torch.checkpoint.convert``.

Tolerance ``rtol=atol=1e-5``: the two frameworks run different float32
convolution algorithms on the CPU, so sums are taken in other orders."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp_torch.checkpoint.convert import from_jax
from tpu_ddp_torch.models import NetResDeep, param_count

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tied,expected", [(True, 76_074), (False, 159_594)])
def test_param_counts(tied, expected):
    assert param_count(NetResDeep(tied=tied)) == expected


def _pair(tied, n_chans1=8, n_blocks=2, seed=0):
    flax_model = FlaxNetResDeep(n_chans1=n_chans1, n_blocks=n_blocks, tied=tied)
    x = np.random.default_rng(seed).normal(size=(8, 32, 32, 3)).astype(np.float32)
    variables = flax_model.init(jax.random.key(seed), x, train=False)
    # perturb the running stats so eval mode reads non-trivial values
    stats = jax.tree.map(
        lambda s: np.asarray(s) + np.float32(0.1), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    port = NetResDeep(n_chans1=n_chans1, n_blocks=n_blocks, tied=tied)
    port.load_state_dict(from_jax(jax.device_get(variables["params"]),
                                  stats)["model"])
    return flax_model, variables, port, x


@pytest.mark.parametrize("tied", [True, False])
def test_forward_and_bn_stats_match_flax(tied):
    flax_model, variables, port, x = _pair(tied)
    xt = torch.from_numpy(x)

    want_eval = np.asarray(flax_model.apply(variables, x, train=False))
    port.eval()
    with torch.no_grad():
        np.testing.assert_allclose(port(xt).numpy(), want_eval, **TOL)

    want_train, mutated = flax_model.apply(
        variables, x, train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got_train = port(xt).numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), **TOL)
    want_stats = from_jax({}, jax.device_get(mutated["batch_stats"]))["model"]
    got_stats = port.state_dict()
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name].numpy(), want.numpy(),
                                   **TOL, err_msg=name)


def test_tied_block_moves_running_stats_n_blocks_times():
    """One shared ResBlock: its BatchNorm's running mean moves on each of
    the n_blocks calls of one forward."""
    n_blocks = 3
    port = NetResDeep(n_chans1=8, n_blocks=n_blocks, tied=True)
    bn = port.resblock.batch_norm
    seen = []
    bn.register_forward_hook(
        lambda mod, inp, out: seen.append(mod.running_mean.clone()))
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32))
    start = bn.running_mean.clone()
    port.train()
    with torch.no_grad():
        port(x)
    assert len(seen) == n_blocks
    snapshots = [start] + seen
    for before, after in zip(snapshots, snapshots[1:]):
        assert not torch.equal(before, after)
    assert torch.equal(bn.running_mean, seen[-1])
