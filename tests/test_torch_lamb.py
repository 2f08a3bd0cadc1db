"""``--optimizer lamb`` in the port (``train/optim.py``) against the JAX
package's ``make_optimizer(optimizer="lamb")`` (optax's ``lamb``): five
updates on the same params and gradients, with masked weight decay, a
global-norm clip, a schedule, the EMA and freeze masks, with one leaf whose
param is all zero and one whose gradient is (the trust ratio's two zero
cases), within ``rtol 1e-5, atol 1e-6``. Then one NetResDeep training step
through the trainer against the JAX train step with lamb, and the
refusals: ``--kernels`` (K1 has no lamb branch) and ``--zero1``."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_ddp.train.optim import freeze_all_but as jax_freeze_all_but
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp_torch.train.optim import freeze_all_but, make_optimizer, trust_ratio

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"conv": (3, 3, 4, 5), "dense": (6, 4), "bias": (4,), "zero_param": (5, 2),
          "zero_grad": (7,), "head": (4, 3)}

CASES = {
    "decay_clip": dict(weight_decay=0.1, grad_clip_norm=1.0),
    "cosine_ema": dict(schedule="cosine", total_steps=10, warmup_steps=2, ema_decay=0.9),
    "decay_clip_frozen": dict(weight_decay=0.05, grad_clip_norm=0.5, freeze=("head",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lamb_five_updates_match_optax(case):
    kw = dict(CASES[case])
    freeze = kw.pop("freeze", None)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero_param"][:] = 0.0
    jtx = jax_make_optimizer(lr=1e-2, optimizer="lamb", **kw,
                             freeze_predicate=jax_freeze_all_but(freeze) if freeze else None)
    ptx = make_optimizer(lr=1e-2, optimizer="lamb", **kw,
                         freeze_predicate=freeze_all_but(freeze) if freeze else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    pp = {k: torch.tensor(v) for k, v in params.items()}
    ps = ptx.init(pp)
    for _ in range(5):
        grads = {k: (3 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        grads["zero_grad"][:] = 0.0
        updates, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.apply({k: torch.tensor(v) for k, v in grads.items()}, ps, pp)
        for k in SHAPES:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    assert int(ps.count) == 5
    if freeze:                     # only the head trains: no moments elsewhere
        assert set(ps.mu) == set(ps.nu) == {"head"}
    if kw.get("ema_decay"):
        leaves = jax.tree_util.tree_leaves_with_path(js)
        ema = {jax.tree_util.keystr(p): v for p, v in leaves if "ema" in jax.tree_util.keystr(p)}
        assert len(ema) == len(SHAPES)
        for name, t in ps.ema.items():
            want = next(v for p, v in ema.items() if f"'{name}'" in p)
            np.testing.assert_allclose(t.numpy(), np.asarray(want), err_msg=name, **TOL)


def test_trust_ratio_zero_cases():
    one = torch.ones(())
    assert torch.equal(trust_ratio(torch.zeros(3), torch.ones(3)), one)
    assert torch.equal(trust_ratio(torch.ones(3), torch.zeros(3)), one)
    assert float(trust_ratio(torch.full((4,), 3.0), torch.full((4,), 1.5))) == 2.0


def test_kernels_and_zero1_refuse_lamb():
    with pytest.raises(ValueError, match="K1 .* has no lamb branch"):
        make_optimizer(optimizer="lamb", kernels=True)
    with pytest.raises(ValueError, match="--zero1 does not compose with --optimizer lamb"):
        make_optimizer(optimizer="lamb", zero1_axis="data")
    with pytest.raises(ValueError, match="--momentum is an SGD knob; lamb"):
        make_optimizer(optimizer="lamb", momentum=0.9)


def test_netresdeep_lamb_steps_match_the_jax_step(devices):
    """Three steps of a small NetResDeep with lamb, decay and a clip through
    the port's one-rank DP step and the JAX step on one device, from the
    same weights: losses ``rtol 1e-5``, params ``atol 1e-5`` (the two
    frameworks' CPU convolutions sum in other orders)."""
    from tpu_ddp.data.cifar10 import synthetic_cifar10
    from tpu_ddp.models import NetResDeep as FlaxNetResDeep
    from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
    from tpu_ddp.parallel.mesh import replicated_sharding
    from tpu_ddp.train import create_train_state
    from tpu_ddp.train.steps import make_train_step as jax_make_train_step
    from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.train.state import create_train_state as port_create_state
    from tpu_ddp_torch.train.steps import make_train_step

    model_kw = dict(n_chans1=6, n_blocks=2, num_classes=7)
    opt = dict(lr=1e-3, optimizer="lamb", weight_decay=0.01, grad_clip_norm=1.0)
    fmodel = FlaxNetResDeep(**model_kw)
    jtx = jax_make_optimizer(**opt)
    init = create_train_state(fmodel, jtx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), devices[:1])
    jstep = jax_make_train_step(fmodel, jtx, mesh, donate=False)
    js = jax.device_put(init, replicated_sharding(mesh))
    ptx = make_optimizer(**opt)
    state = port_create_state(NetResDeep(**model_kw), ptx, torch.device("cpu"))
    state.model.load_state_dict(from_jax(*jax.device_get((init.params, init.batch_stats)))["model"])
    step = make_train_step(ptx)
    images, labels = synthetic_cifar10(24, num_classes=7, seed=3)
    for i in range(3):
        batch = {"image": images[8 * i:8 * i + 8], "label": labels[8 * i:8 * i + 8],
                 "mask": np.ones(8, bool)}
        js, jm = jstep(js, jax.device_put(batch, batch_sharding(mesh)))
        state, pm = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = convert_tree(jax.device_get(js.params))
    got = state.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)
