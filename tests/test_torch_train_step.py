"""The slice as a whole: three ``train_step``s of the PyTorch port against
three steps of the JAX package's ``make_train_step`` on a 1-device mesh,
from the same weights (carried across by the converter) on the same numpy
batches, the last one masked.

Tolerances: per-step loss ``rtol=1e-5``; params and BatchNorm stats after
step 3 ``atol=1e-5`` (different float32 convolution algorithms on the CPU
sum in other orders)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

RECIPES = {
    "reference": dict(lr=1e-2),
    "sgd_mom_wd_clip_ema_cosine": dict(
        lr=1e-2, momentum=0.9, weight_decay=5e-4, grad_clip_norm=1.0,
        ema_decay=0.99, schedule="cosine", total_steps=6, warmup_steps=1),
    "adamw_clip_ema": dict(optimizer="adamw", lr=1e-3, grad_clip_norm=1.0,
                           ema_decay=0.99),
}


def _batches(n_steps=3, batch=8):
    images, labels = synthetic_cifar10(n_steps * batch, 10, seed=4)
    out = []
    for i in range(n_steps):
        sl = slice(i * batch, (i + 1) * batch)
        mask = np.ones(batch, bool)
        if i == n_steps - 1:
            mask[batch // 2 + 1:] = False   # a short, wrap-padded last batch
        out.append({"image": images[sl], "label": labels[sl], "mask": mask})
    return out


@pytest.mark.parametrize("recipe,jax_kernels,port_kernels", [
    ("reference", False, False), ("reference", False, True),
    ("reference", True, False), ("reference", True, True),
    ("sgd_mom_wd_clip_ema_cosine", True, True),
    ("adamw_clip_ema", True, True),
])
def test_three_steps_match_jax(recipe, jax_kernels, port_kernels):
    kw = RECIPES[recipe]
    n_chans1, n_blocks = 8, 2
    flax_model = FlaxNetResDeep(n_chans1=n_chans1, n_blocks=n_blocks)
    jax_tx = jax_make_optimizer(kernels=jax_kernels, **kw)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_train_step(flax_model, jax_tx, mesh, donate=False)

    tx = make_optimizer(kernels=port_kernels, **kw)
    state = create_train_state(
        NetResDeep(n_chans1=n_chans1, n_blocks=n_blocks), tx, torch.device("cpu"))
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    step = make_train_step(tx)

    for batch in _batches():
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, torch.device("cpu")))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=1e-5)
        assert float(metrics["accuracy"]) == pytest.approx(
            float(j_metrics["accuracy"]))
    assert int(state.step) == int(j_state.step) == 3
    want = convert_tree(jax.device_get(j_state.params))
    want.update(convert_tree(jax.device_get(j_state.batch_stats)))
    got = state.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
