"""The MoE ViT in the port (``models/moe.py``) and the auxiliary loss in its
data-parallel steps (``train/steps.py``) against the JAX package
(``tpu_ddp/models/moe.py``, ``tpu_ddp/train/steps.py``), from the same
weights (``checkpoint/convert.py::from_jax``) on the same numpy inputs.

* ``MoEMlp`` at top-1 and top-2 against the Flax layer within ``rtol=2e-5,
  atol=2e-5`` (``tests/test_expert_parallel.py`` :60), with room to spare
  and with a capacity small enough that choices are dropped (the test
  checks that some are), and with a zero router, whose softmax ties every
  expert: the choice must be the lower index, as ``jax.lax.top_k``'s; the
  sown load-balance loss against the Flax ``aux_loss`` collection.
* ``MoEViT`` (patch 8, hidden 32, depth 2, 2 heads, 4 experts: the JAX
  tests' model) forward, its params' names and shapes against the Flax
  tree's.
* The DP step (``make_train_step``), the fused call (``scan``) and the
  accumulating step against the JAX ``make_train_step``,
  ``make_scan_train_step`` and ``make_grad_accum_train_step`` on a 1-device
  mesh: two steps (the first batch partly masked), SGD with momentum and
  weight decay through K1 (``kernels=True``: its plain version on the
  CPU), losses within 1e-5, ``aux_loss`` within 1e-5 where JAX reports it
  (its accumulating step does not), params within ``atol=1e-5,
  rtol=1e-4``. (Under AdamW a weight whose gradient is rounding noise
  moves by up to lr either way, ``tests/test_torch_vit.py``.)
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp.models.moe import MoEMlp as FlaxMoEMlp
from tpu_ddp.models.moe import MoEViT as FlaxMoEViT
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.models.moe import MoEMlp, MoEViT, sown_aux_losses

VIT = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=2, num_experts=4)
RECIPE = dict(lr=0.05, momentum=0.9, weight_decay=1e-3)


def _layer_case(top_k, capacity_factor, zero_router=False, seed=0):
    layer = FlaxMoEMlp(num_experts=4, top_k=top_k, capacity_factor=capacity_factor,
                       mlp_ratio=2)
    x = jax.random.normal(jax.random.key(seed), (2, 16, 8), jnp.float32)
    params = layer.init(jax.random.key(seed + 1), x)["params"]
    if zero_router:
        params = dict(params, router=jax.tree.map(jnp.zeros_like, params["router"]))
    y, mutated = layer.apply({"params": params}, x, mutable=["aux_loss"])
    (aux,) = mutated["aux_loss"]["load_balance"]
    port = MoEMlp(8, 4, torch.Generator().manual_seed(0), top_k=top_k,
                  capacity_factor=capacity_factor, mlp_ratio=2)
    port.load_state_dict(convert_tree(params))
    got = port(torch.tensor(np.asarray(x)))
    return np.asarray(y), float(aux), got, port


@pytest.mark.parametrize("top_k,capacity_factor,zero_router", [
    (1, 1.25, False), (2, 1.25, False), (1, 0.5, False), (2, 0.25, False),
    (1, 1.25, True), (2, 1.25, True)],
    ids=["top1", "top2", "top1_drops", "top2_drops", "top1_ties", "top2_ties"])
def test_moe_mlp_matches_flax(top_k, capacity_factor, zero_router):
    want, aux, got, port = _layer_case(top_k, capacity_factor, zero_router)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(port.aux_loss.detach()), aux, rtol=1e-6)
    assert float(port.aux_loss.detach()) >= 1.0 - 1e-5
    rows_zero = int((got.detach().abs().amax(-1) == 0).sum())
    if capacity_factor < 1.0:
        assert rows_zero > 0            # some tokens lost every choice
    if zero_router:                     # ties: experts 0 (and 1) take every token
        from tpu_ddp_torch.models.moe import top_k_stable

        probs = torch.full((2, 16, 4), 0.25)
        assert top_k_stable(probs, top_k)[1].unique().tolist() == list(range(top_k))


def test_sown_aux_losses_cleared_and_keyed():
    model = MoEViT(**VIT, generator=torch.Generator().manual_seed(0))
    model(torch.zeros(2, 32, 32, 3))
    sown = sown_aux_losses(model)
    assert list(sown) == ["block_1/moe"]
    assert sown_aux_losses(model) == {}


def _flax_vit():
    return FlaxMoEViT(**VIT, num_classes=10)


def test_moe_vit_forward_matches_flax():
    model = _flax_vit()
    x = np.asarray(jax.random.normal(jax.random.key(3), (4, 32, 32, 3)), np.float32)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    want, mutated = model.apply({"params": variables["params"]}, x, train=False,
                                mutable=["aux_loss"])
    port = MoEViT(**VIT)
    converted = from_jax(variables["params"], {})["model"]
    assert {k: tuple(v.shape) for k, v in converted.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(converted)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    aux = float(mutated["aux_loss"]["block_1"]["moe"]["load_balance"][0])
    np.testing.assert_allclose(float(sown_aux_losses(port)["block_1/moe"].detach()), aux,
                               rtol=1e-6)


def _batches():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(16, 10, seed=5)
    masks = [np.r_[np.ones(6), np.zeros(2)].astype(bool), np.ones(8, bool)]
    return [{"image": np.asarray(images[i * 8:(i + 1) * 8], np.float32),
             "label": np.asarray(labels[i * 8:(i + 1) * 8]), "mask": masks[i]}
            for i in range(2)]


def _jax_run(kind):
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.train import create_train_state, make_optimizer
    from tpu_ddp.train import steps as jsteps

    model = _flax_vit()
    tx = make_optimizer(kernels=False, **RECIPE)
    state = create_train_state(model, tx, jax.random.key(0))
    init = jax.device_get((state.params, state.opt_state))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    batches = _batches()
    out = []
    if kind == "scan":
        step = jsteps.make_scan_train_step(model, tx, mesh, steps_per_call=2, donate=False)
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        state, m = step(state, stacked)
        out = [{k: float(np.asarray(v)[i]) for k, v in m.items()} for i in range(2)]
    else:
        if kind == "accum":
            step = jsteps.make_grad_accum_train_step(model, tx, mesh, accum_steps=2,
                                                     donate=False)
        else:
            step = jsteps.make_train_step(model, tx, mesh, donate=False)
        for b in batches:
            state, m = step(state, b)
            out.append({k: float(v) for k, v in m.items()})
    return init, out, convert_tree(jax.device_get(state.params))


@pytest.mark.parametrize("kind", ["step", "scan", "accum"])
def test_dp_steps_carry_aux_loss(kind):
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train import steps

    init, want, final = _jax_run(kind)
    model = MoEViT(**VIT)
    tx = make_optimizer(kernels=True, **RECIPE)
    state = create_train_state(model, tx, torch.device("cpu"))
    load_into(state, from_jax(init[0], {}, init[1]))
    if kind == "accum":
        step = steps.make_grad_accum_train_step(tx, accum_steps=2)
    else:
        step = steps.make_train_step(tx)
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in _batches()]
    got = []
    if kind == "scan":
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        _, m = steps.scan(step, 2)(state, stacked)
        got = [{k: float(v[i]) for k, v in m.items()} for i in range(2)]
    else:
        for b in batches:
            _, m = step(state, b)
            got.append({k: float(v) for k, v in m.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["accuracy"], w["accuracy"], rtol=0, atol=1e-6)
        assert g["aux_loss"] >= 1.0 - 1e-5
        if "aux_loss" in w:
            np.testing.assert_allclose(g["aux_loss"], w["aux_loss"], rtol=0, atol=1e-5)
    params = state.model.state_dict()
    assert set(params) == set(final)
    for name, w in final.items():
        np.testing.assert_allclose(params[name].numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
