"""The flight recorder in the port's one-rank steps
(``train/steps.py::make_train_step(health=)``,
``train/lm_steps.py::make_lm_train_step(health=)``) against the JAX
package's steps with ``health=`` on a 1-device CPU mesh, from the same
weights (carried across by ``checkpoint/convert.py::from_jax``) on the same
numpy batches.

* Stats: every norm of ``metrics["health"]`` within ``rtol=1e-5`` of the
  JAX step's, sentinels equal, and the per-layer norms too, JAX's key paths
  (``conv1/kernel``) mapped onto the port's names (``conv1.weight``) by
  ``convert.py``'s rule (norms do not change under its transposes).
* Health on, with and without the guard, is bitwise health off: params,
  optimizer state and BatchNorm buffers, with K1 (``kernels=True``, its
  plain version on the CPU) and without.
* ``skip_step`` on a NaN batch, under SGD with momentum and a cosine
  schedule and under AdamW with clipping, EMA and a cosine schedule: the
  params, every optimizer slot, ``count``, ``sched_count`` and the
  BatchNorm buffers bitwise as they were, ``step`` advanced, the next step
  finite, and the state after it within the DP step's tolerance
  (``atol=1e-5``, ``tests/test_torch_train_step.py``) of the JAX step's
  with ``skip_nonfinite``.
* No host read in a step with the recorder and the guard: turning a tensor
  into a Python value raises inside it.
* The LM step (SGD; AdamW's key third of ``qkv.bias`` moves by rounding
  noise, ``tests/test_torch_lm_steps.py``) the same way, stats and bits.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.health import HealthConfig as JaxHealthConfig
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import _leaf, convert_tree, from_jax, load_into
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.health.stats import HealthConfig
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import COUNTS, SLOTS, create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

CPU = torch.device("cpu")
MODEL = dict(n_chans1=8, n_blocks=2)
RECIPES = {
    "sgd_momentum_cosine": dict(lr=1e-2, momentum=0.9, schedule="cosine", total_steps=6,
                                warmup_steps=1),
    "adamw_clip_ema_cosine": dict(optimizer="adamw", lr=1e-3, grad_clip_norm=1.0,
                                  ema_decay=0.99, schedule="cosine", total_steps=6),
}
NORMS = ("loss", "grad_norm", "param_norm", "update_norm", "update_ratio")
FLAGS = ("loss_finite", "grads_finite", "updates_finite", "all_finite")


def _batches(nan_step=None, n_steps=3, batch=8):
    images, labels = synthetic_cifar10(n_steps * batch, 10, seed=4)
    images = np.array(images)
    out = []
    for i in range(n_steps):
        sl = slice(i * batch, (i + 1) * batch)
        mask = np.ones(batch, bool)
        if i == n_steps - 1:
            mask[batch // 2 + 1:] = False   # a short, wrap-padded last batch
        img = images[sl].copy()
        if i == nan_step:
            img[:3] = np.nan
        out.append({"image": img, "label": labels[sl], "mask": mask})
    return out


def _port_name(jax_path: str) -> str:
    return _leaf(jax_path.replace("/", "."), np.zeros(()))[0]


def assert_stats_match(got, want):
    """The port's ``metrics["health"]`` against the JAX step's (module
    docstring)."""
    for k in NORMS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k in FLAGS:
        assert bool(got[k]) == bool(want[k]), k
    if "per_layer" in want:
        for group, layers in want["per_layer"].items():
            mapped = {_port_name(k): float(v) for k, v in layers.items()}
            assert set(mapped) == set(got["per_layer"][group])
            for name, w in mapped.items():
                np.testing.assert_allclose(float(got["per_layer"][group][name]), w,
                                           rtol=1e-5, err_msg=f"{group}/{name}")


def _jax_setup(recipe, health):
    flax_model = FlaxNetResDeep(**MODEL)
    jax_tx = jax_make_optimizer(kernels=False, **RECIPES[recipe])
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    return j_state, jax_make_train_step(flax_model, jax_tx, mesh, donate=False,
                                        health=health)


def _port_state(recipe, kernels, j_state):
    tx = make_optimizer(kernels=kernels, **RECIPES[recipe])
    state = create_train_state(NetResDeep(**MODEL), tx, CPU)
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    return tx, state


def snapshot(state):
    """Every tensor of the state the step moves, cloned: the model (params
    and BatchNorm buffers), each optimizer slot and count, the residual."""
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for slot in SLOTS:
        for n, t in (getattr(state.opt_state, slot) or {}).items():
            out[f"opt/{slot}/{n}"] = t.clone()
    for c in COUNTS:
        if getattr(state.opt_state, c) is not None:
            out[f"opt/{c}"] = getattr(state.opt_state, c).clone()
    for n, t in (state.grad_residual or {}).items():
        out[f"residual/{n}"] = t.clone()
    return out


def assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("kernels", [False, True])
def test_stats_match_jax_and_health_is_bitwise_off(recipe, kernels):
    j_state, j_step = _jax_setup(recipe, JaxHealthConfig(per_layer=True))
    runs = {}
    for name, health in (("off", None), ("on", HealthConfig(per_layer=True)),
                         ("guard", HealthConfig(per_layer=True, skip_nonfinite=True))):
        tx, state = _port_state(recipe, kernels, j_state)
        step = make_train_step(tx, health=health)
        stats = []
        for batch in _batches():
            state, metrics = step(state, batch_to_device(batch, CPU))
            assert ("health" in metrics) == (health is not None)
            stats.append(metrics.get("health"))
        runs[name] = (snapshot(state), stats)
    assert_bitwise(runs["off"][0], runs["on"][0])
    assert_bitwise(runs["off"][0], runs["guard"][0])
    s = j_state
    for batch, got, guarded in zip(_batches(), runs["on"][1], runs["guard"][1]):
        s, m = j_step(s, batch)
        assert_stats_match(got, jax.device_get(m["health"]))
        for k in NORMS:
            assert torch.equal(got[k], guarded[k]), k


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("kernels", [False, True])
def test_skip_step_leaves_state_bitwise_and_matches_jax(recipe, kernels):
    j_state, j_step = _jax_setup(recipe, JaxHealthConfig(skip_nonfinite=True))
    tx, state = _port_state(recipe, kernels, j_state)
    step = make_train_step(tx, health=HealthConfig(skip_nonfinite=True))
    batches = _batches(nan_step=1)
    state, m0 = step(state, batch_to_device(batches[0], CPU))
    assert bool(m0["health"]["all_finite"])
    before = snapshot(state)
    state, m1 = step(state, batch_to_device(batches[1], CPU))
    h = m1["health"]
    assert not bool(h["all_finite"]) and not bool(h["loss_finite"])
    assert not bool(h["grads_finite"])
    assert int(state.step) == 2
    assert_bitwise(before, snapshot(state))
    state, m2 = step(state, batch_to_device(batches[2], CPU))
    assert bool(m2["health"]["all_finite"]) and int(state.step) == 3
    assert all(bool(torch.isfinite(p).all()) for p in state.params().values())

    s = j_state
    for batch, got in zip(batches, (m0, m1, m2)):
        s, m = j_step(s, batch)
        want = jax.device_get(m["health"])
        for k in FLAGS:
            assert bool(got["health"][k]) == bool(want[k]), k
        if bool(want["all_finite"]):
            assert_stats_match(got["health"], want)
    want = convert_tree(jax.device_get(s.params))
    want.update(convert_tree(jax.device_get(s.batch_stats)))
    got = state.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("kernels", [False, True])
def test_step_reads_no_device_value_on_the_host(kernels, monkeypatch):
    """Nothing in a step with the recorder and the guard turns a tensor into
    a Python value (on a card each would be a host sync): ``item``,
    ``tolist``, ``bool``, ``float``, ``int`` and ``cpu`` raise inside it."""
    j_state, _ = _jax_setup("adamw_clip_ema_cosine", None)
    tx, state = _port_state("adamw_clip_ema_cosine", kernels, j_state)
    step = make_train_step(tx, health=HealthConfig(per_layer=True, skip_nonfinite=True))
    batches = [batch_to_device(b, CPU) for b in _batches(nan_step=1)]
    state, _ = step(state, batches[0])            # builds K1's batch and the guard's buffers

    def read(*args, **kwargs):
        raise AssertionError("a step read a device value on the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__", "cpu"):
            m.setattr(torch.Tensor, name, read)
        for batch in batches[1:]:
            state, metrics = step(state, batch)
    assert [bool(metrics["health"]["all_finite"])] == [True]


# -- the LM step -----------------------------------------------------------

LM_TINY = dict(vocab_size=17, hidden_dim=32, depth=2, num_heads=2)
LM_T = 32


def test_lm_step_stats_match_jax_and_bits():
    from tpu_ddp.models.lm import CausalTransformerLM as FlaxLM
    from tpu_ddp.parallel import batch_sharding
    from tpu_ddp.parallel.mesh import replicated_sharding
    from tpu_ddp.train.lm_steps import create_lm_train_state as jax_create_state
    from tpu_ddp.train.lm_steps import make_lm_train_step as jax_make_step
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step

    recipe = dict(lr=1e-2, momentum=0.9)
    flax = FlaxLM(**LM_TINY, use_flash=True)
    j_tx = jax_make_optimizer(**recipe)
    init = jax_create_state(flax, j_tx, jax.random.key(0), seq_len=LM_T)
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_step(flax, j_tx, mesh, donate=False,
                           health=JaxHealthConfig(per_layer=True))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 17, (4, LM_T)).astype(np.int32) for _ in range(3)]
    runs = {}
    for name, health in (("off", None), ("on", HealthConfig(per_layer=True)),
                         ("guard", HealthConfig(per_layer=True, skip_nonfinite=True))):
        tx = make_optimizer(kernels=True, **recipe)
        state = create_lm_train_state(
            CausalTransformerLM(**LM_TINY, seq_len=LM_T, use_flash=True), tx, CPU)
        load_into(state, from_jax(*jax.device_get((init.params, {}, init.opt_state))))
        step = make_lm_train_step(tx, health=health)
        stats = []
        for toks in batches:
            state, metrics = step(state, {"tokens": torch.from_numpy(toks).long()})
            stats.append(metrics.get("health"))
        runs[name] = (snapshot(state), stats)
    assert_bitwise(runs["off"][0], runs["on"][0])
    assert_bitwise(runs["off"][0], runs["guard"][0])
    s = jax.device_put(init, replicated_sharding(mesh))
    for toks, got in zip(batches, runs["on"][1]):
        s, m = j_step(s, jax.device_put({"tokens": toks}, batch_sharding(mesh)))
        assert_stats_match(got, jax.device_get(m["health"]))
