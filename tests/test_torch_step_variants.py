"""The step variants on one rank against the JAX package: the fused K-step
call (``train/steps.py::scan``, ``--steps-per-call``) and the accumulating
step (``make_grad_accum_train_step``, ``--grad-accum-steps``), each against
the JAX builder of that name on a 1-device CPU mesh, from the same weights
(carried across by ``checkpoint/convert.py::from_jax``) on the same numpy
batches, the last rows masked.

* Scan, K=4, NetResDeep (6 channels, 2 tied blocks), SGD with momentum: the
  (K,) losses ``rtol=1e-5``, params and BatchNorm buffers ``atol=2e-6,
  rtol=1e-5``. The port's scan against 4 single port steps: bitwise (losses,
  model, optimizer state), with K1 and without, and with augment, mixup and
  the flight recorder's skip guard on.
* Accumulation, K=4, against the JAX accumulating step, for NetResDeep
  (BatchNorm's running stats chain through the microbatches) and a small
  ViT (patch 8, hidden 32, depth 2, 2 heads): the same bounds. The ViT's
  accumulated step equals its full-batch step within the JAX test's bounds
  (``tests/test_train.py::test_grad_accum_matches_full_batch``: loss
  ``rtol=1e-5``, params ``atol=2e-6, rtol=1e-5``; no BatchNorm, equal
  microbatch counts).
* ``health`` on in both: every norm within ``rtol=1e-5`` of the JAX step's
  stats (the scan's stacked (K,) stats step by step), sentinels equal,
  per-layer norms too.
* The guards raise where JAX raises: ``accum_steps < 1``, rows not
  divisible by K, accumulation with augment or mixup, fused steps with
  accumulation; ``steps_per_call`` is clamped to the epoch's length.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.health import HealthConfig as JaxHealthConfig
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_grad_accum_train_step as jax_make_accum
from tpu_ddp.train.steps import make_scan_train_step as jax_make_scan
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.health.stats import HealthConfig
from tpu_ddp_torch.models import NetResDeep, ViT
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import (
    batch_to_device,
    make_grad_accum_train_step,
    make_scan_train_step,
    make_train_step,
    scan,
)
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer
from test_torch_health_steps import FLAGS, assert_stats_match, snapshot

CPU = torch.device("cpu")
K = 4
NRD = dict(n_chans1=6, n_blocks=2)
VIT = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=2, num_classes=10)
OPT = dict(lr=5e-2, momentum=0.9)
PARAMS_TOL = dict(atol=2e-6, rtol=1e-5)


def _batches(n, rows, seed=4):
    images, labels = synthetic_cifar10(n * rows, 10, seed=seed)
    out = []
    for i in range(n):
        sl = slice(i * rows, (i + 1) * rows)
        mask = np.ones(rows, bool)
        if i == n - 1:
            mask[rows // 2 + 1:] = False       # a short, wrap-padded last batch
        out.append({"image": np.array(images[sl]), "label": labels[sl], "mask": mask})
    return out


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _setup(model_name, health=None, kernels=False):
    """(JAX model, JAX state, port tx, port state) from the same weights."""
    flax_model = FlaxNetResDeep(**NRD) if model_name == "netresdeep" else FlaxViT(**VIT)
    jax_tx = jax_make_optimizer(**OPT)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    tx = make_optimizer(kernels=kernels, **OPT)
    model = NetResDeep(**NRD) if model_name == "netresdeep" else ViT(**VIT)
    state = create_train_state(model, tx, CPU)
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    return flax_model, jax_tx, j_state, tx, state


def _mesh():
    return create_mesh(MeshSpec(data=1), jax.devices()[:1])


def _assert_model_close(state, j_state, tol=PARAMS_TOL):
    want = convert_tree(jax.device_get(j_state.params))
    want.update(convert_tree(jax.device_get(j_state.batch_stats)))
    got = state.model.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name, **tol)


def _unstack(tree, j):
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


@pytest.mark.parametrize("health", [False, True])
def test_scan_matches_jax_scan(health):
    h = JaxHealthConfig(per_layer=True) if health else None
    flax_model, jax_tx, j_state, tx, state = _setup("netresdeep")
    j_scan = jax_make_scan(flax_model, jax_tx, _mesh(), steps_per_call=K, donate=False,
                           health=h)
    step = make_scan_train_step(tx, steps_per_call=K,
                                health=HealthConfig(per_layer=True) if health else None)
    batches = _stacked(_batches(K, 8))
    j_state, j_metrics = j_scan(j_state, batches)
    state, metrics = step(state, batch_to_device(batches, CPU))
    assert metrics["loss"].shape == (K,) and metrics["accuracy"].shape == (K,)
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(j_metrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].numpy(),
                               np.asarray(j_metrics["accuracy"]), rtol=1e-6)
    assert int(state.step) == int(j_state.step) == K
    _assert_model_close(state, j_state)
    if health:
        want = jax.device_get(j_metrics["health"])
        for j in range(K):
            assert_stats_match(_unstack(metrics["health"], j), _unstack(want, j))


def _all_bits(state):
    return {k: v.clone() for k, v in snapshot(state).items()}


@pytest.mark.parametrize("variant", ["plain", "kernels", "augment_mixup_health"])
def test_scan_bitwise_single_steps(variant):
    kernels = variant != "plain"
    kw = {}
    if variant == "augment_mixup_health":
        kw = dict(augment=True, augment_seed=2, mixup_alpha=0.2,
                  health=HealthConfig(per_layer=True, skip_nonfinite=True))
    runs = []
    for fused in (True, False):
        _, _, _, tx, state = _setup("netresdeep", kernels=kernels)
        single = make_train_step(tx, **kw)
        batches = _batches(2 * K, 8)
        losses, stats = [], []
        if fused:
            multi = scan(single, K)
            for g in range(2):
                state, m = multi(state, batch_to_device(_stacked(batches[g * K:(g + 1) * K]),
                                                        CPU))
                losses += m["loss"].tolist()
                if "health" in m:
                    stats += [_unstack(m["health"], j) for j in range(K)]
        else:
            for b in batches:
                state, m = single(state, batch_to_device(b, CPU))
                losses.append(float(m["loss"]))
                if "health" in m:
                    stats.append(jax.tree.map(np.asarray, m["health"]))
        runs.append((losses, _all_bits(state), stats))
    (la, sa, ha), (lb, sb, hb) = runs
    assert la == lb
    assert set(sa) == set(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for x, y in zip(ha, hb):
        flat_x, flat_y = jax.tree.leaves(x), jax.tree.leaves(y)
        assert all(np.array_equal(a, b) for a, b in zip(flat_x, flat_y))


@pytest.mark.parametrize("model_name", ["netresdeep", "vit"])
@pytest.mark.parametrize("health", [False, True])
def test_grad_accum_matches_jax(model_name, health):
    h = JaxHealthConfig(per_layer=True) if health else None
    flax_model, jax_tx, j_state, tx, state = _setup(model_name)
    j_step = jax_make_accum(flax_model, jax_tx, _mesh(), accum_steps=K, donate=False,
                            health=h)
    step = make_grad_accum_train_step(
        tx, accum_steps=K, health=HealthConfig(per_layer=True) if health else None)
    for batch in _batches(2, 16):
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
        assert float(metrics["accuracy"]) == pytest.approx(float(j_metrics["accuracy"]))
        if health:
            assert_stats_match(metrics["health"], jax.device_get(j_metrics["health"]))
    assert int(state.step) == int(j_state.step) == 2
    _assert_model_close(state, j_state)


def test_vit_grad_accum_equals_full_batch():
    images, labels = synthetic_cifar10(32, 10, seed=11)
    batch = batch_to_device({"image": np.array(images), "label": labels,
                             "mask": np.ones(32, bool)}, CPU)
    out = []
    for accum in (None, K):
        tx = make_optimizer(**OPT)
        state = create_train_state(ViT(**VIT), tx, CPU)
        step = (make_train_step(tx) if accum is None
                else make_grad_accum_train_step(tx, accum_steps=accum))
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), state.model.state_dict()))
    (l_full, p_full), (l_acc, p_acc) = out
    np.testing.assert_allclose(l_full, l_acc, rtol=1e-5)
    for name in p_full:
        np.testing.assert_allclose(p_acc[name].numpy(), p_full[name].numpy(), err_msg=name,
                                   **PARAMS_TOL)


def test_grad_accum_one_microbatch_is_the_single_step():
    runs = []
    for accum in (None, 1):
        _, _, _, tx, state = _setup("netresdeep", kernels=True)
        step = (make_train_step(tx) if accum is None
                else make_grad_accum_train_step(tx, accum_steps=accum))
        for b in _batches(2, 8):
            state, _ = step(state, batch_to_device(b, CPU))
        runs.append(_all_bits(state))
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


def test_jax_health_flags_agree_under_scan():
    """The sentinels of a scan whose second step is all NaN, step by step
    (the JAX scan's stacked stats against the port's)."""
    h = JaxHealthConfig(skip_nonfinite=True)
    flax_model, jax_tx, j_state, tx, state = _setup("netresdeep")
    j_scan = jax_make_scan(flax_model, jax_tx, _mesh(), steps_per_call=K, donate=False,
                           health=h)
    step = make_scan_train_step(tx, steps_per_call=K,
                                health=HealthConfig(skip_nonfinite=True))
    batches = _batches(K, 8)
    batches[1]["image"][:] = np.nan
    stacked = _stacked(batches)
    _, j_metrics = j_scan(j_state, stacked)
    state, metrics = step(state, batch_to_device(stacked, CPU))
    want = jax.device_get(j_metrics["health"])
    for k in FLAGS:
        assert metrics["health"][k].tolist() == np.asarray(want[k]).tolist(), k
    assert metrics["health"]["all_finite"].tolist() == [True, False, True, True]


def test_guards_raise_where_jax_raises():
    tx = make_optimizer(**OPT)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        make_grad_accum_train_step(tx, accum_steps=0)
    state = create_train_state(NetResDeep(**NRD), tx, CPU)
    step = make_grad_accum_train_step(tx, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(state, batch_to_device(_batches(1, 8)[0], CPU))
    multi = make_scan_train_step(tx, steps_per_call=K)
    with pytest.raises(ValueError, match="stacked batches of 2 steps"):
        multi(state, batch_to_device(_stacked(_batches(2, 8)), CPU))
    data = synthetic_cifar10(64, 10, seed=0)
    base = dict(device="cpu", n_chans1=4, n_blocks=1, per_shard_batch=8, epochs=1)
    for extra in (dict(grad_accum_steps=2, augment=True),
                  dict(grad_accum_steps=2, mixup_alpha=0.2)):
        with pytest.raises(ValueError, match="not yet supported with --grad-accum-steps"):
            Trainer(TrainConfig(**base, **extra), train_data=data)
    with pytest.raises(ValueError, match="opposite trades"):
        Trainer(TrainConfig(**base, steps_per_call=2, grad_accum_steps=2), train_data=data)
    trainer = Trainer(TrainConfig(**base, steps_per_call=50), train_data=data)
    assert trainer.steps_per_call == trainer.train_loader.steps_per_epoch == 8
    assert trainer.multi_step is not None
    assert Trainer(TrainConfig(**base), train_data=data).multi_step is None
