"""The in-step data path (``tpu_ddp_torch/data/augment.py`` and the
``augment``/``mixup_alpha`` options of ``train/steps.py::make_train_step``)
against the JAX package's ``tpu_ddp/data/augment.py`` and its train step.

* ``crop_flip`` with the offsets and flips JAX draws from a key equals JAX's
  ``random_crop_flip`` of that key, bit for bit (both take NHWC images).
* ``mix`` with JAX's ``perm`` and ``lam`` equals JAX's ``mixup`` within
  ``atol=1e-6``; a row whose partner is masked mixes with itself, so a
  masked row never leaks into a valid one.
* The port's own draws (a counter hash keyed on seed, step and rank; they
  cannot be JAX's threefry bits): crop offsets uniform over 0..8 (chi-square
  p > 1e-3 over 20,000 draws), flips at 0.5 within 4 sigma, lambda's mean
  and variance within 4 sigma of Beta(alpha, alpha)'s at alpha 0.2 and 1.0,
  the same for the same (seed, step, rank) and different across ranks,
  steps and seeds, the streams uncorrelated, and the draws of K steps at
  once those of K single steps.
* The train step with ``augment=True, mixup_alpha=0.2`` against the JAX
  step with the JAX step's own draws injected into the port's: losses
  ``rtol=1e-5``, params and BatchNorm buffers ``atol=2e-6``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from tpu_ddp.data.augment import mixup as jax_mixup
from tpu_ddp.data.augment import random_crop_flip
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.data import augment
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

N_DRAWS = 20_000


def _images(b=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def jax_crop_flip_draws(key, b, pad=4):
    """The offsets and flips ``random_crop_flip`` draws from ``key``."""
    key_crop, key_flip = jax.random.split(key)
    offsets = jax.random.randint(key_crop, (b, 2), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(key_flip, 0.5, (b,))
    return np.asarray(offsets), np.asarray(flip)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_crop_flip_matches_jax_bitwise(seed):
    img = _images(seed=seed)
    key = jax.random.key(seed)
    want = np.asarray(random_crop_flip(key, jnp.asarray(img)))
    offsets, flip = jax_crop_flip_draws(key, len(img))
    got = augment.crop_flip(torch.from_numpy(img), torch.from_numpy(offsets).long(),
                            torch.from_numpy(flip)).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("masked", [False, True])
def test_mix_matches_jax_mixup(masked):
    img = _images(seed=3)
    valid = np.ones(len(img), bool)
    if masked:
        valid[11:] = False
    key = jax.random.key(5)
    want, perm, lam = jax_mixup(key, jnp.asarray(img), alpha=0.2,
                                valid=jnp.asarray(valid) if masked else None)
    got = augment.mix(torch.from_numpy(img), torch.from_numpy(np.asarray(perm)).long(),
                      torch.tensor(float(lam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_masked_rows_never_leak():
    img = _images(b=32, seed=4)
    valid = np.ones(32, bool)
    valid[20:] = False
    img[~valid] = np.nan                       # a leak would carry the NaN
    images, mask = torch.from_numpy(img), torch.from_numpy(valid)
    for step in range(50):
        perm, lam = augment.mixup_draws(0, torch.tensor(step), 0, 32, alpha=1.0, valid=mask)
        assert bool(mask[perm][mask].all())
        assert torch.isfinite(augment.mix(images, perm, lam)[mask]).all()
        keep = ~mask[torch.argsort(augment._bits(0, torch.tensor(step), 0, "mix_perm", 32),
                                   stable=True)]
        assert torch.equal(perm[keep], torch.arange(32)[keep])


def test_crop_offsets_uniform_and_flip_rate():
    offsets, flip = augment.crop_flip_draws(0, torch.tensor(3), 0, N_DRAWS)
    assert offsets.shape == (N_DRAWS, 2) and flip.shape == (N_DRAWS,)
    for axis in range(2):
        counts = np.bincount(offsets[:, axis].numpy(), minlength=9)
        assert len(counts) == 9
        assert sps.chisquare(counts).pvalue > 1e-3, counts
    rate, sigma = float(flip.float().mean()), (0.25 / N_DRAWS) ** 0.5
    assert abs(rate - 0.5) < 4 * sigma, rate


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_lambda_moments_match_beta(alpha):
    _, lam = augment.mixup_draws(0, torch.arange(N_DRAWS), 0, 4, alpha=alpha)
    lam = lam.double().numpy()
    assert lam.shape == (N_DRAWS,) and ((lam >= 0) & (lam <= 1)).all()
    mean, var = 0.5, 1.0 / (4.0 * (2.0 * alpha + 1.0))
    # the sample variance's standard error from Beta(a, a)'s fourth central moment
    m4 = sps.beta(alpha, alpha).expect(lambda x: (x - 0.5) ** 4)
    assert abs(lam.mean() - mean) < 4 * (var / N_DRAWS) ** 0.5, lam.mean()
    assert abs(lam.var() - var) < 4 * ((m4 - var ** 2) / N_DRAWS) ** 0.5, lam.var()


def _draws(seed, step, rank, b=64):
    offsets, flip = augment.crop_flip_draws(seed, torch.tensor(step), rank, b)
    perm, lam = augment.mixup_draws(seed, torch.tensor(step), rank, b, alpha=0.2)
    return offsets, flip, perm, lam


def test_draws_keyed_on_seed_step_and_rank():
    a, b = _draws(0, 10, 1), _draws(0, 10, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (_draws(0, 10, 0), _draws(0, 11, 1), _draws(1, 10, 1)):
        assert not torch.equal(a[0], other[0]) and not torch.equal(a[1], other[1])
        assert not torch.equal(a[2], other[2]) and not torch.equal(a[3], other[3])
    big = torch.tensor(2 ** 33 + 10)                 # the step's high half counts
    assert not torch.equal(augment.crop_flip_draws(0, big, 1, 64)[0], a[0])


def test_streams_are_uncorrelated():
    step = torch.tensor(4)
    streams = [augment._bits(0, step, 0, s, N_DRAWS).double().numpy()
               for s in augment.STREAMS]
    corr = np.corrcoef(np.stack(streams))
    off_diag = corr[~np.eye(len(streams), dtype=bool)]
    assert np.abs(off_diag).max() < 4 / N_DRAWS ** 0.5, corr


def test_fused_draws_equal_single_steps():
    steps = torch.arange(5, 9)
    offsets, flip = augment.crop_flip_draws(3, steps, 2, 16)
    perm, lam = augment.mixup_draws(3, steps, 2, 16, alpha=0.2)
    for k, step in enumerate(range(5, 9)):
        o, f = augment.crop_flip_draws(3, torch.tensor(step), 2, 16)
        p, lm = augment.mixup_draws(3, torch.tensor(step), 2, 16, alpha=0.2)
        assert torch.equal(offsets[k], o) and torch.equal(flip[k], f)
        assert torch.equal(perm[k], p) and torch.equal(lam[k], lm)


# -- the train step -------------------------------------------------------

MODEL = dict(n_chans1=8, n_blocks=2)
OPT = dict(lr=1e-2, momentum=0.9)
SEED = 3


def _batches(n_steps=3, batch=8):
    images, labels = synthetic_cifar10(n_steps * batch, 10, seed=4)
    out = []
    for i in range(n_steps):
        sl = slice(i * batch, (i + 1) * batch)
        mask = np.ones(batch, bool)
        if i == n_steps - 1:
            mask[batch // 2 + 1:] = False   # a short, wrap-padded last batch
        out.append({"image": np.array(images[sl]), "label": labels[sl], "mask": mask})
    return out


def jax_step_draws(seed, step, b, alpha, valid):
    """The draws of the JAX ``_make_shard_step`` (:209-220) at shard 0."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step), 0)
    offsets, flip = jax_crop_flip_draws(key, b)
    key_lam, key_perm = jax.random.split(jax.random.fold_in(key, 1))
    lam = jax.random.beta(key_lam, alpha, alpha)
    perm = jax.random.permutation(key_perm, b)
    perm = jnp.where(jnp.asarray(valid)[perm], perm, jnp.arange(b))
    return offsets, flip, np.asarray(perm), np.float32(lam)


def test_augmented_step_matches_jax_with_its_draws(monkeypatch):
    alpha = 0.2
    flax_model = FlaxNetResDeep(**MODEL)
    jax_tx = jax_make_optimizer(**OPT)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_train_step(flax_model, jax_tx, mesh, donate=False, augment=True,
                                 augment_seed=SEED, mixup_alpha=alpha)
    tx = make_optimizer(**OPT)
    state = create_train_state(NetResDeep(**MODEL), tx, torch.device("cpu"))
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    step = make_train_step(tx, augment=True, augment_seed=SEED, mixup_alpha=alpha)

    batches = _batches()
    injected = {}

    def crop_flip_draws(seed, step_t, rank, b):
        assert (seed, rank) == (SEED, 0)
        o, f, _, _ = injected[int(step_t)]
        return torch.from_numpy(o).long(), torch.from_numpy(f)

    def mixup_draws(seed, step_t, rank, b, *, alpha, valid=None):
        _, _, p, lam = injected[int(step_t)]
        return torch.from_numpy(p).long(), torch.tensor(lam)

    monkeypatch.setattr(augment, "crop_flip_draws", crop_flip_draws)
    monkeypatch.setattr(augment, "mixup_draws", mixup_draws)
    for i, batch in enumerate(batches):
        injected[i] = jax_step_draws(SEED, i, len(batch["image"]), alpha, batch["mask"])
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, torch.device("cpu")))
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
        assert float(metrics["accuracy"]) == pytest.approx(float(j_metrics["accuracy"]))
    want = convert_tree(jax.device_get(j_state.params))
    want.update(convert_tree(jax.device_get(j_state.batch_stats)))
    got = state.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=2e-6,
                                   err_msg=name)


def test_augmented_step_draws_on_the_device_step():
    """Without injection: the step's draws follow ``state.step``, so two
    runs from the same state with the same batches end bitwise equal, and a
    run from another step number differs."""
    def run(start):
        tx = make_optimizer(**OPT)
        state = create_train_state(NetResDeep(generator=torch.Generator().manual_seed(0),
                                              **MODEL), tx, torch.device("cpu"))
        state.step.fill_(start)
        step = make_train_step(tx, augment=True, augment_seed=SEED, mixup_alpha=0.2)
        losses = [float(step(state, batch_to_device(b, torch.device("cpu")))[1]["loss"])
                  for b in _batches()]
        return losses, state.model.state_dict()

    a, b, c = run(0), run(0), run(100)
    assert a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert a[0] != c[0]
    assert all(np.isfinite(a[0]))
