"""ZeRO-1 in the port (``tpu_ddp_torch/parallel/zero.py``, and K1's pad
mask in ``ops/fused_update.py``) against the JAX package, on gloo CPU ranks.

The model is NetResDeep with 6 channels, 2 tied blocks and 7 classes; its
7-element head bias pads at every shard count, the head's kernel (224) and
the 32-element bias at N = 3, and every 6-element leaf and the 162-element
conv kernel at N = 4.
The JAX zero1 step itself is not run: under jax 0.9 it fails shard_map's
replication check (``out_specs`` for the params). The port is held instead
to what the JAX package's own zero1 contract (``tests/test_zero1.py``) holds
the JAX zero1 step to, the replicated DP step, and to the JAX pieces that
run outside shard_map (``Zero1Partition``'s layout and ``accounting``,
``_reference_leaf`` with its mask, ``optax.clip_by_global_norm``):

(a) the partition's layout and ``accounting()`` equal JAX
    ``Zero1Partition(tx, params, N)``'s, N in {2, 3, 4};
(b) the masked plain version of K1 equals JAX ``_reference_leaf(...,
    start=, mask_size=)`` for every K1 variant and every rank, within
    ``tests/test_torch_fused_update.py``'s ``rtol=3e-6, atol=1e-7``, and the
    wrapper's CPU path equals it bit for bit; ``valid`` is right for any
    size, N and rank (hypothesis);
(c) the sharded clip against ``optax.clip_by_global_norm`` on the whole
    tree, clipped and not, ``rtol=1e-6, atol=1e-7`` (the JAX test's bound);
(d), (e) three steps at N = 2 and 3, SGD with momentum 0.9, and AdamW with
    decay 0.05 (its mask from the original shapes), clip 1.0, EMA 0.9 and a
    cosine schedule; the plain chain and K1's CPU path: against the JAX
    replicated DP step (losses ``rtol=1e-5``, params and BatchNorm stats
    ``atol=1e-5``), against the port's replicated DP (``atol=1e-5``), the
    de-sharded state against the JAX optax state through ``from_jax``
    (``atol=1e-5``; conv kernels are laid out differently in the two
    frameworks, so states are compared de-sharded), the JAX state sharded
    into the port's layout against the port's shards (``atol=1e-5``) and back
    (exactly), and the ranks' params bit for bit;
(f) zero1 with the int8 ring and error feedback within 0.05 of uncompressed
    zero1 over the three losses, with a non-zero residual;
(g) the trainer through the launcher, ``--zero1 --ema-decay 0.9`` against
    the replicated run: the EMA evaluation's accuracy ``atol=1e-6`` and loss
    ``atol=1e-4`` (JAX ``test_zero1_trainer_ema_eval``'s bounds); and one
    rank, where zero1 has no pad, against the replicated trainer.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_ddp.data.cifar10 import synthetic_cifar10
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.ops.fused_update import _reference_leaf
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding
from tpu_ddp.parallel.zero import Zero1Partition as JaxZero1Partition
from tpu_ddp.train import create_train_state as jax_create_train_state
from tpu_ddp.train import make_optimizer as jax_make_optimizer
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.cli.train import main
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.ops.fused_update import (
    FLAGS,
    MASK,
    VALID,
    LeafBatch,
    LeafConfig,
    shard_valid,
    update_math_masked,
)
from tpu_ddp_torch.parallel.zero import Zero1Partition
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(n_chans1=6, n_blocks=2, num_classes=7)
PER_RANK = 8
N_STEPS = 3
RECIPES = {
    "sgd_mom": dict(lr=1e-2, momentum=0.9),
    "adamw_decay_clip_ema_cosine": dict(
        optimizer="adamw", lr=1e-3, weight_decay=0.05, grad_clip_norm=1.0,
        ema_decay=0.9, schedule="cosine", total_steps=10),
}
SLOTS = ("trace", "mu", "nu", "ema")
COUNTS = ("count", "sched_count")
TOL = dict(rtol=3e-6, atol=1e-7)


def _flax_params():
    return FlaxNetResDeep(**MODEL).init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
        train=False)["params"]


def _port_name(path) -> str:
    """The port's name of a Flax param path (``conv1.kernel`` ->
    ``conv1.weight``)."""
    keys = [getattr(k, "key", k) for k in path]
    tree = node = {}
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.zeros((1, 1, 1, 1) if keys[-1] == "kernel" else (1,))
    (name,) = convert_tree(tree)
    return name


# ---- (a) layout and accounting ----------------------------------------------


@pytest.mark.parametrize("recipe", ["sgd", "sgd_mom", "adamw_decay_clip_ema_cosine"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_partition_layout_and_accounting_match_jax(n, recipe):
    kw = RECIPES.get(recipe, dict(lr=1e-2))
    params = _flax_params()
    jax_tx = jax_make_optimizer(zero1_axis="data", decay_mask=jax.tree.map(
        lambda p: p.ndim >= 2, params), **kw)
    jax_part = JaxZero1Partition(jax_tx, params, n)
    port_params = dict(NetResDeep(**MODEL).named_parameters())
    tx = make_optimizer(zero1_axis="data", decay_mask=decay_mask(port_params), **kw)
    part = Zero1Partition(tx, port_params, n, rank=0)

    jax_slots = {_port_name(path): slot for path, slot in
                 jax.tree_util.tree_flatten_with_path(
                     jax_part.param_slots, is_leaf=lambda x: hasattr(x, "padded"))[0]}
    assert set(jax_slots) == set(part.param_slots)
    for name, want in jax_slots.items():
        got = part.param_slots[name]
        assert (got.size, got.padded) == (want.size, want.padded), name
        assert got.padded % n == 0, name
    assert part.param_slots["fc2.bias"].padded == (8 if n != 3 else 9)
    assert part.accounting() == jax_part.accounting()

    # the chunk-major layout holds each leaf's shard once a row, aligned
    lay = part.layout
    assert [lay.shard[i] for i in range(len(part.names))] == [
        part.shard_size(name) for name in part.names]
    assert all(off % 4 == 0 for off in lay.offsets)
    assert all(a + s <= b for a, s, b in zip(lay.offsets, lay.shard,
                                             lay.offsets[1:] + (lay.width,)))

    # flatten / unflatten round trip; a rank's slices cover the leaf once
    flat = part.flatten(port_params)
    for name, x in part.unflatten(flat).items():
        assert torch.equal(x, port_params[name])
    for name, x in flat.items():
        shards = [Zero1Partition(tx, port_params, n, rank=r).local_shard(
            {name: x})[name] for r in range(n)]
        assert torch.equal(torch.cat(shards), x)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "k1"])
def test_decay_mask_has_one_source_under_zero1(kernels):
    """At weight decay 0 the optimizer may come without a decay mask; the
    partition then sets ``tx.decay_mask`` from the original shapes, which
    the plain chain and K1 both read, and K1's sharded form refuses to clip
    by a norm it was not given (it would be this rank's shards' only)."""
    params = dict(NetResDeep(**MODEL).named_parameters())
    tx = make_optimizer(zero1_axis="data", grad_clip_norm=1.0, kernels=kernels)
    assert tx.decay_mask is None
    part = Zero1Partition(tx, params, 3, rank=2)
    assert tx.decay_mask == decay_mask(params)
    shards = part.local_shard(part.flatten(params))
    assert tx.wd_mask(shards) == decay_mask(params)
    if kernels:
        with pytest.raises(ValueError, match="g_norm"):
            tx.fused.apply_sharded(shards, part.init_opt_state(params),
                                   part.param_shards(params), part)


# ---- (b) the masked plain version of K1 -------------------------------------

K1_VARIANTS = {
    "sgd": dict(kind="sgd", momentum=0.0, wd=0.0, clip=False, ema=0.0),
    "sgd_mom": dict(kind="sgd", momentum=0.9, wd=0.0, clip=False, ema=0.0),
    "sgd_mom_wd_clip_ema": dict(kind="sgd", momentum=0.9, wd=5e-4, clip=True, ema=0.99),
    "adamw": dict(kind="adamw", momentum=0.0, wd=0.0, clip=False, ema=0.0),
    "adamw_wd_clip_ema": dict(kind="adamw", momentum=0.0, wd=0.05, clip=True, ema=0.99),
}
#: leaf sizes: 1 (wholly pad on every rank but 0), a few odd sizes, and
#: NetResDeep's 6-channel conv kernel and head
K1_SIZES = [1, 7, 162, 1003]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("variant", sorted(K1_VARIANTS))
def test_masked_plain_version_matches_jax_reference_leaf(variant, schedule, n):
    v = K1_VARIANTS[variant]
    step_const = (-1e-3 if v["kind"] == "adamw" else -1e-2) \
        if schedule == "constant" else None
    cfg = LeafConfig(kind=v["kind"], momentum=v["momentum"], wd=v["wd"],
                     wd_apply=v["wd"] > 0, has_clip=v["clip"], max_norm=1.0,
                     step_const=step_const, ema_decay=v["ema"], b1=0.9,
                     b2=0.999, eps=1e-8)
    scalars = np.array([2.5, -0.007, 0.271, 0.002997], np.float32)
    rng = np.random.default_rng(n)
    for size in K1_SIZES:
        s = -(-size // n)
        for r in range(n):
            ops = [rng.standard_normal(s).astype(np.float32) for _ in range(5)]
            ops[3] = np.abs(ops[3])
            g, p, m, v_, e = ops
            m = m if cfg.has_m else None
            v_ = v_ if cfg.has_v else None
            e = e if cfg.ema_decay else None
            mask_size = size if s * n != size else None
            want = _reference_leaf(
                *(None if x is None else jnp.asarray(x) for x in (g, p, m, v_, e)),
                kind=cfg.kind, momentum=cfg.momentum, wd=cfg.wd,
                wd_apply=cfg.wd_apply, has_clip=cfg.has_clip,
                max_norm=cfg.max_norm, step_const=step_const,
                ema_decay=cfg.ema_decay, b1=0.9, b2=0.999, eps=1e-8,
                mask_size=mask_size, start=r * s, g_norm=jnp.float32(scalars[0]),
                step=jnp.float32(scalars[1]), bc1=jnp.float32(scalars[2]),
                bc2=jnp.float32(scalars[3]))
            t = lambda x: None if x is None else torch.from_numpy(x.copy())  # noqa: E731
            got = update_math_masked(t(g), t(p), t(m), t(v_), t(e),
                                     torch.from_numpy(scalars), cfg,
                                     start=r * s, mask_size=mask_size)
            for name, a, b in zip(("u", "p", "m", "v", "e"), got, want):
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                               err_msg=f"{name} size {size} rank {r}")
            live = shard_valid(size, r * s, s)
            assert not np.any(got[0].numpy()[live:])            # pad's u is +0
            # the wrapper's CPU path: the same bits, in place
            ops_ = [t(x) for x in (p, m, v_, e)]
            u = torch.empty(s)
            LeafBatch([ops_[0]], [ops_[1]], [ops_[2]], [ops_[3]], cfg,
                      [cfg.wd_apply], us=[u], valid=[live]).run(
                [t(g)], torch.from_numpy(scalars))
            assert torch.equal(u, got[0]) and torch.equal(ops_[0], got[1])
            for a, b in zip(ops_[1:], got[2:]):
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


@settings(max_examples=200, deadline=None)
@given(size=st.integers(1, 20_000), n=st.integers(1, 16), data=st.data())
def test_valid_column_is_right(size, n, data):
    """``valid`` counts the shard's elements with ``start + i < size``; they
    come first; the leaf table carries it and the mask flag exactly when the
    shard has pad; the partition's ``valid()`` agrees."""
    r = data.draw(st.integers(0, n - 1))
    s = -(-size // n)
    live = r * s + np.arange(s) < size
    want = int(live.sum())
    assert shard_valid(size, r * s, s) == want
    assert live[:want].all() and not live[want:].any()
    cfg = LeafConfig(kind="sgd", momentum=0.0, wd=0.0, wd_apply=False,
                     has_clip=False, max_norm=0.0, step_const=-1e-2,
                     ema_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    batch = LeafBatch([torch.zeros(s)], None, None, None, cfg, [False], valid=[want])
    assert batch.table[0, VALID] == want
    assert bool(batch.table[0, FLAGS] & MASK) == (want < s)
    tx = make_optimizer(zero1_axis="data")
    assert Zero1Partition(tx, {"w": torch.empty(size)}, n, rank=r).valid() == [want]


# ---- (c)-(f): the step on ranks ---------------------------------------------


def _batches(n):
    images, labels = synthetic_cifar10(N_STEPS * n * PER_RANK, num_classes=7, seed=5)
    out = []
    for i in range(N_STEPS):
        sl = slice(i * n * PER_RANK, (i + 1) * n * PER_RANK)
        mask = np.ones(n * PER_RANK, bool)
        if i == N_STEPS - 1:
            for r in range(n):                       # rank r keeps 5 + r rows
                mask[r * PER_RANK + 5 + r:(r + 1) * PER_RANK] = False
        out.append({"image": images[sl].astype(np.float32), "label": labels[sl],
                    "mask": mask})
    return out


def _rows(batch, rank):
    return {k: torch.as_tensor(v[rank * PER_RANK:(rank + 1) * PER_RANK])
            for k, v in batch.items()}


def _clip_tree():
    rng = np.random.default_rng(11)
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(13).astype(np.float32),
            "c": rng.standard_normal((2, 3, 3)).astype(np.float32)}


CLIP_NORMS = {"clipped": 0.5, "unclipped": 1e3}


def _state_dict(opt_state):
    return {f: getattr(opt_state, f) for f in SLOTS + COUNTS}


def _worker(rank, n, path):
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import clip_by_global_norm_sharded, sharded_global_norm
    from tpu_ddp_torch.train.optim import OptState
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import make_train_step

    init = torch.load(f"{path}/init.pt")
    result = {"clip": {}}
    # (c) the sharded clip
    tree = {k: torch.from_numpy(v) for k, v in _clip_tree().items()}
    tx = make_optimizer(zero1_axis="data")
    part = Zero1Partition(tx, tree, n)
    shards = part.local_shard(part.flatten(tree))
    for regime, max_norm in CLIP_NORMS.items():
        clipped = clip_by_global_norm_sharded(shards, max_norm)
        result["clip"][regime] = part.gather_params(clipped)
    result["clip"]["norm"] = float(sharded_global_norm(shards.values()))

    for recipe, kw in RECIPES.items():
        cases = ["dp", "zero1", "zero1_k1"] + (["zero1_int8_ef"] if recipe == "sgd_mom" else [])
        for case in cases:
            model = NetResDeep(**MODEL)
            model.load_state_dict(init)
            params = dict(model.named_parameters())
            part = None
            if case == "dp":
                tx = make_optimizer(**kw)
            else:
                tx = make_optimizer(kernels=case == "zero1_k1", zero1_axis="data",
                                    decay_mask=decay_mask(params), **kw)
                part = Zero1Partition(tx, params, n)
            state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
            comp = None
            if case == "zero1_int8_ef":
                comp = GradCompressor(GradCompression(mode="int8", block=64,
                                                      error_feedback=True),
                                      state.params(), n)
                part.set_compression(comp)
                state.grad_residual = comp.init_residual(torch.device("cpu"))
            step = make_train_step(tx, compress=comp, zero1=part)
            losses, batches = [], []
            for batch in _batches(n):
                state, metrics = step(state, _rows(batch, rank))
                losses.append(float(metrics["loss"]))
                if tx.fused is not None:
                    batches.append(tx.fused._batch)
            out = {"losses": losses,
                   "model": {k: v.clone() for k, v in state.model.state_dict().items()},
                   "batch_cached": all(b is batches[0] for b in batches)}
            if part is not None:
                out["shards"] = _state_dict(state.opt_state)
                out["desharded"] = _state_dict(part.deshard_opt_state(state.opt_state))
                if case == "zero1":
                    jax_state = OptState(**torch.load(f"{path}/jax_opt_{recipe}.pt"))
                    landed = part.shard_opt_state(jax_state)
                    out["landed"] = _state_dict(landed)
                    out["round_trip"] = _state_dict(part.deshard_opt_state(landed))
            if state.grad_residual is not None:
                out["residual_norm"] = float(sum(x.square().sum() for x in
                                                 state.grad_residual.values()))
            result[(recipe, case)] = out
    torch.save(result, f"{path}/rank{rank}.pt")


def _jax_run(devices, n, kw):
    model = FlaxNetResDeep(**MODEL)
    tx = jax_make_optimizer(**kw)
    state = jax_create_train_state(model, tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=n), devices[:n])
    step = jax_make_train_step(model, tx, mesh, donate=False)
    s = jax.device_put(state, replicated_sharding(mesh))
    losses = []
    for batch in _batches(n):
        s, m = step(s, jax.device_put(batch, batch_sharding(mesh)))
        losses.append(float(m["loss"]))
    return state, jax.device_get(s), losses


@pytest.fixture(scope="module", params=[2, 3], ids=["n2", "n3"])
def runs(request, devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    n = request.param
    path = tmp_path_factory.mktemp(f"zero1_n{n}")
    jax_runs = {}
    for recipe, kw in RECIPES.items():
        init, final, losses = _jax_run(devices, n, kw)
        jax_runs[recipe] = (final, losses)
        converted = from_jax(*jax.device_get((final.params, final.batch_stats,
                                              final.opt_state)))["opt_state"]
        torch.save(_state_dict(converted), path / f"jax_opt_{recipe}.pt")
    torch.save(from_jax(*jax.device_get((init.params, init.batch_stats)))["model"],
               path / "init.pt")
    spawn(_worker, n, str(path), init_file=str(path / "rdzv"), timeout=300)
    return {"n": n, "jax": jax_runs,
            "port": [torch.load(path / f"rank{r}.pt") for r in range(n)]}


def _close_trees(got, want, atol, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


def _close_states(got, want, atol, what):
    for slot in SLOTS:
        assert (got[slot] is None) == (want[slot] is None), f"{what} {slot}"
        if want[slot] is not None:
            _close_trees(got[slot], want[slot], atol, f"{what} {slot}")
    for slot in COUNTS:
        assert (got[slot] is None) == (want[slot] is None), f"{what} {slot}"
        if want[slot] is not None:
            assert int(got[slot]) == int(want[slot]), f"{what} {slot}"


@pytest.mark.parametrize("regime", sorted(CLIP_NORMS))
def test_sharded_clip_matches_optax(runs, regime):
    tree = _clip_tree()
    tx = optax.clip_by_global_norm(CLIP_NORMS[regime])
    want, _ = tx.update(tree, tx.init(tree))
    norm = float(optax.global_norm(tree))
    assert (norm > CLIP_NORMS[regime]) == (regime == "clipped")
    for rank, res in enumerate(runs["port"]):
        np.testing.assert_allclose(res["clip"]["norm"], norm, rtol=1e-6)
        for name, w in want.items():
            np.testing.assert_allclose(res["clip"][regime][name].numpy(),
                                       np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=f"rank {rank} {name}")


ZERO1_CASES = [(recipe, case) for recipe in RECIPES for case in ("zero1", "zero1_k1")]


@pytest.mark.parametrize("recipe,case", ZERO1_CASES)
def test_zero1_matches_jax_replicated_step(runs, recipe, case):
    final, losses = runs["jax"][recipe]
    got = runs["port"][0][(recipe, case)]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = convert_tree(final.params)
    want.update(convert_tree(final.batch_stats))
    _close_trees({k: v.numpy() for k, v in got["model"].items()}, want, 1e-5,
                 "model")


@pytest.mark.parametrize("recipe,case", ZERO1_CASES)
def test_zero1_matches_port_replicated_step(runs, recipe, case):
    got = runs["port"][0][(recipe, case)]
    dp = runs["port"][0][(recipe, "dp")]
    np.testing.assert_allclose(got["losses"], dp["losses"], rtol=0, atol=1e-5)
    _close_trees({k: v.numpy() for k, v in got["model"].items()},
                 {k: v.numpy() for k, v in dp["model"].items()}, 1e-5, "model")
    if case == "zero1_k1":
        assert got["batch_cached"]          # K1's leaf table built once


@pytest.mark.parametrize("recipe,case", ZERO1_CASES)
def test_desharded_opt_state_matches_jax(runs, recipe, case):
    final, _ = runs["jax"][recipe]
    want = _state_dict(from_jax({}, {}, final.opt_state)["opt_state"])
    for rank, res in enumerate(runs["port"]):
        _close_states(res[(recipe, case)]["desharded"], want, 1e-5, f"rank {rank}")


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_jax_state_lands_in_shard_layout(runs, recipe):
    """The JAX replicated state after three steps, sharded into the port's
    layout, against the port's own shards, and de-sharded back exactly."""
    final, _ = runs["jax"][recipe]
    converted = _state_dict(from_jax({}, {}, final.opt_state)["opt_state"])
    for rank, res in enumerate(runs["port"]):
        out = res[(recipe, "zero1")]
        _close_states(out["landed"], out["shards"], 1e-5, f"rank {rank}")
        _close_states(out["round_trip"], converted, 0.0, f"rank {rank}")


@pytest.mark.parametrize("recipe,case", [(r, c) for r in RECIPES
                                         for c in ("dp", "zero1", "zero1_k1")]
                         + [("sgd_mom", "zero1_int8_ef")])
def test_replicas_end_bitwise_equal(runs, recipe, case):
    first = runs["port"][0][(recipe, case)]
    for res in runs["port"][1:]:
        other = res[(recipe, case)]
        assert other["losses"] == first["losses"]
        assert all(torch.equal(other["model"][k], v) for k, v in first["model"].items())


def test_int8_error_feedback_close_to_uncompressed_zero1(runs):
    for res in runs["port"]:
        got, plain = res[("sgd_mom", "zero1_int8_ef")], res[("sgd_mom", "zero1")]
        assert max(abs(a - b) for a, b in zip(got["losses"], plain["losses"])) < 0.05
        assert got["residual_norm"] > 0


# ---- (g) the trainer ----------------------------------------------------------

SMALL = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "128",
         "--epochs", "2", "--n-chans1", "6", "--n-blocks", "2", "--momentum", "0.9",
         "--ema-decay", "0.9", "--eval-each-epoch", "--log-every-epochs", "1"]


def _launch_evals(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
         "--", sys.executable, "-m", "tpu_ddp_torch.cli.train", *SMALL, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    evals = [(float(a), float(b)) for a, b in re.findall(
        r"test_accuracy=(\S+) test_loss=(\S+)$", proc.stdout, re.M)]
    assert len(evals) == 2 and all(math.isfinite(b) for _, b in evals)
    return evals


def test_trainer_zero1_ema_eval_matches_replicated():
    """Two CPU ranks through the launcher; evaluation reads the EMA
    weights, which ``--zero1`` gathers from the ranks' shards."""
    want = _launch_evals([])
    for extra in (["--zero1"], ["--zero1", "--kernels"]):
        got = _launch_evals(extra)
        for (acc, loss), (w_acc, w_loss) in zip(got, want):
            assert abs(acc - w_acc) <= 1e-6 and abs(loss - w_loss) <= 1e-4


def test_zero1_on_one_rank_matches_replicated():
    """One rank: the shard is the whole padded leaf (no pad), and the run
    matches the replicated one; K1's leaf table is kept across steps."""
    args = SMALL + ["--optimizer", "adamw", "--lr", "1e-3", "--momentum", "0",
                    "--weight-decay", "0.05", "--grad-clip-norm", "1.0", "--kernels"]
    want = main(args)
    got = main(args + ["--zero1"])
    np.testing.assert_allclose(got["step_losses"], want["step_losses"], rtol=0,
                               atol=1e-6)
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 1e-6
    assert abs(got["test_loss"] - want["test_loss"]) <= 1e-4
