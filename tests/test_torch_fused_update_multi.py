"""K1's multi-tensor form: one launch updates every leaf of a step.

* The chunk plan, at the plan's Python level (the kernel's own mapping of a
  block to its leaf and chunk, written out here): every element of every
  leaf is covered exactly once; a leaf takes the 16-byte vector path only
  when all six of its operands are aligned; NetResDeep's 9 leaves and
  ViT-S/4's 79 take one launch; a tree over ``MAX_LEAVES`` takes
  ``ceil(leaves / MAX_LEAVES)``.
* ``FusedUpdate.apply`` over the NetResDeep tree and a small ViT tree on the
  CPU (where ``LeafBatch`` runs the kernel's plain version leaf by leaf)
  against ``tpu_ddp.ops.fused_update.FusedUpdate(recipe, interpret=True)``
  (the Pallas interpreter) on the same numpy inputs, for SGD,
  SGD+momentum+decay+clip+EMA and AdamW+decay+clip+EMA, with the tolerance
  of ``tests/test_torch_fused_update.py`` (``rtol=3e-6, atol=1e-7``).
* The updates ``apply`` returns are views of one buffer, and the batch is
  kept across steps while the same tensors come back."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import bisect
import math

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.ops.fused_update import FusedUpdate as JaxFusedUpdate
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep, ViT
from tpu_ddp_torch.ops import LAUNCHES
from tpu_ddp_torch.ops.fused_update import (
    CHUNK,
    FLAGS,
    MAX_LEAVES,
    VEC,
    WD_APPLY,
    LeafBatch,
    LeafConfig,
    chunk_plan,
    vec_flag,
)
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

TOL = dict(rtol=3e-6, atol=1e-7)
VARIANTS = {
    "sgd": dict(optimizer="sgd", lr=1e-2),
    "sgd_mom_wd_clip_ema": dict(optimizer="sgd", lr=1e-2, momentum=0.9,
                                weight_decay=5e-4, grad_clip_norm=1.0,
                                ema_decay=0.99),
    "adamw_wd_clip_ema": dict(optimizer="adamw", lr=1e-2, weight_decay=0.05,
                              grad_clip_norm=1.0, ema_decay=0.99),
}
VIT_SMALL = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=10)


def _covered(sizes, max_leaves=MAX_LEAVES, chunk=CHUNK):
    """Per leaf, how often each element is updated when every block of
    every launch maps itself as the kernel does: the last leaf whose first
    block is <= the block, elements [(b - first) * chunk, ... + chunk) cut
    at the leaf's end."""
    counts = [np.zeros(n, np.int64) for n in sizes]
    plan = chunk_plan(tuple(sizes), max_leaves, chunk)
    for launch in plan:
        assert 1 <= len(launch.leaves) <= max_leaves
        for b in range(launch.blocks):
            j = bisect.bisect_right(launch.first_blocks, b) - 1
            leaf = launch.leaves[j]
            begin = (b - launch.first_blocks[j]) * chunk
            counts[leaf][begin:min(begin + chunk, sizes[leaf])] += 1
    return plan, counts


@pytest.mark.parametrize("sizes,max_leaves,chunk", [
    ([1, 127, 1_000_003, 16384, 16385, 3], MAX_LEAVES, CHUNK),
    ([0, 5, 0, 40_000, 0], MAX_LEAVES, CHUNK),
    ([7, 1, 64, 65, 4, 0, 300], 3, 16),
    ([CHUNK * 3 + 1] * 5 + [1] * 200, MAX_LEAVES, CHUNK),
])
def test_plan_covers_every_element_once(sizes, max_leaves, chunk):
    plan, counts = _covered(sizes, max_leaves, chunk)
    assert all((c == 1).all() for c in counts)
    live = sum(1 for n in sizes if n)
    assert len(plan) == math.ceil(live / max_leaves)
    assert [i for launch in plan for i in launch.leaves] == [
        i for i, n in enumerate(sizes) if n]
    for launch in plan:
        assert launch.blocks == sum(-(-sizes[i] // chunk) for i in launch.leaves)


@pytest.mark.parametrize("model,leaves", [("netresdeep", 9), ("vit_s4", 79)])
def test_main_path_trees_take_one_launch(model, leaves):
    net = NetResDeep() if model == "netresdeep" else MODEL_REGISTRY[model]()
    sizes = tuple(p.numel() for p in net.parameters())
    assert len(sizes) == leaves
    plan, counts = _covered(sizes)
    assert len(plan) == 1 and plan[0].leaves == tuple(range(leaves))
    assert all((c == 1).all() for c in counts)


@pytest.mark.parametrize("leaves,launches", [
    (MAX_LEAVES, 1), (MAX_LEAVES + 1, 2), (300, 3), (2 * MAX_LEAVES, 2)])
def test_trees_over_the_maximum_take_ceil_launches(leaves, launches):
    assert len(chunk_plan((10,) * leaves)) == launches == math.ceil(leaves / MAX_LEAVES)


def _cfg(kind="adamw", wd=0.05, ema=0.99):
    return LeafConfig(kind=kind, momentum=0.0, wd=wd, wd_apply=False,
                      has_clip=True, max_norm=1.0, step_const=-1e-3,
                      ema_decay=ema, b1=0.9, b2=0.999, eps=1e-8)


def _buf(n, offset):
    """A float32 view of ``n`` elements ``offset`` floats past a 64-byte
    boundary (the CPU allocator's)."""
    return torch.zeros(n + 16)[offset:offset + n]


def test_vec_only_where_every_operand_is_aligned():
    assert vec_flag([0, 16, 32, 4096])
    assert not vec_flag([16, 20, 32])
    # leaf 0: all aligned; leaf 1: its EMA shadow one float off; leaf 2:
    # its param; leaf 3: only the step's grad
    offs = [dict(), dict(e=1), dict(p=2), dict(g=3)]
    n = 40
    ops_ = {s: [_buf(n, o.get(s, 0)) for o in offs] for s in "gpmve"}
    ops_["v"] = [t.abs_() for t in ops_["v"]]
    batch = LeafBatch(ops_["p"], ops_["m"], ops_["v"], ops_["e"], _cfg(),
                      [True, False, True, False])
    table = batch.table_for(ops_["g"])
    assert [bool(f & VEC) for f in table[:, FLAGS]] == [True, False, False, False]
    assert [bool(f & WD_APPLY) for f in table[:, FLAGS]] == [True, False, True, False]
    # a slot the recipe lacks (SGD: no m, v, e) does not count against it
    sgd = LeafBatch(ops_["p"][:1], None, None, None, _cfg("sgd", 0.0, 0.0), [False])
    assert sgd.table_for(ops_["g"][:1])[0, FLAGS] == VEC


def test_batch_refuses_shared_storage_and_bad_grads():
    p, m, v, e = (torch.zeros(32) for _ in range(4))
    with pytest.raises(ValueError, match="share storage"):
        LeafBatch([p, p[8:]], [m, torch.zeros(24)], [v, torch.zeros(24)],
                  [e, torch.zeros(24)], _cfg(), [True, True])
    batch = LeafBatch([p], [m], [v], [e], _cfg(), [True])
    scalars = torch.tensor([2.0, 0.0, 0.1, 0.001])
    with pytest.raises(ValueError, match="share storage"):
        batch.run([m], scalars)
    with pytest.raises(ValueError, match="contiguous"):
        batch.run([torch.zeros(64)[::2]], scalars)
    with pytest.raises(ValueError, match="1 grads for 1 leaves|elements"):
        batch.run([torch.zeros(31)], scalars)
    with pytest.raises(ValueError, match="2 grads for 1 leaves"):
        batch.run([torch.zeros(32), torch.zeros(32)], scalars)


def _flax_tree(model):
    if model == "netresdeep":
        flax_model, x = FlaxNetResDeep(), np.zeros((1, 32, 32, 3), np.float32)
        return flax_model.init(jax.random.key(0), x)["params"]
    flax_model = FlaxViT(**VIT_SMALL)
    return flax_model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
                           train=False)["params"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("model", ["netresdeep", "vit_small"])
def test_apply_over_model_trees_matches_jax_interpret(model, variant):
    kw = VARIANTS[variant]
    params = jax.device_get(_flax_tree(model))
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda x, s=s: (s * rng.standard_normal(x.shape)).astype(
        np.float32), params) for s in (1.0, 1e-3)]
    jax_tx = jax_make_optimizer(kernels=True, **kw)
    j_apply = jax.jit(JaxFusedUpdate(jax_tx.fused.recipe, interpret=True).apply)
    j_params, j_state = params, jax_tx.init(params)

    tx = make_optimizer(kernels=True, **kw)
    p = from_jax(params, {})["model"]
    state = tx.init(p)
    before = LAUNCHES["fused_update"]
    for g in grads:
        j_params, j_u, j_state = jax.device_get(j_apply(g, j_state, j_params))
        u = tx.fused.apply(convert_tree(g), state, p, decay_mask(p))
        for name, want in convert_tree(j_params).items():
            np.testing.assert_allclose(p[name].numpy(), want.numpy(), **TOL,
                                       err_msg=f"param {name}")
        for name, want in convert_tree(j_u).items():
            np.testing.assert_allclose(u[name].numpy(), want.numpy(), **TOL,
                                       err_msg=f"update {name}")
    assert LAUNCHES["fused_update"] == before      # CPU tensors: no kernel


def test_updates_are_views_of_one_buffer_kept_across_steps():
    tx = make_optimizer(lr=1e-3, optimizer="adamw", weight_decay=0.05, kernels=True)
    params = {n: t.detach().clone() for n, t in ViT(**VIT_SMALL).named_parameters()}
    state = tx.init(params)
    gen = torch.Generator().manual_seed(0)
    grads = lambda: {n: torch.randn(t.shape, generator=gen)  # noqa: E731
                     for n, t in params.items()}
    u1 = tx.apply(grads(), state, params)
    batch = tx.fused._batch
    base = batch.u_flat.data_ptr()
    ends = []
    for name, u in u1.items():
        assert u.shape == params[name].shape
        assert u.untyped_storage().data_ptr() == base
        assert (u.data_ptr() - base) % 16 == 0
        ends.append((u.data_ptr(), u.data_ptr() + 4 * u.numel()))
    ends.sort()
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    first = {n: u.clone() for n, u in u1.items()}
    u2 = tx.apply(grads(), state, params)
    assert tx.fused._batch is batch                 # the same tensors: kept
    assert all(u2[n].data_ptr() == u1[n].data_ptr() for n in u1)
    assert not all(torch.equal(first[n], u1[n]) for n in u1)   # overwritten
    # a param replaced by another tensor makes a new batch
    name = next(iter(params))
    params[name] = params[name].clone()
    tx.apply(grads(), state, params)
    assert tx.fused._batch is not batch
