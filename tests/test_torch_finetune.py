"""Fine-tuning in the PyTorch port against the JAX package: the foreign
import and export (``checkpoint/import_foreign.py``), the freeze chain
(``train/optim.py``, K1's frozen rows in ``ops/fused_update.py``, ZeRO-1's
frozen slots in ``parallel/zero.py``), ``from_jax`` of a ``multi_transform``
optimizer state, BCE, the new loaders, ``train/finetune.py`` and the CLI.

The model is a tiny ResNet-18-shaped net (one basic block a stage, two
stages, 8 filters, 5 classes), whose second stage has a projection shortcut.

Tolerances: logits ``atol=1e-5`` and per-step losses ``rtol=1e-5``; params,
BatchNorm stats and optimizer slots after three steps ``atol=1e-5`` (the two
frameworks' float32 convolutions sum in other orders on the CPU; the bound
of ``tests/test_torch_train_step.py``); BCE ``rtol=1e-6``. Frozen params
must come out bitwise ``p + 0.0`` of what went in; the new loaders bitwise
the JAX package's; export and import round-trip bitwise.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.checkpoint import import_foreign as jax_foreign
from tpu_ddp.data import cifar10 as jax_cifar10
from tpu_ddp.models import resnet_family as flax_family
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding
from tpu_ddp.parallel.zero import Zero1Partition as JaxZero1Partition
from tpu_ddp.train.losses import binary_cross_entropy_with_logits as jax_bce
from tpu_ddp.train.optim import freeze_all_but as jax_freeze_all_but
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.checkpoint.import_foreign import (
    export_state_dict,
    import_state_dict,
    load_state_dict,
)
from tpu_ddp_torch.cli.train import build_parser, config_from_args, main
from tpu_ddp_torch.data import cifar10
from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
from tpu_ddp_torch.models import resnet_family as family
from tpu_ddp_torch.ops.fused_update import (
    FLAGS,
    FROZEN,
    G,
    WD_APPLY,
    LeafBatch,
    LeafConfig,
    update_math_frozen,
)
from tpu_ddp_torch.parallel.zero import Zero1Partition
from tpu_ddp_torch.train.finetune import load_pretrained_for_finetune
from tpu_ddp_torch.train.losses import binary_cross_entropy_with_logits
from tpu_ddp_torch.train.optim import decay_mask, freeze_all_but, make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step
from tpu_ddp_torch.train.trainer import TrainConfig

CLASSES, PER_RANK, N_STEPS = 5, 8, 3
CPU = torch.device("cpu")
RECIPES = {
    "sgd_mom_clip_ema": dict(lr=1e-2, momentum=0.9, grad_clip_norm=0.5, ema_decay=0.9),
    "adamw_decay_clip_ema": dict(optimizer="adamw", lr=1e-3, weight_decay=0.05,
                                 grad_clip_norm=0.5, ema_decay=0.9),
}


def _flax_tiny():
    return flax_family.ResNet((1, 1), flax_family._BasicBlock, num_classes=CLASSES,
                              num_filters=8)


def _port_tiny(num_classes=CLASSES, generator=None, image_size=32, dtype=torch.float32):
    del image_size
    return family.ResNet((1, 1), family._BasicBlock, num_classes=num_classes,
                         num_filters=8, generator=generator, dtype=dtype)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _jax_variables(seed=0):
    """A tiny Flax ResNet's variables with random (not initial) values."""
    model = _flax_tiny()
    v = jax.device_get(model.init(jax.random.key(seed),
                                  np.zeros((1, 32, 32, 3), np.float32), train=False))
    rng = np.random.default_rng(seed + 7)
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.1, p.shape).astype(np.float32),
        v["params"])
    stats = jax.tree.map(lambda s: np.asarray(s) + np.float32(0.2), v["batch_stats"])
    return model, params, stats


# ---- the foreign import and export ------------------------------------------


def _foreign_file(tmp_path, suffix, params, stats, model):
    """A torchvision-layout file written by the JAX exporter, with the
    ``num_batches_tracked`` entries torchvision keeps (both importers report
    them unmapped) and, for ``.pt``, DDP's ``module.`` prefix inside a
    ``state_dict`` wrapper."""
    npz = jax_foreign.export_state_dict(params, stats, model, str(tmp_path / "w.npz"))
    with np.load(npz) as z:
        sd = {k: z[k] for k in z.files}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace(".running_mean", ".num_batches_tracked")] = np.asarray(3)
    path = str(tmp_path / f"foreign{suffix}")
    if suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                                   for k, v in sd.items()}}, path)
    return path


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_foreign_import_gives_jax_logits(tmp_path, suffix):
    model, params, stats = _jax_variables()
    path = _foreign_file(tmp_path, suffix, params, stats, model)
    jp, jb, jrep = jax_foreign.import_state_dict(path, model)
    p, b, rep = import_state_dict(path, _port_tiny())
    assert rep == jrep
    assert rep["unmapped"] and all(k.endswith("num_batches_tracked")
                                   for k in rep["unmapped"])
    port = _port_tiny()
    port.load_state_dict({**p, **b})            # strict: every name mapped
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(model.apply({"params": jp, "batch_stats": jb}, x, train=False))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_port_export_round_trips_through_jax_import(tmp_path, suffix):
    """The port's export, read by the JAX importer, is the Flax tree the
    port's weights came from, bitwise; the port's own import gives the
    port's state back, bitwise."""
    model, params, stats = _jax_variables(seed=2)
    port = _port_tiny()
    port.load_state_dict(from_jax(params, stats)["model"])
    sd = port.state_dict()
    p = {n: sd[n] for n, _ in port.named_parameters()}
    b = {n: sd[n] for n, _ in port.named_buffers()}
    path = export_state_dict(p, b, port, str(tmp_path / f"out{suffix}"))
    assert path.endswith(suffix)
    jp, jb, jrep = jax_foreign.import_state_dict(path, model)
    assert jrep["unmapped"] == []
    for got, want in ((jp, params), (jb, stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for k, v in flat_got:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(flat_want[k]))
    pp, pb, rep = import_state_dict(path, port)
    assert rep == {"mapped": len(sd), "unmapped": []}
    for name, t in {**pp, **pb}.items():
        assert torch.equal(_bits(t), _bits(sd[name])), name


def test_export_without_suffix_writes_npz_and_loads_unwrapped(tmp_path):
    port = _port_tiny()
    sd = port.state_dict()
    path = export_state_dict({n: sd[n] for n, _ in port.named_parameters()},
                             {n: sd[n] for n, _ in port.named_buffers()},
                             port, str(tmp_path / "w"))
    assert path.endswith("w.npz")
    assert set(load_state_dict(path)) >= {"conv1.weight", "fc.bias",
                                          "layer2.0.downsample.0.weight"}


@pytest.mark.parametrize("other", ["wide", "netresdeep"])
def test_foreign_import_refuses_other_families(tmp_path, other):
    np.savez(tmp_path / "w.npz", **{"fc.bias": np.zeros(3, np.float32)})
    model = family.WideResNet(depth=10, widen=1) if other == "wide" else NetResDeep()
    with pytest.raises(ValueError, match="ResNet family"):
        import_state_dict(str(tmp_path / "w.npz"), model)


# ---- the freeze chain ----------------------------------------------------------


def _batches(n=1, seed=4):
    images, labels = cifar10.synthetic_cifar10(N_STEPS * n * PER_RANK, CLASSES, seed=seed)
    out = []
    for i in range(N_STEPS):
        sl = slice(i * n * PER_RANK, (i + 1) * n * PER_RANK)
        mask = np.ones(n * PER_RANK, bool)
        if i == N_STEPS - 1:
            for r in range(n):              # a short, wrap-padded last batch
                mask[r * PER_RANK + 5 + r:(r + 1) * PER_RANK] = False
        out.append({"image": images[sl], "label": labels[sl], "mask": mask})
    return out


def _jax_freeze_tx(kw, kernels=False):
    return jax_make_optimizer(kernels=kernels,
                              freeze_predicate=jax_freeze_all_but(("head",)), **kw)


def _port_freeze_tx(kw, kernels=False, **extra):
    return make_optimizer(kernels=kernels, freeze_predicate=freeze_all_but(("head",)),
                          **kw, **extra)


def _frozen_names(model):
    return [n for n, _ in model.named_parameters() if not n.startswith("head.")]


@pytest.mark.parametrize("recipe,jax_kernels,port_kernels", [
    ("sgd_mom_clip_ema", False, False), ("sgd_mom_clip_ema", True, True),
    ("adamw_decay_clip_ema", False, True), ("adamw_decay_clip_ema", True, False),
])
def test_freeze_three_steps_match_jax(recipe, jax_kernels, port_kernels):
    """``freeze_all_but(("head",))``: three DP steps of the port (its plain
    chain or K1's wrapper on the CPU) against the JAX DP step with
    ``kernels`` False or True; frozen params bitwise ``p + 0.0``; the
    optimizer state's slots (the trainable leaves' moments, every leaf's
    EMA) against the optax state through ``from_jax``."""
    kw = RECIPES[recipe]
    flax_model = _flax_tiny()
    jax_tx = _jax_freeze_tx(kw, jax_kernels)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_train_step(flax_model, jax_tx, mesh, donate=False)

    tx = _port_freeze_tx(kw, port_kernels)
    state = create_train_state(_port_tiny(), tx, CPU)
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    before = {n: t.clone() for n, t in state.model.state_dict().items()}
    step = make_train_step(tx)
    for batch in _batches():
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
    want = from_jax(*jax.device_get((j_state.params, j_state.batch_stats,
                                     j_state.opt_state)))
    got = state.model.state_dict()
    assert set(got) == set(want["model"])
    for name, w in want["model"].items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    frozen = _frozen_names(state.model)
    assert frozen and "head.weight" not in frozen
    for name in frozen:
        assert torch.equal(_bits(got[name]), _bits(before[name] + 0.0)), name
    assert not torch.equal(got["head.weight"], before["head.weight"])
    trainable = {"head.weight", "head.bias"}
    for slot in ("trace", "mu", "nu", "ema"):
        mine, theirs = getattr(state.opt_state, slot), getattr(want["opt_state"], slot)
        assert (mine is None) == (theirs is None), slot
        if mine is None:
            continue
        assert set(mine) == set(theirs) == (set(got) - {n for n in got if "running" in n}
                                            if slot == "ema" else trainable), slot
        for name, w in theirs.items():
            np.testing.assert_allclose(mine[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{slot} {name}")
    for slot in ("count", "sched_count"):
        mine, theirs = getattr(state.opt_state, slot), getattr(want["opt_state"], slot)
        assert (mine is None) == (theirs is None), slot
        if mine is not None:
            assert int(mine) == int(theirs) == N_STEPS


@pytest.mark.parametrize("recipe", sorted(RECIPES) + ["sgd_cosine_ema"])
def test_from_jax_reads_a_multi_transform_opt_state(recipe):
    """``from_jax`` walks ``multi_transform``'s ``inner_states`` dict and
    skips its ``MaskedNode``s: slots only for the trainable leaves (the EMA
    for all), the counts read; ``load_into`` lands them in a port state."""
    kw = RECIPES.get(recipe, dict(lr=1e-2, momentum=0.9, ema_decay=0.5,
                                  schedule="cosine", total_steps=10))
    flax_model = _flax_tiny()
    jax_tx = _jax_freeze_tx(kw)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(1))
    grads = jax.tree.map(lambda p: np.full(p.shape, 0.25, np.float32), j_state.params)
    _, opt_state = jax_tx.update(grads, j_state.opt_state, j_state.params)
    conv = from_jax(*jax.device_get((j_state.params, j_state.batch_stats, opt_state)))
    s = conv["opt_state"]
    moments = ("mu", "nu") if "adamw" in recipe else ("trace",)
    for slot in moments:
        assert set(getattr(s, slot)) == {"head.weight", "head.bias"}, slot
        assert float(getattr(s, slot)["head.bias"].abs().sum()) > 0
    assert len(s.ema) == len(list(_port_tiny().parameters()))
    if "adamw" in recipe:
        assert int(s.count) == 1
    if "cosine" in recipe:
        assert int(s.sched_count) == 1
    tx = _port_freeze_tx(kw)
    state = create_train_state(_port_tiny(), tx, CPU)
    load_into(state, conv)
    for slot in moments:
        assert torch.equal(getattr(state.opt_state, slot)["head.weight"],
                           getattr(s, slot)["head.weight"])


def test_frozen_rows_in_the_leaf_table():
    """K1's table: a frozen row has the ``FROZEN`` flag, no decay, a null
    grad address and no m or v (those given are ignored and left alone);
    the CPU path gives ``update_math_frozen``, which turns -0.0 into
    +0.0."""
    cfg = LeafConfig(kind="sgd", momentum=0.9, wd=0.1, wd_apply=True, has_clip=False,
                     max_norm=0.0, step_const=-0.01, ema_decay=0.5, b1=0.9,
                     b2=0.999, eps=1e-8)
    gen = torch.Generator().manual_seed(0)
    ps = [torch.randn(n, generator=gen) for n in (7, 33, 5)]
    ps[1][::3] = -0.0
    ms = [torch.randn(p.shape, generator=gen) for p in ps]
    es = [torch.randn(p.shape, generator=gen) for p in ps]
    gs = [torch.randn(p.shape, generator=gen) for p in ps]
    want_p, want_e, m_before = ps[1].clone(), es[1].clone(), ms[1].clone()
    batch = LeafBatch(ps, ms, None, es, cfg, [True, True, True],
                      frozen=[False, True, False])
    tab = batch.table_for(gs)
    assert tab[1, FLAGS] & FROZEN and not tab[1, FLAGS] & WD_APPLY
    assert tab[0, FLAGS] & WD_APPLY and not tab[0, FLAGS] & FROZEN
    assert tab[1, G] == 0 and tab[0, G] == gs[0].data_ptr()
    batch.run(gs, torch.tensor([0.0, 0.0, 1.0, 1.0]))
    u, p, _, _, e = update_math_frozen(want_p, want_e, cfg)
    assert torch.equal(_bits(batch.us[1]), _bits(u)) and not u.signbit().any()
    assert torch.equal(_bits(ps[1]), _bits(p)) and not ps[1].signbit()[::3].any()
    assert torch.equal(_bits(es[1]), _bits(e))
    assert torch.equal(ms[1], m_before)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "k1"])
def test_all_frozen_and_negative_zero_match_optax(kernels):
    """Every leaf frozen, under clip and EMA: the update is zeros, params
    become ``p + 0.0`` (-0.0 turns +0.0, as ``optax.apply_updates`` gives),
    the EMA moves toward them, and the counts still move."""
    kw = dict(optimizer="adamw", lr=1e-3, grad_clip_norm=1.0, ema_decay=0.5,
              schedule="cosine", total_steps=5)
    params = {"head.w": torch.tensor([[-0.0, 1.5], [0.0, -2.0]]),
              "body.b": torch.tensor([-0.0, 3.0])}
    tx = make_optimizer(kernels=kernels, freeze_predicate=lambda n, leaf: True, **kw)
    state = tx.init(params)
    assert state.mu == {} and state.nu == {}
    ema_before = {n: t.clone() for n, t in state.ema.items()}
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    u = tx.apply(grads, state, params)
    for n, p in params.items():
        assert torch.equal(_bits(u[n]), _bits(torch.zeros_like(p)))
        assert not ((p == 0) & p.signbit()).any()
        assert torch.equal(_bits(state.ema[n]), _bits(0.5 * ema_before[n] + 0.5 * p))
    assert int(state.count) == int(state.sched_count) == 1


# ---- ZeRO-1 with a freeze -------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_zero1_partition_with_freeze_matches_jax_accounting(n):
    """Frozen leaves have no slot in the sharded moments (their rows lay out
    the trainable leaves alone), the EMA row keeps every leaf, and
    ``accounting()`` equals the JAX ``Zero1Partition``'s over a
    ``multi_transform`` chain; original-layout state shards and de-shards
    back exactly."""
    kw = RECIPES["sgd_mom_clip_ema"]
    flax_params = _flax_tiny().init(jax.random.key(0), np.zeros((1, 32, 32, 3),
                                                                np.float32))["params"]
    jax_part = JaxZero1Partition(
        jax_make_optimizer(zero1_axis="data", freeze_predicate=jax_freeze_all_but(("head",)),
                           **kw), flax_params, n)
    params = dict(_port_tiny().named_parameters())
    tx = _port_freeze_tx(kw, zero1_axis="data", decay_mask=decay_mask(params))
    part = Zero1Partition(tx, params, n, rank=n - 1)
    assert part.accounting() == jax_part.accounting()
    state = part.init_opt_state(params)
    assert set(state.trace) == {"head.weight", "head.bias"}
    assert set(state.ema) == set(params)
    full = tx.init(params)
    for t in full.trace.values():
        t.normal_(generator=torch.Generator().manual_seed(5))
    sharded = part.shard_opt_state(full)
    assert set(sharded.trace) == set(full.trace)
    for name, t in sharded.trace.items():
        s = part.shard_size(name)
        flat = part.flatten({name: full.trace[name]})[name]
        assert torch.equal(t, flat[(n - 1) * s:n * s]), name


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "k1"])
def test_zero1_all_frozen_under_clip_is_a_no_op_update(kernels):
    """ZeRO-1 at one rank with every leaf frozen, under clip and EMA: no
    moment slot, the clip has no trainable shard to norm, and a step leaves
    every param ``p + 0.0``."""
    model = _port_tiny()
    params = dict(model.named_parameters())
    tx = make_optimizer(kernels=kernels, momentum=0.9, grad_clip_norm=0.5,
                        ema_decay=0.9, zero1_axis="data", decay_mask=decay_mask(params),
                        freeze_predicate=lambda name, leaf: True)
    part = Zero1Partition(tx, params, 1)
    state = create_train_state(model, tx, CPU, zero1=part)
    assert state.opt_state.trace == {}
    before = {n: p.detach().clone() for n, p in params.items()}
    step = make_train_step(tx, zero1=part)
    state, metrics = step(state, batch_to_device(_batches()[0], CPU))
    assert math.isfinite(float(metrics["loss"]))
    for name, p in state.model.named_parameters():
        assert torch.equal(_bits(p), _bits(before[name] + 0.0)), name


def _zero1_worker(rank, n, path):
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    init = torch.load(f"{path}/init.pt")
    kw = RECIPES["sgd_mom_clip_ema"]
    result = {}
    for case in ("zero1", "zero1_k1", "zero1_k1_int8_ef"):
        model = _port_tiny()
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        tx = _port_freeze_tx(kw, kernels="k1" in case, zero1_axis="data",
                             decay_mask=decay_mask(params))
        part = Zero1Partition(tx, params, n)
        state = create_train_state(model, tx, CPU, zero1=part)
        comp = None
        if "int8" in case:
            comp = GradCompressor(GradCompression(mode="int8", block=64,
                                                  error_feedback=True, kernels=True),
                                  state.params(), n)
            part.set_compression(comp)
            state.grad_residual = comp.init_residual(CPU)
        step = make_train_step(tx, compress=comp, zero1=part)
        losses = []
        for batch in _batches(n):
            rows = {k: torch.as_tensor(v[rank * PER_RANK:(rank + 1) * PER_RANK])
                    for k, v in batch.items()}
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
        result[case] = {"losses": losses,
                        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
                        "trace": set(state.opt_state.trace),
                        "desharded": part.deshard_opt_state(state.opt_state)}
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def zero1_runs(devices, tmp_path_factory):
    """Two gloo ranks of the port under ZeRO-1 with ``--freeze head`` (plain
    chain, K1's CPU path, and K1 with the int8 ring and error feedback), and
    the JAX replicated freeze step on two devices, from the same weights on
    the same batches."""
    from tpu_ddp_torch.parallel.runtime import spawn

    n = 2
    path = tmp_path_factory.mktemp("ft_zero1")
    model = _flax_tiny()
    tx = _jax_freeze_tx(RECIPES["sgd_mom_clip_ema"])
    j_state = jax_create_train_state(model, tx, jax.random.key(0))
    init = from_jax(*jax.device_get((j_state.params, j_state.batch_stats)))["model"]
    torch.save(init, path / "init.pt")
    mesh = create_mesh(MeshSpec(data=n), devices[:n])
    step = jax_make_train_step(model, tx, mesh, donate=False)
    s = jax.device_put(j_state, replicated_sharding(mesh))
    losses = []
    for batch in _batches(n):
        s, m = step(s, jax.device_put(batch, batch_sharding(mesh)))
        losses.append(float(m["loss"]))
    final = from_jax(*jax.device_get((s.params, s.batch_stats, s.opt_state)))
    spawn(_zero1_worker, n, str(path), init_file=str(path / "rdzv"), timeout=300)
    return {"init": init, "jax_losses": losses, "jax": final,
            "port": [torch.load(path / f"rank{r}.pt", weights_only=False)
                     for r in range(n)]}


@pytest.mark.parametrize("case", ["zero1", "zero1_k1"])
def test_zero1_freeze_matches_jax_replicated_step(zero1_runs, case):
    """ZeRO-1 at two ranks with a freeze, float32: losses, params, stats and
    the de-sharded state (moments of the trainable leaves alone) against the
    JAX replicated freeze step; frozen params bitwise ``p + 0.0``; the
    replicas bitwise equal."""
    runs = [r[case] for r in zero1_runs["port"]]
    np.testing.assert_allclose(runs[0]["losses"], zero1_runs["jax_losses"], rtol=1e-5)
    want = zero1_runs["jax"]
    for name, w in want["model"].items():
        np.testing.assert_allclose(runs[0]["model"][name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in [n for n in zero1_runs["init"] if not n.startswith("head.")
                 and "running" not in n]:
        for r in runs:
            assert torch.equal(_bits(r["model"][name]),
                               _bits(zero1_runs["init"][name] + 0.0)), name
    assert runs[0]["trace"] == {"head.weight", "head.bias"}
    for slot in ("trace", "ema"):
        got, theirs = getattr(runs[0]["desharded"], slot), getattr(want["opt_state"], slot)
        assert set(got) == set(theirs), slot
        for name, w in theirs.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{slot} {name}")
    for name, t in runs[0]["model"].items():
        assert torch.equal(_bits(t), _bits(runs[1]["model"][name])), name


def test_zero1_freeze_int8_ring_close_to_jax(zero1_runs):
    """The same with K1, the int8 ring and error feedback: losses within
    0.05 of the JAX replicated step's (``tests/test_torch_zero1.py``'s
    bound for the ring), frozen params still bitwise ``p + 0.0``, replicas
    bitwise equal."""
    runs = [r["zero1_k1_int8_ef"] for r in zero1_runs["port"]]
    np.testing.assert_allclose(runs[0]["losses"], zero1_runs["jax_losses"], atol=0.05)
    for name in [n for n in zero1_runs["init"] if not n.startswith("head.")
                 and "running" not in n]:
        assert torch.equal(_bits(runs[0]["model"][name]),
                           _bits(zero1_runs["init"][name] + 0.0)), name
    for name, t in runs[0]["model"].items():
        assert torch.equal(_bits(t), _bits(runs[1]["model"][name])), name


# ---- BCE and the loaders -------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_bce_and_its_gradient_match_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(9, 4)) * np.array([0.1, 1.0, 10.0, 60.0])).astype(np.float32)
    targets = (rng.random((9, 4)) < 0.4).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool) if masked else None
    want, want_grad = jax.value_and_grad(jax_bce)(logits, targets, mask)
    x = torch.from_numpy(logits).requires_grad_()
    got = binary_cross_entropy_with_logits(
        x, torch.from_numpy(targets), None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed,num_classes", [(0, 3), (5, 7)])
def test_synthetic_multilabel_is_jax_bitwise(seed, num_classes):
    got = cifar10.synthetic_multilabel(40, num_classes, seed)
    want = jax_cifar10.synthetic_multilabel(40, num_classes, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (40, num_classes)


@pytest.mark.parametrize("kw", [dict(), dict(label_noise=0.0),
                                dict(separation=0.7, max_shift=1, label_noise=0.3)])
def test_synthetic_cifar10_hard_is_jax_bitwise(kw):
    got = cifar10.synthetic_cifar10_hard(50, 10, 2, **kw)
    want = jax_cifar10.synthetic_cifar10_hard(50, 10, 2, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _write_cifar100(root, rows=(6, 4), seed=0):
    rng = np.random.default_rng(seed)
    sub = root / "cifar-100-python"
    sub.mkdir(parents=True)
    for name, n in zip(("train", "test"), rows):
        d = {b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8),
             b"fine_labels": [int(x) for x in rng.integers(0, 100, size=n)],
             b"coarse_labels": [int(x) for x in rng.integers(0, 20, size=n)]}
        with open(sub / name, "wb") as f:
            pickle.dump(d, f)
    return sub


@pytest.fixture
def native_codec():
    """Both packages decode through their copies of the C++ codec, which
    round alike; the JAX package's numpy fallback must not be live."""
    from tpu_ddp import native

    assert native.AVAILABLE


@pytest.mark.parametrize("layout", ["extracted", "tarball"])
def test_load_cifar100_is_jax_bitwise(tmp_path, layout, native_codec):
    """The fine labels, as the JAX loader reads them, from the extracted
    batches or from the tarball alone (extracted atomically)."""
    import tarfile

    src = _write_cifar100(tmp_path / "src")
    dirs = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        if layout == "tarball":
            with tarfile.open(d / "cifar-100-python.tar.gz", "w:gz") as tf:
                tf.add(src, "cifar-100-python")
        else:
            (d / "cifar-100-python").symlink_to(src, target_is_directory=True)
        dirs.append(str(d))
    for train in (True, False):
        got = cifar10.load_cifar100(dirs[0], train=train)
        want = jax_cifar10.load_cifar100(dirs[1], train=train)
        assert got[0].shape == ((6 if train else 4), 32, 32, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="cifar-100-python.tar.gz"):
        cifar10.load_cifar100(str(tmp_path / "src" / "nowhere"))


# ---- train/finetune.py, the trainer and the CLI --------------------------------


@pytest.fixture
def tiny_registry(monkeypatch):
    """``tiny_resnet`` in the registry for the CLI (full-width members are
    too slow for the CPU tests)."""
    monkeypatch.setitem(MODEL_REGISTRY, "tiny_resnet", _port_tiny)


CLI_BASE = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "48",
            "--epochs", "1", "--batch-size", "8", "--model", "tiny_resnet",
            "--log-every-epochs", "1", "--momentum", "0.9"]


def _pretrain(tmp_path):
    """Six CLI steps at 100 classes with a checkpoint; returns its state."""
    from tpu_ddp_torch.cli import train as cli

    trainer, _ = cli.run(CLI_BASE + ["--num-classes", "100", "--checkpoint-dir",
                                     str(tmp_path / "ck")])
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


@pytest.mark.parametrize("source", ["file", "directory"])
def test_cli_fine_tune_from_file_and_directory(tmp_path, capsys, tiny_registry, source):
    """``--pretrained-dir`` from an exported ``.pt`` or the pretraining's
    checkpoint directory, ``--num-classes 3 --loss bce --freeze head
    --kernels``: the backbone is the source's bitwise (``p + 0.0``), the
    fresh 3-class head trains, the stats move, and the run reports a test
    loss and no accuracy."""
    from tpu_ddp_torch.cli import train as cli

    pre = _pretrain(tmp_path)
    capsys.readouterr()
    path = str(tmp_path / "ck")
    if source == "file":
        model = _port_tiny(100)
        path = export_state_dict({n: pre[n] for n, _ in model.named_parameters()},
                                 {n: pre[n] for n, _ in model.named_buffers()},
                                 model, str(tmp_path / "pre.pt"))
    trainer, metrics = cli.run(CLI_BASE + ["--num-classes", "3", "--loss", "bce",
                                           "--freeze", "head", "--kernels",
                                           "--pretrained-dir", path])
    out = capsys.readouterr().out
    assert re.search(r"^final test loss: \S+$", out, re.M)
    assert "final test accuracy" not in out and "test_accuracy" not in metrics
    assert all(math.isfinite(x) for x in metrics["step_losses"])
    got = trainer.state.model.state_dict()
    for name in _frozen_names(trainer.state.model):
        assert torch.equal(_bits(got[name]), _bits(pre[name] + 0.0)), name
    assert got["head.weight"].shape == (3, 16)
    fresh = _port_tiny(3, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(got["head.weight"], fresh.head.weight)
    assert all(not torch.equal(got[n], pre[n]) for n in got if "running" in n)
    assert trainer.tx.fused is not None and trainer.state.opt_state.trace.keys() == {
        "head.weight", "head.bias"}


def test_finetune_merge_keeps_the_fresh_head_and_stem(tmp_path):
    """A 100-class ImageNet-stem checkpoint into a 3-class CIFAR-stem model:
    the blocks and BatchNorms load, the 7x7 stem conv and the head keep the
    fresh init; the optimizer state is fresh and the step 0."""
    src = family.ResNet((1, 1), family._BasicBlock, num_classes=100, num_filters=8,
                        cifar_stem=False, generator=torch.Generator().manual_seed(9))
    sd = src.state_dict()
    path = export_state_dict({n: sd[n] for n, _ in src.named_parameters()},
                             {n: sd[n] for n, _ in src.named_buffers()}, src,
                             str(tmp_path / "w.npz"))
    model = _port_tiny(3, generator=torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    tx = make_optimizer(momentum=0.9)
    state = load_pretrained_for_finetune(path, model, tx, CPU)
    got = state.model.state_dict()
    for name, t in got.items():
        keep_fresh = name.startswith(("head.", "stem_conv."))
        assert torch.equal(t, fresh[name] if keep_fresh else sd[name]), name
    assert int(state.step) == 0
    assert all(float(t.abs().sum()) == 0 for t in state.opt_state.trace.values())


def test_cli_flags_and_config():
    def cfg(*argv):
        return config_from_args(build_parser().parse_args(list(argv)))

    assert cfg().num_classes == 10 and cfg().loss == "ce"
    assert cfg("--dataset", "cifar100").num_classes == 100
    assert cfg("--dataset", "cifar100", "--num-classes", "3").num_classes == 3
    c = cfg("--freeze", "head", "stem", "--loss", "bce", "--pretrained-dir", "x.pt",
            "--label-smoothing", "0.1", "--synthetic-task", "hard", "--model", "resnet50")
    assert c.freeze_prefixes == ("head", "stem") and c.loss == "bce"
    assert (c.pretrained_dir, c.label_smoothing, c.synthetic_task, c.model) == (
        "x.pt", 0.1, "hard", "resnet50")
    assert cfg("--freeze").freeze_prefixes is None
    for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
                 "wrn28_10", "wrn16_4"):
        assert cfg("--model", name).model == name


def test_bce_with_class_index_targets_is_refused(tmp_path):
    sub = tmp_path / "cifar-10-batches-py"
    sub.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(sub / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (2, 3072), dtype=np.uint8),
                         b"labels": [1, 2]}, f)
    with pytest.raises(ValueError, match="multi-hot"):
        main(["--device", "cpu", "--data-dir", str(tmp_path), "--loss", "bce",
              "--epochs", "1", "--n-chans1", "4", "--n-blocks", "1"])


def test_keep_best_is_refused_under_bce(tmp_path):
    with pytest.raises(ValueError, match="CE loss"):
        TrainConfig(loss="bce", keep_best=True, checkpoint_dir=str(tmp_path),
                    eval_each_epoch=True)
    with pytest.raises(ValueError, match="unknown loss"):
        TrainConfig(loss="mse")


def test_label_smoothing_and_hard_task_reach_the_run(tiny_registry):
    """``--label-smoothing`` reaches the loss (a different first loss from
    the same start) and ``--synthetic-task hard`` the data."""
    from tpu_ddp_torch.cli import train as cli

    base = CLI_BASE + ["--synthetic-task", "hard"]
    t0, plain = cli.run(base)
    t1, smooth = cli.run(base + ["--label-smoothing", "0.2"])
    assert plain["step_losses"][0] != smooth["step_losses"][0]
    want = cifar10.synthetic_cifar10_hard(48, 10, 0, label_noise=0.1)
    np.testing.assert_array_equal(t0.train_loader.images, want[0])


def test_launcher_fine_tune_two_ranks_zero1_int8(tmp_path):
    """ResNet-18 (full width, 2 steps) fine-tuned from a file on two CPU
    ranks through the launcher with ``--zero1 --grad-compress int8
    --grad-compress-error-feedback --freeze head --kernels`` and a
    checkpoint: the final checkpoint's frozen params are the file's
    (``p + 0.0``), its head moved, and its optimizer state, de-sharded, holds
    the head's trace alone."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpu_ddp_torch.checkpoint.manager import Checkpointer
    from tpu_ddp_torch.train.state import split_checkpoint

    root = Path(__file__).resolve().parents[1]
    model = MODEL_REGISTRY["resnet18"](generator=torch.Generator().manual_seed(5))
    sd = model.state_dict()
    path = export_state_dict({n: sd[n] for n, _ in model.named_parameters()},
                             {n: sd[n] for n, _ in model.named_buffers()}, model,
                             str(tmp_path / "r18.pt"))
    ck = tmp_path / "ck"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
         "--", sys.executable, "-m", "tpu_ddp_torch.cli.train", "--device", "cpu",
         "--model", "resnet18", "--synthetic-data", "--synthetic-size", "16",
         "--batch-size", "4", "--epochs", "1", "--momentum", "0.9", "--zero1",
         "--grad-compress", "int8", "--grad-compress-error-feedback", "--freeze",
         "head", "--kernels", "--pretrained-dir", path, "--checkpoint-dir", str(ck)],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loss = re.findall(r"^Epoch 1, Training loss (\S+)$", proc.stdout, re.M)
    assert len(loss) == 1 and math.isfinite(float(loss[0]))
    checkpointer = Checkpointer(str(ck))
    ckpt = split_checkpoint(checkpointer.restore())
    checkpointer.close()
    assert ckpt["step"] == 2
    for name, _ in model.named_parameters():
        got = ckpt["model"][name]
        if name.startswith("head."):
            assert not torch.equal(got, sd[name]), name
        else:
            assert torch.equal(_bits(got), _bits(sd[name] + 0.0)), name
    assert set(ckpt["opt_state"].trace) == {"head.weight", "head.bias"}
    assert ckpt["grad_residual_rows"] is not None
