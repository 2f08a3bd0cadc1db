"""Tensor parallelism in the port (``parallel/tensor_parallel.py``) against
the JAX package's ``make_tp_train_step`` (``tpu_ddp/parallel/
tensor_parallel.py`` :252) on a data=2 x model=2 grid.

The JAX step runs on 4 of the conftest's CPU devices; the port on 4 gloo
ranks, rank r at data index ``r // 2`` and model index ``r % 2``, each with
its data shard's 8 rows of the global batch of 16. Both start from the
JAX init (``from_jax``) and take two SGD steps (lr 0.05, momentum 0.9; the
port with ``kernels=True``, K1's plain version on the CPU) on the same
seeded batches, the first with a partial mask (5 of 16 rows padded, 1 of
them in the first data shard, 4 in the second), which pins the masked mean
over the global batch. Cases:

* a ViT (patch 8, hidden 64, depth 2, 4 heads), full attention;
* a ViT with 3 heads at model=2 (hidden 48): the ranks hold 2 heads and 1;
* NetResDeep (n_chans1 8, 2 tied blocks) under the channel rules, its
  BatchNorm over the global batch, running stats included, and a
  ResNet-family member (stages (1, 1), 8 filters, basic blocks): in
  ``tests/test_torch_tensor_parallel_cnn.py``, with these helpers.

Tolerances are the JAX tests' own (``tests/test_tensor_parallel.py`` :62,
:252, :217-218): losses within 1e-4 (ViT) and 5e-4 (conv), params (and
BatchNorm's running stats) and the optimizer state (momentum trace, Adam's
moments, the EMA shadow), gathered after two steps, within ``atol=1e-5,
rtol=1e-4``. Every rank's gathered params equal to the bit. A case may
name another optimizer recipe (``RECIPES``: AdamW, SGD and lamb with weight
decay, EMA and a clip norm low enough to trigger, which the global norm
over the cut leaves sets); ``tests/test_torch_gspmd_adamw.py`` and
``tests/test_torch_gspmd_lamb.py`` run those. Under AdamW the key third
of each ViT ``qkv`` bias, whose gradient is rounding noise that Adam
scales to steps of up to ``lr`` (``tests/test_torch_vit.py``), is held to
3 such steps from its start on both sides instead; under lamb the whole
``qkv`` bias, whose trust ratio that noise moves. Also
``--grad-accum-steps 2`` against the JAX accumulating step on the ViT
(its microbatches slices of the global batch, the mask's padded rows
spread unevenly over them).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

DATA, MODEL = 2, 2
ROWS = 8
MASKS = [np.r_[np.ones(7), 0, np.ones(4), np.zeros(4)].astype(bool), np.ones(16, bool)]
CASES = {
    "vit": dict(kind="vit", patch_size=8, hidden_dim=64, depth=2, num_heads=4),
    "vit_3heads": dict(kind="vit", patch_size=8, hidden_dim=48, depth=2, num_heads=3),
    "netresdeep": dict(kind="netresdeep", n_chans1=8, n_blocks=2),
    "resnet": dict(kind="resnet"),
    "vit_accum": dict(kind="vit", patch_size=8, hidden_dim=64, depth=2, num_heads=4,
                      accum=2),
    "vit_remat": dict(kind="vit", patch_size=8, hidden_dim=64, depth=2, num_heads=4,
                      remat=True),
    "vit_health": dict(kind="vit", patch_size=8, hidden_dim=64, depth=2, num_heads=4,
                       health=True),
}
#: the step knobs a case may set
KNOBS = ("kind", "accum", "remat", "health", "opt")
#: the optimizers a case may name (``opt``; default ``sgd``), the same
#: ``make_optimizer`` arguments in both packages
RECIPES = {
    "sgd": dict(lr=0.05, momentum=0.9),
    "sgd_clip": dict(lr=0.05, momentum=0.9, weight_decay=1e-3, grad_clip_norm=0.05,
                     ema_decay=0.9),
    "adamw": dict(lr=1e-3, optimizer="adamw", weight_decay=0.05, grad_clip_norm=0.05,
                  ema_decay=0.9),
    "lamb": dict(lr=1e-2, optimizer="lamb", weight_decay=0.01, grad_clip_norm=0.05,
                 ema_decay=0.9),
}
VIT = dict(kind="vit", patch_size=8, hidden_dim=64, depth=2, num_heads=4)
NET = dict(kind="netresdeep", n_chans1=8, n_blocks=2)
CASES.update({f"{name}_{opt}": dict(base, opt=opt) for name, base in
              (("vit", VIT), ("netresdeep", NET)) for opt in ("sgd_clip", "adamw", "lamb")})
LOSS_TOL = {"vit": 1e-4, "netresdeep": 5e-4, "resnet": 5e-4}


def _batches():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(32, 10, seed=7)
    return [{"image": np.asarray(images[i * 16:(i + 1) * 16], np.float32),
             "label": np.asarray(labels[i * 16:(i + 1) * 16]), "mask": MASKS[i]}
            for i in range(2)]


def _kw(case):
    return {k: v for k, v in CASES[case].items() if k not in KNOBS}


def _flax_model(case):
    from tpu_ddp.models import resnet_family as flax_family
    from tpu_ddp.models.resnet import NetResDeep
    from tpu_ddp.models.vit import ViT

    kind = CASES[case]["kind"]
    if kind == "vit":
        return ViT(num_classes=10, **_kw(case))
    if kind == "netresdeep":
        return NetResDeep(**_kw(case))
    return flax_family.ResNet((1, 1), flax_family._BasicBlock, num_filters=8)


def _port_model(case):
    from tpu_ddp_torch.models import NetResDeep, ViT
    from tpu_ddp_torch.models import resnet_family as family

    kind = CASES[case]["kind"]
    if kind == "vit":
        return ViT(num_classes=10, **_kw(case))
    if kind == "netresdeep":
        return NetResDeep(**_kw(case))
    return family.ResNet((1, 1), family._BasicBlock, num_filters=8)


def _jax_case(case, devices, build="tp"):
    from tpu_ddp.health import HealthConfig
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel import tensor_parallel as jtp
    from tpu_ddp.parallel.partitioning import shard_train_state
    from tpu_ddp.train import create_train_state, make_optimizer
    from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax

    model = _flax_model(case)
    tx = make_optimizer(kernels=False, **_recipe(case))
    state = create_train_state(model, tx, jax.random.key(0))
    init = (jax.device_get(state.params), jax.device_get(state.batch_stats))
    has_bs = CASES[case]["kind"] != "vit"
    rules = jtp.VIT_TP_RULES if not has_bs else jtp.CNN_TP_RULES
    sizes = {"tp": dict(data=DATA, model=MODEL), "fsdp": dict(data=4),
             "fsdp_tp": dict(data=DATA, model=MODEL)}[build]
    mesh = create_mesh(MeshSpec(**sizes), devices[:4])
    kw = dict(has_batch_stats=has_bs, donate=False,
              grad_accum_steps=CASES[case].get("accum", 1),
              remat=CASES[case].get("remat", False),
              health=HealthConfig(per_layer=True) if CASES[case].get("health") else None)
    if build == "fsdp":
        step, shardings = jtp.make_fsdp_train_step(model, tx, mesh, state, **kw)
    else:
        make_step = jtp.make_tp_train_step if build == "tp" else jtp.make_fsdp_tp_train_step
        step, shardings = make_step(model, tx, mesh, state, rules=rules, **kw)
    state = shard_train_state(state, shardings)
    losses, stats = [], []
    for batch in _batches():
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        stats.append(jax.device_get(metrics.get("health")))
    final = convert_tree(jax.device_get(state.params))
    final.update(convert_tree(jax.device_get(state.batch_stats)))
    opt = _slots(from_jax({}, {}, jax.device_get(state.opt_state))["opt_state"])
    return init, losses, final, stats, opt


def port_rank(mesh, build, case, path):
    """One rank's run of ``case`` under ``build`` from the JAX init saved
    at ``path``: ``{"losses", "params"}`` with the params gathered whole."""
    from tpu_ddp_torch.checkpoint.convert import from_jax
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    model = _port_model(case)
    params, stats = torch.load(f"{path}/init_{build}_{case}.pt", weights_only=False)
    model.load_state_dict(from_jax(params, stats)["model"])
    fsdp = build != "tp"
    recipe = _recipe(case)
    tx = make_optimizer(kernels=recipe.get("optimizer") != "lamb", **recipe,
                        decay_mask=decay_mask(dict(model.named_parameters())) if fsdp else None)
    strat = build_strategy(build, mesh, model, tx, torch.device("cpu"),
                           grad_accum_steps=CASES[case].get("accum", 1),
                           remat=CASES[case].get("remat", False),
                           health=HealthConfig(per_layer=True) if CASES[case].get("health")
                           else None)
    rows = slice(mesh.data_index * (16 // mesh.data_size),
                 (mesh.data_index + 1) * (16 // mesh.data_size))
    losses, stats = [], []
    for batch in _batches():
        local = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        _, metrics = strat.train_step(strat.state, local)
        losses.append(float(metrics["loss"]))
        if "health" in metrics:
            h = metrics["health"]
            stats.append({k: (float(v) if k != "per_layer" else
                              {g: {n: float(x) for n, x in layers.items()}
                               for g, layers in v.items()}) for k, v in h.items()})
    whole = strat.layout.model_state(strat.state)
    opt = _slots(strat.layout.deshard_opt_state(strat.state.opt_state))
    return {"losses": losses, "stats": stats, "opt": opt,
            "params": {k: v.clone() for k, v in whole.items()}}


def _worker(rank, n, path, build, cases):
    from tpu_ddp_torch.parallel.mesh import create_mesh

    sizes = {"tp": {"data": DATA, "model": MODEL}, "fsdp": {"data": 4},
             "fsdp_tp": {"data": DATA, "model": MODEL}}[build]
    mesh = create_mesh(sizes)
    torch.save({case: port_rank(mesh, build, case, path) for case in cases},
               f"{path}/{build}_rank{rank}.pt")


def run_build(build, cases, devices, tmp_path_factory):
    """The JAX runs and the port's 4 ranks of ``cases`` under ``build``."""
    from tpu_ddp_torch.checkpoint.convert import convert_tree
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp(f"gspmd_{build}")
    jax_runs = {}
    for case in cases:
        init, losses, final, stats, opt = _jax_case(case, devices, build)
        torch.save(init, path / f"init_{build}_{case}.pt")
        start = convert_tree(init[0])
        jax_runs[case] = (losses, final, stats, opt, start)
    spawn(_worker, 4, str(path), build, list(cases), init_file=str(path / "rdzv"),
          timeout=300)
    return jax_runs, [torch.load(path / f"{build}_rank{r}.pt") for r in range(4)]


def _recipe(case):
    return RECIPES[CASES[case].get("opt", "sgd")]


def _slots(opt_state):
    """``{slot: {name: tensor}}`` of an ``OptState``'s per-param slots."""
    return {slot: {n: torch.as_tensor(np.asarray(t)) for n, t in getattr(opt_state, slot).items()}
            for slot in ("trace", "mu", "nu", "ema") if getattr(opt_state, slot) is not None}


def _close(name, got, want, start, case):
    """``got`` (the port's) and ``want`` (JAX's) of the tree entry ``name``
    within ``atol=1e-5, rtol=1e-4``; under AdamW and lamb a ViT qkv bias's
    noise-driven part within 3 steps of lr of ``start`` on both sides
    instead (module docstring)."""
    g, w = np.array(got), np.array(want)
    opt = CASES[case].get("opt", "sgd")
    if start is not None and opt in ("adamw", "lamb") and name.endswith("attn.qkv.bias"):
        C = g.shape[0] // 3
        part = slice(C, 2 * C) if opt == "adamw" else slice(None)
        s0 = np.asarray(start)[part]
        for side in (g, w):
            assert np.all(np.abs(side[part] - s0) <= 3 * _recipe(case)["lr"]), name
        g[part] = w[part] = 0.0
    np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4, err_msg=name)


def check_case(case, jax_runs, ranks):
    losses, final, stats, opt, start = jax_runs[case]
    got = ranks[0][case]
    if CASES[case].get("health"):
        from test_torch_health_steps import assert_stats_match

        assert len(got["stats"]) == len(stats)
        for g, w in zip(got["stats"], stats):
            assert_stats_match(g, w)
    tol = LOSS_TOL[CASES[case]["kind"]]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=tol)
    assert set(got["params"]) == set(final)
    for name, want in final.items():
        _close(name, got["params"][name], want, start.get(name), case)
    assert set(got["opt"]) == set(opt)
    for slot, tree in opt.items():
        assert set(got["opt"][slot]) == set(tree), slot
        for name, want in tree.items():
            base = start.get(name) if slot == "ema" else None
            _close(f"{slot}/{name}", got["opt"][slot][name], want, base, case)
    for r in ranks[1:]:
        assert r[case]["losses"] == got["losses"]
        for k, v in got["params"].items():
            assert torch.equal(r[case]["params"][k], v), k


VIT_CASES = ["vit", "vit_3heads", "vit_accum"]


@pytest.fixture(scope="module")
def tp_runs(devices, tmp_path_factory):
    return run_build("tp", VIT_CASES, devices, tmp_path_factory)


@pytest.mark.parametrize("case", VIT_CASES)
def test_tp_step_matches_jax(tp_runs, case):
    check_case(case, *tp_runs)
