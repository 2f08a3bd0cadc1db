"""Pipeline parallelism in the port (``parallel/pipeline.py``, ``--parallelism
pp``) against the JAX package's ``make_pp_train_step``
(``tpu_ddp/parallel/pipeline.py`` :196, its 1F1B :425) on the conftest's CPU
devices.

The JAX step runs on 4 CPU devices; the port on 4 gloo ranks, started once
for the file, each at the stage and data index the JAX mesh gives its
device (rank r at data ``r // S``, stage ``r % S``), with its data shard's
rows of a global batch of 16. Both start from the JAX init (the plain ViT's
params, which ``create_pp_train_state`` stacks) and take two steps on the
same seeded batches, the first with 3 of its 16 rows masked (2 in the first
data shard, 1 in the second). The model is the JAX test's ViT (patch 8,
hidden 64, depth 4, 4 heads), cases:

* gpipe and 1f1b at ``data=2,pipeline=2`` (2 blocks a stage, 2
  microbatches), SGD with momentum and weight decay (which the JAX pp
  optimizer applies to every stacked block leaf);
* gpipe and 1f1b at ``pipeline=4`` (1 block a stage, 4 microbatches), AdamW
  with weight decay and EMA, through K1 (``kernels=True``, its plain
  version on the CPU);
* gpipe at ``data=2,pipeline=2`` under lamb (each stage's stacked leaves'
  trust ratios) with the flight recorder's per-layer stats.

Tolerances are JAX's own (``tests/test_pipeline.py`` :93): losses within
1e-4, params gathered whole within ``rtol=2e-3, atol=2e-5`` (under AdamW
the key third of each ``qkv`` bias, whose gradient is rounding noise that
Adam scales to steps of up to lr, is held to 3 such steps from its start on
both sides instead, and under lamb the whole ``qkv`` bias, whose trust
ratio that noise moves: ``tests/test_torch_tensor_parallel.py``); every
rank's gathered params equal to the bit; 1f1b against gpipe within
``atol=1e-5`` (``tests/test_pipeline.py`` :139; the AdamW ``qkv`` bias's key
third as above); health norms within
``rtol=1e-5``. Also the layout round trip against ``to_pipeline_params``,
``pp_schedule_stats`` over a grid, and the clip's refusal (the JAX pp step
fails its replication check under a clip).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

VIT = dict(patch_size=8, hidden_dim=64, depth=4, num_heads=4)
D2P2, P4 = {"data": 2, "pipeline": 2}, {"data": 1, "pipeline": 4}
#: name -> (schedule, mesh, microbatches, optimizer, health)
CASES = {
    "gpipe_d2p2_sgd": ("gpipe", D2P2, 2, "sgd", False),
    "1f1b_d2p2_sgd": ("1f1b", D2P2, 2, "sgd", False),
    "gpipe_p4_adamw": ("gpipe", P4, 4, "adamw", False),
    "1f1b_p4_adamw": ("1f1b", P4, 4, "adamw", False),
    "gpipe_d2p2_lamb_health": ("gpipe", D2P2, 2, "lamb", True),
}
RECIPES = {
    "sgd": dict(lr=0.05, momentum=0.9, weight_decay=1e-3),
    "adamw": dict(lr=1e-3, optimizer="adamw", weight_decay=0.05, ema_decay=0.9),
    "lamb": dict(lr=1e-2, optimizer="lamb", weight_decay=0.01),
}
MASKS = [np.r_[np.ones(6), np.zeros(2), np.ones(7), 0].astype(bool), np.ones(16, bool)]


def _batches():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(32, 10, seed=11)
    return [{"image": np.asarray(images[i * 16:(i + 1) * 16], np.float32),
             "label": np.asarray(labels[i * 16:(i + 1) * 16]), "mask": MASKS[i]}
            for i in range(2)]


def _jax_case(case, devices):
    from tpu_ddp.health import HealthConfig
    from tpu_ddp.models.vit import ViT
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel.pipeline import create_pp_train_state, make_pp_train_step
    from tpu_ddp.train import make_optimizer
    from tpu_ddp_torch.checkpoint.convert import convert_tree

    schedule, sizes, micro, opt, health = CASES[case]
    model = ViT(num_classes=10, **VIT)
    tx = make_optimizer(kernels=False, **RECIPES[opt])
    state = create_pp_train_state(model, tx, jax.random.key(0))
    init = convert_tree(jax.device_get(state.params))
    mesh = create_mesh(MeshSpec(**sizes), devices[:4])
    step, shardings = make_pp_train_step(
        model, tx, mesh, state, n_microbatches=micro, schedule=schedule, donate=False,
        health=HealthConfig(per_layer=True) if health else None)
    state = jax.device_put(state, shardings)
    losses, stats = [], []
    for batch in _batches():
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        stats.append(jax.device_get(metrics.get("health")))
    return init, losses, stats, convert_tree(jax.device_get(state.params))


def port_rank(case, path):
    """One rank's run of ``case`` from the JAX init at ``path``."""
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    schedule, sizes, micro, opt, health = CASES[case]
    mesh = create_mesh(sizes)
    model = ViT(num_classes=10, **VIT)
    model.load_state_dict(torch.load(f"{path}/init_{case}.pt"))
    tx = make_optimizer(kernels=opt != "lamb", **RECIPES[opt])
    strat = build_strategy("pp", mesh, model, tx, torch.device("cpu"),
                           n_microbatches=micro, pp_schedule=schedule,
                           health=HealthConfig(per_layer=True) if health else None)
    rows = slice(mesh.data_index * 16 // mesh.data_size,
                 (mesh.data_index + 1) * 16 // mesh.data_size)
    losses, stats = [], []
    for batch in _batches():
        local = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        _, metrics = strat.train_step(strat.state, local)
        losses.append(float(metrics["loss"]))
        if "health" in metrics:
            stats.append({k: (float(v) if k != "per_layer" else
                              {g: {n: float(x) for n, x in layers.items()}
                               for g, layers in v.items()})
                          for k, v in metrics["health"].items()})
    whole = strat.layout.model_state(strat.state)
    return {"losses": losses, "stats": stats, "line": strat.line,
            "stage": mesh.pipeline_index,
            "held": sorted({n.split(".")[0] for n in strat.state.model.state_dict()}),
            "params": {k: v.clone() for k, v in whole.items()}}


def _worker(rank, n, path, cases):
    torch.save({case: port_rank(case, path) for case in cases}, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("pp")
    jax_runs = {}
    for case in CASES:
        init, losses, stats, final = _jax_case(case, devices)
        torch.save(init, path / f"init_{case}.pt")
        jax_runs[case] = (init, losses, stats, final)
    spawn(_worker, 4, str(path), list(CASES), init_file=str(path / "rdzv"), timeout=300)
    return jax_runs, [torch.load(path / f"rank{r}.pt") for r in range(4)]


def _close(name, got, want, start, opt, rtol=2e-3, atol=2e-5):
    g, w = np.array(got), np.array(want)
    if opt in ("adamw", "lamb") and name.endswith("attn.qkv.bias"):
        C = g.shape[0] // 3
        part = slice(C, 2 * C) if opt == "adamw" else slice(None)
        s0 = np.asarray(start)[part]
        for side in (g, w):
            assert np.all(np.abs(side[part] - s0) <= 3 * RECIPES[opt]["lr"]), name
        g[part] = w[part] = 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_pp_step_matches_jax(runs, case):
    from test_torch_health_steps import assert_stats_match

    jax_runs, ranks = runs
    init, losses, stats, final = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-4)
    assert set(got["params"]) == set(final)
    opt = CASES[case][3]
    for name, want in final.items():
        _close(name, got["params"][name], want, init[name], opt)
    if CASES[case][4]:
        assert len(got["stats"]) == len(stats)
        for g, w in zip(got["stats"], stats):
            assert_stats_match(g, w)
    for r in ranks[1:]:
        assert r[case]["losses"] == got["losses"]
        for k, v in got["params"].items():
            assert torch.equal(r[case]["params"][k], v), k


@pytest.mark.parametrize("pair", [("gpipe_d2p2_sgd", "1f1b_d2p2_sgd"),
                                  ("gpipe_p4_adamw", "1f1b_p4_adamw")])
def test_1f1b_matches_gpipe(runs, pair):
    jax_runs, ranks = runs
    a, b = ranks[0][pair[0]], ranks[0][pair[1]]
    init, opt = jax_runs[pair[0]][0], CASES[pair[0]][3]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=0, atol=1e-5)
    for k, v in a["params"].items():
        _close(k, v, b["params"][k], init[k], opt, rtol=0, atol=1e-5)


def test_stage_holds_its_blocks_and_prints_its_line(runs):
    from tpu_ddp.parallel.pipeline import pp_schedule_stats

    for case, (schedule, sizes, micro, _, _) in CASES.items():
        S = sizes["pipeline"]
        stats = pp_schedule_stats(S, micro, schedule)
        want = (f"pp strategy: schedule={stats['schedule']} stages={S} microbatches="
                f"{micro} bubble={stats['bubble_fraction']:.1%} "
                f"in-flight={stats['in_flight_microbatches']} recompute={stats['recompute']}")
        for r in runs[1]:
            got = r[case]
            assert got["line"] == want
            per = VIT["depth"] // S
            blocks = [f"block_{i}" for i in range(got["stage"] * per, (got["stage"] + 1) * per)]
            assert got["held"] == sorted(blocks + ["head", "ln_f", "patch_embed",
                                                   "pos_embed"])


def test_layout_roundtrip():
    from tpu_ddp.models.vit import ViT
    from tpu_ddp.parallel import pipeline as jpp
    from tpu_ddp_torch.checkpoint.convert import convert_tree
    from tpu_ddp_torch.parallel.pipeline import from_pipeline_params, to_pipeline_params

    params = ViT(num_classes=10, **VIT).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False)["params"]
    plain = convert_tree(params)
    stacked = jpp.to_pipeline_params(params, VIT["depth"])
    carried = convert_tree(stacked)         # from_jax unstacks the blocks
    assert set(carried) == set(plain)
    for k in plain:
        assert torch.equal(carried[k], plain[k]), k
    pp = to_pipeline_params(plain, VIT["depth"])
    assert {k for k in pp if k.startswith("blocks.")} == {
        "blocks." + k.split(".", 1)[1] for k in plain if k.startswith("block_0.")}
    for k, v in pp.items():
        if k.startswith("blocks."):
            rest = k[len("blocks."):]
            for i in range(VIT["depth"]):
                assert torch.equal(v[i], carried[f"block_{i}.{rest}"]), k
    back = from_pipeline_params(pp, VIT["depth"])
    assert set(back) == set(plain)
    for k in plain:
        assert torch.equal(back[k], plain[k]), k


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_pp_schedule_stats_match_jax(schedule, stages):
    from tpu_ddp.parallel.pipeline import pp_schedule_stats as jax_stats
    from tpu_ddp_torch.parallel.pipeline import pp_schedule_stats

    for micro in (1, 2, 4, 8, 16):
        assert pp_schedule_stats(stages, micro, schedule) == jax_stats(stages, micro, schedule)


def test_clip_refused():
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    tx = make_optimizer(lr=0.1, grad_clip_norm=1.0)
    with pytest.raises(ValueError, match="--grad-clip-norm is not supported with "
                                         "--parallelism pp"):
        build_strategy("pp", create_mesh({"data": 1, "pipeline": 1}), ViT(**VIT), tx,
                       torch.device("cpu"))
