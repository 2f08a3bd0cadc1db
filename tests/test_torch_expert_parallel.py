"""Expert parallelism in the port (``parallel/expert_parallel.py``,
``--parallelism ep``) and the MoE ViT under the GSPMD step's aux path
(``parallel/tensor_parallel.py::make_sharded_train_step``) against the JAX
package's ``make_ep_train_step`` (``tpu_ddp/parallel/expert_parallel.py``
:41) and ``make_tp_train_step`` on 4 of the conftest's CPU devices.

The port runs on 4 gloo ranks, started once for the file, each at the
data, expert (or model) index the JAX mesh gives its device, with its data
shard's rows of a global batch of 16 (the first batch with 3 rows masked).
Both start from the JAX init of the JAX tests' MoE ViT (patch 8, hidden 32,
depth 2, 2 heads, 4 experts, MoE in block 1) and take two steps. Cases:

* ep at ``data=2,expert=2`` and at ``expert=4``, SGD with momentum through
  K1 (``kernels=True``, its plain version on the CPU);
* ep at ``data=2,expert=2`` under AdamW with weight decay, a clip norm low
  enough to trigger (its norm over whole leaves: the experts' squares
  summed over the expert group) and EMA;
* tp at ``data=2,model=2`` on the MoE ViT (attention and the dense block's
  MLP cut by the Megatron rules, the experts replicated), SGD;
* ep at ``data=2,expert=2``, SGD, with ``remat`` and with two accumulated
  microbatches a step (``grad_accum_steps=2``), both of which the JAX
  ``make_ep_train_step`` takes (:41-71).

Checks: losses within 1e-4 and ``aux_loss`` within 1e-5 of JAX's, and at
least ``1 - 1e-5`` (``tests/test_expert_parallel.py`` :167); params gathered
whole within ``atol=1e-5, rtol=1e-4`` (under AdamW the key third of each
``qkv`` bias held to 3 steps of lr from its start instead:
``tests/test_torch_tensor_parallel.py``), every rank's gathered params
equal to the bit; under ep each rank holds ``w_up`` as ``(E / ep, C, H)``,
its rows of the whole, and the router whole and equal on every rank.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

MOE = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=2, num_experts=4)
#: name -> (family, mesh, optimizer, the step's remat and accumulation)
CASES = {
    "ep_d2e2_sgd": ("ep", {"data": 2, "expert": 2}, "sgd", {}),
    "ep_e4_sgd": ("ep", {"data": 1, "expert": 4}, "sgd", {}),
    "ep_d2e2_adamw": ("ep", {"data": 2, "expert": 2}, "adamw", {}),
    "tp_d2m2_sgd": ("tp", {"data": 2, "model": 2}, "sgd", {}),
    "ep_d2e2_sgd_remat": ("ep", {"data": 2, "expert": 2}, "sgd", {"remat": True}),
    "ep_d2e2_sgd_accum2": ("ep", {"data": 2, "expert": 2}, "sgd", {"grad_accum_steps": 2}),
}
RECIPES = {
    "sgd": dict(lr=0.05, momentum=0.9),
    "adamw": dict(lr=1e-3, optimizer="adamw", weight_decay=0.05, grad_clip_norm=0.05,
                  ema_decay=0.9),
}
MASKS = [np.r_[np.ones(7), 0, np.ones(6), np.zeros(2)].astype(bool), np.ones(16, bool)]


def _batches():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(32, 10, seed=13)
    return [{"image": np.asarray(images[i * 16:(i + 1) * 16], np.float32),
             "label": np.asarray(labels[i * 16:(i + 1) * 16]), "mask": MASKS[i]}
            for i in range(2)]


def _jax_case(case, devices):
    from tpu_ddp.models.moe import MoEViT
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel import tensor_parallel as jtp
    from tpu_ddp.parallel.expert_parallel import make_ep_train_step
    from tpu_ddp.parallel.partitioning import shard_train_state
    from tpu_ddp.train import create_train_state, make_optimizer
    from tpu_ddp_torch.checkpoint.convert import convert_tree

    family, sizes, opt, step_kw = CASES[case]
    model = MoEViT(num_classes=10, **MOE)
    tx = make_optimizer(kernels=False, **RECIPES[opt])
    state = create_train_state(model, tx, jax.random.key(0))
    init = convert_tree(jax.device_get(state.params))
    mesh = create_mesh(MeshSpec(**sizes), devices[:4])
    if family == "ep":
        step, shardings = make_ep_train_step(model, tx, mesh, state, donate=False,
                                             **step_kw)
    else:
        step, shardings = jtp.make_tp_train_step(model, tx, mesh, state,
                                                 rules=jtp.VIT_TP_RULES, donate=False)
    state = shard_train_state(state, shardings)
    out = []
    for batch in _batches():
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["aux_loss"])))
    return init, out, convert_tree(jax.device_get(state.params))


def port_rank(case, path):
    from tpu_ddp_torch.models import MoEViT
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    family, sizes, opt, step_kw = CASES[case]
    mesh = create_mesh(sizes)
    model = MoEViT(num_classes=10, **MOE)
    model.load_state_dict(torch.load(f"{path}/init_{case}.pt"))
    tx = make_optimizer(kernels=True, **RECIPES[opt])
    strat = build_strategy(family, mesh, model, tx, torch.device("cpu"), **step_kw)
    rows = slice(mesh.data_index * 16 // mesh.data_size,
                 (mesh.data_index + 1) * 16 // mesh.data_size)
    out = []
    for batch in _batches():
        local = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        _, metrics = strat.train_step(strat.state, local)
        out.append((float(metrics["loss"]), float(metrics["aux_loss"])))
    held = strat.state.model.state_dict()
    return {"metrics": out, "w_up": held["block_1.moe.w_up"].clone(),
            "router": held["block_1.moe.router.weight"].clone(),
            "index": mesh.expert_index,
            "params": {k: v.clone() for k, v in strat.layout.model_state(strat.state).items()}}


def _worker(rank, n, path, cases):
    torch.save({case: port_rank(case, path) for case in cases}, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("ep")
    jax_runs = {}
    for case in CASES:
        init, metrics, final = _jax_case(case, devices)
        torch.save(init, path / f"init_{case}.pt")
        jax_runs[case] = (init, metrics, final)
    spawn(_worker, 4, str(path), list(CASES), init_file=str(path / "rdzv"), timeout=300)
    return jax_runs, [torch.load(path / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("case", list(CASES))
def test_moe_step_matches_jax(runs, case):
    jax_runs, ranks = runs
    init, want, final = jax_runs[case]
    got = ranks[0][case]
    opt = CASES[case][2]
    for (loss, aux), (w_loss, w_aux) in zip(got["metrics"], want):
        np.testing.assert_allclose(loss, w_loss, rtol=0, atol=1e-4)
        np.testing.assert_allclose(aux, w_aux, rtol=0, atol=1e-5)
        assert aux >= 1.0 - 1e-5
    assert set(got["params"]) == set(final)
    for name, w in final.items():
        g, w = got["params"][name].numpy().copy(), np.asarray(w).copy()
        if opt == "adamw" and name.endswith("attn.qkv.bias"):
            C = g.shape[0] // 3
            s0 = init[name].numpy()[C:2 * C]
            for side in (g, w):
                assert np.all(np.abs(side[C:2 * C] - s0) <= 3 * RECIPES[opt]["lr"]), name
            g[C:2 * C] = w[C:2 * C] = 0.0
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4, err_msg=name)
    for r in ranks[1:]:
        assert r[case]["metrics"] == got["metrics"]
        for k, v in got["params"].items():
            assert torch.equal(r[case]["params"][k], v), k


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "ep"])
def test_ep_ranks_hold_their_experts(runs, case):
    ranks = runs[1]
    ep = CASES[case][1]["expert"]
    whole = ranks[0][case]["params"]["block_1.moe.w_up"]
    for r in ranks:
        got = r[case]
        per = MOE["num_experts"] // ep
        assert tuple(got["w_up"].shape) == (per, MOE["hidden_dim"], 4 * MOE["hidden_dim"])
        assert torch.equal(got["w_up"], whole[got["index"] * per:(got["index"] + 1) * per])
        assert torch.equal(got["router"], ranks[0][case]["router"])
        assert torch.equal(got["router"], ranks[0][case]["params"]["block_1.moe.router.weight"])
