"""The LM's sequence-parallel step in the port
(``train/lm_steps.py::make_sp_lm_train_step``) against the JAX package's
``make_sp_lm_train_step`` and against the port's own data-parallel LM step,
mirroring ``tests/test_lm.py:99`` and ``:133``.

The JAX test's tiny LM (vocab 17, hidden 32, depth 2, 2 heads, T = 64)
starts from the JAX init (carried across by ``from_jax``) and takes three
SGD steps (lr 0.5, as in the JAX test: a mismatch shows at once;
``kernels=True``, K1's plain version on the CPU) on numpy token batches of
8 rows, with the flight recorder on. The JAX step runs on a data=2 x
sequence=2 mesh of the conftest's CPU devices, the port on 4 gloo ranks,
each with its data shard's 4 rows cut to its 32-token chunk; plain ring
and ``sp_flash`` (the JAX flash ring takes its jnp tile on the CPU, the
port K4-K6's plain versions).

* Losses ``rtol=1e-5``, params after step 3 ``rtol=1e-5`` (``atol=1e-6``)
  against JAX, health stats ``rtol=1e-5``; the replicas equal to the bit.
* Against the port's one-rank DP LM step on the whole 8 x 64 batch: the
  same tolerances (the JAX test's ``1e-5`` on the loss).
* The targets at the chunk edges are exact: each rank's targets and mask,
  put back in sequence order, are ``tokens[:, 1:]`` and ones, with the
  last rank's last position masked (its target is the wrapped first token).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from test_torch_health_steps import assert_stats_match

TINY = dict(vocab_size=17, hidden_dim=32, depth=2, num_heads=2)
T, ROWS, DATA, SEQ, N_STEPS = 64, 4, 2, 2, 3
OPT = dict(lr=0.5)
TILES = ("plain", "flash")


def _batches():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 17, (DATA * ROWS, T)).astype(np.int32) for _ in range(N_STEPS)]


def _host(stats):
    out = {k: float(v) for k, v in stats.items() if k != "per_layer"}
    out["per_layer"] = {g: {n: float(v) for n, v in layers.items()}
                        for g, layers in stats.get("per_layer", {}).items()}
    return out


def _jax_run(flash, devices):
    from tpu_ddp.health import HealthConfig
    from tpu_ddp.models.lm import CausalTransformerLM
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.train import make_optimizer
    from tpu_ddp.train.lm_steps import create_lm_train_state, make_sp_lm_train_step
    from tpu_ddp_torch.checkpoint.convert import convert_tree

    model = CausalTransformerLM(**TINY, sp_axis="sequence", sp_flash=flash)
    tx = make_optimizer(kernels=False, **OPT)
    state = create_lm_train_state(model, tx, jax.random.key(0), seq_len=T)
    init = jax.device_get(state.params)
    mesh = create_mesh(MeshSpec(data=DATA, sequence=SEQ), devices[:DATA * SEQ])
    step = make_sp_lm_train_step(model, tx, mesh, donate=False,
                                 health=HealthConfig(per_layer=True))
    losses, stats = [], []
    for toks in _batches():
        state, metrics = step(state, {"tokens": toks})
        losses.append(float(metrics["loss"]))
        stats.append(jax.device_get(metrics["health"]))
    return init, losses, stats, convert_tree(jax.device_get(state.params))


@pytest.fixture(scope="module")
def jax_runs(devices):
    return {tile: _jax_run(tile == "flash", devices) for tile in TILES}


def _worker(rank, n, path):
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.train import create_lm_train_state, make_sp_lm_train_step
    from tpu_ddp_torch.train.lm_steps import sp_targets
    from tpu_ddp_torch.train.optim import make_optimizer

    mesh = create_mesh({"data": DATA, "sequence": SEQ})
    rows = slice(mesh.data_index * ROWS, (mesh.data_index + 1) * ROWS)
    t_local = T // SEQ
    cols = slice(mesh.sequence_index * t_local, (mesh.sequence_index + 1) * t_local)
    result = {}
    for tile in TILES:
        model = CausalTransformerLM(**TINY, seq_len=T)
        model.load_state_dict(torch.load(f"{path}/init_{tile}.pt"))
        tx = make_optimizer(kernels=True, **OPT)
        state = create_lm_train_state(model, tx, torch.device("cpu"))
        step = make_sp_lm_train_step(tx, mesh, sp_flash=tile == "flash",
                                     health=HealthConfig(per_layer=True))
        losses, stats = [], []
        for toks in _batches():
            local = torch.from_numpy(toks[rows, cols].copy()).long()
            state, metrics = step(state, {"tokens": local})
            losses.append(float(metrics["loss"]))
            stats.append(_host(metrics["health"]))
        result[tile] = {"losses": losses, "stats": stats,
                        "params": {k: v.clone() for k, v in model.state_dict().items()}}
    toks = torch.from_numpy(_batches()[0][rows, cols].copy()).long()
    result["targets"] = sp_targets(toks, mesh)
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    from tpu_ddp_torch.checkpoint.convert import convert_tree
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("sp_lm")
    for tile, (init, *_) in jax_runs.items():
        torch.save(convert_tree(init), path / f"init_{tile}.pt")
    spawn(_worker, DATA * SEQ, str(path), init_file=str(path / "rdzv"), timeout=300)
    return [torch.load(path / f"rank{r}.pt") for r in range(DATA * SEQ)]


def _close_params(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("tile", TILES)
def test_sp_lm_matches_jax(ranks, jax_runs, tile):
    _, j_losses, j_stats, j_params = jax_runs[tile]
    got = ranks[0][tile]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    _close_params(got["params"], j_params)
    for g, w in zip(got["stats"], j_stats):
        assert_stats_match(g, w)


@pytest.mark.parametrize("tile", TILES)
def test_sp_lm_replicas_bitwise(ranks, tile):
    for r in ranks[1:]:
        assert r[tile]["losses"] == ranks[0][tile]["losses"]
        for k, v in ranks[0][tile]["params"].items():
            assert torch.equal(r[tile]["params"][k], v), k


@pytest.mark.parametrize("tile", TILES)
def test_sp_lm_matches_dp_step(ranks, jax_runs, tile):
    from tpu_ddp_torch.checkpoint.convert import convert_tree
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    model = CausalTransformerLM(**TINY, seq_len=T, use_flash=tile == "flash")
    model.load_state_dict(convert_tree(jax_runs[tile][0]))
    tx = make_optimizer(kernels=True, **OPT)
    state = create_lm_train_state(model, tx, torch.device("cpu"))
    step = make_lm_train_step(tx)
    losses = []
    for toks in _batches():
        state, metrics = step(state, {"tokens": torch.from_numpy(toks).long()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(ranks[0][tile]["losses"], losses, rtol=1e-5)
    _close_params(ranks[0][tile]["params"], model.state_dict())


def test_sp_lm_targets_exact(ranks):
    toks = torch.from_numpy(_batches()[0]).long()
    for d in range(DATA):
        ring = ranks[d * SEQ:(d + 1) * SEQ]
        targets = torch.cat([r["targets"][0] for r in ring], dim=1)
        mask = torch.cat([r["targets"][1] for r in ring], dim=1)
        rows = toks[d * ROWS:(d + 1) * ROWS]
        assert torch.equal(targets[:, :-1], rows[:, 1:])
        assert torch.equal(targets[:, -1], rows[:, 0])       # wrapped, masked
        assert torch.equal(mask[:, :-1], torch.ones(ROWS, T - 1))
        assert torch.all(mask[:, -1] == 0.0)
