"""The flight recorder on two CPU ranks over gloo: the port's data-parallel
step with ``health=`` replicated, under ``--zero1``, and under
``--grad-compress int8`` with and without error feedback, against the JAX
package on a 2-device CPU mesh, three steps of a small NetResDeep (6
channels, 2 tied blocks, 7 classes: no leaf divides evenly by 2, so every
leaf pads and ZeRO-1's pad mask runs) from the same weights, on the same
numpy batches, the second one all NaN in rank 0's rows. SGD with momentum
and a cosine schedule, ``kernels=True`` (K1, K2 and K3 take their plain
versions on the CPU), ``skip_nonfinite`` and the per-layer norms on.

* Both ranks report the same stats, to the bit, per-layer norms included.
* Replicated and ZeRO-1 against the JAX step with ``health=`` (replicated:
  the JAX ZeRO-1 and compressed steps fail shard_map's replication check
  under jax 0.9, ``tests/test_torch_dp_step.py``; ZeRO-1's arithmetic is
  the replicated one): norms ``rtol=1e-5``, sentinels equal; the params
  after the three steps ``atol=1e-5``.
* int8, whose gradient no JAX step computes here: the port's stats within
  ``rtol=1e-5`` of ``tpu_ddp.health.stats.health_stats`` on the trees the
  port's step used (the ring's averaged gradients, the old params, the
  updates applied, the ring's error summed over the ranks).
  ``compress_error_norm`` finite and above 0 on the healthy steps, with
  and without error feedback (the ring computes its error for health
  alone).
* The NaN step is skipped on both ranks: every rank's params, optimizer
  slots, counts, BatchNorm buffers and (error feedback) residual bitwise
  as before it; the step after is finite; replicas end bitwise equal.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.health import HealthConfig as JaxHealthConfig
from tpu_ddp.health import stats as jax_stats
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding
from tpu_ddp.train import create_train_state, make_optimizer
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from test_torch_health_steps import FLAGS, NORMS, assert_bitwise, assert_stats_match, snapshot

N = 2
PER_RANK = 8
MODEL = dict(n_chans1=6, n_blocks=2, num_classes=7)
OPT = dict(lr=1e-2, momentum=0.9, schedule="cosine", total_steps=6, warmup_steps=1)
#: case -> (zero1, compression mode, error feedback)
CASES = {"replicated": (False, None, False), "zero1": (True, None, False),
         "int8": (False, "int8", False), "int8_ef": (False, "int8", True)}
NAN_STEP = 1


def _batches():
    from tpu_ddp.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(3 * N * PER_RANK, num_classes=7, seed=5)
    out = []
    for i in range(3):
        sl = slice(i * N * PER_RANK, (i + 1) * N * PER_RANK)
        img = images[sl].astype(np.float32)
        if i == NAN_STEP:
            img[:PER_RANK] = np.nan                  # rank 0's rows
        out.append({"image": img, "label": labels[sl], "mask": np.ones(N * PER_RANK, bool)})
    return out


def _host(stats):
    out = {k: float(v) for k, v in stats.items() if k != "per_layer"}
    out["per_layer"] = {g: {n: float(v) for n, v in layers.items()}
                        for g, layers in stats.get("per_layer", {}).items()}
    return out


def _worker(rank, n, path):
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition
    from tpu_ddp_torch.train.optim import decay_mask
    from tpu_ddp_torch.train.optim import make_optimizer as port_make_optimizer
    from tpu_ddp_torch.train.state import create_train_state as port_create_state
    from tpu_ddp_torch.train.steps import make_train_step

    init = torch.load(f"{path}/init.pt")
    result = {}
    for case, (use_zero1, mode, ef) in CASES.items():
        model = NetResDeep(**MODEL)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        tx = port_make_optimizer(kernels=True, decay_mask=decay_mask(params) if use_zero1 else None,
                                 zero1_axis=DATA_AXIS if use_zero1 else None, **OPT)
        zero1 = Zero1Partition(tx, params, n) if use_zero1 else None
        state = port_create_state(model, tx, torch.device("cpu"), zero1=zero1)
        comp, seen = None, {}
        if mode is not None:
            comp = GradCompressor(GradCompression(mode=mode, block=64, error_feedback=ef,
                                                  kernels=True), state.params(), n)
            if ef:
                state.grad_residual = comp.init_residual(torch.device("cpu"))
            ring, apply = comp.all_reduce_mean, tx.apply

            def all_reduce_mean(*a, **kw):
                grads, err = ring(*a, **kw)
                seen["grads"] = {k: v.clone() for k, v in grads.items()}
                seen["err_sq"] = float(comp.local_error_sq(err))
                return grads, err

            def tx_apply(*a, **kw):
                seen["params"] = {k: v.clone() for k, v in a[2].items()}
                updates = apply(*a, **kw)
                seen["updates"] = {k: v.clone() for k, v in updates.items()}
                return updates

            comp.all_reduce_mean, tx.apply = all_reduce_mean, tx_apply
        step = make_train_step(tx, compress=comp, zero1=zero1,
                               health=HealthConfig(per_layer=True, skip_nonfinite=True))
        rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
        out = {"stats": [], "trees": []}
        for i, batch in enumerate(_batches()):
            if i == NAN_STEP:
                out["before"] = snapshot(state)
            state, metrics = step(state, {k: torch.as_tensor(v[rows]) for k, v in batch.items()})
            out["stats"].append(_host(metrics["health"]))
            out["trees"].append(dict(seen))
            if i == NAN_STEP:
                out["after"] = snapshot(state)
        out["step"] = int(state.step)
        out["model"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        result[case] = out
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    model = FlaxNetResDeep(**MODEL)
    tx = make_optimizer(**OPT)
    init = create_train_state(model, tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=N), devices[:N])
    step = jax_make_train_step(model, tx, mesh, donate=False,
                               health=JaxHealthConfig(per_layer=True, skip_nonfinite=True))
    s = jax.device_put(init, replicated_sharding(mesh))
    j_stats = []
    for batch in _batches():
        s, m = step(s, jax.device_put(batch, batch_sharding(mesh)))
        j_stats.append(jax.device_get(m["health"]))
    want = convert_tree(jax.device_get(s.params))
    want.update(convert_tree(jax.device_get(s.batch_stats)))
    path = tmp_path_factory.mktemp("health_ranks")
    torch.save(from_jax(*jax.device_get((init.params, init.batch_stats)))["model"],
               path / "init.pt")
    spawn(_worker, N, str(path), init_file=str(path / "rdzv"), timeout=300)
    return {"jax_stats": j_stats, "jax_model": want,
            "port": [torch.load(path / f"rank{r}.pt") for r in range(N)]}


def _same_floats(a, b):
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_nan=True)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_report_the_same_stats(runs, case):
    a, b = (r[case]["stats"] for r in runs["port"])
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k == "per_layer":
                for g in x[k]:
                    assert _same_floats(list(x[k][g].values()), list(y[k][g].values())), g
            else:
                assert _same_floats(x[k], y[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_nan_step_skipped_on_every_rank(runs, case):
    for rank in range(N):
        got = runs["port"][rank][case]
        h = got["stats"][NAN_STEP]
        assert not h["all_finite"] and not h["grads_finite"]
        assert_bitwise(got["before"], got["after"])
        assert all(s["all_finite"] for i, s in enumerate(got["stats"]) if i != NAN_STEP)
        assert got["step"] == 3
        assert all(bool(torch.isfinite(v).all()) for v in got["model"].values())
    a, b = (r[case]["model"] for r in runs["port"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["replicated", "zero1"])
def test_stats_and_params_match_the_jax_step(runs, case):
    got = runs["port"][0][case]
    for mine, want in zip(got["stats"], runs["jax_stats"]):
        for k in FLAGS:
            assert bool(mine[k]) == bool(want[k]), k
        if bool(want["all_finite"]):
            assert_stats_match(mine, want)
    for name, w in runs["jax_model"].items():
        np.testing.assert_allclose(got["model"][name].numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["int8", "int8_ef"])
def test_int8_stats_match_jax_health_stats(runs, case):
    import jax.numpy as jnp

    for i in range(3):
        if i == NAN_STEP:
            continue
        mine = runs["port"][0][case]["stats"][i]
        trees = runs["port"][0][case]["trees"][i]
        j = lambda tree: {n: jnp.asarray(v.detach().numpy()) for n, v in tree.items()}  # noqa: E731
        want = jax_stats.health_stats(
            loss=jnp.float32(mine["loss"]), grads=j(trees["grads"]), params=j(trees["params"]),
            updates=j(trees["updates"]), per_layer=True,
            compress_error_sq=jnp.float32(sum(r[case]["trees"][i]["err_sq"]
                                              for r in runs["port"])))
        want = jax.device_get(want)
        for k in NORMS + ("compress_error_norm",):
            np.testing.assert_allclose(mine[k], float(want[k]), rtol=1e-5, err_msg=k)
        for k in FLAGS:
            assert mine[k] == bool(want[k]), k
        for group, layers in want["per_layer"].items():
            for name, w in layers.items():
                np.testing.assert_allclose(mine["per_layer"][group][name], float(w),
                                           rtol=1e-5, err_msg=f"{group}/{name}")
        assert np.isfinite(mine["compress_error_norm"]) and mine["compress_error_norm"] > 0
