"""``--sync-bn`` in the port (``models/resnet.py::sync_stats``) against the
JAX ``dp`` step with ``bn_cross_replica_axis="data"`` on a 2-device CPU
mesh: two gloo ranks train three steps (the last batch masked) of a small
NetResDeep (8 channels, 2 tied blocks) and of ResNet-18's structure at 8
filters, from the same weights (``checkpoint/convert.py::from_jax``) on the
same rows. Per-step losses, the params and the BatchNorm running buffers
within ``rtol 1e-5`` (``atol 1e-5`` where a value is near 0: the two
frameworks' CPU convolutions sum in other orders, as in
``tests/test_torch_dp_step.py``); replicas bitwise equal; one all-reduce a
BatchNorm call forward and one backward. The same ranks without sync BN
differ from the JAX run by more than that tolerance, which shows the sync
ran. At one rank, sync BN sends nothing and trains bitwise the unsynced
model."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.data.cifar10 import synthetic_cifar10
from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models import resnet_family as flax_family
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding
from tpu_ddp.train import create_train_state, make_optimizer
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax

N = 2
PER_RANK = 8
OPT = dict(lr=1e-2, momentum=0.9)
KINDS = ("netresdeep", "resnet18")
#: BatchNorm calls a forward: NetResDeep's one tied BN twice; ResNet-18's
#: stem, two a basic block, one a projection (3 of them)
BN_CALLS = {"netresdeep": 2, "resnet18": 1 + 2 * 8 + 3}


def _flax(kind, axis):
    if kind == "netresdeep":
        return FlaxNetResDeep(n_chans1=8, n_blocks=2, num_classes=7, bn_cross_replica_axis=axis)
    return flax_family.ResNet((2, 2, 2, 2), flax_family._BasicBlock, num_classes=7,
                              num_filters=8, bn_cross_replica_axis=axis)


def _port(kind, axis):
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.models import resnet_family as family

    if kind == "netresdeep":
        return NetResDeep(n_chans1=8, n_blocks=2, num_classes=7, bn_cross_replica_axis=axis)
    return family.ResNet((2, 2, 2, 2), family._BasicBlock, num_classes=7, num_filters=8,
                         bn_cross_replica_axis=axis)


def _batches():
    images, labels = synthetic_cifar10(3 * N * PER_RANK, num_classes=7, seed=11)
    out = []
    for i in range(3):
        sl = slice(i * N * PER_RANK, (i + 1) * N * PER_RANK)
        mask = np.ones(N * PER_RANK, bool)
        if i == 2:
            mask[PER_RANK - 2:PER_RANK] = False
            mask[2 * PER_RANK - 3:] = False
        out.append({"image": images[sl], "label": labels[sl], "mask": mask})
    return out


def _rows(batch, rank, n=N):
    per = len(batch["mask"]) // n
    return {k: torch.as_tensor(v[rank * per:(rank + 1) * per]) for k, v in batch.items()}


def _train(kind, axis, init, rank, n):
    from tpu_ddp_torch.models.resnet import SYNC_BN_COLLECTIVES
    from tpu_ddp_torch.train.optim import make_optimizer as port_make_optimizer
    from tpu_ddp_torch.train.state import create_train_state as port_create_state
    from tpu_ddp_torch.train.steps import make_train_step

    tx = port_make_optimizer(**OPT)
    state = port_create_state(_port(kind, axis), tx, torch.device("cpu"))
    state.model.load_state_dict(init)
    step = make_train_step(tx)
    SYNC_BN_COLLECTIVES.clear()
    losses = []
    for batch in _batches():
        state, metrics = step(state, _rows(batch, rank, n))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "collectives": dict(SYNC_BN_COLLECTIVES),
            "model": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _worker(rank, n, path):
    out = {}
    for kind in KINDS:
        init = torch.load(f"{path}/{kind}.pt")
        out[kind] = {"sync": _train(kind, "data", init, rank, n),
                     "local": _train(kind, None, init, rank, n)}
    torch.save(out, f"{path}/rank{rank}.pt")


def _jax_run(kind, devices):
    model = _flax(kind, "data")
    tx = make_optimizer(**OPT)
    state = create_train_state(model, tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=N), devices[:N])
    step = jax_make_train_step(model, tx, mesh, donate=False)
    s = jax.device_put(state, replicated_sharding(mesh))
    losses = []
    for batch in _batches():
        s, m = step(s, jax.device_put(batch, batch_sharding(mesh)))
        losses.append(float(m["loss"]))
    want = convert_tree(jax.device_get(s.params))
    want.update(convert_tree(jax.device_get(s.batch_stats)))
    return state, losses, want


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("sync_bn")
    jax_runs = {}
    for kind in KINDS:
        init, losses, want = _jax_run(kind, devices)
        jax_runs[kind] = (losses, want)
        torch.save(from_jax(*jax.device_get((init.params, init.batch_stats)))["model"],
                   path / f"{kind}.pt")
    spawn(_worker, N, str(path), init_file=str(path / "rdzv"), timeout=240)
    return {"jax": jax_runs, "port": [torch.load(path / f"rank{r}.pt") for r in range(N)],
            "path": path}


@pytest.mark.parametrize("kind", KINDS)
def test_sync_bn_matches_the_jax_dp_step(runs, kind):
    want_losses, want = runs["jax"][kind]
    got = runs["port"][0][kind]["sync"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert set(got["model"]) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got["model"][name].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_replicas_bitwise_and_one_collective_a_call(runs, kind):
    a, b = (r[kind]["sync"] for r in runs["port"])
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    calls = 3 * BN_CALLS[kind]
    assert a["collectives"] == {"forward": calls, "backward": calls}
    assert runs["port"][0][kind]["local"]["collectives"] == {}


@pytest.mark.parametrize("kind", KINDS)
def test_unsynced_ranks_differ_beyond_the_tolerance(runs, kind):
    want_losses, want = runs["jax"][kind]
    local = runs["port"][0][kind]["local"]
    rel = max(abs(g - w) / abs(w) for g, w in zip(local["losses"], want_losses))
    stats = [k for k in want if k.endswith("running_mean")]
    drift = max(float(np.max(np.abs(local["model"][k].numpy() - np.asarray(want[k]))))
                for k in stats)
    assert rel > 1e-5 and drift > 1e-4, (rel, drift)


@pytest.mark.parametrize("kind", KINDS)
def test_one_rank_sync_is_bitwise_unsynced(runs, kind):
    init = torch.load(runs["path"] / f"{kind}.pt")
    synced = _train(kind, "data", init, 0, 1)
    local = _train(kind, None, init, 0, 1)
    assert synced["losses"] == local["losses"]
    assert all(torch.equal(synced["model"][k], local["model"][k]) for k in local["model"])
    assert synced["collectives"] == {}
