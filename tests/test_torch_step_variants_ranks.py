"""The step variants on two CPU ranks over gloo: the fused K-step call
(``train/steps.py::scan``) and the accumulating step
(``make_grad_accum_train_step``), plain, under ``--zero1`` and under
``--grad-compress int8`` with error feedback, with K1 (``kernels=True``;
K1, K2 and K3 take their plain versions on the CPU), against the JAX
package on a 2-device CPU mesh. A small NetResDeep (6 channels, 2 tied
blocks, 7 classes: no leaf divides evenly by 2, so ZeRO-1's pad mask runs),
SGD with momentum, K = 4, 8 rows a rank, from the same weights on the same
numpy batches.

* Replicas bitwise equal after every run.
* The scan bitwise K single steps on the same ranks (losses and model), in
  every mode.
* Plain and ZeRO-1 against the JAX ``make_scan_train_step`` and
  ``make_grad_accum_train_step`` on the 2-device mesh (replicated: the JAX
  ZeRO-1 and compressed steps fail shard_map's replication check under jax
  0.9, ``tests/test_torch_dp_step.py``; ZeRO-1's arithmetic is the
  replicated one): losses ``rtol=1e-5``, params and BatchNorm buffers
  ``atol=2e-6, rtol=1e-5``.
* int8 with error feedback, whose gradient no JAX step computes here: the
  first loss ``rtol=1e-5`` of the JAX step's (it is taken before any
  update), and each param after the first step within the ring's
  quantization error of the JAX step's: two rounding steps of a block
  scale, ``2 * max|dp| / 127`` of the leaf's JAX update ``dp`` (momentum's
  first step is ``lr * g``); the ring itself is held bitwise to the JAX
  ``GradCompressor`` in ``tests/test_torch_flat_ring.py``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding, stacked_batch_sharding
from tpu_ddp.train import create_train_state, make_optimizer
from tpu_ddp.train.steps import make_grad_accum_train_step as jax_make_accum
from tpu_ddp.train.steps import make_scan_train_step as jax_make_scan
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax

N = 2
PER_RANK = 8
K = 4
MODEL = dict(n_chans1=6, n_blocks=2, num_classes=7)
OPT = dict(lr=5e-2, momentum=0.9)
#: mode -> (zero1, compression mode, error feedback)
MODES = {"plain": (False, None, False), "zero1": (True, None, False),
         "int8_ef": (False, "int8", True)}
ACCUM_STEPS = 2
PARAMS_TOL = dict(atol=2e-6, rtol=1e-5)


def _batches(n_steps):
    from tpu_ddp.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(n_steps * N * PER_RANK, num_classes=7, seed=6)
    out = []
    for i in range(n_steps):
        sl = slice(i * N * PER_RANK, (i + 1) * N * PER_RANK)
        mask = np.ones(N * PER_RANK, bool)
        if i == n_steps - 1:
            mask[PER_RANK - 3:PER_RANK] = False        # rank 0's last rows masked
        out.append({"image": np.array(images[sl]), "label": labels[sl], "mask": mask})
    return out


def _stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _worker(rank, n, path):
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition
    from tpu_ddp_torch.train.optim import decay_mask
    from tpu_ddp_torch.train.optim import make_optimizer as port_make_optimizer
    from tpu_ddp_torch.train.state import create_train_state as port_create_state
    from tpu_ddp_torch.train.steps import make_grad_accum_train_step, make_train_step, scan

    init = torch.load(f"{path}/init.pt")
    rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)

    def build(mode, accum=False):
        use_zero1, comp_mode, ef = MODES[mode]
        model = NetResDeep(**MODEL)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        tx = port_make_optimizer(kernels=True, decay_mask=decay_mask(params) if use_zero1
                                 else None, zero1_axis=DATA_AXIS if use_zero1 else None, **OPT)
        zero1 = Zero1Partition(tx, params, n) if use_zero1 else None
        state = port_create_state(model, tx, torch.device("cpu"), zero1=zero1)
        comp = None
        if comp_mode is not None:
            comp = GradCompressor(GradCompression(mode=comp_mode, block=64, error_feedback=ef,
                                                  kernels=True), state.params(), n)
            if ef:
                state.grad_residual = comp.init_residual(torch.device("cpu"))
        if accum:
            return state, make_grad_accum_train_step(tx, accum_steps=K, compress=comp,
                                                     zero1=zero1)
        return state, make_train_step(tx, compress=comp, zero1=zero1)

    def mine(batch, stacked=False):
        return {k: torch.as_tensor(v[:, rows] if stacked else v[rows])
                for k, v in batch.items()}

    result = {}
    for mode in MODES:
        state, step = build(mode)
        state, m = scan(step, K)(state, mine(_stacked(_batches(K)), stacked=True))
        out = {"scan_losses": m["loss"].tolist(),
               "scan_model": {k: v.clone() for k, v in state.model.state_dict().items()}}
        state, step = build(mode)
        losses = []
        for b in _batches(K):
            state, m = step(state, mine(b))
            losses.append(float(m["loss"]))
        out["single_losses"] = losses
        out["single_model"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, step = build(mode, accum=True)
        losses, models = [], []
        for b in _batches(ACCUM_STEPS):
            state, m = step(state, mine(b))
            losses.append(float(m["loss"]))
            models.append({k: v.clone() for k, v in state.model.state_dict().items()})
        out["accum_losses"], out["accum_models"] = losses, models
        result[mode] = out
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    model = FlaxNetResDeep(**MODEL)
    tx = make_optimizer(**OPT)
    init = create_train_state(model, tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=N), devices[:N])
    s = jax.device_put(init, replicated_sharding(mesh))
    j_scan = jax_make_scan(model, tx, mesh, steps_per_call=K, donate=False)
    s_scan, m = j_scan(s, jax.device_put(_stacked(_batches(K)), stacked_batch_sharding(mesh)))
    scan_out = {"losses": np.asarray(m["loss"]).tolist(), "model": _model(s_scan)}
    j_accum = jax_make_accum(model, tx, mesh, accum_steps=K, donate=False)
    s_acc, losses, models = s, [], []
    for b in _batches(ACCUM_STEPS):
        s_acc, m = j_accum(s_acc, jax.device_put(b, batch_sharding(mesh)))
        losses.append(float(m["loss"]))
        models.append(_model(s_acc))
    path = tmp_path_factory.mktemp("variants_ranks")
    init_model = from_jax(*jax.device_get((init.params, init.batch_stats)))["model"]
    torch.save(init_model, path / "init.pt")
    spawn(_worker, N, str(path), init_file=str(path / "rdzv"), timeout=300)
    return {"jax_scan": scan_out, "jax_accum": {"losses": losses, "models": models},
            "init": init_model,
            "port": [torch.load(path / f"rank{r}.pt") for r in range(N)]}


def _model(state):
    out = convert_tree(jax.device_get(state.params))
    out.update(convert_tree(jax.device_get(state.batch_stats)))
    return out


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", list(MODES))
def test_replicas_bitwise(runs, mode):
    a, b = (r[mode] for r in runs["port"])
    assert _same(a["scan_model"], b["scan_model"])
    assert _same(a["single_model"], b["single_model"])
    assert all(_same(x, y) for x, y in zip(a["accum_models"], b["accum_models"]))
    assert a["scan_losses"] == b["scan_losses"] and a["accum_losses"] == b["accum_losses"]


@pytest.mark.parametrize("mode", list(MODES))
def test_scan_bitwise_single_steps_on_ranks(runs, mode):
    got = runs["port"][0][mode]
    assert got["scan_losses"] == got["single_losses"]
    assert _same(got["scan_model"], got["single_model"])


def _close(got, want, **tol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("mode", ["plain", "zero1"])
def test_scan_matches_jax_on_two_devices(runs, mode):
    got, want = runs["port"][0][mode], runs["jax_scan"]
    np.testing.assert_allclose(got["scan_losses"], want["losses"], rtol=1e-5)
    _close(got["scan_model"], want["model"], **PARAMS_TOL)


@pytest.mark.parametrize("mode", ["plain", "zero1"])
def test_accum_matches_jax_on_two_devices(runs, mode):
    got, want = runs["port"][0][mode], runs["jax_accum"]
    np.testing.assert_allclose(got["accum_losses"], want["losses"], rtol=1e-5)
    for mine, theirs in zip(got["accum_models"], want["models"]):
        _close(mine, theirs, **PARAMS_TOL)


def test_int8_within_the_rings_quantization_error(runs):
    got = runs["port"][0]["int8_ef"]
    for losses, want in ((got["scan_losses"], runs["jax_scan"]["losses"]),
                         (got["accum_losses"], runs["jax_accum"]["losses"])):
        np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
        assert np.isfinite(losses).all()
    init, want = runs["init"], runs["jax_accum"]["models"][0]
    mine = got["accum_models"][0]
    for name, w in want.items():
        w = np.asarray(w)
        if name.endswith(("running_mean", "running_var")):   # no gradient in them
            np.testing.assert_allclose(mine[name].numpy(), w, err_msg=name, **PARAMS_TOL)
            continue
        dp = np.abs(w - init[name].numpy()).max()
        err = np.abs(mine[name].numpy() - w).max()
        assert err <= 2 * dp / 127 + 1e-6, (name, err, dp)
