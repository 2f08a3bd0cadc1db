"""Sequence parallelism in the port (``parallel/sequence_parallel.py``,
``train/strategy.py``, ``parallel/mesh.py``) against the JAX package's
``make_sp_train_step`` on a data=2 x sequence=2 grid.

A small ViT (patch 4, hidden 64, depth 2, 2 heads, 10 classes) starts from
the JAX init (carried across by ``from_jax``) and takes three steps of SGD
(lr 0.05, momentum 0.9, ``kernels=True``: K1's plain version on the CPU)
on the same numpy batches of 16 images, with the flight recorder on
(per-layer norms). The JAX step runs on 4 of the conftest's CPU devices;
the port on 4 gloo ranks, rank r at data index ``r // 2`` and sequence
index ``r % 2``, each with its data shard's 8 rows cut to its stripe of 16
image rows. Both the plain ring and ``sp_flash`` (K4-K6's plain versions on
the CPU; the JAX flash ring takes its jnp tile there):

* losses ``rtol=1e-5`` and params after step 3 ``rtol=1e-5`` (``atol=1e-6``
  for the entries near zero) against JAX, health stats ``rtol=1e-5``
  (``tests/test_torch_health_steps.py``'s check); the four replicas equal
  to the bit;
* the port's SP step against its own one-rank data-parallel step on the
  whole 16-image batch (the same global batch): losses and params within
  the same tolerances;
* the grid: rank r at ``(r // 2, r % 2)``, its ring and its data group;
* the trainer under ``--parallelism sp --mesh data=2,sequence=2``: a run cut
  after epoch 1 and resumed ends bitwise equal to the uncut run;
* the guards: JAX's messages word for word for ``--remat`` and
  ``--grad-accum-steps`` under sp, and for ``--zero3`` with a parallelism;
  ``--zero1`` and ``--grad-compress`` under sp and the GSPMD families
  pass them, pp takes the ViT and ep refuses it.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_health_steps import assert_stats_match

VIT = dict(patch_size=4, hidden_dim=64, depth=2, num_heads=2, num_classes=10)
OPT = dict(lr=0.05, momentum=0.9)
DATA, SEQ = 2, 2
ROWS = 8                      # a data shard's rows a step
N_STEPS = 3
TILES = ("plain", "flash")


def _batches():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(N_STEPS * DATA * ROWS, 10, seed=5)
    n = DATA * ROWS
    return [{"image": np.asarray(images[i * n:(i + 1) * n], np.float32),
             "label": np.asarray(labels[i * n:(i + 1) * n]),
             "mask": np.ones(n, bool)} for i in range(N_STEPS)]


def _host(stats):
    out = {k: float(v) for k, v in stats.items() if k != "per_layer"}
    out["per_layer"] = {g: {n: float(v) for n, v in layers.items()}
                        for g, layers in stats.get("per_layer", {}).items()}
    return out


def _jax_run(flash, devices):
    from tpu_ddp.health import HealthConfig
    from tpu_ddp.models.vit import ViT
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel.sequence_parallel import make_sp_train_step
    from tpu_ddp.train import create_train_state, make_optimizer
    from tpu_ddp_torch.checkpoint.convert import convert_tree

    kw = dict(patch_size=4, hidden_dim=64, depth=2, num_heads=2, num_classes=10)
    tx = make_optimizer(kernels=False, **OPT)
    state = create_train_state(ViT(**kw), tx, jax.random.key(0))
    init = jax.device_get(state.params)
    mesh = create_mesh(MeshSpec(data=DATA, sequence=SEQ), devices[:DATA * SEQ])
    step = make_sp_train_step(ViT(**kw, sp_axis="sequence", sp_flash=flash), tx, mesh,
                              donate=False, health=HealthConfig(per_layer=True))
    losses, stats = [], []
    for batch in _batches():
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        stats.append(jax.device_get(metrics["health"]))
    return init, losses, stats, convert_tree(jax.device_get(state.params))


@pytest.fixture(scope="module")
def jax_runs(devices):
    return {tile: _jax_run(tile == "flash", devices) for tile in TILES}


def _trainer_config(path, epochs, resume=False):
    from tpu_ddp_torch.train.trainer import TrainConfig

    return TrainConfig(device="cpu", synthetic_data=True, synthetic_size=32,
                       per_shard_batch=4, model="vit_s4", optimizer="adamw", lr=1e-3,
                       kernels=True, parallelism="sp", mesh={"data": DATA, "sequence": SEQ},
                       sp_flash=True, epochs=epochs, checkpoint_dir=path,
                       checkpoint_every_epochs=1, log_every_epochs=1, resume=resume,
                       prefetch_depth=0)


def _worker(rank, n, path):
    import torch.distributed as dist

    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.sequence_parallel import image_stripe, make_sp_train_step
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.trainer import Trainer

    mesh = create_mesh({"data": DATA, "sequence": SEQ})
    assert (mesh.data_index, mesh.sequence_index) == (rank // SEQ, rank % SEQ)
    d, s = rank // SEQ, rank % SEQ
    assert dist.get_process_group_ranks(mesh.sequence_group()) == [d * SEQ + i for i in range(SEQ)]
    assert dist.get_process_group_ranks(mesh.data_group()) == [s + SEQ * i for i in range(DATA)]
    rows = slice(mesh.data_index * ROWS, (mesh.data_index + 1) * ROWS)
    result = {}
    for tile in TILES:
        model = ViT(**VIT)
        model.load_state_dict(torch.load(f"{path}/init_{tile}.pt"))
        tx = make_optimizer(kernels=True, **OPT)
        state = create_train_state(model, tx, torch.device("cpu"))
        step = make_sp_train_step(tx, mesh, sp_flash=tile == "flash",
                                  health=HealthConfig(per_layer=True))
        losses, stats = [], []
        for batch in _batches():
            local = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
            local["image"] = image_stripe(local["image"], mesh, 4)
            state, metrics = step(state, local)
            losses.append(float(metrics["loss"]))
            stats.append(_host(metrics["health"]))
        assert model.sp_group is None            # the plain module between steps
        result[tile] = {"losses": losses, "stats": stats,
                        "params": {k: v.clone() for k, v in model.state_dict().items()}}
    # the trainer: uncut, then cut after epoch 1 and resumed
    runs = {}
    for name, cuts in (("uncut", (2,)), ("resumed", (1, 2))):
        for i, epochs in enumerate(cuts):
            trainer = Trainer(_trainer_config(f"{path}/ck_{name}", epochs, resume=i > 0))
            trainer.run()
            runs[name] = {k: v.clone() for k, v in trainer.model_state().items()}
            if name == "uncut":
                result["predict"] = [torch.from_numpy(x) for x in trainer.predict()]
                result["evaluate"] = trainer.evaluate()
            trainer.close()
    result["trainer"] = runs
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    from tpu_ddp_torch.checkpoint.convert import convert_tree
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("sp_ranks")
    for tile, (init, *_) in jax_runs.items():
        torch.save(convert_tree(init), path / f"init_{tile}.pt")
    spawn(_worker, DATA * SEQ, str(path), init_file=str(path / "rdzv"), timeout=400)
    return [torch.load(path / f"rank{r}.pt") for r in range(DATA * SEQ)]


def _close_params(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("tile", TILES)
def test_sp_step_matches_jax(ranks, jax_runs, tile):
    _, j_losses, j_stats, j_params = jax_runs[tile]
    got = ranks[0][tile]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    _close_params(got["params"], j_params)
    for g, w in zip(got["stats"], j_stats):
        assert_stats_match(g, w)


@pytest.mark.parametrize("tile", TILES)
def test_sp_replicas_bitwise(ranks, tile):
    for r in ranks[1:]:
        assert r[tile]["losses"] == ranks[0][tile]["losses"]
        for k, v in ranks[0][tile]["params"].items():
            assert torch.equal(r[tile]["params"][k], v), k


def test_sp_step_matches_dp_step(ranks, jax_runs):
    """The port's SP step against its own one-rank DP step on the global
    batch of 16."""
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import make_train_step
    from tpu_ddp_torch.checkpoint.convert import convert_tree

    model = ViT(**VIT)
    model.load_state_dict(convert_tree(jax_runs["flash"][0]))
    tx = make_optimizer(kernels=True, **OPT)
    state = create_train_state(model, tx, torch.device("cpu"))
    step = make_train_step(tx)
    losses = []
    for batch in _batches():
        state, metrics = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(ranks[0]["flash"]["losses"], losses, rtol=1e-5)
    _close_params(ranks[0]["flash"]["params"], model.state_dict())


def test_sp_resume_bitwise(ranks):
    for r in ranks:
        uncut, resumed = r["trainer"]["uncut"], r["trainer"]["resumed"]
        for k, v in uncut.items():
            assert torch.equal(resumed[k], v), k
    for k, v in ranks[0]["trainer"]["uncut"].items():
        assert all(torch.equal(r["trainer"]["uncut"][k], v) for r in ranks[1:]), k


def test_sp_predict_and_evaluate(ranks):
    """``predict`` and ``evaluate`` under sp run the plain module on whole
    images, each data shard's rows once: the same on every rank, and equal
    to the plain module's logits, loss and accuracy from the final params
    on the whole test set, rows in the sampler's order."""
    from tpu_ddp_torch.data.loader import ShardedBatchLoader
    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.train.losses import cross_entropy_loss
    from tpu_ddp_torch.train.trainer import load_dataset

    logits, labels = (t.numpy() for t in ranks[0]["predict"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["predict"][0].numpy(), logits)
        assert r["evaluate"] == ranks[0]["evaluate"]
    _, (images, test_labels) = load_dataset(_trainer_config("unused", 1))
    loader = ShardedBatchLoader(images, test_labels, world_size=DATA, per_shard_batch=4,
                                shuffle=False, exclude_sampler_pad=True)
    index = list(loader.epoch_index_batches(epoch=0))
    order = np.concatenate([i for i, _ in index])[np.concatenate([m for _, m in index])]
    model = MODEL_REGISTRY["vit_s4"](num_classes=10)
    model.load_state_dict(ranks[0]["trainer"]["uncut"])
    model.eval()
    with torch.no_grad():
        want = model(torch.as_tensor(np.asarray(images), dtype=torch.float32))
    np.testing.assert_array_equal(labels, np.asarray(test_labels)[order])
    np.testing.assert_allclose(logits, want.numpy()[order], rtol=1e-5, atol=1e-5)
    acc, loss = ranks[0]["evaluate"]
    y = torch.as_tensor(np.asarray(test_labels))
    np.testing.assert_allclose(loss, float(cross_entropy_loss(want, y)), rtol=1e-5)
    assert acc == float((want.argmax(-1) == y).float().mean())


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("flag", ["remat", "grad_accum_steps"])
def test_remat_guard_matches_jax(devices, flag):
    from tpu_ddp.models.vit import ViT as FlaxViT
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.train import make_optimizer as jax_make_optimizer
    from tpu_ddp.train.strategy import build_strategy as jax_build_strategy
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.train.strategy import check_strategy

    kw = {"remat": True} if flag == "remat" else {"grad_accum_steps": 2}
    mesh = create_mesh(MeshSpec(data=4, sequence=2), devices)
    want = _jax_error(lambda: jax_build_strategy(
        "sp", mesh, FlaxViT(depth=1, hidden_dim=32, num_heads=2),
        jax_make_optimizer(lr=0.1), jax.random.key(0), **kw))
    got = _jax_error(lambda: check_strategy("sp", ViT(**VIT), **kw))
    assert got == want


@pytest.mark.parametrize("parallelism", ["sp", "tp", "pp"])
def test_zero3_guard_matches_jax(parallelism):
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
    from tpu_ddp_torch.train.trainer import TrainConfig

    want = _jax_error(lambda: JaxTrainConfig(zero3=True, parallelism=parallelism).validate())
    got = _jax_error(lambda: TrainConfig(device="cpu", zero3=True, parallelism=parallelism))
    assert got == want


@pytest.mark.parametrize("overlay", [{"zero1": True}, {"grad_compress": {"mode": "int8"}}],
                         ids=["zero1", "grad_compress"])
def test_sp_overlays_deferred(overlay):
    """The overlays were deferred under sp until they ran over the data
    group; now the guards pass them and the step builds with them
    (``tests/test_torch_sp_overlays.py`` holds their arithmetic)."""
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.sequence_parallel import make_sp_train_step
    from tpu_ddp_torch.train.strategy import check_strategy

    check_strategy("sp", ViT(**VIT), **overlay)
    assert callable(make_sp_train_step(None, create_mesh(), **{
        "zero1" if "zero1" in overlay else "compress": object()}))


@pytest.mark.parametrize("parallelism", ["fsdp", "tp", "fsdp_tp", "pp", "ep"])
def test_unported_families_raise(parallelism):
    """Every family is ported: fsdp, tp, fsdp_tp and pp take the ViT; ep
    raises on it, naming the MoE ViT it needs
    (``tests/test_torch_pp_ep_cli.py`` holds the message to JAX's)."""
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.train.strategy import check_strategy

    if parallelism != "ep":
        check_strategy(parallelism, ViT(**VIT))
        return
    with pytest.raises(ValueError, match="needs a MoEViT model"):
        check_strategy(parallelism, ViT(**VIT))


def test_sp_needs_a_vit():
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.train.strategy import check_strategy

    with pytest.raises(ValueError, match="needs a ViT model"):
        check_strategy("sp", NetResDeep(n_chans1=4, n_blocks=1))


@pytest.mark.parametrize("flag", ["augment", "mixup_alpha", "sync_bn"])
def test_trainer_dp_only_flags(flag):
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    value = 0.2 if flag == "mixup_alpha" else True
    name = "--" + flag.replace("_", "-")
    config = dataclasses.replace(
        TrainConfig(device="cpu", synthetic_data=True, synthetic_size=32, model="vit_s4",
                    parallelism="sp", mesh={"sequence": 1}), **{flag: value})
    with pytest.raises(ValueError) as e:
        Trainer(config)
    assert str(e.value) == f"{name} is only supported with data parallelism (got --parallelism sp)"


def test_image_stripe():
    from tpu_ddp_torch.parallel.mesh import Mesh
    from tpu_ddp_torch.parallel.sequence_parallel import image_stripe

    x = torch.arange(2 * 32 * 32 * 3, dtype=torch.float32).view(2, 32, 32, 3)
    parts = [image_stripe(x, Mesh(1, 4, r), 4) for r in range(4)]
    assert all(p.shape == (2, 8, 32, 3) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), x)
    with pytest.raises(ValueError, match="must divide by patch 4 x 3"):
        image_stripe(x, Mesh(1, 3, 0), 4)
