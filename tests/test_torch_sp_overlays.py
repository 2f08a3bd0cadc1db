"""``--zero1`` and ``--grad-compress`` under sequence parallelism
(``parallel/sequence_parallel.py``, ``train/lm_steps.py``,
``train/strategy.py``), on a data=2 x sequence=2 grid of gloo CPU ranks.

The JAX zero1 step fails shard_map's replication check under jax 0.9
(``tests/test_torch_zero1.py``'s docstring), so the oracle here is the
port's own replicated SP step, which ``tests/test_torch_sequence_parallel.py``
and ``tests/test_torch_sp_lm.py`` hold to the JAX SP steps:

* the ViT (patch 4, hidden 64, depth 2, 2 heads) three SGD steps with
  momentum, clip, decay and EMA, ``kernels=True`` (K1's masked plain version on the
  CPU), the flight recorder on: ``--zero1`` within ``rtol=1e-5`` of the
  replicated step (losses, params, the health scalars); int8 with error
  feedback (K2/K3's plain versions) within the band ``chip_smoke.py`` holds DP's
  compressed ring to (phase 12),
  0.05 on the losses, over float32 ``--zero1``; the four replicas' params
  bitwise in every run, and the optimizer state bitwise over the sequence
  ring;
* the LM (vocab 32, hidden 32, depth 2, 2 heads, T = 16) three steps
  under ``--zero1`` and under int8 against its replicated SP step;
* the ring over the data group bitwise the default-group ring of 2 ranks
  on the same inputs (``GradCompressor.all_reduce_mean`` with its residual,
  ``Zero1Partition.reduce_scatter_mean``);
* the trainer under ``--parallelism sp --zero1 --grad-compress int8
  --grad-compress-error-feedback``: cut after epoch 1 and resumed, bitwise
  the uncut run, its checkpoint in the replicated layout.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

VIT = dict(patch_size=4, hidden_dim=64, depth=2, num_heads=2, num_classes=10)
LM = dict(vocab_size=32, hidden_dim=32, depth=2, num_heads=2, seq_len=16)
DATA, SEQ = 2, 2
ROWS = 4
N_STEPS = 3
# SGD: AdamW would scale the key third of qkv.bias, whose gradient is float
# noise (softmax ignores a per-query constant), up to +-lr in either run
OPT = dict(lr=0.05, momentum=0.9, weight_decay=0.05, grad_clip_norm=0.5, ema_decay=0.9,
           kernels=True)
INT8_LOSS_ATOL = 0.05          # chip_smoke.py's band for DP's compressed ring
RUNS = ("replicated", "zero1", "int8", "zero1_int8")


def _images():
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10

    n = DATA * ROWS
    images, labels = synthetic_cifar10(N_STEPS * n, 10, seed=3)
    return [{"image": torch.as_tensor(np.asarray(images[i * n:(i + 1) * n], np.float32)),
             "label": torch.as_tensor(np.asarray(labels[i * n:(i + 1) * n])),
             "mask": torch.ones(n)} for i in range(N_STEPS)]


def _tokens():
    g = np.random.default_rng(4)
    return [torch.as_tensor(g.integers(0, LM["vocab_size"], (DATA * ROWS, LM["seq_len"])))
            for _ in range(N_STEPS)]


def _overlays(run, tx, params, mesh):
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import Zero1Partition

    part = comp = None
    if "zero1" in run:
        part = Zero1Partition(tx, params, mesh.data_size, group=mesh.data_group())
    if "int8" in run:
        comp = GradCompressor(GradCompression(mode="int8", error_feedback=True, kernels=True),
                              params, mesh.data_size, group=mesh.data_group())
        if part is not None:
            part.set_compression(comp)
    return part, comp


def _state(model, tx, part, comp):
    from tpu_ddp_torch.train.state import create_train_state

    state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
    if comp is not None:
        state.grad_residual = comp.init_residual(torch.device("cpu"))
    return state


def _opt_rows(state):
    from tpu_ddp_torch.train.state import SLOTS

    return {f"{slot}/{n}": t.clone() for slot in SLOTS
            for n, t in (getattr(state.opt_state, slot) or {}).items()}


def _vit_runs(mesh):
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.sequence_parallel import image_stripe, make_sp_train_step
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

    rows = slice(mesh.data_index * ROWS, (mesh.data_index + 1) * ROWS)
    out = {}
    for run in RUNS:
        model = ViT(**VIT)
        sharded = "zero1" in run
        tx = make_optimizer(**OPT, zero1_axis="data" if sharded else None,
                            decay_mask=decay_mask(dict(model.named_parameters())))
        part, comp = _overlays(run, tx, dict(model.named_parameters()), mesh)
        state = _state(model, tx, part, comp)
        step = make_sp_train_step(tx, mesh, health=HealthConfig(), zero1=part, compress=comp)
        losses, stats = [], []
        for batch in _images():
            local = {k: v[rows] for k, v in batch.items()}
            local["image"] = image_stripe(local["image"], mesh, VIT["patch_size"])
            state, metrics = step(state, local)
            losses.append(float(metrics["loss"]))
            stats.append({k: float(v) for k, v in metrics["health"].items()})
        out[run] = {"losses": losses, "stats": stats, "opt": _opt_rows(state),
                    "params": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


def _lm_runs(mesh):
    from tpu_ddp_torch.models.lm import CausalTransformerLM
    from tpu_ddp_torch.train.lm_steps import make_sp_lm_train_step
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

    rows = slice(mesh.data_index * ROWS, (mesh.data_index + 1) * ROWS)
    t = LM["seq_len"] // SEQ
    cols = slice(mesh.sequence_index * t, (mesh.sequence_index + 1) * t)
    out = {}
    for run in ("replicated", "zero1", "int8"):
        model = CausalTransformerLM(**LM)
        tx = make_optimizer(**OPT, zero1_axis="data" if run == "zero1" else None,
                            decay_mask=decay_mask(dict(model.named_parameters())))
        part, comp = _overlays(run, tx, dict(model.named_parameters()), mesh)
        state = _state(model, tx, part, comp)
        step = make_sp_lm_train_step(tx, mesh, zero1=part, compress=comp)
        losses = []
        for tokens in _tokens():
            state, metrics = step(state, {"tokens": tokens[rows, cols].contiguous()})
            losses.append(float(metrics["loss"]))
        out[run] = {"losses": losses,
                    "params": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


def _rings(mesh, default_group: bool):
    """The data ring and the partition's reduce-scatter on inputs seeded by
    the data index; over ``mesh.data_group()``, or with ``default_group``
    over the default group of a 2-rank world."""
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train.optim import make_optimizer

    group = None if default_group else mesh.data_group()
    template = dict(ViT(**VIT).named_parameters())
    g = torch.Generator().manual_seed(10 + mesh.data_index)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in template.items()}
    comp = GradCompressor(GradCompression(mode="int8", error_feedback=True), template,
                          DATA, group=group)
    residual = comp.init_residual(torch.device("cpu"))
    for n, r in residual.items():
        r.copy_(torch.randn(r.shape, generator=g) * 1e-3)
    mean, err = comp.all_reduce_mean(grads, residual, with_error=True)
    part = Zero1Partition(make_optimizer(lr=0.1), template, DATA, group=group)
    shards, _ = part.reduce_scatter_mean(grads)
    return {"mean": mean, "err": {n: e.clone() for n, e in err.items()},
            "shards": {n: s.clone() for n, s in shards.items()}}


def _config(path, epochs, resume=False):
    from tpu_ddp_torch.train.trainer import TrainConfig

    return TrainConfig(device="cpu", synthetic_data=True, synthetic_size=32,
                       per_shard_batch=4, model="vit_s4", optimizer="adamw", lr=1e-3,
                       weight_decay=0.05, kernels=True, parallelism="sp",
                       mesh={"data": DATA, "sequence": SEQ}, sp_flash=True, zero1=True,
                       grad_compress="int8", grad_compress_error_feedback=True,
                       epochs=epochs, checkpoint_dir=path, checkpoint_every_epochs=1,
                       log_every_epochs=1, resume=resume, prefetch_depth=0)


def _trainer_runs(path):
    from tpu_ddp_torch.train.trainer import Trainer

    runs = {}
    for name, cuts in (("uncut", (2,)), ("resumed", (1, 2))):
        for i, epochs in enumerate(cuts):
            trainer = Trainer(_config(f"{path}/ck_{name}", epochs, resume=i > 0))
            assert trainer.layout.zero.group is trainer.mesh.data_group()
            trainer.run()
            runs[name] = {k: v.clone() for k, v in trainer.model_state().items()}
            trainer.close()
    flat = torch.load(f"{path}/ck_uncut/{max(int(p) for p in _steps(path))}/state.pt")
    runs["ckpt_shapes"] = {k: tuple(v.shape) for k, v in flat.items()
                           if hasattr(v, "shape")}
    return runs


def _steps(path):
    import os

    return [p for p in os.listdir(f"{path}/ck_uncut") if p.isdigit()]


def _worker(rank, n, path):
    from tpu_ddp_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"data": DATA, "sequence": SEQ})
    result = {"vit": _vit_runs(mesh), "lm": _lm_runs(mesh), "rings": _rings(mesh, False),
              "trainer": _trainer_runs(f"{path}/rank_shared")}
    torch.save(result, f"{path}/rank{rank}.pt")


def _pair_worker(rank, n, path):
    from tpu_ddp_torch.parallel.mesh import Mesh

    torch.save(_rings(Mesh(DATA, 1, rank), True), f"{path}/pair{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("sp_overlays")
    spawn(_worker, DATA * SEQ, str(path), init_file=str(path / "rdzv"), timeout=400)
    spawn(_pair_worker, DATA, str(path), init_file=str(path / "rdzv2"), timeout=120)
    return ([torch.load(path / f"rank{r}.pt") for r in range(DATA * SEQ)],
            [torch.load(path / f"pair{r}.pt") for r in range(DATA)])


def _close(got, want, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_sp_zero1_matches_replicated(ranks):
    got, want = ranks[0][0]["vit"]["zero1"], ranks[0][0]["vit"]["replicated"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["params"])
    for g, w in zip(got["stats"], want["stats"]):
        for key, value in w.items():
            np.testing.assert_allclose(g[key], value, rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("run", ["int8", "zero1_int8"])
def test_sp_int8_within_band(ranks, run):
    vit = ranks[0][0]["vit"]
    float_run = vit["zero1"] if run == "zero1_int8" else vit["replicated"]
    diff = np.abs(np.subtract(vit[run]["losses"], float_run["losses"]))
    assert diff.max() <= INT8_LOSS_ATOL
    assert all(np.isfinite(list(s.values())).all() for s in vit[run]["stats"])


@pytest.mark.parametrize("run", RUNS)
def test_sp_overlay_replicas_bitwise(ranks, run):
    """Every rank's params equal to the bit; the optimizer state (ZeRO-1's
    shards) equal over the sequence ring, where it is replicated."""
    rows = ranks[0]
    for r in rows[1:]:
        assert r["vit"][run]["losses"] == rows[0]["vit"][run]["losses"]
        for k, v in rows[0]["vit"][run]["params"].items():
            assert torch.equal(r["vit"][run]["params"][k], v), k
    for d in range(DATA):
        base = rows[d * SEQ]["vit"][run]["opt"]
        for s in range(1, SEQ):
            other = rows[d * SEQ + s]["vit"][run]["opt"]
            assert all(torch.equal(other[k], v) for k, v in base.items())


@pytest.mark.parametrize("run", ["zero1", "int8"])
def test_sp_lm_overlays(ranks, run):
    lm = ranks[0][0]["lm"]
    if run == "zero1":
        np.testing.assert_allclose(lm[run]["losses"], lm["replicated"]["losses"], rtol=1e-5)
        _close(lm[run]["params"], lm["replicated"]["params"])
    else:
        diff = np.abs(np.subtract(lm[run]["losses"], lm["replicated"]["losses"]))
        assert diff.max() <= INT8_LOSS_ATOL
    for r in ranks[0][1:]:
        for k, v in lm[run]["params"].items():
            assert torch.equal(r["lm"][run]["params"][k], v), k


@pytest.mark.parametrize("key", ["mean", "err", "shards"])
def test_data_group_ring_bitwise_default_group(ranks, key):
    rows, pair = ranks
    for rank, got in enumerate(rows):
        want = pair[rank // SEQ]
        for n, v in want[key].items():
            assert torch.equal(got["rings"][key][n], v), (rank, n)


def test_sp_overlay_trainer_resume_bitwise(ranks):
    for r in ranks[0]:
        uncut, resumed = r["trainer"]["uncut"], r["trainer"]["resumed"]
        for k, v in uncut.items():
            assert torch.equal(resumed[k], v), k
    # the checkpoint holds the replicated layout: whole optimizer slots
    shapes = ranks[0][0]["trainer"]["ckpt_shapes"]
    for name, shape in shapes.items():
        if name.startswith("opt/mu/"):
            assert shape == shapes["model/" + name[len("opt/mu/"):]], name
    assert shapes["grad_residual_rows"][0] == DATA
