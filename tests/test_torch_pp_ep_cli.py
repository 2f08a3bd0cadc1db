"""The pp and ep surface of the port's CLI and trainer against the JAX
package: the flags (``--microbatches``, ``--pp-schedule``, ``--aux-weight``,
``--model vit_moe_s4``/``vit_moe_s4_top2``), the guards' messages, and
trainer runs on two gloo CPU ranks.

* The new flags' names, defaults and choices equal ``tpu_ddp.cli.train``'s
  ``build_parser()``; the MoE models are in the registry and in ``--model``'s
  choices; the pp and expert mesh axes resolve as ``MeshSpec.resolve``.
* Each guard's message equals the JAX one: pp with ``--remat``, ``--zero1``
  or ``--grad-compress`` (``build_strategy`` :332-351); pp on NetResDeep and
  ep on a ViT (``_require_model``); a depth that does not divide into the
  stages (``make_pp_train_step`` :236); ``--attention flash`` on the MoE ViT
  (``build_model`` :569-574).
* Two ranks (``Trainer``, the CLI's path): ViT-S/4's narrow cousin under pp
  gpipe for two epochs with evaluation (the params gathered over the
  pipeline) and K1, finite and falling; 1f1b cut after one epoch with a
  checkpoint and resumed to two, bitwise the uninterrupted 1f1b run (params
  and the eval), and the gpipe run's losses within 1e-5 of 1f1b's; the MoE
  ViT under ep at ``expert=2`` one epoch with ``aux_loss`` in its metrics.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

VIT = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=2)


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, a.choices, a.help)
            for a in parser._actions}


@pytest.mark.parametrize("dest", ["microbatches", "pp_schedule", "aux_weight"])
def test_new_flags_match_jax(dest):
    from tpu_ddp.cli.train import build_parser as jax_parser
    from tpu_ddp_torch.cli.train import build_parser

    assert _flags(build_parser())[dest] == _flags(jax_parser())[dest]


def test_moe_models_registered():
    from tpu_ddp.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
    from tpu_ddp_torch.cli.train import build_parser
    from tpu_ddp_torch.models import MODEL_REGISTRY

    choices = _flags(build_parser())["model"][2]
    for name in ("vit_moe_s4", "vit_moe_s4_top2"):
        assert name in JAX_REGISTRY and name in MODEL_REGISTRY and name in choices
    model = MODEL_REGISTRY["vit_moe_s4_top2"](num_classes=10)
    moe = [m for m in model.modules() if hasattr(m, "num_experts")]
    assert [(m.num_experts, m.top_k) for m in moe] == [(8, 2)] * 3


@pytest.mark.parametrize("sizes", [{"data": 2, "pipeline": 4}, {"expert": 4},
                                   {"data": -1, "pipeline": 2, "expert": 2}])
def test_mesh_axes_resolve_as_jax(sizes):
    from tpu_ddp.parallel.mesh import MeshSpec
    from tpu_ddp_torch.parallel.mesh import resolve

    assert resolve(sizes, 8) == MeshSpec(**sizes).resolve(8)


def _jax_pp_error(devices, model=None, mesh_sizes=None, **kw):
    from tpu_ddp.models.vit import ViT as FlaxViT
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.train.optim import make_optimizer
    from tpu_ddp.train.strategy import build_strategy

    mesh = create_mesh(MeshSpec(**(mesh_sizes or {"data": 4, "pipeline": 2})), devices)
    return _jax_error(lambda: build_strategy(
        kw.pop("parallelism", "pp"), mesh, model or FlaxViT(depth=2, hidden_dim=32, num_heads=2),
        make_optimizer(lr=0.1), jax_key(), **kw))


def jax_key():
    import jax

    return jax.random.key(0)


@pytest.mark.parametrize("kw", [{"remat": True}, {"zero1": True},
                                {"grad_compress": {"mode": "int8"}}],
                         ids=["remat", "zero1", "grad_compress"])
def test_pp_guards_match_jax(devices, kw):
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.train.strategy import check_strategy

    want = _jax_pp_error(devices, **dict(kw))
    assert _jax_error(lambda: check_strategy("pp", ViT(**VIT), **kw)) == want


def test_pp_needs_a_vit(devices):
    from tpu_ddp.models.resnet import NetResDeep as FlaxNetResDeep
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.train.strategy import check_strategy

    want = _jax_pp_error(devices, model=FlaxNetResDeep(n_chans1=4, n_blocks=1))
    assert _jax_error(lambda: check_strategy("pp", NetResDeep(n_chans1=4, n_blocks=1))) == want


def test_ep_needs_the_moe_vit(devices):
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.train.strategy import check_strategy

    want = _jax_pp_error(devices, parallelism="ep", mesh_sizes={"data": 4, "expert": 2})
    assert _jax_error(lambda: check_strategy("ep", ViT(**VIT))) == want


def test_pp_depth_must_divide(devices):
    from tpu_ddp.models.vit import ViT as FlaxViT
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.mesh import Mesh
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    want = _jax_pp_error(devices, model=FlaxViT(depth=3, hidden_dim=32, num_heads=2),
                         mesh_sizes={"data": 2, "pipeline": 4})
    mesh = Mesh(1, 1, 0, pipeline_size=4)
    got = _jax_error(lambda: build_strategy("pp", mesh, ViT(**dict(VIT, depth=3)),
                                            make_optimizer(lr=0.1), torch.device("cpu")))
    assert got == want


def test_flash_on_the_moe_vit_raises_as_jax():
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
    from tpu_ddp.train.trainer import build_model as jax_build_model
    from tpu_ddp_torch.train.trainer import TrainConfig, build_model

    want = _jax_error(lambda: jax_build_model(JaxTrainConfig(model="vit_moe_s4",
                                                             attention="flash")))
    got = _jax_error(lambda: build_model(TrainConfig(device="cpu", model="vit_moe_s4",
                                                     attention="flash")))
    assert got == want


# ---- trainer runs on two gloo ranks ----------------------------------------------


def _config(model, parallelism, mesh, epochs, path=None, synthetic_size=64, **kw):
    from tpu_ddp_torch.train.trainer import TrainConfig

    return TrainConfig(device="cpu", synthetic_data=True, synthetic_size=synthetic_size,
                       per_shard_batch=16, model=model, optimizer="adamw", lr=1e-3,
                       kernels=True, parallelism=parallelism, mesh=mesh, epochs=epochs,
                       eval_each_epoch=True, log_every_epochs=1, prefetch_depth=0,
                       checkpoint_dir=path, checkpoint_every_epochs=1,
                       resume=path is not None and epochs > 1, **kw)


def _run(config):
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(config)
    aux, inner = [], trainer.train_step

    def step(state, batch):
        state, metrics = inner(state, batch)
        if "aux_loss" in metrics:
            aux.append(float(metrics["aux_loss"]))
        return state, metrics

    trainer.train_step = step
    out = trainer.run()
    out["aux"] = aux
    out["eval"] = trainer.evaluate()
    out["params"] = {k: v.clone() for k, v in trainer.model_state().items()}
    out["resumed"] = trainer.resumed_step
    out["line"] = trainer.strategy_line
    trainer.close()
    return out


def _trainer_worker(rank, n, path):
    from tpu_ddp_torch.models import MODEL_REGISTRY, ViT

    MODEL_REGISTRY["vit_tiny_pp"] = lambda num_classes=10, generator=None, **kw: ViT(
        **VIT, num_classes=num_classes, generator=generator)
    pp = {"data": 1, "pipeline": 2}
    out = {"gpipe": _run(_config("vit_tiny_pp", "pp", pp, 2)),
           "1f1b": _run(_config("vit_tiny_pp", "pp", pp, 2, pp_schedule="1f1b")),
           "1f1b_cut": _run(_config("vit_tiny_pp", "pp", pp, 1, f"{path}/ck",
                                    pp_schedule="1f1b")),
           "1f1b_resumed": _run(_config("vit_tiny_pp", "pp", pp, 2, f"{path}/ck",
                                        pp_schedule="1f1b")),
           "ep": _run(_config("vit_moe_s4", "ep", {"data": 1, "expert": 2}, 1,
                              synthetic_size=32))}
    torch.save(out, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("pp_ep_trainer")
    spawn(_trainer_worker, 2, str(path), init_file=str(path / "rdzv"), timeout=300)
    return [torch.load(path / f"rank{r}.pt") for r in range(2)]


def test_pp_trainer_trains_and_evaluates(trainer_runs):
    for r in trainer_runs:
        for name in ("gpipe", "1f1b"):
            run = r[name]
            assert run["steps"] == 8
            losses = run["step_losses"]
            assert all(np.isfinite(losses)) and np.mean(losses[4:]) < np.mean(losses[:4])
            acc, loss = run["eval"]
            assert np.isfinite(loss) and 0.0 <= acc <= 1.0
        assert r["gpipe"]["line"].startswith("pp strategy: schedule=gpipe stages=2")
    a, b = trainer_runs[0]["gpipe"]["step_losses"], trainer_runs[0]["1f1b"]["step_losses"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for k, v in trainer_runs[0]["gpipe"]["params"].items():
        assert torch.equal(trainer_runs[1]["gpipe"]["params"][k], v), k


def test_pp_checkpoint_resumes_bitwise(trainer_runs):
    for r in trainer_runs:
        resumed, whole = r["1f1b_resumed"], r["1f1b"]
        assert resumed["resumed"] == 4 and resumed["steps"] == 8
        assert resumed["eval"] == whole["eval"]
        for k, v in whole["params"].items():
            assert torch.equal(resumed["params"][k], v), k


def test_ep_trainer_reports_aux(trainer_runs):
    for r in trainer_runs:
        run = r["ep"]
        assert run["steps"] == 2 and all(np.isfinite(run["step_losses"]))
        assert len(run["aux"]) == 2 and min(run["aux"]) >= 1.0 - 1e-5
        assert np.isfinite(run["eval"][1])
    w = trainer_runs[0]["ep"]["params"]["block_1.moe.w_up"]
    assert tuple(w.shape) == (8, 192, 768)
    assert torch.equal(trainer_runs[1]["ep"]["params"]["block_1.moe.w_up"], w)
