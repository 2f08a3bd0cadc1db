"""The GSPMD families in the router and the trainer (``train/strategy.py``,
``train/trainer.py``): the guards against the JAX package's, word for
word, and checkpoints portable across dp, tp, fsdp and fsdp_tp.

* ``_tp_rules_for`` refuses a model with no rule set with the JAX
  message; ``--zero1``, ``--zero3`` and
  ``--grad-compress`` under tp, fsdp and fsdp_tp raise the JAX
  ``TrainConfig``'s messages; ``--augment``, ``--mixup-alpha`` and
  ``--sync-bn`` under them the JAX trainer's; ``--steps-per-call`` warns;
  pp takes the ViT and refuses the MoE ViT, ep the reverse.
* Portability (the JAX ``test_checkpoint_portable_across_strategies``,
  ``tests/test_strategy.py:371``): on 4 gloo CPU ranks NetResDeep (n_chans1
  8, 2 tied blocks; BatchNorm's running stats cut under tp) trains an epoch
  under dp (4 ranks), then resumes under tp (data=2 x model=2), fsdp
  (data=4) and dp again, at one global batch of 16; after each restore the
  params, buffers and optimizer state the trainer holds, gathered whole,
  equal the checkpoint's to the bit, and the run's last step is the
  epochs' count.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from tpu_ddp_torch.models import ViT

VIT = dict(patch_size=8, hidden_dim=32, depth=1, num_heads=2, num_classes=10)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_tp_rules_refuse_other_models_as_jax():
    from tpu_ddp.models.lm import CausalTransformerLM as JaxLM
    from tpu_ddp.train.strategy import _tp_rules_for as jax_rules
    from tpu_ddp_torch.models.lm import CausalTransformerLM
    from tpu_ddp_torch.train.strategy import _tp_rules_for

    lm = CausalTransformerLM(vocab_size=8, hidden_dim=8, depth=1, num_heads=2, seq_len=4)
    assert _error(lambda: _tp_rules_for(lm, "tp")) == _error(
        lambda: jax_rules(JaxLM(), "tp"))


@pytest.mark.parametrize("parallelism", ["tp", "fsdp", "fsdp_tp"])
@pytest.mark.parametrize("flag", ["zero1", "zero3", "grad_compress"])
def test_overlay_guards_match_jax(parallelism, flag):
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
    from tpu_ddp_torch.train.trainer import TrainConfig

    kw = {flag: "int8" if flag == "grad_compress" else True, "parallelism": parallelism}
    want = _error(lambda: JaxTrainConfig(**kw).validate())
    assert _error(lambda: TrainConfig(device="cpu", **kw)) == want


@pytest.mark.parametrize("parallelism", ["tp", "fsdp", "fsdp_tp"])
@pytest.mark.parametrize("flag", ["augment", "mixup_alpha", "sync_bn"])
def test_dp_only_flags_under_gspmd(parallelism, flag):
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    name = "--" + flag.replace("_", "-")
    config = dataclasses.replace(
        TrainConfig(device="cpu", synthetic_data=True, synthetic_size=32, model="vit_s4",
                    parallelism=parallelism, mesh={"data": 1}),
        **{flag: 0.2 if flag == "mixup_alpha" else True})
    assert _error(lambda: Trainer(config)) == (
        f"{name} is only supported with data parallelism (got --parallelism {parallelism})")


def test_steps_per_call_warns_under_tp():
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    config = TrainConfig(device="cpu", synthetic_data=True, synthetic_size=32,
                         per_shard_batch=8, model="netresdeep", n_chans1=4, n_blocks=1,
                         parallelism="tp", mesh={"data": 1, "model": 1}, steps_per_call=4,
                         prefetch_depth=0, epochs=1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trainer = Trainer(config)
    assert any("steps_per_call=4 ignored" in str(w.message) for w in seen)
    assert trainer.multi_step is None and trainer.layout is not None
    out = trainer.run()
    assert out["steps"] == 4 and np.isfinite(out["train_loss"])
    trainer.close()


@pytest.mark.parametrize("parallelism", ["pp", "ep"])
def test_pp_ep_still_raise(parallelism):
    """pp and ep are ported: pp takes the ViT, ep the MoE ViT and raises on
    a ViT (``tests/test_torch_pp_ep_cli.py`` holds the messages to JAX's)."""
    from tpu_ddp_torch.models import MoEViT
    from tpu_ddp_torch.train.strategy import check_strategy

    if parallelism == "pp":
        check_strategy("pp", ViT(**VIT))
        with pytest.raises(ValueError, match="needs a ViT model"):
            check_strategy("pp", MoEViT(depth=2, hidden_dim=32, num_heads=2, num_experts=2))
        return
    check_strategy("ep", MoEViT(depth=2, hidden_dim=32, num_heads=2, num_experts=2))
    with pytest.raises(ValueError, match="needs a MoEViT model"):
        check_strategy("ep", ViT(**VIT))


# ---- checkpoints portable across the families ------------------------------------

CHAIN = [("dp", None), ("tp", {"data": 2, "model": 2}), ("fsdp", {"data": 4}),
         ("dp", None)]


def _config(path, parallelism, mesh, epochs):
    from tpu_ddp_torch.train.trainer import TrainConfig

    return TrainConfig(device="cpu", synthetic_data=True, synthetic_size=64,
                       per_shard_batch=16 // (mesh or {"data": 4})["data"],
                       model="netresdeep", n_chans1=8, n_blocks=2, momentum=0.9,
                       kernels=True, parallelism=parallelism, mesh=mesh, epochs=epochs,
                       checkpoint_dir=path, checkpoint_every_epochs=1, log_every_epochs=1,
                       resume=epochs > 1, prefetch_depth=0)


def _chain_worker(rank, n, path):
    from tpu_ddp_torch.train.trainer import Trainer

    out = []
    for i, (parallelism, mesh) in enumerate(CHAIN):
        trainer = Trainer(_config(f"{path}/ck", parallelism, mesh, i + 1))
        restored = None
        if i:
            flat = torch.load(f"{path}/ck/{trainer.resumed_step}/state.pt")
            now = trainer._ckpt_state()
            restored = all(torch.equal(now[k], v) if torch.is_tensor(v) else now[k] == v
                           for k, v in flat.items()) and set(now) == set(flat)
        trainer.run()
        out.append({"restored": restored, "step": int(trainer.state.step),
                    "resumed": trainer.resumed_step})
        trainer.close()
    torch.save(out, f"{path}/chain{rank}.pt")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("gspmd_chain")
    spawn(_chain_worker, 4, str(path), init_file=str(path / "rdzv"), timeout=300)
    return [torch.load(path / f"chain{r}.pt") for r in range(4)]


@pytest.mark.parametrize("hop", [1, 2, 3], ids=["dp_to_tp", "tp_to_fsdp", "fsdp_to_dp"])
def test_checkpoint_portable_across_strategies(chain, hop):
    for runs in chain:
        assert runs[hop]["restored"] is True
        assert runs[hop]["resumed"] == runs[hop - 1]["step"]
        assert runs[hop]["step"] == runs[hop - 1]["step"] + runs[0]["step"]
