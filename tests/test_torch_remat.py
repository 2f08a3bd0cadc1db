"""``--remat`` in the PyTorch port: the forward recomputed in the backward.

* Three steps with and without remat end bitwise equal on the CPU, params
  and losses, for the ViT with flash attention (per-block recompute), the LM
  with flash attention (per block) and NetResDeep (the whole forward
  checkpointed), and NetResDeep's BatchNorm running buffers too: the
  recompute runs with ``update_running`` off, so the buffers move once a
  step, as ``jax.checkpoint`` returns the mutated ``batch_stats`` once.
  With remat the attention runs twice a block a step (the recompute).
* Against the JAX steps with remat on: ``make_train_step(..., remat=True)``
  for the ViT (which becomes ``ViT(remat=True)``, ``resolve_remat``) and
  NetResDeep (a whole-forward ``jax.checkpoint``), ``make_lm_train_step`` on
  ``CausalTransformerLM(remat=True)``; three steps of SGD lr 1e-2 from the
  same weights on the same batches. Inside the JAX steps, which run under
  shard_map, the JAX flash attention takes its jnp reference on the CPU.
  Tolerances of ``tests/test_torch_train_step.py``: per-step loss
  ``rtol=1e-5``, params and BatchNorm stats after step 3 ``atol=1e-5``.
* ``--remat --compute-dtype bfloat16`` on the CLI, on the CPU.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.lm import CausalTransformerLM as FlaxLM
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.ops.flash_attention import flash_attention as jax_flash
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.lm_steps import create_lm_train_state as jax_create_lm_state
from tpu_ddp.train.lm_steps import make_lm_train_step as jax_make_lm_step
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.cli.train import main
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.models import CausalTransformerLM, NetResDeep, ViT
from tpu_ddp_torch.ops.flash_attention import flash_attention
from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

VIT = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=10)
LM = dict(vocab_size=17, hidden_dim=32, depth=2, num_heads=2)
LM_SEQ = 32
CPU = torch.device("cpu")


def _image_batches(n_steps=3, batch=8):
    images, labels = synthetic_cifar10(n_steps * batch, 10, seed=4)
    out = []
    for i in range(n_steps):
        sl = slice(i * batch, (i + 1) * batch)
        mask = np.ones(batch, bool)
        if i == n_steps - 1:
            mask[batch // 2 + 1:] = False   # a short, wrap-padded last batch
        out.append({"image": images[sl], "label": labels[sl], "mask": mask})
    return out


def _token_batches(n_steps=3, rows=4):
    rng = np.random.default_rng(5)
    return [{"tokens": rng.integers(0, LM["vocab_size"], (rows, LM_SEQ)).astype(np.int32)}
            for _ in range(n_steps)]


def _port_model(name):
    gen = torch.Generator().manual_seed(3)
    if name == "vit_flash":
        model = ViT(**VIT, generator=gen)
        model.attention_impl = flash_attention
        return model
    if name == "lm_flash":
        return CausalTransformerLM(**LM, seq_len=LM_SEQ, use_flash=True, generator=gen)
    return NetResDeep(n_chans1=8, n_blocks=2, generator=gen)


def _port_run(name, remat, dtype=torch.float32):
    """Three steps from ``_port_model(name)``'s seeded weights: (losses,
    state_dict, attention calls)."""
    model = _port_model(name)
    calls = []
    if hasattr(model, "blocks") and name != "netresdeep":
        impl = model.blocks[0].attn.attention_impl

        def counted(q, k, v):
            calls.append(q.shape)
            return impl(q, k, v)

        model.blocks[0].attn.attention_impl = counted
    tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
    if name == "lm_flash":
        model.remat = remat
        state = create_lm_train_state(model, tx, CPU)
        step, batches = make_lm_train_step(tx), _token_batches()
    else:
        state = create_train_state(model, tx, CPU)
        step, batches = make_train_step(tx, remat=remat), _image_batches()
    losses = []
    for batch in batches:
        state, metrics = step(state, batch_to_device(batch, CPU))
        losses.append(float(metrics["loss"]))
    return losses, state.model.state_dict(), len(calls)


@pytest.mark.parametrize("name", ["vit_flash", "lm_flash", "netresdeep"])
def test_remat_is_bitwise_the_run_without(name):
    losses, want, calls = _port_run(name, remat=False)
    r_losses, got, r_calls = _port_run(name, remat=True)
    assert r_losses == losses and all(math.isfinite(x) for x in losses)
    assert set(got) == set(want)
    for key, t in want.items():      # params and BatchNorm running buffers
        assert torch.equal(got[key], t), key
    if name != "netresdeep":
        assert calls == 3 and r_calls == 6      # the block's recompute
    else:
        assert not torch.equal(want["resblock.batch_norm.running_mean"],
                               torch.zeros(8))


@pytest.mark.parametrize("name", ["vit_flash", "netresdeep"])
def test_remat_steps_match_jax(name):
    if name == "vit_flash":
        flax_model = FlaxViT(**VIT).clone(attention_impl=jax_flash)
        port = ViT(**VIT)
        port.attention_impl = flash_attention
    else:
        flax_model = FlaxNetResDeep(n_chans1=8, n_blocks=2)
        port = NetResDeep(n_chans1=8, n_blocks=2)
    jax_tx = jax_make_optimizer(lr=1e-2)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_train_step(flax_model, jax_tx, mesh, donate=False, remat=True)
    tx = make_optimizer(lr=1e-2, kernels=True)
    state = create_train_state(port, tx, CPU)
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    step = make_train_step(tx, remat=True)
    for batch in _image_batches():
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
    assert getattr(state.model, "remat", True)   # resolve_remat turned the ViT's on
    want = convert_tree(jax.device_get(j_state.params))
    want.update(convert_tree(jax.device_get(j_state.batch_stats)))
    got = state.model.state_dict()
    assert set(want) == set(got)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_remat_lm_step_matches_jax():
    flax_model = FlaxLM(**LM, use_flash=True, remat=True)
    jax_tx = jax_make_optimizer(lr=1e-2)
    j_state = jax_create_lm_state(flax_model, jax_tx, jax.random.key(0), seq_len=LM_SEQ)
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_lm_step(flax_model, jax_tx, mesh, donate=False)
    tx = make_optimizer(lr=1e-2, kernels=True)
    state = create_lm_train_state(
        CausalTransformerLM(**LM, seq_len=LM_SEQ, use_flash=True, remat=True), tx, CPU)
    load_into(state, from_jax(*jax.device_get((j_state.params, {}, j_state.opt_state))))
    step = make_lm_train_step(tx)
    for batch in _token_batches():
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, CPU))
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]),
                                   rtol=1e-5)
    want = convert_tree(jax.device_get(j_state.params))
    got = state.model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_cli_remat_bf16_cpu_run(capsys):
    metrics = main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
                    "--epochs", "1", "--n-chans1", "8", "--n-blocks", "2", "--kernels",
                    "--compute-dtype", "bfloat16", "--remat", "--eval-each-epoch",
                    "--log-every-epochs", "1"])
    assert "Epoch 1, Training loss" in capsys.readouterr().out
    assert metrics["steps"] == 2
    assert all(math.isfinite(x) for x in metrics["step_losses"])
    assert math.isfinite(metrics["test_loss"])
