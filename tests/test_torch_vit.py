"""The ViT in the PyTorch port against the Flax model, and the slice as a
whole: ViT training with ``--attention flash``.

* Param counts of ``vit_s4`` and ``vit_b16`` equal the Flax modules'
  (``jax.eval_shape``), leaf for leaf.
* Forward logits on weights carried across by the converter, small config
  (patch 4, hidden 32, depth 2, 2 heads, 32x32 input: 64 tokens), with full
  and with flash attention on both sides; ``atol=1e-5``. On the JAX side,
  flash is the Pallas kernel in interpret mode (the model is applied outside
  any shard_map).
* Three train steps of the small ViT with flash attention, port against
  ``tpu_ddp.train.steps.make_train_step`` on a 1-device mesh, for SGD and
  AdamW with clipping; loss ``rtol=1e-5``, params ``atol=1e-5``. Inside the
  JAX step, which runs under shard_map, the JAX ``flash_attention`` takes
  its jnp ``_reference`` on the CPU (``tpu_ddp/ops/flash_attention.py:260``:
  interpret-mode Pallas does not trace under shard_map). That is the JAX
  package's own behaviour there; the port's CPU path runs the plain
  versions of its three kernels, the same function on whole score
  matrices, so the step compares the model, loss, gradients and update
  around the attention. One slice is left out of the AdamW comparison: the key
  third of each ``qkv`` bias. Adding a constant to every key adds the same
  number to a query's scores, which the softmax ignores, so the loss does
  not depend on that bias and its gradient is rounding noise (1e-9), which
  differs between the frameworks; Adam divides it by its own size into steps
  of up to ``lr``. There both sides are held to the bound of 3 such steps.
* The CLI drives ``--model vit_s4 --attention flash`` on the CPU, and
  ``--attention flash`` on NetResDeep raises."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from tpu_ddp.ops.flash_attention import flash_attention as jax_flash
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import _decay_mask
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.cli.train import main
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.models import MODEL_REGISTRY, ViT, param_count
from tpu_ddp_torch.ops.flash_attention import flash_attention
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

SMALL = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=10)
RECIPES = {
    "sgd": dict(lr=1e-2),
    "adamw_clip": dict(optimizer="adamw", lr=1e-3, grad_clip_norm=1.0),
}


def _flax_small(attention):
    model = FlaxViT(**SMALL)
    return model.clone(attention_impl=jax_flash) if attention == "flash" else model


def _port_small(attention):
    model = ViT(**SMALL)
    if attention == "flash":
        model.attention_impl = flash_attention
    return model


@pytest.mark.parametrize("name,expected", [("vit_s4", 2_693_194), ("vit_b16", None)])
def test_param_counts_match_flax(name, expected):
    flax_model = JAX_REGISTRY[name](num_classes=10)
    shapes = jax.eval_shape(
        lambda: flax_model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
                                train=False))["params"]
    leaves = jax.tree.leaves(shapes)
    want = sum(math.prod(x.shape) for x in leaves)
    port = MODEL_REGISTRY[name](num_classes=10)
    assert param_count(port) == want
    assert len(list(port.parameters())) == len(leaves)
    if expected is not None:
        assert want == expected and len(leaves) == 79
    got_shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    converted = convert_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert {n: tuple(t.shape) for n, t in converted.items()} == got_shapes


def test_initializers_follow_flax():
    """lecun-normal: a truncated normal of variance 1/fan_in (stddev within
    1.5% of Flax's on a 192 x 576 kernel, no draw past two of its own
    stddevs), zero biases, pos_embed std 0.02, LayerNorm 1/0."""
    port = MODEL_REGISTRY["vit_s4"](generator=torch.Generator().manual_seed(3))
    w = port.block_0.attn.qkv.weight.detach()
    flax_w = jax.nn.initializers.lecun_normal()(jax.random.key(3), (192, 576))
    assert w.std().item() == pytest.approx(float(np.std(flax_w)), rel=0.015)
    limit = 2 * math.sqrt(1 / 192) / 0.87962566103423978
    assert w.abs().max().item() <= limit
    assert torch.count_nonzero(port.block_0.attn.qkv.bias) == 0
    assert port.pos_embed.std().item() == pytest.approx(0.02, rel=0.05)
    assert torch.all(port.ln_f.weight == 1) and torch.all(port.ln_f.bias == 0)
    # the conv's fan_in is kh*kw*in
    pe = port.patch_embed.weight.detach()
    assert pe.std().item() == pytest.approx(math.sqrt(1 / 48), rel=0.05)
    # a seed fixes the weights
    fresh = MODEL_REGISTRY["vit_s4"](generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(fresh.block_0.attn.qkv.weight, w, rtol=0, atol=0)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_forward_matches_flax(attention):
    flax_model = _flax_small(attention)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    variables = flax_model.init(jax.random.key(0), x, train=False)
    want = np.asarray(flax_model.apply(variables, x, train=False))
    port = _port_small(attention)
    port.load_state_dict(from_jax(jax.device_get(variables["params"]),
                                  variables.get("batch_stats", {}))["model"])
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decay_mask_matches_jax():
    """``ndim >= 2`` decays the kernels and ``pos_embed`` (1, T, C), not the
    biases or LayerNorm params, in both packages."""
    flax_model = FlaxViT(**SMALL)
    params = flax_model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
                             train=False)["params"]
    want = {n: bool(t) for n, t in convert_tree(_decay_mask(params)).items()}
    port = _port_small("full")
    assert decay_mask(dict(port.named_parameters())) == want
    assert want["pos_embed"] is True and want["head.bias"] is False


def _batches(n_steps=3, batch=8):
    images, labels = synthetic_cifar10(n_steps * batch, 10, seed=5)
    out = []
    for i in range(n_steps):
        sl = slice(i * batch, (i + 1) * batch)
        mask = np.ones(batch, bool)
        if i == n_steps - 1:
            mask[batch // 2 + 1:] = False   # a short, wrap-padded last batch
        out.append({"image": images[sl], "label": labels[sl], "mask": mask})
    return out


@pytest.mark.parametrize("recipe,port_kernels", [
    ("sgd", False), ("sgd", True), ("adamw_clip", False), ("adamw_clip", True)])
def test_three_flash_steps_match_jax(recipe, port_kernels):
    kw = RECIPES[recipe]
    flax_model = _flax_small("flash")
    jax_tx = jax_make_optimizer(**kw)
    j_state = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    j_step = jax_make_train_step(flax_model, jax_tx, mesh, donate=False)

    tx = make_optimizer(kernels=port_kernels, **kw)
    state = create_train_state(_port_small("flash"), tx, torch.device("cpu"))
    load_into(state, from_jax(*jax.device_get(
        (j_state.params, j_state.batch_stats, j_state.opt_state))))
    step = make_train_step(tx)
    start = {n: t.clone() for n, t in state.model.state_dict().items()}

    for batch in _batches():
        j_state, j_metrics = j_step(j_state, batch)
        state, metrics = step(state, batch_to_device(batch, torch.device("cpu")))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=1e-5)
    assert int(state.step) == int(j_state.step) == 3
    want = convert_tree(jax.device_get(j_state.params))
    got = state.model.state_dict()
    assert set(want) == set(got)
    C = SMALL["hidden_dim"]
    for name, w in want.items():
        g, w = got[name].numpy().copy(), w.numpy().copy()
        if kw.get("optimizer") == "adamw" and name.endswith("attn.qkv.bias"):
            s0 = start[name].numpy()[C:2 * C]
            for side in (g, w):
                assert np.all(np.abs(side[C:2 * C] - s0) <= 3 * kw["lr"]), name
            g[C:2 * C] = w[C:2 * C] = 0.0     # the loss does not see them
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def test_cli_cpu_vit_s4_flash(capsys):
    metrics = main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
                    "--epochs", "1", "--model", "vit_s4", "--attention", "flash",
                    "--kernels", "--optimizer", "adamw", "--lr", "1e-3",
                    "--eval-each-epoch", "--log-every-epochs", "1"])
    out = capsys.readouterr().out
    assert "Epoch 1, Training loss" in out
    assert metrics["steps"] == 2 and metrics["eval_batches"] == 4
    assert all(math.isfinite(x) for x in metrics["step_losses"])
    assert math.isfinite(metrics["test_loss"])


def test_cli_flash_needs_an_attention_model():
    with pytest.raises(ValueError, match="needs an attention model"):
        main(["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
              "--epochs", "1", "--attention", "flash"])


def _one_block(monkeypatch):
    """ViT-B/16's builder at one block: its widths, its patch, a CPU-sized
    depth (a test size; the depth does not touch the input size)."""
    import tpu_ddp_torch.models.vit as vit_mod

    monkeypatch.setattr(vit_mod, "ViT", lambda **kw: ViT(**{**kw, "depth": 1}))


def test_vit_b16_takes_its_published_input_size(monkeypatch):
    """``vit_b16(image_size=224)`` sizes ``pos_embed`` (1, 196, 768), as the
    Flax ``vit_b16`` does when initialised on a 224x224 batch, and its
    logits on such a batch match the Flax model's through ``from_jax``
    (``atol=1e-5``, as above). ``build_model`` passes the size through;
    ViT-S/4 keeps 64 tokens by default."""
    from tpu_ddp_torch.train.trainer import TrainConfig, build_model

    flax_b16 = JAX_REGISTRY["vit_b16"](num_classes=10)
    x224 = np.random.default_rng(2).normal(size=(1, 224, 224, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: flax_b16.init(jax.random.key(0), x224,
                                                  train=False))["params"]
    assert shapes["pos_embed"].shape == (1, 196, 768)
    assert MODEL_REGISTRY["vit_s4"]().pos_embed.shape == (1, 64, 192)

    _one_block(monkeypatch)
    port = MODEL_REGISTRY["vit_b16"](num_classes=10, image_size=224)
    assert port.pos_embed.shape == (1, 196, 768) and len(port.blocks) == 1
    built = build_model(TrainConfig(model="vit_b16"), image_size=224)
    assert built.pos_embed.shape == (1, 196, 768)

    flax_model = FlaxViT(patch_size=16, hidden_dim=768, depth=1, num_heads=12,
                         num_classes=10)
    variables = flax_model.init(jax.random.key(0), x224, train=False)
    want = np.asarray(flax_model.apply(variables, x224, train=False))
    port.load_state_dict(from_jax(jax.device_get(variables["params"]), {})["model"])
    with torch.no_grad():
        got = port(torch.from_numpy(x224)).numpy()
    assert got.shape == (1, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
