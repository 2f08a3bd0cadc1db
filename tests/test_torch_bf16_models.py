"""bfloat16 compute in the PyTorch port against the Flax models at
``dtype=jnp.bfloat16``, from one tree of float32 params carried across by
``checkpoint/convert.py::from_jax``.

* Models: the ViT (patch 4, hidden 32, depth 2, 2 heads) with full and with
  flash attention (the JAX flash is the Pallas kernel in interpret mode), the
  causal LM (vocab 64, hidden 32, depth 2, T = 128) with its plain causal
  attention and with flash, NetResDeep (8 channels, 2 tied blocks) and
  ResNet-18, in train mode: float32 logits and the gradients of the mean
  cross-entropy (the LM's next-token loss) with respect to every param.
* One trainer step (``build_model`` of each package with
  ``compute_dtype="bfloat16"``, SGD lr 1e-2): NetResDeep, and ViT-S/4 with
  ``--attention flash`` (inside the JAX step, which runs under shard_map,
  the JAX flash takes its jnp ``_reference`` on the CPU:
  ``tpu_ddp/ops/flash_attention.py:260``).
* Two gloo ranks: three bfloat16 steps end bitwise equal on both.

Tolerances. bfloat16 keeps 8 significant bits, and the two frameworks round
at other places (a sum in another order can flip a rounding, which the
next layers carry on). Logits: within 4 bfloat16 units in the last place of
the largest ``|logit|`` (measured: at most 3). Gradients: the relative L2
distance over all params, ``|g_port - g_jax| / |g_jax|``, at most 0.03
(measured 0.006-0.009), and 0.1 for ResNet-18 (measured 0.07: the same as
the distance between the JAX model's own bfloat16 and float32 gradients on
these inputs, so at batch 4 its 18 layers of BatchNorm make the rounding
noise that large whichever framework rounds, and at batch 16 or 32 too:
0.053-0.058 against 0.061-0.063). That bound cannot tell bfloat16 from
float32, so every conv and dense output is checked to be bfloat16, and
ResNet-18's gradients are held in eval mode too, within 0.01 of the Flax
model's, where the float32 port lies beyond it. One step: loss ``rtol=2e-3``,
the param update's relative L2 distance at most 0.03 (measured 0.004 and
0.009), BatchNorm running stats ``atol=1e-4`` (float32 from bfloat16
activations; measured 2e-5)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.lm import CausalTransformerLM as FlaxLM
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.models.zoo import MODEL_REGISTRY as JAX_REGISTRY
from tpu_ddp.ops.flash_attention import flash_attention as jax_flash
from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp.train.state import create_train_state as jax_create_train_state
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
from tpu_ddp.train.trainer import build_model as jax_build_model
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.models import MODEL_REGISTRY, CausalTransformerLM, NetResDeep, ViT
from tpu_ddp_torch.ops.flash_attention import flash_attention
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step
from tpu_ddp_torch.train.trainer import TrainConfig, build_model

BF16 = torch.bfloat16
VIT = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=10)
LM = dict(vocab_size=64, hidden_dim=32, depth=2, num_heads=2)
LM_SEQ = 128
LOGIT_ULPS = 4
GRAD_REL = {"resnet18": 0.1}
GRAD_REL_DEFAULT = 0.03
GRAD_REL_EVAL = 0.01


def ulp(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7)


def _pair(name):
    """(Flax model at bfloat16, port model at bfloat16, is_lm)."""
    if name.startswith("vit"):
        flax_model, port = FlaxViT(**VIT, dtype=jnp.bfloat16), ViT(**VIT, dtype=BF16)
        if name == "vit_flash":
            flax_model = flax_model.clone(attention_impl=jax_flash)
            port.attention_impl = flash_attention
        return flax_model, port, False
    if name.startswith("lm"):
        flash = name == "lm_flash"
        return (FlaxLM(**LM, use_flash=flash, attention_interpret=True, dtype=jnp.bfloat16),
                CausalTransformerLM(**LM, seq_len=LM_SEQ, use_flash=flash, dtype=BF16), True)
    if name == "netresdeep":
        return (FlaxNetResDeep(n_chans1=8, n_blocks=2, dtype=jnp.bfloat16),
                NetResDeep(n_chans1=8, n_blocks=2, dtype=BF16), False)
    return (JAX_REGISTRY[name](num_classes=10, dtype=jnp.bfloat16),
            MODEL_REGISTRY[name](num_classes=10, dtype=BF16), False)


def _inputs(is_lm):
    rng = np.random.default_rng(0)
    if is_lm:
        return rng.integers(0, LM["vocab_size"], (2, LM_SEQ)).astype(np.int32), None
    return (rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))


def _jax_loss(logits, x, labels):
    if labels is None:      # next-token
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32))
        return -jnp.take_along_axis(lp, x[:, 1:, None], -1).mean()
    return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()


def _port_loss(logits, x, labels):
    if labels is None:
        lp = torch.log_softmax(logits[:, :-1].float(), -1)
        return -lp.gather(-1, x[:, 1:, None].long()).mean()
    return F.cross_entropy(logits, labels.long())


def rel_l2(got: dict, want: dict) -> float:
    names = sorted(want)
    g = np.concatenate([np.asarray(got[n], np.float64).ravel() for n in names])
    w = np.concatenate([np.asarray(want[n], np.float64).ravel() for n in names])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("name", ["vit_full", "vit_flash", "lm_full", "lm_flash",
                                  "netresdeep", "resnet18"])
def test_bf16_model_matches_flax(name):
    flax_model, port, is_lm = _pair(name)
    x, labels = _inputs(is_lm)
    variables = flax_model.init(jax.random.key(0), x, train=False)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables.get("batch_stats", {}))
    port.load_state_dict(from_jax(params, stats)["model"])

    def loss_fn(p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        if stats:
            logits, _ = flax_model.apply(v, x, train=True, mutable=["batch_stats"])
        else:
            logits = flax_model.apply(v, x, train=True)
        return _jax_loss(logits, x, labels), logits

    (_, j_logits), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    seen = []
    if port.__class__ in (ViT, CausalTransformerLM):
        impl = port.blocks[0].attn.attention_impl

        def spy(q, k, v):
            seen.append(q.dtype)
            return impl(q, k, v)

        port.blocks[0].attn.attention_impl = spy
    port.train()
    xt = torch.from_numpy(x)
    layer_dtypes = []   # every conv and dense output: the compute ran in bf16
    hooks = [m.register_forward_hook(lambda mod, inp, out: layer_dtypes.append(out.dtype))
             for m in port.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    logits = port(xt)
    for hook in hooks:
        hook.remove()
    assert layer_dtypes and all(d == BF16 for d in layer_dtypes)
    assert logits.dtype == torch.float32 and j_logits.dtype == jnp.float32
    if port.__class__ in (ViT, CausalTransformerLM):   # the attention took bf16
        assert seen and all(d == BF16 for d in seen)
    grads = dict(zip([n for n, _ in port.named_parameters()],
                     torch.autograd.grad(_port_loss(logits, xt, None if labels is None
                                                    else torch.from_numpy(labels)),
                                         list(port.parameters()))))
    assert all(g.dtype == torch.float32 for g in grads.values())
    want = np.asarray(j_logits)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=LOGIT_ULPS * ulp(np.abs(want).max()))
    want_grads = {n: t.numpy() for n, t in convert_tree(jax.device_get(j_grads)).items()}
    assert set(want_grads) == set(grads)
    assert rel_l2({n: g.numpy() for n, g in grads.items()}, want_grads) <= GRAD_REL.get(
        name, GRAD_REL_DEFAULT)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_resnet18_eval_gradients_tell_bf16_from_float32(dtype):
    """In eval mode, where BatchNorm takes its running statistics and does
    not amplify a rounding as the batch statistics of 4 images do, the
    bfloat16 port's gradients lie within ``GRAD_REL_EVAL`` of the Flax
    bfloat16 ResNet-18's (measured 0.0038) and the float32 port's lie
    beyond it (measured 0.022), so this bound tells the compute dtypes
    apart where the train-mode one cannot."""
    flax_model = JAX_REGISTRY["resnet18"](num_classes=10, dtype=jnp.bfloat16)
    port = MODEL_REGISTRY["resnet18"](num_classes=10, dtype=dtype)
    x, labels = _inputs(False)
    variables = flax_model.init(jax.random.key(0), x, train=False)
    params, stats = jax.device_get((variables["params"], variables["batch_stats"]))
    port.load_state_dict(from_jax(params, stats)["model"])

    def loss_fn(p):
        logits = flax_model.apply({"params": p, "batch_stats": stats}, x, train=False)
        return _jax_loss(logits, x, labels)

    want = {n: t.numpy() for n, t in
            convert_tree(jax.device_get(jax.jit(jax.grad(loss_fn))(params))).items()}
    port.eval()
    xt = torch.from_numpy(x)
    loss = _port_loss(port(xt), xt, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(port.parameters()))
    dist = rel_l2({n: g.numpy() for (n, _), g in zip(port.named_parameters(), grads)}, want)
    assert (dist <= GRAD_REL_EVAL) == (dtype == BF16), dist


def _step_batch():
    images, labels = synthetic_cifar10(8, 10, seed=4)
    return {"image": images, "label": labels, "mask": np.ones(8, bool)}


@pytest.mark.parametrize("kw", [dict(model="netresdeep", n_chans1=8, n_blocks=2),
                                dict(model="vit_s4", attention="flash")],
                         ids=["netresdeep", "vit_s4_flash"])
def test_one_bf16_trainer_step_matches_jax(kw):
    flax_model = jax_build_model(JaxTrainConfig(compute_dtype="bfloat16", **kw))
    jax_tx = jax_make_optimizer(lr=1e-2)
    j_start = jax_create_train_state(flax_model, jax_tx, jax.random.key(0))
    start = convert_tree(jax.device_get(j_start.params))
    mesh = create_mesh(MeshSpec(data=1), jax.devices()[:1])
    batch = _step_batch()
    j_state, j_metrics = jax_make_train_step(flax_model, jax_tx, mesh, donate=False)(
        j_start, batch)

    config = TrainConfig(compute_dtype="bfloat16", **kw)
    tx = make_optimizer(lr=1e-2, kernels=True)
    state = create_train_state(build_model(config), tx, torch.device("cpu"))
    assert state.model.dtype == BF16
    load_into(state, from_jax(*jax.device_get(
        (j_start.params, j_start.batch_stats, j_start.opt_state))))
    state, metrics = make_train_step(tx)(state, batch_to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=2e-3)
    want = convert_tree(jax.device_get(j_state.params))
    got = state.model.state_dict()
    assert rel_l2({n: got[n] - start[n] for n in want},
                  {n: want[n] - start[n] for n in want}) <= 0.03
    for name, w in convert_tree(jax.device_get(j_state.batch_stats)).items():
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def _rank_worker(rank, n, path):
    from tpu_ddp_torch.parallel.runtime import world_size

    assert world_size() == n
    images, labels = synthetic_cifar10(3 * n * 4, 10, seed=6)
    out = {}
    for kw in (dict(model="netresdeep", n_chans1=8, n_blocks=2),
               dict(model="vit_s4", attention="flash")):
        config = TrainConfig(compute_dtype="bfloat16", **kw)
        tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
        state = create_train_state(build_model(config), tx, torch.device("cpu"))
        step = make_train_step(tx)
        losses = []
        for i in range(3):
            rows = slice((i * n + rank) * 4, (i * n + rank + 1) * 4)
            batch = {"image": images[rows], "label": labels[rows], "mask": np.ones(4, bool)}
            state, metrics = step(state, batch_to_device(batch, torch.device("cpu")))
            losses.append(float(metrics["loss"]))
        out[kw["model"]] = {"losses": losses, "model": state.model.state_dict()}
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))


def test_bf16_replicas_end_bitwise_equal_at_two_ranks(tmp_path):
    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(_rank_worker, 2, str(tmp_path), init_file=str(tmp_path / "rdzv"), timeout=180)
    a, b = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    for model in a:
        assert a[model]["losses"] == b[model]["losses"], model
        assert all(math.isfinite(x) for x in a[model]["losses"])
        for name, t in a[model]["model"].items():
            assert torch.equal(t, b[model]["model"][name]), (model, name)
