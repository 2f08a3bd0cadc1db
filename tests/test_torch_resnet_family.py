"""The ResNet family in the PyTorch port (``tpu_ddp_torch/models/
resnet_family.py``) against the Flax models of ``tpu_ddp/models/
resnet_family.py``: param counts of every factory, the tree's names (the
port loads a converted Flax tree strictly), the initial BatchNorm scales and
head bias, and train- and eval-mode logits and the BatchNorm running stats
on weights carried across by ``checkpoint/convert.py::from_jax``.

Tolerance ``rtol=atol=1e-5`` on logits and stats: the two frameworks run
different float32 convolution algorithms on the CPU, so sums are taken in
other orders (``tests/test_torch_models.py``'s bound)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import resnet_family as flax_family
from tpu_ddp.models.zoo import MODEL_REGISTRY as FLAX_REGISTRY
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.models import MODEL_REGISTRY, param_count
from tpu_ddp_torch.models import resnet_family as family

TOL = dict(rtol=1e-5, atol=1e-5)

#: name -> (Flax module, port module): tiny members of each shape the family
#: has, with projection shortcuts in every kind of block
TINY = {
    "basic": (lambda: flax_family.ResNet((1, 1), flax_family._BasicBlock,
                                         num_classes=5, num_filters=8),
              lambda: family.ResNet((1, 1), family._BasicBlock, num_classes=5,
                                    num_filters=8)),
    "bottleneck": (lambda: flax_family.ResNet((1, 2), flax_family._Bottleneck,
                                              num_classes=5, num_filters=8),
                   lambda: family.ResNet((1, 2), family._Bottleneck, num_classes=5,
                                         num_filters=8)),
    "imagenet_stem": (lambda: flax_family.ResNet((1, 1), flax_family._BasicBlock,
                                                 num_classes=5, num_filters=8,
                                                 cifar_stem=False),
                      lambda: family.ResNet((1, 1), family._BasicBlock, num_classes=5,
                                            num_filters=8, cifar_stem=False)),
    "wide": (lambda: flax_family.WideResNet(depth=10, widen=1, num_classes=5),
             lambda: family.WideResNet(depth=10, widen=1, num_classes=5)),
}


def _flax_count(name, num_classes):
    model = FLAX_REGISTRY[name](num_classes=num_classes)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("name,num_classes", [
    ("resnet18", 10), ("resnet18", 100), ("resnet34", 10), ("resnet50", 10),
    ("resnet50", 100), ("resnet50", 3), ("resnet101", 10), ("resnet152", 10),
    ("wrn28_10", 10), ("wrn16_4", 10)])
def test_param_counts_match_flax(name, num_classes):
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](num_classes=num_classes)
    assert param_count(model) == _flax_count(name, num_classes)


@pytest.mark.parametrize("name,num_classes,params,leaves,stats", [
    ("resnet50", 100, 23_705_252, 161, 106), ("resnet50", 3, 23_506_499, 161, 106),
    ("resnet18", 100, 11_220_132, 62, 40), ("wrn28_10", 10, 36_479_194, 80, 50)])
def test_published_sizes(name, num_classes, params, leaves, stats):
    """ResNet-50 at CIFAR-100 and at the 3-class fine-tune, ResNet-18 at
    CIFAR-100, and WRN-28-10 at the WRN paper's 36.5M."""
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](num_classes=num_classes)
    assert param_count(model) == params
    assert len(list(model.parameters())) == leaves
    assert len(list(model.buffers())) == stats


def _pair(kind, seed=0, image=32):
    flax_model, port = TINY[kind][0](), TINY[kind][1]()
    x = np.random.default_rng(seed).normal(size=(4, image, image, 3)).astype(np.float32)
    variables = flax_model.init(jax.random.key(seed), x, train=False)
    rng = np.random.default_rng(seed + 1)
    # random scales (the zero-initialised ones too) and shifted running stats,
    # so every branch and the eval-mode normalisation do work
    params = jax.tree.map(
        lambda p: np.asarray(p) + rng.normal(0, 0.1, p.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = jax.tree.map(lambda s: np.asarray(s) + np.float32(0.1),
                         jax.device_get(variables["batch_stats"]))
    port.load_state_dict(from_jax(params, stats)["model"])   # strict: names match
    return flax_model, {"params": params, "batch_stats": stats}, port, x


@pytest.mark.parametrize("kind", sorted(TINY))
def test_forward_and_bn_stats_match_flax(kind):
    flax_model, variables, port, x = _pair(kind)
    xt = torch.from_numpy(x)
    want_eval = np.asarray(flax_model.apply(variables, x, train=False))
    port.eval()
    with torch.no_grad():
        got_eval = port(xt)
    assert got_eval.dtype == torch.float32
    np.testing.assert_allclose(got_eval.numpy(), want_eval, **TOL)

    want_train, mutated = flax_model.apply(variables, x, train=True,
                                           mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got_train = port(xt).numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), **TOL)
    want_stats = convert_tree(jax.device_get(mutated["batch_stats"]))
    got_stats = port.state_dict()
    assert want_stats
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name].numpy(), want.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(TINY))
def test_init_matches_flax_where_it_is_constant(kind):
    """The names and shapes of the two trees are equal, and so are the
    constant initial values: BatchNorm scales 1 and 0 (the last BatchNorm of
    each residual branch), BatchNorm biases and the head's bias 0, running
    means 0 and variances 1."""
    flax_model, port = TINY[kind][0](), TINY[kind][1]()
    variables = jax.device_get(flax_model.init(
        jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    want = from_jax(variables["params"], variables["batch_stats"])["model"]
    got = port.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for name, w in want.items():
        if name.endswith(".weight") and w.ndim >= 2:
            continue                            # random draws
        torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)


def test_conv_init_is_he_normal_over_fan_out():
    """The draws differ from Flax's (another generator), so their
    distribution is checked: std ``sqrt(2 / fan_out)`` within 5% at the
    widest conv of a ResNet-18; lecun-normal's truncation at 2 stds in the
    head."""
    model = MODEL_REGISTRY["resnet18"](num_classes=100,
                                       generator=torch.Generator().manual_seed(3))
    w = model._BasicBlock_7.Conv_1.weight.detach()          # (512, 512, 3, 3)
    fan_out = w.shape[0] * 9
    assert abs(float(w.std()) / (2.0 / fan_out) ** 0.5 - 1.0) < 0.05
    head = model.head.weight.detach()                         # (100, 512)
    std = (1.0 / 512) ** 0.5 / 0.87962566103423978
    assert float(head.abs().max()) <= 2 * std
    assert torch.count_nonzero(model.head.bias) == 0


def test_same_seed_same_weights_and_other_seed_other_weights():
    a, b, c = (MODEL_REGISTRY["resnet18"](generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["stem_conv.weight"], sc["stem_conv.weight"])


def test_wrn_depth_must_be_6n_plus_4():
    with pytest.raises(ValueError, match="6n\\+4"):
        family.WideResNet(depth=12)
