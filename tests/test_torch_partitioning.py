"""The partition rules (``tpu_ddp_torch/parallel/partitioning.py``) and the
tensor-parallel layout read from them (``parallel/tensor_parallel.py``)
against the JAX package's ``tpu_ddp/parallel/partitioning.py`` on the ViT,
NetResDeep and ResNet-18 templates, with the shapes
``tests/test_tensor_parallel.py:98-168`` pins. No process group: the
layout is computed for each rank index in turn.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

VIT = dict(patch_size=8, hidden_dim=64, depth=2, num_heads=4, num_classes=10)


def _flat(tree, is_leaf=None):
    from tpu_ddp.parallel.partitioning import _path_str

    return {_path_str(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _jax_params(name):
    from tpu_ddp.models.resnet import NetResDeep
    from tpu_ddp.models.vit import ViT
    from tpu_ddp.models.zoo import MODEL_REGISTRY

    model = {"vit": lambda: ViT(**VIT), "netresdeep": NetResDeep,
             "resnet18": lambda: MODEL_REGISTRY["resnet18"](num_classes=10)}[name]()
    x = np.zeros((1, 32, 32, 3), np.float32)
    return jax.eval_shape(lambda: model.init(jax.random.key(0), x, train=False))["params"]


def _port_model(name):
    from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep, ViT

    return {"vit": lambda: ViT(**VIT), "netresdeep": NetResDeep,
            "resnet18": lambda: MODEL_REGISTRY["resnet18"](num_classes=10)}[name]()


def _rules(name):
    from tpu_ddp.parallel import tensor_parallel as jtp
    from tpu_ddp_torch.parallel import tensor_parallel as ptp

    return (jtp.VIT_TP_RULES, ptp.VIT_TP_RULES) if name == "vit" else \
        (jtp.CNN_TP_RULES, ptp.CNN_TP_RULES)


def _specs(tree):
    return {k: tuple(v) for k, v in _flat(tree, is_leaf=lambda x: isinstance(x, P)).items()}


MODELS = ["vit", "netresdeep", "resnet18"]


@pytest.mark.parametrize("name", MODELS)
def test_jax_view_is_the_jax_tree(name):
    """The port's params name the JAX paths with their JAX shapes."""
    from tpu_ddp_torch.parallel.tensor_parallel import jax_view

    want = {k: tuple(v.shape) for k, v in _flat(_jax_params(name)).items()}
    got = {path: shape for path, shape, _ in jax_view(_port_model(name)).values()}
    assert got == want


@pytest.mark.parametrize("name", MODELS)
def test_specs_for_params_as_jax(name):
    from tpu_ddp.parallel.partitioning import specs_for_params as jax_specs
    from tpu_ddp_torch.parallel.partitioning import specs_for_params

    params = _jax_params(name)
    jrules, prules = _rules(name)
    shapes = {k: tuple(v.shape) for k, v in _flat(params).items()}
    assert specs_for_params(shapes, prules) == _specs(jax_specs(params, jrules))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("axis_size", [2, 4, 8])
def test_fsdp_and_compose_as_jax(name, axis_size):
    from tpu_ddp.parallel import partitioning as jp
    from tpu_ddp_torch.parallel import partitioning as pp

    params = _jax_params(name)
    jrules, prules = _rules(name)
    shapes = {k: tuple(v.shape) for k, v in _flat(params).items()}
    assert pp.fsdp_specs(shapes, "data", axis_size) == _specs(
        jp.fsdp_specs(params, "data", axis_size))
    tp = jp.specs_for_params(params, jrules)
    assert pp.compose_fsdp_over(pp.specs_for_params(shapes, prules), shapes, "data",
                                axis_size) == _specs(
        jp.compose_fsdp_over(tp, params, "data", axis_size))


def test_fsdp_specs_skip_small_and_indivisible():
    from tpu_ddp_torch.parallel.partitioning import fsdp_specs

    specs = fsdp_specs({"small": (4,), "odd": (30, 3), "big": (7, 64)}, "data", 8)
    assert specs == {"small": (), "odd": (), "big": (None, "data")}


def test_compose_fsdp_over_tp_specs():
    from tpu_ddp_torch.parallel.partitioning import compose_fsdp_over

    shapes = {"qkv_kernel": (64, 96), "tiny_bias": (5,), "plain_kernel": (64, 64)}
    tp = {"qkv_kernel": (None, "model"), "tiny_bias": (), "plain_kernel": ()}
    assert compose_fsdp_over(tp, shapes, "data", 2) == {
        "qkv_kernel": ("data", "model"), "tiny_bias": (), "plain_kernel": ("data", None)}


def test_opt_state_suffix_matching():
    from tpu_ddp_torch.parallel.partitioning import opt_state_specs, specs_for_params
    from tpu_ddp_torch.parallel.tensor_parallel import VIT_TP_RULES

    shapes = {k: tuple(v.shape) for k, v in _flat(_jax_params("vit")).items()}
    specs = specs_for_params(shapes, VIT_TP_RULES)
    got = opt_state_specs(["0/trace/block_1/attn/qkv/kernel", "0/trace/block_1/ln1/scale",
                           "1/count"], specs)
    assert got == {"0/trace/block_1/attn/qkv/kernel": (None, "model"),
                   "0/trace/block_1/ln1/scale": (), "1/count": ()}


@pytest.mark.parametrize("name,model_size", [("vit", 4), ("vit", 2), ("netresdeep", 4),
                                             ("resnet18", 2)])
def test_local_shapes_match_jax_shards(name, model_size):
    """Each rank's cut leaf has the JAX shard's shape (transposed to the
    torch layout), the cut leaves are exactly those the JAX specs shard, and
    the ranks' pieces tile the whole leaf."""
    from tpu_ddp.parallel.partitioning import specs_for_params as jax_specs
    from tpu_ddp_torch.parallel.tensor_parallel import TensorParallel, jax_view

    model = _port_model(name)
    jrules, prules = _rules(name)
    jspecs = _specs(jax_specs(_jax_params(name), jrules))
    view = jax_view(model)
    params = dict(model.named_parameters())
    for m in range(model_size):
        tp = TensorParallel(model, prules, model_size, m, None)
        for pname, (path, jshape, dims) in view.items():
            spec = jspecs[path]
            assert tp.sharded(pname) == ("model" in spec), pname
            if "model" not in spec:
                continue
            local = tp.local(pname, params[pname].detach())
            jd = spec.index("model")
            want = list(jshape)
            want[jd] //= model_size
            assert tuple(local.shape[d] for d in dims) == tuple(want), pname
    for pname in params:
        if "model" in jspecs[view[pname][0]]:
            dim, idx = TensorParallel(model, prules, model_size, 0, None).layout[pname]
            assert sorted(torch.cat(idx).tolist()) == list(range(params[pname].shape[dim]))


def test_vit_qkv_cut_by_heads():
    """At model=2 with 3 heads a rank holds whole heads, 2 and 1: each
    rank's q, k and v columns of its heads, the matching rows of proj."""
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.parallel.tensor_parallel import VIT_TP_RULES, TensorParallel

    model = ViT(patch_size=8, hidden_dim=48, depth=1, num_heads=3)
    C, D = 48, 16
    for m, heads in ((0, [0, 1]), (1, [2])):
        tp = TensorParallel(model, VIT_TP_RULES, 2, m, None)
        cols = np.concatenate([np.arange(h * D, (h + 1) * D) for h in heads])
        dim, idx = tp.layout["block_0.attn.qkv.weight"]
        assert dim == 0
        np.testing.assert_array_equal(idx[m], np.concatenate([cols, C + cols, 2 * C + cols]))
        dim, idx = tp.layout["block_0.attn.proj.weight"]
        assert dim == 1
        np.testing.assert_array_equal(idx[m], cols)
        dim, idx = tp.layout["block_0.mlp_up.weight"]
        assert (dim, len(idx[m])) == (0, 96)
    with pytest.raises(ValueError, match="whole heads"):
        TensorParallel(model, VIT_TP_RULES, 4, 0, None)
