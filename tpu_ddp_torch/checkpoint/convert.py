"""Carry the JAX package's weights and optimizer state into the port.

The inverse of the transposes in ``tpu_ddp/checkpoint/import_foreign.py``:
``from_jax`` takes the Flax ``params`` and ``batch_stats`` trees and,
optionally, the optax ``opt_state``, all with numpy leaves, and returns the
port's ``state_dict`` and ``OptState``. The port's module names follow the
Flax tree, so each leaf maps by path:

* conv ``kernel`` ``(kh, kw, in, out)`` -> ``weight`` ``(out, in, kh, kw)``;
* dense ``kernel`` ``(in, out)`` -> ``weight`` ``(out, in)`` (the port
  flattens channels-last, so ``fc1`` needs no row permutation);
* an ``nn.Embed``'s ``embedding`` ``(V, F)`` -> ``weight`` ``(V, F)``, as
  it is (the LM's ``tok_embed``);
* BatchNorm and LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* a raw param (the ViT's and the LM's ``pos_embed``, the MoE layer's
  stacked expert weights ``w_up``, ``b_up``, ``w_down`` and ``b_down``,
  kept in the JAX layout) is carried as it is, under its own name; an
  empty ``batch_stats`` tree (the ViT and the LM have no BatchNorm) gives
  no entries;
* the pipeline layout's stacked ``blocks`` tree (``tpu_ddp/parallel/
  pipeline.py``'s ``to_pipeline_params``) is unstacked into ``block_<i>``
  first, in params and in every optimizer slot, so a pp state carries
  across in the plain layout.

Every param-shaped optimizer slot (SGD trace, AdamW mu/nu, EMA) maps the
same way; the optax state is read by its field names (``trace``, ``mu``,
``nu``, ``count``, ``ema``), not by importing optax. A freeze's
``multi_transform`` state is walked too: its ``inner_states`` dict of
``MaskedState``s, whose slots hold ``MaskedNode`` (an empty NamedTuple) at
the frozen leaves, which are skipped, so a frozen leaf gets no slot, as in
the port (``train/optim.py``). Under ZeRO-1,
``parallel/zero.py``'s ``Zero1Partition.shard_opt_state`` lays the converted
state out in a rank's shards and ``deshard_opt_state`` brings it back.
Used by tests; reads nothing from the network.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpu_ddp_torch.train.optim import OptState

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias", "mean": "running_mean", "var": "running_var"}
#: params that are tensors of the module itself, not of a layer
_RAW = ("pos_embed", "w_up", "b_up", "w_down", "b_down")


def _leaf(path: str, x) -> tuple:
    head, _, last = path.rpartition(".")
    x = np.asarray(x)
    if last in _RAW:
        return path, torch.tensor(np.ascontiguousarray(x))
    if last not in _RENAME:
        raise KeyError(f"no rule to carry the Flax leaf {path!r} across")
    if last == "kernel":
        x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
    return f"{head}.{_RENAME[last]}", torch.tensor(np.ascontiguousarray(x))


def _unstack_blocks(tree):
    """A top-level ``blocks`` subtree (leaves with a leading depth axis) ->
    ``block_<i>`` subtrees (the JAX ``from_pipeline_params``)."""
    blocks = tree["blocks"]

    def depth(node):
        if hasattr(node, "items"):
            return depth(next(iter(node.values())))
        return np.asarray(node).shape[0]

    def pick(node, i):
        if hasattr(node, "items"):
            return {k: pick(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"block_{i}": pick(blocks, i) for i in range(depth(blocks))})
    return out


def convert_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested Flax dict -> flat ``{torch_name: tensor}``."""
    out = {}
    if not prefix and hasattr(tree, "items") and "blocks" in tree:
        tree = _unstack_blocks(tree)
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if getattr(value, "_fields", None) == ():      # optax MaskedNode
            continue
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(convert_tree(value, path))
        else:
            name, t = _leaf(path, value)
            out[name] = t
    return out


def _walk_opt_state(node, state: OptState) -> None:
    fields = getattr(node, "_fields", None)
    if fields is not None:
        if "trace" in fields:
            state.trace = convert_tree(node.trace)
        if "mu" in fields:
            state.mu, state.nu = convert_tree(node.mu), convert_tree(node.nu)
            state.count = torch.tensor(np.asarray(node.count), dtype=torch.int32)
        elif fields == ("count",):             # ScaleByScheduleState
            state.sched_count = torch.tensor(np.asarray(node.count),
                                             dtype=torch.int32)
        if "ema" in fields:
            state.ema = convert_tree(node.ema)
        children = [getattr(node, f) for f in fields
                    if f not in ("trace", "mu", "nu", "ema", "count")]
    elif isinstance(node, (tuple, list)):
        children = list(node)
    elif isinstance(node, dict):                 # multi_transform's partitions
        children = list(node.values())
    else:
        return
    for child in children:
        _walk_opt_state(child, state)


def from_jax(params, batch_stats, opt_state=None) -> dict:
    """``{"model": state_dict, "opt_state": OptState or None}``, on the CPU."""
    model = convert_tree(params)
    model.update(convert_tree(batch_stats))
    converted = None
    if opt_state is not None:
        converted = OptState()
        _walk_opt_state(opt_state, converted)
    return {"model": model, "opt_state": converted}


def load_into(state, converted: dict) -> None:
    """Copy ``from_jax``'s result into a port ``TrainState`` in place."""
    state.model.load_state_dict(converted["model"])
    src: Optional[OptState] = converted["opt_state"]
    if src is None:
        return
    dst = state.opt_state
    for slot in ("trace", "mu", "nu", "ema"):
        if getattr(src, slot) is not None:
            for name, t in getattr(src, slot).items():
                getattr(dst, slot)[name].copy_(t)
    for slot in ("count", "sched_count"):
        if getattr(src, slot) is not None:
            getattr(dst, slot).copy_(getattr(src, slot))
