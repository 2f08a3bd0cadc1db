"""The parameter-partitioning rules of the GSPMD families, over name ->
shape maps.

Counterpart of ``tpu_ddp/parallel/partitioning.py`` (``PartitionRule``
:44, ``specs_for_params`` :54, ``fsdp_specs`` :68, ``compose_fsdp_over``
:88, ``opt_state_specs`` :116). The JAX functions walk pytrees of arrays
and return ``PartitionSpec`` trees for the XLA partitioner; these take
flat ``{path: shape}`` dicts (a path is the JAX tree path, ``/`` between
the keys; the port's parameter names are those paths with ``.`` for ``/``
and ``weight`` for ``kernel`` or ``scale``, ``parallel/tensor_parallel.py``
maps one onto the other) and return ``{path: spec}``, where a spec is a
tuple of mesh axis names or None, one a dimension of the JAX shape, and
``()`` means replicated (``P()``). The rules, the first-match order and
the fsdp heuristics are the JAX ones; the arithmetic that follows from a
spec is ``parallel/tensor_parallel.py``'s.

Not ported: ``train_state_shardings``, ``shard_train_state`` and
``abstract_train_state`` (``NamedSharding`` trees for ``jax.jit``; the
port lays a rank's shards out itself).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Sequence, Tuple

Spec = Tuple[object, ...]
Shapes = Dict[str, Tuple[int, ...]]


def _path(name: str) -> str:
    """A name with ``.`` or ``/`` between its keys -> the JAX path string."""
    return name.replace(".", "/")


@dataclasses.dataclass(frozen=True)
class PartitionRule:
    """First rule whose regex matches (``re.search``) the param's path string
    wins; unmatched params are replicated."""

    pattern: str
    spec: Spec

    def matches(self, path_str: str) -> bool:
        return re.search(self.pattern, _path(path_str)) is not None


def specs_for_params(shapes: Shapes, rules: Sequence[PartitionRule]) -> Dict[str, Spec]:
    """``{path: spec}`` for every path of ``shapes``: the first matching
    rule's spec, ``()`` where none matches."""
    out = {}
    for name in shapes:
        out[name] = next((r.spec for r in rules if r.matches(name)), ())
    return out


def _fsdp_pick(spec: Spec, shape: Tuple[int, ...], axis: str, axis_size: int) -> Spec:
    """``compose_fsdp_over``'s choice for one leaf (``fsdp_specs`` is the
    case of an all-free spec)."""
    if not shape or max(shape) < 2 * axis_size:
        return spec
    merged = list(spec) + [None] * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if merged[d] is None]
    for d in sorted(free, key=lambda d: -shape[d]):
        if shape[d] % axis_size == 0:
            merged[d] = axis
            return tuple(merged)
    return spec


def fsdp_specs(shapes: Shapes, axis: str, axis_size: int) -> Dict[str, Spec]:
    """ZeRO-3/FSDP-style specs: shard each param's LARGEST axis-size-divisible
    dimension over ``axis``; params with no divisible dim (or too small to be
    worth scattering) stay replicated."""
    return {name: _fsdp_pick((), tuple(shape), axis, axis_size)
            for name, shape in shapes.items()}


def compose_fsdp_over(specs: Dict[str, Spec], shapes: Shapes, axis: str,
                      axis_size: int) -> Dict[str, Spec]:
    """Layer ZeRO-3 scattering over an EXISTING spec map (Megatron TP over
    ``model`` + FSDP over ``data``): for each param, shard its largest
    still-unsharded, axis-size-divisible dimension over ``axis``. Params
    already fully sharded, too small, or with no divisible free dim keep
    their spec unchanged."""
    return {name: _fsdp_pick(tuple(specs[name]), tuple(shape), axis, axis_size)
            for name, shape in shapes.items()}


def opt_state_specs(slot_names: Sequence[str], specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """Specs for optimizer-state leaves named by their paths (a slot's
    path, e.g. ``0/trace/block_0/attn/qkv/kernel``): a leaf whose path ENDS
    with a param's path inherits that param's spec (the longest suffix
    wins); everything else (step counts, scalars) is replicated."""
    by_suffix = {tuple(_path(n).split("/")): spec for n, spec in specs.items()}
    out = {}
    for name in slot_names:
        parts = tuple(_path(name).split("/"))
        out[name] = next((by_suffix[parts[-k:]] for k in range(len(parts), 0, -1)
                          if parts[-k:] in by_suffix), ())
    return out
