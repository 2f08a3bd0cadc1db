"""The rank grid: the ``data``, ``sequence`` and ``model`` axes over the
ranks.

Counterpart of ``tpu_ddp/parallel/mesh.py`` (``MeshSpec.resolve`` :42,
``create_mesh`` :65) for the three axes the port runs. The JAX mesh is
data-major with ``model`` innermost (``AXIS_ORDER`` :28,
``devices.reshape(shape)`` :79), so here rank r sits at data index
``r // (S * M)``, sequence index ``(r // M) % S`` and model index
``r % M`` (``S``, ``M``: the sequence and model sizes): a model group is
``M`` consecutive ranks, a sequence ring is ``S`` ranks ``M`` apart, in
sequence order (the causal ring's schedule depends on it), and a data
group is every ``S * M``-th rank. With ``M == 1`` this is the grid of
sequence parallelism as it was: ring ``d * S .. d * S + S - 1``.

``create_mesh`` builds one ``torch.distributed`` group for each ring, each
data column and each model group, every rank calling ``new_group`` for
every group in the same order (``torch.distributed`` requires it), and
keeps this rank's three. With no process group up (one process) they are
None and the grid is 1 x 1 x 1. The other JAX axes (``pipeline``,
``expert``) belong to parallelisms not ported yet (``ROADMAP.md`` §1 item
2): naming one at a size other than 1 raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch.distributed as dist

DATA_AXIS = "data"
SEQUENCE_AXIS = "sequence"
PIPELINE_AXIS = "pipeline"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
#: the JAX package's axis order, outermost first
AXIS_ORDER = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQUENCE_AXIS, MODEL_AXIS)
#: the axes the port runs, outermost first
PORTED_AXES = (DATA_AXIS, SEQUENCE_AXIS, MODEL_AXIS)


def resolve(sizes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """``{"data": D, "sequence": S, "model": M}`` with ``D * S * M ==
    n_devices`` from the axis sizes ``sizes`` (missing axes are 1; -1 on at
    most one axis means "the rest"), with ``MeshSpec.resolve``'s
    messages."""
    for axis, size in sizes.items():
        if axis not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {axis!r}; choose from {AXIS_ORDER}")
        if axis not in PORTED_AXES and size != 1:
            raise ValueError(
                f"mesh axis {axis!r} is not ported yet: the port runs the data, "
                "sequence and model axes (ROADMAP.md §1 item 2 queues the "
                "pipeline and expert axes)")
    # MeshSpec's defaults: data takes the rest, the others are 1
    full = {DATA_AXIS: sizes.get(DATA_AXIS, -1), SEQUENCE_AXIS: sizes.get(SEQUENCE_AXIS, 1),
            MODEL_AXIS: sizes.get(MODEL_AXIS, 1)}
    wild = [k for k, v in full.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis, got {wild}")
    fixed = math.prod(v for v in full.values() if v != -1)
    if wild:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}")
        full[wild[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(f"mesh wants {fixed} devices, have {n_devices}")
    return full


@dataclasses.dataclass
class Mesh:
    """This rank's place on the grid and its three groups (module
    docstring): ``data_size`` x ``sequence_size`` x ``model_size`` ranks,
    this one at ``(data_index, sequence_index, model_index)``."""

    data_size: int
    sequence_size: int
    rank: int
    ring: Optional[dist.ProcessGroup] = None      # this rank's sequence group
    column: Optional[dist.ProcessGroup] = None    # this rank's data group
    model_size: int = 1
    tensor: Optional[dist.ProcessGroup] = None    # this rank's model group

    @property
    def data_index(self) -> int:
        return self.rank // (self.sequence_size * self.model_size)

    @property
    def sequence_index(self) -> int:
        return (self.rank // self.model_size) % self.sequence_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def sequence_group(self) -> Optional[dist.ProcessGroup]:
        """This rank's sequence ring: ranks ``d * S * M + s * M + m`` over
        s (``d * S .. d * S + S - 1`` at ``M == 1``)."""
        return self.ring

    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks at this rank's sequence and model index: ``s * M + m``,
        then every ``S * M``-th rank."""
        return self.column

    def model_group(self) -> Optional[dist.ProcessGroup]:
        """The ``M`` consecutive ranks at this rank's data and sequence
        index."""
        return self.tensor


def create_mesh(sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The grid of ``sizes`` (``resolve``; default all data) over the
    ranks of the default process group, or the 1 x 1 x 1 grid of one
    process with no group. Every rank must call it, at the same point."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    shape = resolve(dict(sizes or {DATA_AXIS: -1}), world)
    D, S, M = shape[DATA_AXIS], shape[SEQUENCE_AXIS], shape[MODEL_AXIS]
    mesh = Mesh(D, S, dist.get_rank() if up else 0, model_size=M)
    if not up:
        return mesh
    at = lambda d, s, m: (d * S + s) * M + m  # noqa: E731
    for d in range(D):                       # every rank builds every group
        for m in range(M):
            group = dist.new_group([at(d, s, m) for s in range(S)])
            if (d, m) == (mesh.data_index, mesh.model_index):
                mesh.ring = group
    for s in range(S):
        for m in range(M):
            group = dist.new_group([at(d, s, m) for d in range(D)])
            if (s, m) == (mesh.sequence_index, mesh.model_index):
                mesh.column = group
    for d in range(D):
        for s in range(S):
            group = dist.new_group([at(d, s, m) for m in range(M)])
            if (d, s) == (mesh.data_index, mesh.sequence_index):
                mesh.tensor = group
    return mesh
