"""The rank grid: the ``data`` and ``sequence`` axes over the ranks.

Counterpart of ``tpu_ddp/parallel/mesh.py`` (``MeshSpec.resolve`` :42,
``create_mesh`` :65) for the two axes the port runs. The JAX mesh is
data-major (``AXIS_ORDER`` :28, ``devices.reshape(shape)`` :79), so here
rank r sits at data index ``r // sequence`` and sequence index
``r % sequence``: a sequence ring is ``sequence`` consecutive ranks, in
sequence order (the causal ring's schedule depends on it), and a data
group is every ``sequence``-th rank.

``create_mesh`` builds one ``torch.distributed`` group for each ring and
one for each data column, every rank calling ``new_group`` for every group
in the same order (``torch.distributed`` requires it), and keeps this
rank's two. With no process group up (one process) both are None and the
grid is 1 x 1. The other JAX axes (``pipeline``, ``expert``, ``model``)
belong to parallelisms not ported yet (``ROADMAP.md`` §1 item 2): naming one
at a size other than 1 raises.
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
#: the axes the port runs
PORTED_AXES = (DATA_AXIS, SEQUENCE_AXIS)


def resolve(sizes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """``{"data": D, "sequence": S}`` with ``D * S == n_devices`` from the
    axis sizes ``sizes`` (missing axes are 1; -1 on at most one axis means
    "the rest"), with ``MeshSpec.resolve``'s messages."""
    for axis, size in sizes.items():
        if axis not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {axis!r}; choose from {AXIS_ORDER}")
        if axis not in PORTED_AXES and size != 1:
            raise ValueError(
                f"mesh axis {axis!r} is not ported yet: the port runs the data and "
                "sequence axes only (ROADMAP.md §1 item 2 queues the others)")
    # MeshSpec's defaults: data takes the rest, sequence is 1
    full = {DATA_AXIS: sizes.get(DATA_AXIS, -1), SEQUENCE_AXIS: sizes.get(SEQUENCE_AXIS, 1)}
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
    """This rank's place on the grid and its two groups (module
    docstring): ``data_size`` x ``sequence_size`` ranks, this one at
    ``(data_index, sequence_index)``."""

    data_size: int
    sequence_size: int
    rank: int
    ring: Optional[dist.ProcessGroup] = None      # this rank's sequence group
    column: Optional[dist.ProcessGroup] = None    # this rank's data group

    @property
    def data_index(self) -> int:
        return self.rank // self.sequence_size

    @property
    def sequence_index(self) -> int:
        return self.rank % self.sequence_size

    def sequence_group(self) -> Optional[dist.ProcessGroup]:
        """This rank's sequence ring: ranks ``d * S .. d * S + S - 1``."""
        return self.ring

    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks at this rank's sequence index: ``s, s + S, ...``."""
        return self.column


def create_mesh(sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The grid of ``sizes`` (``resolve``; default all data) over the
    ranks of the default process group, or the 1 x 1 grid of one process
    with no group. Every rank must call it, at the same point."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    shape = resolve(dict(sizes or {DATA_AXIS: -1}), world)
    D, S = shape[DATA_AXIS], shape[SEQUENCE_AXIS]
    mesh = Mesh(D, S, dist.get_rank() if up else 0)
    if not up:
        return mesh
    for d in range(D):                       # every rank builds every group
        group = dist.new_group(list(range(d * S, (d + 1) * S)))
        if d == mesh.data_index:
            mesh.ring = group
    for s in range(S):
        group = dist.new_group(list(range(s, world, S)))
        if s == mesh.sequence_index:
            mesh.column = group
    return mesh
