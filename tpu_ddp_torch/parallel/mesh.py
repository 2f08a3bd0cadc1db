"""The rank grid: the ``data``, ``pipeline``, ``expert``, ``sequence`` and
``model`` axes over the ranks.

Counterpart of ``tpu_ddp/parallel/mesh.py`` (``MeshSpec.resolve`` :42,
``create_mesh`` :65). The JAX mesh is data-major with ``model`` innermost
(``AXIS_ORDER`` :28, ``devices.reshape(shape)`` :79), so here rank r sits
where the JAX mesh puts device r: with ``P``, ``E``, ``S`` and ``M`` the
pipeline, expert, sequence and model sizes, rank
``(((d * P + p) * E + e) * S + s) * M + m`` is at data index d, pipeline
index p (stage p of a pipeline), expert index e, sequence index s and model
index m. A model group is ``M`` consecutive ranks, a sequence ring is ``S``
ranks ``M`` apart, in sequence order (the causal ring's schedule depends on
it), an expert group ``E`` ranks ``S * M`` apart, a pipeline ``P`` ranks
``E * S * M`` apart in stage order, and a data group every
``P * E * S * M``-th rank. With ``P == E == 1`` this is the grid of the
sequence-parallel and GSPMD families as it was.

``create_mesh`` builds one ``torch.distributed`` group for each group of
each axis, every rank calling ``new_group`` for every group in the same
order (``torch.distributed`` requires it), and keeps this rank's five.
With no process group up (one process) they are None and every axis is 1.
``axis_of`` names the axis of a group it built (the collective recorder's
axis, ``parallel/collectives.py``), and ``axis_groups`` the ranks of every
group of that axis, the set the recorder books for the lint's
participation check (``analysis/lint.py``, COL001).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Dict, Optional

import torch.distributed as dist

DATA_AXIS = "data"
SEQUENCE_AXIS = "sequence"
PIPELINE_AXIS = "pipeline"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
#: the JAX package's axis order, outermost first
AXIS_ORDER = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQUENCE_AXIS, MODEL_AXIS)


def resolve(sizes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """Every axis's size, their product ``n_devices``, from the axis sizes
    ``sizes`` (missing axes are 1, data -1; -1 on at most one axis means
    "the rest"), with ``MeshSpec.resolve``'s messages."""
    for axis in sizes:
        if axis not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {axis!r}; choose from {AXIS_ORDER}")
    # MeshSpec's defaults: data takes the rest, the others are 1
    full = {a: sizes.get(a, -1 if a == DATA_AXIS else 1) for a in AXIS_ORDER}
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
    """This rank's place on the grid and its groups (module docstring):
    ``data_size`` x ``pipeline_size`` x ``expert_size`` x ``sequence_size``
    x ``model_size`` ranks, this one at ``(data_index, pipeline_index,
    expert_index, sequence_index, model_index)``."""

    data_size: int
    sequence_size: int
    rank: int
    ring: Optional[dist.ProcessGroup] = None      # this rank's sequence group
    column: Optional[dist.ProcessGroup] = None    # this rank's data group
    model_size: int = 1
    tensor: Optional[dist.ProcessGroup] = None    # this rank's model group
    pipeline_size: int = 1
    pipe: Optional[dist.ProcessGroup] = None      # this rank's pipeline
    expert_size: int = 1
    experts: Optional[dist.ProcessGroup] = None   # this rank's expert group

    def _index(self, inner: int, size: int) -> int:
        return (self.rank // inner) % size

    @property
    def data_index(self) -> int:
        return self.rank // (self.pipeline_size * self.expert_size * self.sequence_size
                             * self.model_size)

    @property
    def pipeline_index(self) -> int:
        return self._index(self.expert_size * self.sequence_size * self.model_size,
                           self.pipeline_size)

    @property
    def expert_index(self) -> int:
        return self._index(self.sequence_size * self.model_size, self.expert_size)

    @property
    def sequence_index(self) -> int:
        return self._index(self.model_size, self.sequence_size)

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    def sequence_group(self) -> Optional[dist.ProcessGroup]:
        """This rank's sequence ring: the ``S`` ranks at its other indices,
        in sequence order."""
        return self.ring

    def data_group(self) -> Optional[dist.ProcessGroup]:
        """The ``D`` ranks at this rank's pipeline, expert, sequence and
        model index."""
        return self.column

    def model_group(self) -> Optional[dist.ProcessGroup]:
        """The ``M`` consecutive ranks at this rank's other indices."""
        return self.tensor

    def pipeline_group(self) -> Optional[dist.ProcessGroup]:
        """This rank's pipeline: the ``P`` ranks at its other indices, in
        stage order."""
        return self.pipe

    def expert_group(self) -> Optional[dist.ProcessGroup]:
        """The ``E`` ranks at this rank's other indices, in expert order."""
        return self.experts


#: each group ``create_mesh`` built -> (its axis, the global ranks of every
#: group of that axis, in the order they were built); a group dropped (its
#: world destroyed, its mesh gone) drops out
_GROUPS = weakref.WeakKeyDictionary()


def axis_of(group: Optional[dist.ProcessGroup], world_axis: str = "data") -> str:
    """The axis name of ``group``: ``world_axis`` for the default group
    (None), the axis ``create_mesh`` built it for, else "unknown"."""
    if group is None:
        return world_axis
    return _GROUPS[group][0] if group in _GROUPS else "unknown"


def axis_groups(group: Optional[dist.ProcessGroup]) -> list:
    """The global ranks of every group of ``group``'s axis, one tuple a
    group (every rank builds them all, ``create_mesh``): all ranks for the
    default group (None), ``group``'s own ranks alone for a group the mesh
    did not build."""
    if group is None:
        return [tuple(range(dist.get_world_size() if dist.is_initialized() else 1))]
    if group in _GROUPS:
        return list(_GROUPS[group][1])
    return [tuple(dist.get_process_group_ranks(group))]


#: the Mesh field each axis's group is kept in
_GROUP_FIELD = {SEQUENCE_AXIS: "ring", DATA_AXIS: "column", MODEL_AXIS: "tensor",
                PIPELINE_AXIS: "pipe", EXPERT_AXIS: "experts"}


def create_mesh(sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The grid of ``sizes`` (``resolve``; default all data) over the
    ranks of the default process group, or the grid of one process with
    no group. Every rank must call it, at the same point."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    shape = resolve(dict(sizes or {DATA_AXIS: -1}), world)
    mesh = Mesh(shape[DATA_AXIS], shape[SEQUENCE_AXIS], dist.get_rank() if up else 0,
                model_size=shape[MODEL_AXIS], pipeline_size=shape[PIPELINE_AXIS],
                expert_size=shape[EXPERT_AXIS])
    if not up:
        return mesh
    mine = {DATA_AXIS: mesh.data_index, PIPELINE_AXIS: mesh.pipeline_index,
            EXPERT_AXIS: mesh.expert_index, SEQUENCE_AXIS: mesh.sequence_index,
            MODEL_AXIS: mesh.model_index}

    def at(coords: Dict[str, int]) -> int:
        r = 0
        for a in AXIS_ORDER:
            r = r * shape[a] + coords[a]
        return r

    # every rank builds every group, the axes in this order
    for axis in (SEQUENCE_AXIS, DATA_AXIS, MODEL_AXIS, PIPELINE_AXIS, EXPERT_AXIS):
        others = [a for a in AXIS_ORDER if a != axis]
        built, members = [], []
        for rest in itertools.product(*(range(shape[a]) for a in others)):
            coords = dict(zip(others, rest))
            ranks = [at({**coords, axis: i}) for i in range(shape[axis])]
            group = dist.new_group(ranks)
            members.append(tuple(ranks))
            if isinstance(group, dist.ProcessGroup):
                built.append(group)
            if all(coords[a] == mine[a] for a in others):
                setattr(mesh, _GROUP_FIELD[axis], group)
        for group in built:
            _GROUPS[group] = (axis, tuple(members))
    return mesh
