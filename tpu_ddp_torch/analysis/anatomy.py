"""The ``StepAnatomy`` of one train step that really runs.

Counterpart of ``tpu_ddp/analysis/hlo.py``. The JAX module reads XLA's
compiled program: the cost model's FLOPs and bytes accessed, the memory
analysis, and the collective inventory parsed from the optimized HLO text.
The port compiles no step graph, so this module (renamed because it reads
no HLO) takes the same record from one step run eagerly:

- the **collective inventory** and its program order from the recorder in
  ``parallel/collectives.py`` (``record_collectives``), through which every
  step collective goes: each call's kind, dtype, axis, group size and
  payload bytes, bucketed and priced on the ring model exactly as
  ``extract_collectives`` buckets HLO definition sites;
- ``flops`` by ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``, applied in the same dispatch mode as the bytes, so
  no module hooks run inside pp's ``autograd.grad``) over the whole step
  (forward, backward and the optimizer, as XLA counts the whole step).
  The formulas count matmuls, convolutions and attention; a hand-written
  kernel launched through its wrapper (K1-K6) is opaque to them, as XLA's
  cost model does not count a Pallas custom call;
- ``bytes_accessed`` from a dispatch mode that sums the operand and result
  bytes of every aten op the step runs (views move nothing and are not
  counted), the eager counterpart of XLA's per-op bytes accessed;
- ``hlo_ops``: the aten ops the step ran, by name. ``fusion_count`` is 0
  (eager PyTorch fuses nothing) and ``generated_code_bytes`` is None (no
  program is generated);
- ``argument_bytes``, ``output_bytes`` and ``temp_bytes`` from the card's
  allocator: the bytes allocated before the step (the state and the
  batch), after it, and the peak above the former. They are None on the
  CPU, as the memory record's CPU case is.

For the graph lint (``analysis/lint.py``) the same pass also books the
dtype and bytes of every matmul and convolution result (``PRODUCT_OPS``),
every device-to-host copy and host read the step's own code issues
(``_local_scalar_dense``: ``.item()``, ``bool(t)``; a ``_to_copy`` or
``copy_`` from the card to the host, gloo's wire staging left out:
``parallel/collectives.py::on_wire``), and, with ``track_memory``, the
bytes of the tensors alive through the step (the memory planner's CPU
figures, ``tools/memplan.py``, where no allocator counts them): each
storage the step's ops create or the step started with is counted until
it is freed (a ``weakref.finalize`` on its storage), and the live bytes'
peak and the largest storages alive at it are kept.

A step of N ranks is analyzed in one process by running rank 0's step
against a process group that does not communicate (``fake_world``:
``torch.distributed``'s fake backend): its collectives return at once, so
the recorder sees the calls a real rank 0 makes. ``tests/test_torch_anatomy.py``
holds that inventory against a real gloo step's.

``StepAnatomy``, ``Collective``, ``ScheduledCollective``, ``_wire_bytes``,
``ANATOMY_SCHEMA_VERSION`` and ``COLLECTIVE_OPS`` are the JAX ones: an
anatomy's JSON reads back through the JAX ``StepAnatomy.from_json``. The
HLO-text parsers (``extract_collectives``, ``collective_schedule``,
``hlo_op_counts``, ``cost_analysis_figures``) and ``cached_compile`` have
no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: bump on any breaking change to the StepAnatomy record shape
#: (v2: + ``program_order`` — the linearized collective schedule)
ANATOMY_SCHEMA_VERSION = 2

#: collective kinds the inventory tracks (the JAX opcodes)
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all")


@dataclasses.dataclass
class Collective:
    """One (kind, dtype, axis) bucket of the inventory.

    ``payload_bytes`` is the full logical tensor the collective moves
    (summed over occurrences): the operand bytes, scaled by the group
    size for all-gather (whose operand is each device's shard).
    ``wire_bytes`` applies the standard per-device ring model on top:
    2(g-1)/g x payload for all-reduce, (g-1)/g for all-gather /
    reduce-scatter / all-to-all, 1x for collective-permute."""

    kind: str
    dtype: str
    axis: str
    count: int
    payload_bytes: int
    wire_bytes: int
    group_size: int

    def key(self) -> str:
        return f"{self.kind}/{self.dtype}/{self.axis}/g{self.group_size}"


def _wire_bytes(kind: str, payload: int, g: int) -> int:
    if g <= 1:
        return payload if kind == "collective-permute" else 0
    if kind == "all-reduce":
        return int(2 * (g - 1) / g * payload)
    if kind == "collective-permute":
        return payload
    return int((g - 1) / g * payload)


@dataclasses.dataclass
class ScheduledCollective:
    """ONE collective call in program order, where :class:`Collective` is
    the aggregated bucket. ``groups`` holds the group's global ranks;
    ``pairs`` a permute's (this rank, destination) pair, both global."""

    index: int
    kind: str
    dtype: str
    axis: str
    group_size: int
    payload_bytes: int
    groups: Optional[List[Tuple[int, ...]]]
    pairs: Optional[List[Tuple[int, int]]]

    def key(self) -> str:
        return f"{self.kind}/{self.dtype}/{self.axis}/g{self.group_size}"


def collective_schedule(calls: Sequence[dict]) -> List[ScheduledCollective]:
    """The recorder's calls (``parallel/collectives.py::record_collectives``)
    as the linearized schedule, one entry a call: ``groups`` every group of
    the call's axis (the JAX HLO's replica groups), or the call's own group
    where the record has no set."""
    return [ScheduledCollective(
        index=i, kind=c["kind"], dtype=c["dtype"], axis=c["axis"],
        group_size=c["group_size"], payload_bytes=c["payload_bytes"],
        groups=[tuple(g) for g in c.get("groups") or [c["ranks"]]],
        pairs=None if c.get("peer") is None else [(c["src"], c["peer"])])
        for i, c in enumerate(calls)]


def inventory(calls: Sequence[dict]) -> List[Collective]:
    """The recorder's calls bucketed by (kind, dtype, axis, group size),
    sorted by descending wire bytes (the JAX ``extract_collectives``)."""
    buckets: Dict[Tuple[str, str, str, int], Dict[str, int]] = {}
    for c in calls:
        key = (c["kind"], c["dtype"], c["axis"], c["group_size"])
        b = buckets.setdefault(key, {"count": 0, "payload": 0, "wire": 0})
        b["count"] += 1
        b["payload"] += c["payload_bytes"]
        b["wire"] += _wire_bytes(c["kind"], c["payload_bytes"], c["group_size"])
    out = [
        Collective(kind=k, dtype=d, axis=a, count=b["count"],
                   payload_bytes=b["payload"], wire_bytes=b["wire"],
                   group_size=g)
        for (k, d, a, g), b in buckets.items()
    ]
    out.sort(key=lambda c: (-c.wire_bytes, c.kind, c.dtype))
    return out


@dataclasses.dataclass
class StepAnatomy:
    """Schema-versioned anatomy of ONE train step (the JAX record).

    All sizes are PER DEVICE (a rank's); ``flops``/``bytes_accessed`` are
    one step's counts (module docstring), ``None`` where none was taken."""

    strategy: str
    model: str
    device_kind: str
    mesh: Dict[str, int]
    n_devices: int
    per_shard_batch: Optional[int]
    compute_dtype: Optional[str]
    flops: Optional[float]
    bytes_accessed: Optional[float]
    argument_bytes: Optional[int]
    output_bytes: Optional[int]
    temp_bytes: Optional[int]
    generated_code_bytes: Optional[int]
    fusion_count: int
    hlo_ops: Dict[str, int]
    collectives: List[Collective]
    #: inventory keys in program order (one entry per collective call)
    program_order: List[str] = dataclasses.field(default_factory=list)
    schema_version: int = ANATOMY_SCHEMA_VERSION

    @property
    def peak_bytes(self) -> Optional[int]:
        """Steady-state estimate: arguments + temps (the JAX convention)."""
        if self.argument_bytes is None or self.temp_bytes is None:
            return None
        return self.argument_bytes + self.temp_bytes

    def inventory(self) -> Dict[str, Dict[str, int]]:
        """``{"kind/dtype/axis/gN": {count, payload_bytes, wire_bytes}}``
        — the comparison key ``bench compare`` diffs."""
        return {
            c.key(): {"count": c.count, "payload_bytes": c.payload_bytes,
                      "wire_bytes": c.wire_bytes,
                      "group_size": c.group_size}
            for c in self.collectives
        }

    def collective_kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.count
        return out

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["peak_bytes"] = self.peak_bytes
        rec["inventory"] = self.inventory()
        return rec

    @classmethod
    def from_json(cls, rec: dict) -> "StepAnatomy":
        version = rec.get("schema_version", 0)
        if version > ANATOMY_SCHEMA_VERSION:
            raise ValueError(
                f"anatomy schema_version {version} is newer than this "
                f"tool understands ({ANATOMY_SCHEMA_VERSION})"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in rec.items() if k in fields}
        kw["collectives"] = [
            Collective(**c) for c in rec.get("collectives", ())
        ]
        return cls(**kw)


# -- counting one step -----------------------------------------------------


def world_axis(mesh: Dict[str, int]) -> str:
    """The axis name of the whole rank grid: its one axis of more than one
    rank, "all" for several, "unknown" for none (the JAX
    ``_axis_of_groups`` on the full group)."""
    live = [a for a, s in mesh.items() if s > 1]
    return live[0] if len(live) == 1 else ("all" if live else "unknown")


#: the aten ops whose results DTY001 reads: the matmuls and convolutions
#: (the JAX ``dot_general`` and ``conv_general_dilated``), backward too
PRODUCT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "convolution",
                         "_convolution", "convolution_backward", "cudnn_convolution",
                         "_scaled_mm"})


def _dtype_token(dtype) -> str:
    """``torch.float32`` -> ``float32`` (the JAX dtype names)."""
    return str(dtype).replace("torch.", "")


class _LiveBytes:
    """The tensors alive through a step, by storage (module docstring):
    ``live`` bytes now, their ``peak`` and the largest storages at it;
    ``start`` the bytes its owner counted before the step."""

    def __init__(self, top: int):
        self.live = self.peak = self.start = 0
        self.top = top
        self.at_peak: List[dict] = []
        self._rows: Dict[int, dict] = {}     # id(storage) -> its row

    def _freed(self, key: int) -> None:
        row = self._rows.pop(key, None)
        if row is not None:
            self.live -= row["bytes"]

    def add(self, t, op: str, name: Optional[str] = None) -> None:
        """Count ``t``'s storage from now until it is freed (once); its row
        names the op that made it (``name``: what it is, default the op)."""
        import weakref

        st = t.untyped_storage()
        nbytes = st.nbytes()
        if not nbytes or id(st) in self._rows:
            return
        self._rows[id(st)] = {"name": name or op, "op": op, "dtype": _dtype_token(t.dtype),
                              "shape": list(t.shape), "bytes": int(nbytes)}
        weakref.finalize(st, self._freed, id(st))
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live
            self.at_peak = sorted(self._rows.values(), key=lambda r: -r["bytes"])[:self.top]


def _counting_mode(live: Optional[_LiveBytes] = None):
    """A dispatch mode over every aten op the step runs: its FLOPs by
    ``torch.utils.flop_counter``'s formulas (the ops ``FlopCounterMode``
    counts: matmuls, convolutions, attention), the bytes of its tensor
    operands and results (views excluded), its name, the lint's records
    (``products``: each ``PRODUCT_OPS`` result's op, dtype and bytes;
    ``host``: each host read and device-to-host copy, module docstring)
    and, given ``live``, the storages of its results."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    from tpu_ddp_torch.parallel.collectives import on_wire

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.ops: Dict[str, int] = {}
            self.products: List[Tuple[str, str, int]] = []
            self.host: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            name = packet.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if not getattr(func, "is_view", False):
                for t in tree_leaves((args, kwargs)):
                    if isinstance(t, torch.Tensor):
                        self.bytes += t.numel() * t.element_size()
                for t in results:
                    self.bytes += t.numel() * t.element_size()
                    if live is not None:
                        live.add(t, name)
            if name in PRODUCT_OPS:
                self.products += [(name, _dtype_token(t.dtype), t.numel() * t.element_size())
                                  for t in results]
            if name == "_local_scalar_dense":
                self.host.append(f"{name} on {args[0].device.type} (a host read: "
                                 ".item(), bool(), int() or float() of a tensor)")
            elif name in ("_to_copy", "copy_", "copy") and not on_wire():
                src = args[1] if name != "_to_copy" else args[0]
                dst = out if name != "copy_" else args[0]
                if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                        and src.device.type != "cpu" and dst.device.type == "cpu"):
                    self.host.append(f"{name} {src.device.type} -> cpu of "
                                     f"{src.numel() * src.element_size()} B")
            return out

    return Counter()


def count_step(step: Callable[[], object], *, world: str = "data",
               device=None, live: Optional[_LiveBytes] = None) -> dict:
    """Run ``step()`` once under the collective recorder and the counting
    mode (module docstring). Returns ``flops``, ``bytes_accessed``,
    ``hlo_ops``, ``calls`` (the recorder's), the lint's ``products`` and
    ``host`` records, and the allocator's ``argument_bytes``,
    ``output_bytes`` and ``temp_bytes`` (None off the card). ``live`` (a
    ``_LiveBytes`` already holding the step's arguments) also tracks the
    bytes alive through the step."""
    import torch

    from tpu_ddp_torch.parallel.collectives import record_collectives

    cuda = device is not None and torch.device(device).type == "cuda"
    arg = out = temp = None
    if cuda:
        torch.cuda.synchronize(device)
        arg = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    counter = _counting_mode(live)
    with record_collectives(world) as calls, counter:
        step()
    if cuda:
        torch.cuda.synchronize(device)
        out = torch.cuda.memory_allocated(device)
        temp = torch.cuda.max_memory_allocated(device) - arg
    return {"flops": float(counter.flops) or None,
            "bytes_accessed": float(counter.bytes) or None,
            "hlo_ops": dict(sorted(counter.ops.items())), "calls": list(calls),
            "products": list(counter.products), "host": list(counter.host),
            "argument_bytes": arg, "output_bytes": out, "temp_bytes": temp}


def anatomy_from_counts(counts: dict, *, strategy: str, model: str, device_kind: str,
                        mesh: Dict[str, int], per_shard_batch: Optional[int],
                        compute_dtype: Optional[str]) -> StepAnatomy:
    """The :class:`StepAnatomy` of one ``count_step`` record."""
    n_devices = 1
    for size in mesh.values():
        n_devices *= size
    calls = counts["calls"]
    return StepAnatomy(
        strategy=strategy, model=model, device_kind=device_kind, mesh=dict(mesh),
        n_devices=n_devices, per_shard_batch=per_shard_batch,
        compute_dtype=compute_dtype, flops=counts["flops"],
        bytes_accessed=counts["bytes_accessed"],
        argument_bytes=counts["argument_bytes"], output_bytes=counts["output_bytes"],
        temp_bytes=counts["temp_bytes"], generated_code_bytes=None, fusion_count=0,
        hlo_ops=counts["hlo_ops"], collectives=inventory(calls),
        program_order=[c.key() for c in collective_schedule(calls)])


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a process group of ``n`` ranks that does not communicate
    (``torch.distributed``'s fake backend), for the ``with``; the group is
    torn down after it. Refuses when a process group is up already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is up already; analyze "
                           "a step in a process of its own")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
