"""Measured collective microbenchmarks over the rank grid.

Counterpart of ``tpu_ddp/comms/microbench.py``. For every collective kind
of the JAX fingerprint vocabulary (``BENCH_KINDS``, through the port's own
``parallel/collectives.py``: ``_all_reduce_flat``, ``reduce_scatter_sum``,
``all_gather_bytes``, ``all_to_all`` and ``ring_shift``) plus the
compressed rings the trainer runs (``RING_KINDS``: ``ring_all_reduce_flat``
and ``ring_reduce_scatter_flat``, whose int8 hops launch K2/K3 on the
card), sweep payload sizes over each nontrivial axis of the rank grid
(``parallel/mesh.py``, the JAX axis names) and measure wall time: the
minimum over reps after a warm-up call, each rep started behind a barrier
of the axis's group and ended by a synchronisation of the card. Rank 0's
times go into the artifact. Wire bytes a call use the JAX ring factors
(``_wire_bytes``, a copy of ``tpu_ddp/analysis/hlo.py:229-236``: all-reduce
2(g-1)/g, all-gather, reduce-scatter and all-to-all (g-1)/g, permute 1x;
the compressed rings ``chunk_wire_bytes`` a hop), so the measured achieved
bandwidth and the accounted bytes on the wire compare directly.

The sweeps fit into per-link α-β lines (``comms/model.py``) and go into
the schema-versioned artifact (``bench_artifact``) that ``registry record``
classifies as kind ``"comms"`` and ``bench compare`` gates.

The JAX sweep records a combination that fails to build or run as
skipped. Here a failure raises: under gloo and NCCL every kind runs in
every dtype (gloo through pinned host memory for a card's tensors), so the
only rows skipped are the sizes the axis does not divide, as in JAX.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_ddp_torch.comms.model import (
    COMMS_SCHEMA_VERSION,
    AlphaBeta,
    _chip_key,
    fit_alpha_beta,
    link_key,
)
from tpu_ddp_torch.parallel import collectives
from tpu_ddp_torch.parallel.compression import chunk_wire_bytes
from tpu_ddp_torch.parallel.mesh import AXIS_ORDER, _GROUP_FIELD

#: fingerprint-vocabulary kinds benched through the stock collectives
BENCH_KINDS = ("all-reduce", "reduce-scatter", "all-gather",
               "all-to-all", "collective-permute")

#: wire dtypes swept for the stock kinds (the JAX dtype tokens)
BENCH_DTYPES = ("f32", "bf16", "s8")

#: the compressed rings (a whole call: N-1 quantized hops [+ the
#: all-gather phase]), keyed by their WIRE dtype
RING_KINDS = ("ring-all-reduce", "ring-reduce-scatter")

#: ring wire modes -> wire dtype token
RING_MODE_DTYPE = {"f32": "f32", "bf16": "bf16", "int8": "s8"}

#: per-rank payload sizes (elements): divisible by any axis size up to 16
#: and by the default int8 block (256)
DEFAULT_SIZES = (4096, 16384, 65536, 262144)
DEFAULT_REPS = 10

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "s8": torch.int8}


def _wire_bytes(kind: str, payload: int, g: int) -> int:
    if g <= 1:
        return payload if kind == "collective-permute" else 0
    if kind == "all-reduce":
        return int(2 * (g - 1) / g * payload)
    if kind == "collective-permute":
        return payload
    return int((g - 1) / g * payload)


def _ring_wire_bytes(kind: str, size: int, g: int, mode: str,
                     block: int) -> int:
    """A rank's bytes on the wire for one whole ring call, from the
    compressor's own accounting."""
    if g <= 1:
        return 0
    cw = chunk_wire_bytes(size // g, mode, block)
    hops = (g - 1) * cw  # reduce-scatter phase: N-1 quantized hops
    if kind == "ring-reduce-scatter":
        return hops
    return hops + _wire_bytes("all-gather", cw, g)  # + gather phase


def mesh_shape(mesh) -> Dict[str, int]:
    """Every axis's size of ``mesh`` (``parallel/mesh.py::Mesh``), in the
    JAX axis order."""
    return {a: int(getattr(mesh, f"{a}_size")) for a in AXIS_ORDER}


def nontrivial_axes(mesh) -> Dict[str, int]:
    return {a: s for a, s in mesh_shape(mesh).items() if s > 1}


def _stock_fn(kind: str, group):
    if kind == "all-reduce":
        return lambda x: collectives._all_reduce_flat([x], group)
    if kind == "reduce-scatter":
        return lambda x: collectives.reduce_scatter_sum(x, group)
    if kind == "all-gather":
        return lambda x: collectives.all_gather_bytes(x, group)
    if kind == "all-to-all":
        return lambda x: collectives.all_to_all(x, group)
    if kind == "collective-permute":
        return lambda x: collectives.ring_shift(x, group, 1)
    raise ValueError(f"unknown bench kind {kind!r}")


def _ring_fn(kind: str, g: int, mode: str, block: int, group):
    """The trainer's ring over one leaf of ``size`` elements; the kernel
    switch is on, so the int8 hops launch K2/K3 on the card (the CPU takes
    the plain versions)."""
    layouts: Dict[int, collectives.FlatLayout] = {}

    def layout(x):
        n = x.numel()
        if n not in layouts:
            layouts[n] = collectives.FlatLayout([n], g, block)
        return layouts[n]

    if kind == "ring-all-reduce":
        return lambda x: collectives.ring_all_reduce_flat(
            x, layout(x), mode=mode, kernels=True, group=group)[0]
    if kind == "ring-reduce-scatter":
        return lambda x: collectives.ring_reduce_scatter_flat(
            x, layout(x), mode=mode, kernels=True, group=group)[0]
    raise ValueError(f"unknown ring kind {kind!r}")


def _input(size: int, tok: str, g: int, index: int,
           device: torch.device) -> torch.Tensor:
    """This rank's ``size``-element shard of the JAX bench's global input:
    ones in s8, else ``arange(g * size) % 251`` in the dtype."""
    if tok == "s8":
        return torch.ones(size, dtype=torch.int8, device=device)
    x = torch.arange(index * size, (index + 1) * size, dtype=torch.float32) % 251.0
    return x.to(device=device, dtype=_DTYPES[tok])


def _time_best(fn, x, reps: int, group, device: torch.device) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(x)  # warm the path (and build the kernels)
    sync()
    best = float("inf")
    for _ in range(max(reps, 1)):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        fn(x)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def run_sweeps(
    mesh,
    *,
    device: torch.device,
    kinds: Sequence[str] = BENCH_KINDS + RING_KINDS,
    dtypes: Sequence[str] = BENCH_DTYPES,
    ring_modes: Sequence[str] = ("f32", "bf16", "int8"),
    sizes: Sequence[int] = DEFAULT_SIZES,
    reps: int = DEFAULT_REPS,
    block: int = 256,
    progress=None,
) -> Tuple[List[dict], List[dict]]:
    """Measure every (kind, dtype, axis, size) combination on every rank
    (each calls it, in the same order); returns ``(sweeps, skipped)`` of
    this rank's times. A size the axis does not divide is skipped, as in
    JAX; any other failure raises (module docstring)."""
    for kind in kinds:
        if kind not in BENCH_KINDS + RING_KINDS:
            raise ValueError(f"unknown bench kind {kind!r}")
    sweeps: List[dict] = []
    skipped: List[dict] = []
    for axis, g in sorted(nontrivial_axes(mesh).items()):
        group = getattr(mesh, _GROUP_FIELD[axis])
        index = dist.get_rank(group)
        combos = [(kind, tok, _stock_fn(kind, group), tok, None)
                  for kind in kinds if kind not in RING_KINDS for tok in dtypes]
        combos += [(kind, RING_MODE_DTYPE[mode], _ring_fn(kind, g, mode, block, group),
                    "f32", mode)
                   for kind in kinds if kind in RING_KINDS for mode in ring_modes]
        for kind, tok, fn, in_tok, mode in combos:
            for size in sizes:
                if size % g:
                    skipped.append({
                        "kind": kind, "dtype": tok, "axis": axis,
                        "size": size,
                        "error": f"size not divisible by axis size {g}",
                    })
                    continue
                x = _input(size, in_tok, g, index, device)
                t = _time_best(fn, x, reps, group, device)
                width = 1 if tok == "s8" else (2 if tok == "bf16" else 4)
                if mode is not None:
                    wire = _ring_wire_bytes(kind, size, g, mode, block)
                    payload = size * 4  # ring input is f32
                else:
                    payload = size * width
                    wire = _wire_bytes(kind, payload, g)
                sweeps.append({
                    "kind": kind, "dtype": tok, "axis": axis,
                    "group_size": g, "size": size,
                    "payload_bytes": payload, "wire_bytes": wire,
                    "time_s": t,
                    "bw_bytes_per_s": (wire / t) if t > 0 and wire else 0.0,
                })
                if progress:
                    progress(sweeps[-1])
    return sweeps, skipped


def fit_links(sweeps: Sequence[dict]) -> Dict[str, AlphaBeta]:
    """Per-link α-β fits over the sweep points; links with fewer than
    two distinct wire sizes are dropped (no line through one point)."""
    grouped: Dict[str, List[dict]] = {}
    for row in sweeps:
        key = link_key(row["kind"], row["dtype"], row["axis"])
        grouped.setdefault(key, []).append(row)
    out: Dict[str, AlphaBeta] = {}
    for key, rows in grouped.items():
        xs = [r["wire_bytes"] for r in rows]
        ys = [r["time_s"] for r in rows]
        if len(set(xs)) < 2:
            continue
        out[key] = fit_alpha_beta(xs, ys)
    return out


def bench_artifact(mesh, sweeps: Sequence[dict], skipped: Sequence[dict],
                   *, device: torch.device, reps: int = DEFAULT_REPS) -> dict:
    """The schema-versioned ``comms bench --json`` artifact, the JAX keys
    (headline gates: the best link bandwidth, higher is better; the median
    fitted α; per-link ``rows`` for the registry's trend channel)."""
    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    # the JAX device_kind: the card's name, or "cpu"
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    chip = _chip_key(kind) or kind
    shape = mesh_shape(mesh)
    n_devices = dist.get_world_size() if dist.is_initialized() else 1
    fitted = fit_links(sweeps)
    best_bw: Dict[str, float] = {}
    group_of: Dict[str, int] = {}
    for row in sweeps:
        key = link_key(row["kind"], row["dtype"], row["axis"])
        best_bw[key] = max(best_bw.get(key, 0.0), row["bw_bytes_per_s"])
        group_of[key] = row["group_size"]
    links = {
        key: {
            **ab.to_json(),
            "achieved_bw_bytes_per_s": best_bw.get(key, 0.0),
            "group_size": group_of.get(key, 0),
        }
        for key, ab in sorted(fitted.items())
    }
    comms = {
        "chip": chip,
        "device_kind": kind,
        "n_devices": n_devices,
        "mesh": shape,
        "reps": reps,
        "achieved_bw_bytes_per_s": max(best_bw.values()) if best_bw else 0.0,
        "alpha_s": (statistics.median(ab.alpha_s for ab in fitted.values())
                    if fitted else None),
        "links": links,
        "rows": {key: {"value": bw} for key, bw in sorted(best_bw.items())},
        "sweeps": list(sweeps),
        "skipped": list(skipped),
    }
    return {
        "type": "comms",
        "comms_schema_version": COMMS_SCHEMA_VERSION,
        "provenance": artifact_provenance(
            descriptor={"artifact": "comms_bench", "chip": chip,
                        "mesh": shape, "n_devices": n_devices},
            device_kind=kind, torch_version=torch.__version__, mesh=shape,
        ),
        "comms": comms,
    }
