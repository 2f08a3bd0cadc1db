"""α-β interconnect model fitted from measured collective sweeps.

Counterpart of ``tpu_ddp/comms/model.py`` (``link_key``, ``AlphaBeta``,
``fit_alpha_beta``, ``LinkModel``, ``axis_baselines`` :191,
``model_from_comms_record``, ``comms_model_for_chip``), line for line but
for the chip lookup. One *link* is a (collective kind, wire dtype, mesh
axis) triple on one chip kind; its cost model is the latency-bandwidth line

    time(wire_bytes) = α + wire_bytes / β

with α in seconds (a call's fixed cost: dispatch, rendezvous, protocol)
and β in bytes/second (the asymptotic achieved bandwidth). The fit is plain
least squares over the microbenchmark sweep with the slope clamped
positive, so a fitted model is monotone in payload by construction.

``comms_model_for_chip`` assembles a :class:`LinkModel` from evidence:
``comms bench --json`` artifact files plus registry entries of kind
``"comms"``, filtered to the requested chip kind (a CPU host's links say
nothing about an H100), merged per link key by the median. The chip lookup,
``_chip_key``, reads ``analysis/roofline.py::chip_spec``, as the JAX one
does (:222).

Stdlib-only. The measured side lives in ``comms/microbench.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Dict, List, Mapping, Optional, Sequence

#: bump on any breaking change to the ``comms bench --json`` artifact
COMMS_SCHEMA_VERSION = 1

#: slope floor for the fit (seconds per byte): keeps β finite and the
#: fitted line monotone even on sweeps noise tilted downward
_MIN_SLOPE_S_PER_BYTE = 1e-18

#: axis placeholders that mean "not attributed to a named mesh axis" —
#: lookups for these may fall back across axes; a NAMED axis never does
UNATTRIBUTED_AXES = ("unknown", "all", "")


def link_key(kind: str, dtype: str, axis: str) -> str:
    """The canonical link identity, matching the fingerprint vocabulary:
    e.g. ``all-reduce/f32/data``, ``collective-permute/s8/data``,
    ``ring-all-reduce/s8/data`` (the explicit quantized ring, keyed by
    its WIRE dtype — it lowers to collective-permute in HLO)."""
    return f"{kind}/{dtype}/{axis}"


def split_link_key(key: str) -> Optional[Dict[str, str]]:
    parts = str(key).split("/")
    if len(parts) != 3 or not all(parts):
        return None
    return {"kind": parts[0], "dtype": parts[1], "axis": parts[2]}


@dataclasses.dataclass
class AlphaBeta:
    """One fitted link line. ``samples`` counts the sweep points (or,
    after a median merge, the total points behind the merged line)."""

    alpha_s: float
    beta_bytes_per_s: float
    samples: int = 0

    def time_s(self, wire_bytes: float) -> float:
        return self.alpha_s + float(wire_bytes) / self.beta_bytes_per_s

    def bandwidth_at(self, wire_bytes: float) -> float:
        """Achieved bytes/s at a given payload — approaches β from below
        as the payload amortizes α."""
        t = self.time_s(wire_bytes)
        return float(wire_bytes) / t if t > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "alpha_s": self.alpha_s,
            "beta_bytes_per_s": self.beta_bytes_per_s,
            "samples": self.samples,
        }

    @staticmethod
    def from_json(rec: Mapping) -> Optional["AlphaBeta"]:
        if not isinstance(rec, Mapping):
            return None
        alpha = rec.get("alpha_s")
        beta = rec.get("beta_bytes_per_s")
        if not isinstance(alpha, (int, float)) or alpha < 0:
            return None
        if not isinstance(beta, (int, float)) or beta <= 0:
            return None
        samples = rec.get("samples")
        return AlphaBeta(
            alpha_s=float(alpha), beta_bytes_per_s=float(beta),
            samples=int(samples) if isinstance(samples, int) else 0)


def fit_alpha_beta(wire_bytes: Sequence[float],
                   times_s: Sequence[float]) -> AlphaBeta:
    """Least-squares α-β fit over (wire_bytes, measured seconds) pairs.

    Needs >= 2 points at >= 2 distinct payload sizes. The slope is
    clamped to ``_MIN_SLOPE_S_PER_BYTE`` (so β stays finite-positive and
    time is monotone in payload) and α is clamped to 0 (a negative
    intercept is measurement noise, not negative latency)."""
    xs = [float(x) for x in wire_bytes]
    ys = [float(y) for y in times_s]
    if len(xs) != len(ys):
        raise ValueError(
            f"fit_alpha_beta: {len(xs)} payloads vs {len(ys)} timings")
    if len(xs) < 2 or len(set(xs)) < 2:
        raise ValueError(
            "fit_alpha_beta: need >= 2 samples at >= 2 distinct payload "
            f"sizes, got payloads {sorted(set(xs))}")
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = max(sxy / sxx, _MIN_SLOPE_S_PER_BYTE)
    alpha = max(my - slope * mx, 0.0)
    return AlphaBeta(alpha_s=alpha, beta_bytes_per_s=1.0 / slope,
                     samples=n)


def _beta(ab: AlphaBeta) -> float:
    return ab.beta_bytes_per_s


@dataclasses.dataclass
class LinkModel:
    """All fitted links for one chip kind, plus where they came from.

    Lookup rules (``lookup``/``time_for``):

    - exact ``kind/dtype/axis`` wins;
    - same kind + NAMED axis, other measured dtype: the slowest (min-β)
      stands in — conservative, never flattering;
    - an UNATTRIBUTED axis ("unknown"/"all") may borrow any measured
      axis of the same kind (dtype match preferred, min-β);
    - a NAMED axis with no measurement on that axis returns None — the
      caller falls back to the spec-sheet number. Evidence measured on
      the wrong axis never prices a link it didn't see (the wrong-axis
      refusal test).
    """

    chip: str
    links: Dict[str, AlphaBeta] = dataclasses.field(default_factory=dict)
    source: str = "none"
    samples: int = 0

    def __bool__(self) -> bool:
        return bool(self.links)

    def lookup(self, kind: str, dtype: Optional[str] = None,
               axis: Optional[str] = None) -> Optional[AlphaBeta]:
        kind = str(kind or "")
        dtype = str(dtype or "unknown")
        axis = str(axis or "unknown")
        exact = self.links.get(link_key(kind, dtype, axis))
        if exact is not None:
            return exact
        parsed = [(split_link_key(k), ab) for k, ab in self.links.items()]
        parsed = [(p, ab) for p, ab in parsed if p and p["kind"] == kind]
        if axis not in UNATTRIBUTED_AXES:
            same_axis = [ab for p, ab in parsed if p["axis"] == axis]
            return min(same_axis, key=_beta) if same_axis else None
        same_dtype = [ab for p, ab in parsed if p["dtype"] == dtype]
        pool = same_dtype or [ab for _, ab in parsed]
        return min(pool, key=_beta) if pool else None

    def time_for(self, kind: str, dtype: Optional[str],
                 axis: Optional[str], wire_bytes: float,
                 count: int = 1) -> Optional[float]:
        """Modeled seconds for ``count`` invocations moving
        ``wire_bytes`` TOTAL, or None when no applicable link was
        measured (α is charged per invocation)."""
        ab = self.lookup(kind, dtype, axis)
        if ab is None:
            return None
        return max(count, 1) * ab.alpha_s \
            + float(wire_bytes) / ab.beta_bytes_per_s

    def links_json(self) -> Dict[str, dict]:
        return {k: ab.to_json() for k, ab in sorted(self.links.items())}


def axis_baselines(rec: Mapping) -> Dict[str, float]:
    """Per-axis calibrated bandwidth reference for the COM001 alert: the
    best measured achieved bandwidth among the explicit-ring links on
    each axis (the collectives the live hop monitor actually times),
    falling back to the best link of ANY kind where no ring was benched
    on that axis. Takes an artifact's ``"comms"`` object."""
    if not isinstance(rec, Mapping):
        return {}
    links = rec.get("links")
    if not isinstance(links, Mapping):
        return {}
    ring: Dict[str, float] = {}
    any_: Dict[str, float] = {}
    for key, val in links.items():
        parts = split_link_key(key)
        if parts is None or not isinstance(val, Mapping):
            continue
        bw = val.get("achieved_bw_bytes_per_s")
        if not isinstance(bw, (int, float)) or bw <= 0:
            continue
        axis = parts["axis"]
        any_[axis] = max(any_.get(axis, 0.0), float(bw))
        if parts["kind"].startswith("ring-"):
            ring[axis] = max(ring.get(axis, 0.0), float(bw))
    return {a: ring.get(a, any_[a]) for a in any_}


# ---- assembling a model from evidence (the calibration side) -------------


def _chip_key(device_kind: Optional[str]) -> Optional[str]:
    """The chip key of a device kind string or of a key itself
    ("NVIDIA H100 80GB HBM3" -> "h100"), through the one chip table
    (``analysis/roofline.py::chip_spec``, as JAX ``comms/model.py:222``);
    None when unknown."""
    from tpu_ddp_torch.analysis.roofline import chip_spec

    spec = chip_spec(device_kind)
    return spec.key if spec else None


def _links_from_comms_record(rec: Mapping,
                             chip_key: str) -> Dict[str, AlphaBeta]:
    """The fitted links of one artifact's ``"comms"`` object, or {} when
    it does not apply (wrong chip kind, malformed, no links)."""
    if not isinstance(rec, Mapping):
        return {}
    if _chip_key(rec.get("device_kind") or rec.get("chip")) != chip_key:
        return {}
    out: Dict[str, AlphaBeta] = {}
    links = rec.get("links")
    if not isinstance(links, Mapping):
        return {}
    for key, val in links.items():
        if split_link_key(key) is None:
            continue
        ab = AlphaBeta.from_json(val)
        if ab is not None:
            out[str(key)] = ab
    return out


def _comms_record_from_file(path: str) -> Optional[Mapping]:
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    rec = art.get("comms") if isinstance(art, dict) else None
    return rec if isinstance(rec, Mapping) else None


def model_from_comms_record(rec: Mapping,
                            source: str = "artifact") -> Optional[LinkModel]:
    """A :class:`LinkModel` straight from one artifact's ``"comms"``
    object, keyed to the artifact's OWN chip (no cross-chip filtering —
    use :func:`comms_model_for_chip` for that)."""
    if not isinstance(rec, Mapping):
        return None
    chip = _chip_key(rec.get("device_kind") or rec.get("chip")) \
        or str(rec.get("chip") or "unknown")
    links: Dict[str, AlphaBeta] = {}
    raw = rec.get("links")
    for key, val in raw.items() if isinstance(raw, Mapping) else ():
        if split_link_key(key) is None:
            continue
        ab = AlphaBeta.from_json(val)
        if ab is not None:
            links[str(key)] = ab
    if not links:
        return None
    return LinkModel(chip=chip, links=links, source=source,
                     samples=sum(ab.samples for ab in links.values()))


def comms_model_for_chip(
    chip: str,
    *,
    sources: Sequence[str] = (),
    registry_dir: Optional[str] = None,
) -> LinkModel:
    """Assemble the per-chip link model from every applicable piece of
    evidence — ``comms bench --json`` artifact files in ``sources`` plus
    comms-kind registry entries — merged per link key by the median α
    and β (the :func:`hbm_calibration_for_chip` shape exactly). Evidence
    for another chip kind is ignored; with no evidence the model is
    empty (falsy) and the caller keeps its spec-sheet numbers."""
    chip_key = _chip_key(chip)
    if chip_key is None:
        raise ValueError(f"unknown chip {chip!r}")
    per_key: Dict[str, List[AlphaBeta]] = {}
    used: List[str] = []

    def _merge(links: Dict[str, AlphaBeta]) -> bool:
        for key, ab in links.items():
            per_key.setdefault(key, []).append(ab)
        return bool(links)

    for src in sources:
        if os.path.isdir(src):
            continue  # comms evidence is artifact files, not run dirs
        rec = _comms_record_from_file(src)
        if rec is not None and _merge(
                _links_from_comms_record(rec, chip_key)):
            used.append(os.path.basename(src) or src)
    if registry_dir:
        from tpu_ddp_torch.registry.store import read_entries

        try:
            entries = read_entries(registry_dir)
        except (OSError, ValueError):
            entries = []
        found = False
        for entry in entries:
            if entry.artifact_kind != "comms":
                continue
            rec = (entry.programs or {}).get("comms") or {}
            found = _merge(_links_from_comms_record(rec, chip_key)) \
                or found
        if found:
            used.append(f"registry:{registry_dir}")
    if not per_key:
        return LinkModel(chip=chip_key)
    links = {
        key: AlphaBeta(
            alpha_s=statistics.median(ab.alpha_s for ab in abs_),
            beta_bytes_per_s=statistics.median(
                ab.beta_bytes_per_s for ab in abs_),
            samples=sum(ab.samples for ab in abs_),
        )
        for key, abs_ in per_key.items()
    }
    return LinkModel(chip=chip_key, links=links, source="+".join(used),
                     samples=sum(ab.samples for ab in links.values()))
