"""Per-kernel cost model fitted from measured kernel-vs-plain sweeps.

The port's copy of ``tpu_ddp/ops/model.py``, with the JAX names and
artifact keys. One *kernel* is a named entry of the ops registry
(``ops/__init__.py``); its cost model is a pair of latency-throughput lines

    time(elements) = α + elements * s_per_elem

one for the hand-written kernel (``fused``) and one for the path without it
(``xla``: the JAX key, which in the port holds the kernel's plain PyTorch
version), fitted by plain least squares over the ``ops bench`` sweep with
the slope clamped positive (monotone by construction, the same discipline
as ``comms/model.py``). The interesting derived quantity is the SIGNED
per-invocation saving

    savings_s(kernel, elements) = time_xla(elements) - time_fused(elements)

which is deliberately NOT clamped at zero: on a CPU tensor the wrapper
takes the plain version, so a CPU sweep times plain against plain and its
savings sit near zero, either sign; an honest saving is what lets a tuner
rank kernel-off against kernel-on instead of flattering the switch.

``ops_model_for_chip`` assembles an :class:`OpsModel` from evidence the
same way ``comms_model_for_chip`` assembles link evidence: ``ops bench
--json`` artifact files plus registry entries of kind ``"ops"``, filtered
to the requested chip kind through ``analysis/roofline.py::chip_spec`` (a
CPU host's timings say nothing about an H100), merged per kernel by the
median.

Everything here is stdlib-only; torch never loads. The measured side
lives in ``ops/microbench.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Dict, List, Mapping, Optional, Sequence

#: bump on any breaking change to the ``ops bench --json`` artifact
OPS_SCHEMA_VERSION = 1

#: slope floor (seconds per element): keeps the fitted line monotone
#: even on sweeps noise tilted downward
_MIN_SLOPE_S_PER_ELEM = 1e-15


@dataclasses.dataclass
class CostLine:
    """One fitted implementation line (fused or xla) for one kernel."""

    alpha_s: float
    s_per_elem: float
    samples: int = 0

    def time_s(self, elements: float) -> float:
        return self.alpha_s + float(elements) * self.s_per_elem

    def to_json(self) -> dict:
        return {
            "alpha_s": self.alpha_s,
            "s_per_elem": self.s_per_elem,
            "samples": self.samples,
        }

    @staticmethod
    def from_json(rec: Mapping) -> Optional["CostLine"]:
        if not isinstance(rec, Mapping):
            return None
        alpha = rec.get("alpha_s")
        slope = rec.get("s_per_elem")
        if not isinstance(alpha, (int, float)) or alpha < 0:
            return None
        if not isinstance(slope, (int, float)) or slope <= 0:
            return None
        samples = rec.get("samples")
        return CostLine(
            alpha_s=float(alpha), s_per_elem=float(slope),
            samples=int(samples) if isinstance(samples, int) else 0)


def fit_cost_line(elements: Sequence[float],
                  times_s: Sequence[float]) -> CostLine:
    """Least-squares line over (elements, measured seconds) pairs; needs
    >= 2 points at >= 2 distinct sizes, slope clamped positive, α
    clamped to 0 (``comms/model.py::fit_alpha_beta`` shape)."""
    xs = [float(x) for x in elements]
    ys = [float(y) for y in times_s]
    if len(xs) != len(ys):
        raise ValueError(
            f"fit_cost_line: {len(xs)} sizes vs {len(ys)} timings")
    if len(xs) < 2 or len(set(xs)) < 2:
        raise ValueError(
            "fit_cost_line: need >= 2 samples at >= 2 distinct sizes, "
            f"got sizes {sorted(set(xs))}")
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = max(sxy / sxx, _MIN_SLOPE_S_PER_ELEM)
    alpha = max(my - slope * mx, 0.0)
    return CostLine(alpha_s=alpha, s_per_elem=slope, samples=n)


@dataclasses.dataclass
class KernelCost:
    """Kernel (``fused``) and plain (``xla``) lines for one kernel, plus
    the bench's parity verdict (a kernel that failed its own parity gate
    never prices)."""

    fused: CostLine
    xla: CostLine
    parity_ok: bool = True

    def savings_s(self, elements: float) -> float:
        """SIGNED seconds saved per invocation at ``elements`` — negative
        when the kernel measured slower than its plain version."""
        return self.xla.time_s(elements) - self.fused.time_s(elements)

    def to_json(self) -> dict:
        return {
            "fused": self.fused.to_json(),
            "xla": self.xla.to_json(),
            "parity_ok": bool(self.parity_ok),
        }

    @staticmethod
    def from_json(rec: Mapping) -> Optional["KernelCost"]:
        if not isinstance(rec, Mapping):
            return None
        fused = CostLine.from_json(rec.get("fused"))
        xla = CostLine.from_json(rec.get("xla"))
        if fused is None or xla is None:
            return None
        return KernelCost(fused=fused, xla=xla,
                          parity_ok=bool(rec.get("parity_ok", True)))


@dataclasses.dataclass
class OpsModel:
    """All fitted kernel costs for one chip kind, plus provenance."""

    chip: str
    kernels: Dict[str, KernelCost] = dataclasses.field(default_factory=dict)
    source: str = "none"
    samples: int = 0

    def __bool__(self) -> bool:
        return bool(self.kernels)

    def cost(self, kernel: str) -> Optional[KernelCost]:
        kc = self.kernels.get(str(kernel))
        return kc if kc is not None and kc.parity_ok else None

    def savings_s(self, kernel: str, elements: float,
                  count: int = 1) -> Optional[float]:
        """SIGNED modeled seconds saved by routing ``count`` invocations
        of ``elements`` each through the fused kernel, or None when the
        kernel was never benched (or failed parity) on this chip."""
        kc = self.cost(kernel)
        if kc is None:
            return None
        return max(count, 1) * kc.savings_s(elements)

    def kernels_json(self) -> Dict[str, dict]:
        return {k: kc.to_json() for k, kc in sorted(self.kernels.items())}


# ---- assembling a model from evidence (the calibration side) -------------


def _chip_key(device_kind: Optional[str]) -> Optional[str]:
    from tpu_ddp_torch.analysis.roofline import chip_spec

    spec = chip_spec(device_kind)
    return spec.key if spec else None


def _kernels_from_ops_record(rec: Mapping,
                             chip_key: str) -> Dict[str, KernelCost]:
    """The fitted kernel costs of one artifact's ``"ops"`` object, or {}
    when it does not apply (wrong chip kind, malformed, no kernels)."""
    if not isinstance(rec, Mapping):
        return {}
    if _chip_key(rec.get("device_kind") or rec.get("chip")) != chip_key:
        return {}
    out: Dict[str, KernelCost] = {}
    kernels = rec.get("kernels")
    if not isinstance(kernels, Mapping):
        return {}
    for name, val in kernels.items():
        kc = KernelCost.from_json(val)
        if kc is not None:
            out[str(name)] = kc
    return out


def _ops_record_from_file(path: str) -> Optional[Mapping]:
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    rec = art.get("ops") if isinstance(art, dict) else None
    return rec if isinstance(rec, Mapping) else None


def model_from_ops_record(rec: Mapping,
                          source: str = "artifact") -> Optional[OpsModel]:
    """An :class:`OpsModel` straight from one artifact's ``"ops"``
    object, keyed to the artifact's OWN chip (no cross-chip filtering —
    use :func:`ops_model_for_chip` for that)."""
    if not isinstance(rec, Mapping):
        return None
    chip = _chip_key(rec.get("device_kind") or rec.get("chip")) \
        or str(rec.get("chip") or "unknown")
    kernels: Dict[str, KernelCost] = {}
    raw = rec.get("kernels")
    for name, val in raw.items() if isinstance(raw, Mapping) else ():
        kc = KernelCost.from_json(val)
        if kc is not None:
            kernels[str(name)] = kc
    if not kernels:
        return None
    return OpsModel(
        chip=chip, kernels=kernels, source=source,
        samples=sum(kc.fused.samples + kc.xla.samples
                    for kc in kernels.values()))


def ops_model_for_chip(
    chip: str,
    *,
    sources: Sequence[str] = (),
    registry_dir: Optional[str] = None,
) -> OpsModel:
    """Assemble the per-chip kernel cost model from every applicable
    piece of evidence — ``ops bench --json`` artifact files in
    ``sources`` plus ops-kind registry entries — merged per kernel by
    the median line parameters (the ``comms_model_for_chip`` shape
    exactly). Evidence for another chip kind is ignored; with no
    evidence the model is empty (falsy): a tuner prices the kernel switch
    as a no-op."""
    chip_key = _chip_key(chip)
    if chip_key is None:
        raise ValueError(f"unknown chip {chip!r}")
    per_name: Dict[str, List[KernelCost]] = {}
    used: List[str] = []

    def _merge(kernels: Dict[str, KernelCost]) -> bool:
        for name, kc in kernels.items():
            per_name.setdefault(name, []).append(kc)
        return bool(kernels)

    for src in sources:
        if os.path.isdir(src):
            continue  # ops evidence is artifact files, not run dirs
        rec = _ops_record_from_file(src)
        if rec is not None and _merge(
                _kernels_from_ops_record(rec, chip_key)):
            used.append(os.path.basename(src) or src)
    if registry_dir:
        from tpu_ddp_torch.registry.store import read_entries

        try:
            entries = read_entries(registry_dir)
        except (OSError, ValueError):
            entries = []
        found = False
        for entry in entries:
            if entry.artifact_kind != "ops":
                continue
            rec = (entry.programs or {}).get("ops") or {}
            found = _merge(_kernels_from_ops_record(rec, chip_key)) \
                or found
        if found:
            used.append(f"registry:{registry_dir}")
    if not per_name:
        return OpsModel(chip=chip_key)

    def _median_line(lines: List[CostLine]) -> CostLine:
        return CostLine(
            alpha_s=statistics.median(ln.alpha_s for ln in lines),
            s_per_elem=statistics.median(ln.s_per_elem for ln in lines),
            samples=sum(ln.samples for ln in lines),
        )

    kernels = {
        name: KernelCost(
            fused=_median_line([kc.fused for kc in kcs]),
            xla=_median_line([kc.xla for kc in kcs]),
            parity_ok=all(kc.parity_ok for kc in kcs),
        )
        for name, kcs in per_name.items()
    }
    return OpsModel(
        chip=chip_key, kernels=kernels, source="+".join(used),
        samples=sum(kc.fused.samples + kc.xla.samples
                    for kc in kernels.values()))
