"""Convergence observatory: learning-curve extraction, seed-band
baselines, and trajectory regression gating (``tpu-ddp-torch curves``).

The PR 5–12 arc observes speed, health, and memory; this package
observes *learning quality* — the one axis every perf overlay
(``--zero1``, ``--grad-compress``, a new hand-written kernel) must leave
intact. Four stdlib-only modules:

- ``extract``   — reduce a run dir (all incarnations: health sinks for
  per-step loss/grad-norm, trace records for the eval history and
  provenance) into a schema-versioned ``LearningCurve`` record.
- ``bands``     — build a per-step median + k×MAD seed envelope from N
  archived baseline runs sharing a *seed-invariant* ``quality_digest``,
  and judge a candidate against it with lint-style CRV findings.
- ``diff``      — step-aligned paired A/B comparison for overlay-parity
  verdicts (the oracle ``make compress-demo`` gates on, and the
  contract later ZeRO-3 and kernel changes pin against).
- ``report``    — the ``tpu-ddp-torch curves`` CLI: sparkline render, band
  verdicts with fix hints, ``--json`` artifacts the perf registry
  records (kind "curves") and ``bench compare`` gates.

Stdlib-only end to end (no torch, no numpy): curves are extracted and
judged wherever the run dir lands. See ``docs/curves.md``. The port's copy
of ``tpu_ddp/curves/``.
"""

from tpu_ddp_torch.curves.bands import (
    RULES,
    BandConfig,
    SeedBand,
    band_from_registry,
    build_band,
    judge_curve,
)
from tpu_ddp_torch.curves.diff import diff_curves, render_diff
from tpu_ddp_torch.curves.extract import (
    CURVES_SCHEMA_VERSION,
    curve_artifact,
    extract_curve,
    load_curve,
)

__all__ = [
    "CURVES_SCHEMA_VERSION",
    "RULES",
    "BandConfig",
    "SeedBand",
    "band_from_registry",
    "build_band",
    "curve_artifact",
    "diff_curves",
    "extract_curve",
    "judge_curve",
    "load_curve",
    "render_diff",
]
