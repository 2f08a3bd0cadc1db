"""Host half of the numerics flight recorder.

Counterpart of ``tpu_ddp/health/monitor.py`` (``SpikeDetector`` :46,
``HealthMonitor`` :86). The trainer feeds each step's health stats
(``health/stats.py``, fetched to the host in one copy) into one
``HealthMonitor`` a rank, which

- appends a schema-versioned record a step to ``health-p<rank>.jsonl`` in
  the run dir (read back by ``python -m tpu_ddp_torch.cli.main health DIR``), the
  JAX package's records to the key;
- runs the divergence detector: any non-finite sentinel, or a loss above
  ``median + threshold * MAD`` of the rolling window;
- on the first anomaly writes a one-shot dump to
  ``run_dir/anomalies/step_<n>/``: ``meta.json`` (with the run's config),
  ``health.json`` (the stats, per-layer breakdown included when the step
  computes it, and the recent history) and ``batch.npz`` (the offending
  batch, fetched only then).

The monitor never raises into the train loop: it returns the policy verdict
("halt" | "skip_step" | "warn") and the trainer acts on it (the skip itself
already happened in the step, ``HealthConfig.skip_nonfinite``).

With ``telemetry=`` the monitor mirrors each step into it as the JAX
monitor does (:215-245): the ``health/<key>`` gauges (loss, grad, param and
update norms, update ratio, compression error), the counters
``health/nonfinite_steps``, ``health/skipped_steps`` (under ``skip_step``)
and ``health/loss_spikes``, and a ``health_anomaly`` instant an anomaly.
The file names and incarnations are the telemetry package's grammar
(``sink_file_name``, ``next_incarnation``).

numpy and stdlib only.
"""

from __future__ import annotations

import collections
import functools
import json
import logging
import math
import os
import statistics
from typing import Any, Callable, Dict, Optional

import numpy as np

from tpu_ddp_torch.health.summarize import HEALTH_SCHEMA_VERSION
from tpu_ddp_torch.telemetry import next_incarnation as _next_incarnation
from tpu_ddp_torch.telemetry import sink_file_name

log = logging.getLogger(__name__)

POLICIES = ("warn", "skip_step", "halt")


#: ``next_incarnation(run_dir, process_index)`` of the health records: one
#: past the newest ``health-p<i>[.i<k>].jsonl`` of the rank, so a resumed run
#: writes a new file and keeps the earlier life's record
next_incarnation = functools.partial(_next_incarnation, prefix="health")


class SpikeDetector:
    """Rolling median + MAD threshold on a scalar series (the loss).

    A value is a spike when it exceeds ``median + threshold * MAD`` over
    the retained window, after ``warmup`` observations. MAD is floored at a
    small fraction of |median| so a plateaued loss (MAD ~ 0) does not flag
    ordinary jitter."""

    def __init__(self, window: int = 128, threshold: float = 10.0,
                 warmup: int = 20):
        if window < 4:
            raise ValueError(f"window must be >= 4, got {window}")
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self._values: collections.deque = collections.deque(maxlen=window)
        self.observed = 0

    def observe(self, x: float) -> bool:
        """Record ``x``; True when it spikes above the rolling threshold.
        Non-finite values are not recorded (they are their own anomaly
        class and would poison the median)."""
        if not math.isfinite(x):
            return False
        self.observed += 1
        spike = False
        if self.observed > self.warmup and len(self._values) >= 4:
            med = statistics.median(self._values)
            mad = statistics.median(abs(v - med) for v in self._values)
            floor = max(1e-3 * abs(med), 1e-8)
            spike = x > med + self.threshold * max(mad, floor)
        self._values.append(x)
        return spike


def _scalar(x) -> float:
    return float(np.asarray(x))


class HealthMonitor:
    """A rank's consumer of the step's health stats (module docstring).
    ``run_dir`` None: detection and the policy run, nothing is written."""

    def __init__(
        self,
        *,
        run_dir: Optional[str] = None,
        policy: str = "warn",
        per_layer_stride: int = 0,
        process_index: int = 0,
        window: int = 128,
        spike_threshold: float = 10.0,
        max_dumps: int = 1,
        run_meta: Optional[dict] = None,
        incarnation: int = 0,
        telemetry=None,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown health policy {policy!r}; valid policies: "
                f"{', '.join(POLICIES)}"
            )
        if telemetry is None:
            from tpu_ddp_torch.telemetry import NULL as telemetry
        self.telemetry = telemetry
        self.policy = policy
        self.per_layer_stride = per_layer_stride
        self.process_index = process_index
        self.run_dir = run_dir
        self.run_meta = run_meta or {}
        self.max_dumps = max_dumps
        self.dumps_written = 0
        self.anomaly_count = 0
        self.nonfinite_steps = 0
        self.spike_steps = 0
        self.detector = SpikeDetector(window=window, threshold=spike_threshold)
        #: recent scalar records, dumped alongside an anomaly for context
        self.history: collections.deque = collections.deque(maxlen=window)
        self._fh = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir, sink_file_name("health", process_index, incarnation))
            self._fh = open(path, "w")
            self._write({
                "schema_version": HEALTH_SCHEMA_VERSION,
                "type": "header",
                "pid": process_index,
                "policy": policy,
                "per_layer_stride": per_layer_stride,
                "spike_threshold": spike_threshold,
                "window": window,
            })

    # -- record plumbing --------------------------------------------------

    def _write(self, record: dict) -> None:
        if self._fh is None:
            return
        # one line a record, flushed, so a crash (the very event health
        # exists to explain) loses nothing
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    @staticmethod
    def _host_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
        """Scalars -> plain floats and bools (and the nested per-layer
        dict), JSON-ready."""
        out: Dict[str, Any] = {}
        for k, v in stats.items():
            if k == "per_layer":
                out[k] = {group: {name: _scalar(val) for name, val in layers.items()}
                          for group, layers in v.items()}
            elif k.endswith("_finite"):
                out[k] = bool(np.asarray(v))
            else:
                out[k] = _scalar(v)
        return out

    # -- the per-step hook -------------------------------------------------

    def on_step(
        self,
        step: int,
        stats: Dict[str, Any],
        *,
        batch_provider: Optional[Callable[[], Optional[dict]]] = None,
    ) -> str:
        """Consume one step's stats (host values); returns "ok" or the
        policy verdict. ``batch_provider`` is called only when an anomaly
        dump is written: fetching the batch stays off the healthy path."""
        host = self._host_stats(stats)
        nonfinite = not host.get("all_finite", True)
        spike = self.detector.observe(host.get("loss", float("nan")))
        anomaly = "nonfinite" if nonfinite else ("loss_spike" if spike else None)

        record = {
            "schema_version": HEALTH_SCHEMA_VERSION,
            "type": "health",
            "step": step,
            "pid": self.process_index,
        }
        record.update({k: v for k, v in host.items() if k != "per_layer"})
        if anomaly:
            record["anomaly"] = anomaly
        if ("per_layer" in host and self.per_layer_stride
                and (step % self.per_layer_stride == 0 or anomaly)):
            record["per_layer"] = host["per_layer"]
        self._write(record)
        self.history.append({k: v for k, v in record.items() if k != "per_layer"})

        tel = self.telemetry
        for key in ("loss", "grad_norm", "param_norm", "update_norm",
                    "update_ratio", "compress_error_norm"):
            if key in host and math.isfinite(host[key]):
                tel.gauge(f"health/{key}").set(host[key])

        if anomaly is None:
            return "ok"
        self.anomaly_count += 1
        if nonfinite:
            self.nonfinite_steps += 1
            tel.count("health/nonfinite_steps")
            if self.policy == "skip_step":
                # the step's guard already discarded this update
                tel.count("health/skipped_steps")
        else:
            self.spike_steps += 1
            tel.count("health/loss_spikes")
        dump_path = None
        if self.dumps_written < self.max_dumps:
            dump_path = self._dump(step, anomaly, host, batch_provider)
        tel.instant(
            "health_anomaly", step=step, reason=anomaly,
            loss=host.get("loss"), grad_norm=host.get("grad_norm"),
            policy=self.policy,
            **({"dump": dump_path} if dump_path else {}),
        )
        log.warning(
            "health anomaly at step %d: %s (loss=%g grad_norm=%g "
            "update_ratio=%g) -> policy %s%s",
            step, anomaly, host.get("loss", float("nan")),
            host.get("grad_norm", float("nan")),
            host.get("update_ratio", float("nan")), self.policy,
            f"; diagnostics dumped to {dump_path}" if dump_path else "",
        )
        return self.policy

    # -- anomaly dump ------------------------------------------------------

    def _dump(self, step, reason, host_stats, batch_provider) -> Optional[str]:
        if not self.run_dir:
            return None
        # every rank's monitor fires at the same step into the shared run
        # dir: ranks other than 0 write to a suffixed directory
        suffix = f"-p{self.process_index}" if self.process_index else ""
        out_dir = os.path.join(self.run_dir, "anomalies", f"step_{step:08d}{suffix}")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "meta.json"), "w") as f:
                json.dump({
                    "schema_version": HEALTH_SCHEMA_VERSION,
                    "step": step,
                    "reason": reason,
                    "policy": self.policy,
                    "pid": self.process_index,
                    "config": self.run_meta,
                }, f, indent=2, default=str)
            with open(os.path.join(out_dir, "health.json"), "w") as f:
                json.dump({
                    "step": step,
                    "reason": reason,
                    "stats": host_stats,
                    "history": list(self.history),
                }, f, indent=2)
            batch = batch_provider() if batch_provider is not None else None
            if batch is not None:
                np.savez(os.path.join(out_dir, "batch.npz"),
                         **{k: np.asarray(v) for k, v in batch.items()})
            self.dumps_written += 1
            return out_dir
        except Exception:  # diagnostics must never kill training
            log.exception("failed to write anomaly dump to %s", out_dir)
            return None

    def close(self) -> None:
        if self._fh is not None:
            self._write({
                "schema_version": HEALTH_SCHEMA_VERSION,
                "type": "footer",
                "pid": self.process_index,
                "nonfinite_steps": self.nonfinite_steps,
                "loss_spikes": self.spike_steps,
                "anomalies": self.anomaly_count,
                "dumps": self.dumps_written,
            })
            self._fh.close()
            self._fh = None
