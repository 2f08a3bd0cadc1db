"""Metric logging to stdout.

Counterpart of ``tpu_ddp/metrics/logging.py`` (``MetricLogger`` :17), with
the same text formats; the JSONL and TensorBoard sinks are not ported yet.
"""

from __future__ import annotations


class MetricLogger:
    def log(self, step: int, **scalars) -> None:
        pretty = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        print(f"[step {step}] {pretty}", flush=True)

    def log_text(self, msg: str) -> None:
        print(msg, flush=True)
