"""Metric logging to stdout.

Counterpart of ``tpu_ddp/metrics/logging.py`` (``MetricLogger`` :17), with
the same text formats; the JSONL and TensorBoard sinks are not ported yet.
Rank 0 alone prints, as in the JAX logger.
"""

from __future__ import annotations

from tpu_ddp_torch.parallel.runtime import is_primary_process


class MetricLogger:
    def log(self, step: int, **scalars) -> None:
        if not is_primary_process():
            return
        pretty = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        print(f"[step {step}] {pretty}", flush=True)

    def log_text(self, msg: str) -> None:
        if not is_primary_process():
            return
        print(msg, flush=True)
