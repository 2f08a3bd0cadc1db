"""Structured, single-writer metric logging.

Counterpart of ``tpu_ddp/metrics/logging.py`` (``SCHEMA_VERSION``,
``MetricLogger`` :17-80), with the same text formats, the same JSONL
records (``schema_version``, ``step``, ``time`` and the scalars, flushed a
line at a time) and the same TensorBoard sink. Rank 0 alone prints and
writes, as in the JAX logger.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from tpu_ddp_torch.parallel.runtime import is_primary_process

#: Version of the metrics-JSONL record shape (one bump per breaking
#: change; consumers should skip records from a future version).
SCHEMA_VERSION = 1


class MetricLogger:
    """Scalars -> stdout (+ optional JSONL file, + optional TensorBoard
    event files). ``torch.utils.tensorboard`` is imported only when
    ``tensorboard_dir`` is given; without the ``tensorboard`` package that
    raises ``ImportError``, as the JAX logger does."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self._fh = None
        self._tb = None
        if jsonl_path and is_primary_process():
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a")
        if tensorboard_dir and is_primary_process():
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "--tensorboard-dir needs torch's SummaryWriter; "
                    "use --jsonl in environments without torch"
                ) from e
            self._tb = SummaryWriter(tensorboard_dir)

    def log(self, step: int, **scalars) -> None:
        if not is_primary_process():
            return
        record = {"schema_version": SCHEMA_VERSION, "step": step,
                  "time": time.time(), **scalars}
        pretty = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        print(f"[step {step}] {pretty}", flush=True)
        if self._fh:
            # a flush a line: a crash, or a kill after a preemption's grace
            # window, loses at most the record being written
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)

    def log_text(self, msg: str) -> None:
        if is_primary_process():
            print(msg, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
