"""The exposed-comm record's reader (``<run_dir>/comms-exposure.json``).

The port's copy of the reader half of ``tpu_ddp/comms/exposure.py``
(``EXPOSURE_FILENAME``, ``read_exposure``): a JAX run dir can carry the
record, and ``trace summarize`` and ``diagnose`` join it. The measuring
half times a recorded program against its one-device twin through the
JAX analyze rebuild, which the port does not have, so ``tpu-ddp-torch
comms exposure`` refuses by name. Stdlib-only.
"""

from __future__ import annotations

import json
import os
from typing import Optional

#: the run-dir filename the analyze/summarize joins look for
EXPOSURE_FILENAME = "comms-exposure.json"


def read_exposure(run_dir: str) -> Optional[dict]:
    """The run's exposure record, or None — stdlib-only so the analyze/
    summarize joins can call it without loading torch."""
    path = os.path.join(run_dir, EXPOSURE_FILENAME)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(rec, dict) \
            or "comms_exposure_schema_version" not in rec:
        return None
    return rec
