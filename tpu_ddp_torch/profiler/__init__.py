"""Anomaly-triggered profiler: capture windows, host stacks, per-op joins.

The port's copy of ``tpu_ddp/profiler/``. The monitor (``monitor/``) can
say *that* a run is slow (a host straggles, STR001; throughput collapsed,
THR001; the loop is input-bound, DWT001). This package captures evidence
for *why* a live run is slow:

- ``capture``: a :class:`CaptureManager` in each training process arms a
  window of N steps three ways (``--profile-steps A:B``, ``POST
  /profile`` on the monitor exporter, or the ``capture_profile`` alert
  action) and writes a schema-versioned bundle to
  ``<run_dir>/profiles/step_<n>-p<i>/``.
- ``host``: a stdlib-only sampling profiler over every Python thread
  (``sys._current_frames`` at a fixed Hz): folded stacks plus a
  self-time top-frames table.
- ``device``: the window's ``torch.profiler`` session (CUDA kernels on
  the card), and the per-op attribution arithmetic.
- ``report``: ``tpu-ddp-torch profile <run_dir>``: renders bundles and,
  across two or more hosts, the straggler diff.

Module-level stdlib-only (torch imports are lazy), so the watch/report
side runs wherever the run dir lands.
"""

from tpu_ddp_torch.profiler.capture import (
    PROFILE_SCHEMA_VERSION,
    CaptureManager,
    list_bundles,
    parse_profile_steps,
    post_profile_trigger,
    read_bundle_meta,
)
from tpu_ddp_torch.profiler.device import per_op_attribution
from tpu_ddp_torch.profiler.host import HostSampler, frame_shares, top_frames
from tpu_ddp_torch.profiler.report import straggler_diff

__all__ = [
    "PROFILE_SCHEMA_VERSION",
    "CaptureManager",
    "HostSampler",
    "frame_shares",
    "list_bundles",
    "parse_profile_steps",
    "per_op_attribution",
    "post_profile_trigger",
    "read_bundle_meta",
    "straggler_diff",
    "top_frames",
]
