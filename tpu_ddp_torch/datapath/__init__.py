"""Data-path observatory: the loader's stages observed four ways.

Counterpart of ``tpu_ddp/datapath/``:

- **Live spans and health** — ``data/<stage>`` spans (``data/loader.py``)
  and :class:`~tpu_ddp_torch.datapath.stages.StageMonitor`, which keeps
  ``data-health-p<i>.json`` fresh for the fleet aggregator
  (``tpu-ddp-torch watch``) and the DAT001 alert, and carries the chaos
  per-stage stall seam.
- **Determinism audit** — a seeded per-step batch-content digest in the
  incarnation-stamped ``data-p<i>[.i<k>].jsonl`` sink;
  ``tpu-ddp-torch data audit`` verifies that replayed steps across a
  kill and resume saw the same batches (``audit.py``).
- **Measured baselines** — ``tpu-ddp-torch data bench`` times each stage
  standalone into a kind-"data" registry artifact (``microbench.py``,
  ``model.py``).
- **Attribution** — ``tpu-ddp-torch data report`` decomposes a run's
  ``data_wait`` into its stages (``report.py``); the staged background
  prefetcher is ``prefetch.py``.

Everything but ``microbench`` and the digests themselves is stdlib-only,
so the audit and report commands run where torch and numpy are not
installed.
"""
