"""Comms observatory: measured collective cost and stuck-collective
forensics.

Counterpart of ``tpu_ddp/comms/``:

- ``microbench``: sweep real collectives (the stock kinds through
  ``parallel/collectives.py`` and the compressed rings the trainer runs)
  over the rank grid's data axis and payload sizes, measuring achieved
  bandwidth and latency;
- ``model``: fit per-(chip, axis, kind, dtype) α-β link models from the
  sweeps and assemble them from artifact files and the registry;
- ``forensics``: name the suspect in-flight collective when the watchdog
  declares a hang, from the ring hop hook's health files.

CLI: ``tpu-ddp-torch comms bench|calibrate|forensics`` (``comms/cli.py``).
The JAX ``exposure`` leg times a recorded program against a one-device
twin through ``analysis/explain``, which the port does not have; its
command refuses by name.
"""

from tpu_ddp_torch.comms.model import (  # noqa: F401
    COMMS_SCHEMA_VERSION,
    AlphaBeta,
    LinkModel,
    comms_model_for_chip,
    fit_alpha_beta,
    link_key,
    model_from_comms_record,
)
