"""Analysis of a train step and of recorded artifacts.

Counterpart of ``tpu_ddp/analysis``: ``regress`` (``tpu-ddp-torch bench
compare``, the gate the perf registry shares), ``roofline`` (the one chip
table and the roofline, stdlib-only), ``anatomy`` (the step anatomy of one
step that really runs: the counterpart of the JAX ``hlo``, which reads
XLA's compiled program), ``explain`` (``tpu-ddp-torch analyze``) and
``lint`` (``tpu-ddp-torch lint``, the graph lint over one step that runs).
Only ``regress`` and ``roofline`` load here; ``anatomy``, ``explain`` and
``lint`` import torch and are imported by name.
"""

from tpu_ddp_torch.analysis import regress, roofline

__all__ = ["regress", "roofline"]
