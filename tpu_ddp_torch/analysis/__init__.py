"""Deviceless analysis of recorded artifacts.

The port's ``analysis`` holds ``regress`` alone (``tpu-ddp-torch bench
compare``, the gate the perf registry shares). The JAX package's ``hlo``,
``lint``, ``explain`` and ``roofline`` read XLA's compiled programs; their
counterparts come with the port's static analysis.
"""

from tpu_ddp_torch.analysis import regress

__all__ = ["regress"]
