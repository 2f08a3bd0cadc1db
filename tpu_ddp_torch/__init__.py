"""tpu_ddp_torch — the PyTorch/CUDA port of ``tpu_ddp`` for NVIDIA Hopper.

The JAX package ``tpu_ddp`` is the reference; this package re-expresses its
main training path in PyTorch and replaces each Pallas kernel on that path
with a CUDA C++ kernel written for ``sm_90a``. It never imports JAX or
anything of ``tpu_ddp``: what it needs from there it keeps as its own copy.

Entry point: ``python -m tpu_ddp_torch.cli.train`` (runs on the GPU unless
``--device cpu`` is given).
"""
