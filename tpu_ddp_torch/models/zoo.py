"""Model registry: ``register(name)`` puts a factory into
``MODEL_REGISTRY``.

Counterpart of ``tpu_ddp/models/zoo.py``. A factory takes ``num_classes``,
a ``torch.Generator`` that fixes its weights, the ``image_size`` of its
square input (default 32, CIFAR's) and the compute ``dtype`` (float32 by
default, or bfloat16, as the JAX registry's factories take it). NetResDeep is built by the
trainer itself (its constructor carries the tied-blocks flag), as in the
JAX package.
"""

from __future__ import annotations

MODEL_REGISTRY: dict = {}


def register(name: str):
    def deco(factory):
        MODEL_REGISTRY[name] = factory
        return factory

    return deco
