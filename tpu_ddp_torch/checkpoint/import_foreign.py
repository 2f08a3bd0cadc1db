"""Import and export of torchvision-layout state dicts for the ResNet family.

Counterpart of ``tpu_ddp/checkpoint/import_foreign.py`` (``_resnet_key_map``
:44, ``_model_map`` :97, ``load_state_dict`` :111, ``import_state_dict``
:132, ``export_state_dict`` :158). A torchvision ``state_dict`` (a torch
``.pt``/``.pth`` file, or an ``.npz`` with the same keys) maps onto the
port's ResNet (``models/resnet_family.py``), whose names follow the Flax
tree:

- ``conv1`` / ``bn1``       → ``stem_conv`` / ``stem_bn``
- ``layer{L}.{b}.conv{c}``  → ``_BasicBlock_{g}.Conv_{c-1}`` (or
  ``_Bottleneck_{g}``), ``g`` the block's index over the network
- ``layer{L}.{b}.downsample.{0,1}`` → the block's trailing conv/BN pair
- ``fc``                    → ``head``
- BN ``weight``/``bias`` are params, ``running_mean``/``running_var``
  buffers (the JAX package's ``batch_stats``).

Both sides are torch layout, so no weight is transposed (the JAX module
transposes conv and linear weights into Flax's). ``num_batches_tracked`` has
no counterpart (the port's BatchNorm does not count) and is reported as
unmapped. ``train/finetune.py`` routes a ``--pretrained-dir`` FILE here.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

#: foreign key -> (collection, the port's name)
KeyMap = Dict[str, Tuple[str, str]]


def _resnet_key_map(stage_sizes, bottleneck: bool) -> KeyMap:
    """torchvision ``state_dict`` key -> (``"params"`` or ``"batch_stats"``,
    the port's name) for a ResNet with the given stage layout."""
    m: KeyMap = {}

    def conv(tk, name):
        m[f"{tk}.weight"] = ("params", f"{name}.weight")

    def bn(tk, name):
        m[f"{tk}.weight"] = ("params", f"{name}.weight")
        m[f"{tk}.bias"] = ("params", f"{name}.bias")
        m[f"{tk}.running_mean"] = ("batch_stats", f"{name}.running_mean")
        m[f"{tk}.running_var"] = ("batch_stats", f"{name}.running_var")

    conv("conv1", "stem_conv")
    bn("bn1", "stem_bn")
    blk_cls = "_Bottleneck" if bottleneck else "_BasicBlock"
    n_convs = 3 if bottleneck else 2
    g = 0
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            blk, t = f"{blk_cls}_{g}", f"layer{stage + 1}.{b}"
            for c in range(n_convs):
                conv(f"{t}.conv{c + 1}", f"{blk}.Conv_{c}")
                bn(f"{t}.bn{c + 1}", f"{blk}.BatchNorm_{c}")
            # the projection shortcut is the block's trailing conv/BN pair;
            # blocks without one have no downsample.* keys
            conv(f"{t}.downsample.0", f"{blk}.Conv_{n_convs}")
            bn(f"{t}.downsample.1", f"{blk}.BatchNorm_{n_convs}")
            g += 1
    m["fc.weight"] = ("params", "head.weight")
    m["fc.bias"] = ("params", "head.bias")
    return m


def _model_map(model) -> KeyMap:
    from tpu_ddp_torch.models.resnet_family import ResNet, _Bottleneck

    if not isinstance(model, ResNet):
        raise ValueError(
            "foreign state_dict import covers the torchvision-layout "
            "ResNet family (models/resnet_family.py); got "
            f"{type(model).__name__}. For other families use this "
            "framework's own checkpoints.")
    return _resnet_key_map(model.stage_sizes, model.block is _Bottleneck)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A foreign checkpoint as ``{key: np.ndarray}``. ``.npz`` loads with
    numpy; anything else with ``torch.load`` (CPU, ``weights_only``). A
    nested ``state_dict``/``model`` entry and DDP's ``module.`` prefix are
    unwrapped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        for wrapper in ("state_dict", "model"):
            if isinstance(loaded, dict) and isinstance(loaded.get(wrapper), dict):
                loaded = loaded[wrapper]
        raw = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
               for k, v in loaded.items()}
    return {k.removeprefix("module."): v for k, v in raw.items()}


def import_state_dict(path: str, model) -> Tuple[dict, dict, dict]:
    """Foreign checkpoint file -> ``(params, batch_stats, report)``: flat
    ``{port name: tensor}`` dicts and ``report`` with the count of
    ``mapped`` keys and the sorted ``unmapped`` ones, so a mis-shaped import
    shows instead of passing silently."""
    key_map = _model_map(model)
    sd = load_state_dict(path)
    out = {"params": {}, "batch_stats": {}}
    unmapped = []
    for key, arr in sd.items():
        entry = key_map.get(key)
        if entry is None:
            unmapped.append(key)
            continue
        coll, name = entry
        out[coll][name] = torch.from_numpy(np.ascontiguousarray(arr))
    report = {"mapped": len(sd) - len(unmapped), "unmapped": sorted(unmapped)}
    return out["params"], out["batch_stats"], report


def export_state_dict(params: dict, batch_stats: dict, model, path: str) -> str:
    """The port's flat ``params`` and ``batch_stats`` (a ``state_dict``
    holds both) -> a torchvision-layout file at ``path``, the exact inverse
    of ``import_state_dict``: ``.pt``/``.pth`` through ``torch.save``,
    anything else as ``.npz`` (the suffix added when missing, as the JAX
    exporter does). Returns the absolute path."""
    key_map = _model_map(model)
    trees = {"params": params, "batch_stats": batch_stats}
    flat = {}
    for key, (coll, name) in key_map.items():
        t = trees[coll].get(name)
        if t is not None:            # a block without a projection shortcut
            flat[key] = t.detach().cpu().contiguous()
    if path.endswith((".pt", ".pth")):
        torch.save(flat, path)
    else:
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, **{k: v.numpy() for k, v in flat.items()})
    return os.path.abspath(path)
