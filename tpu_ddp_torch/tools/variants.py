"""What ``k4_variants`` and ``k56_variants`` share: a kernel library's
source rebuilt with textual edits, one library a variant, and the device
time of its kernels under ``torch.profiler``."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_ddp_torch.ops import _build


def build(library: str, variants: dict, extra: dict | None = None) -> dict:
    """variant -> loaded library, all compiled at once with ``library``'s
    nvcc flags into ``build/tpu_ddp_torch/<library>_variants/``: its
    source with each variant's ``[(text, replacement)]`` edits (each text
    found once), and each ``extra`` ``{name: (source path, extra flags)}``,
    a source with the same C entry points."""
    src = (_build.CSRC / _build.LIBRARIES[library][0]).read_text()
    out = _build.BUILD_DIR / f"{library}_variants"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        sources[name] = (out / f"{name}.cu", ())
    sources.update({name: (Path(path), tuple(flags))
                    for name, (path, flags) in (extra or {}).items()})
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.flags(library), *flags, "-o", str(out / f"{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, flags) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, (restype, argtypes) in _build.LIBRARIES[library][2].items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = lib
    return libs


def kernel_us(fn, iters: int, names) -> dict:
    """Device microseconds a call of ``fn`` spends in the kernels whose
    names hold each of ``names``, under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    us[name] += e.self_device_time_total / iters
    return us
