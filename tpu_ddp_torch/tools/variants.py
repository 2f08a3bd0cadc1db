"""What ``k4_variants`` and ``k56_variants`` share: a kernel library's
source rebuilt with textual edits, one library a variant, the device time
of its kernels under ``torch.profiler``, and the bfloat16 tolerance."""

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
    nvcc flags into ``build/tpu_ddp_torch/<library>_variants/`` (each
    variant's compiler output beside it, ``<variant>.log``): its
    source and the headers of ``csrc/`` with each variant's
    ``[(text, replacement)]`` edits (each text found once in all of them),
    in a directory of the variant's own; and each ``extra`` ``{name:
    (source path, extra flags)}``, a source with the same C entry points,
    with the headers of ``csrc/`` on the include path after its own
    directory."""
    files = {f.name: f.read_text()
             for f in [_build.CSRC / _build.LIBRARIES[library][0],
                       *sorted(_build.CSRC.glob("*.cuh"))]}
    out = _build.BUILD_DIR / f"{library}_variants"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, edits in variants.items():
        texts = dict(files)
        for old, new in edits:
            where = [f for f, text in texts.items() if old in text]
            if len(where) != 1 or texts[where[0]].count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the sources once")
            texts[where[0]] = texts[where[0]].replace(old, new)
        (out / name).mkdir(exist_ok=True)
        for f, text in texts.items():
            (out / name / f).write_text(text)
        sources[name] = (out / name / _build.LIBRARIES[library][0], ())
    sources.update({name: (Path(path), tuple(flags))
                    for name, (path, flags) in (extra or {}).items()})
    # -I: an extra source finds the headers of csrc/ that its directory lacks
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.flags(library), *flags, "-I", str(_build.CSRC),
         "-o", str(out / f"{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, flags) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (out / f"{name}.log").write_text(log)     # ptxas's register report
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


def event_us(fn, iters: int) -> float:
    """Microseconds a call of ``fn`` between CUDA events around ``iters``
    back-to-back calls, after a warm-up call: what the caller waits for."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


#: a row's scale in ``bf16_row_units`` is at least this share of the
#: tensor's largest |value|: a row whose terms cancel (causal row 0 of dq,
#: ds = p (dO v - di) with di = dO v) holds the float32 sums' residual,
#: which scales with the tensor, not with the row
BF16_ROW_FLOOR = 2.0 ** -12


def bf16_row_units(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """``|got - want|`` in bfloat16 units in the last place of the largest
    ``|want|`` of its own row (the last axis: a query row of out and dq, a
    key row of dk and dv; at least ``BF16_ROW_FLOOR`` of the largest of
    all), so that a row of small values is held to its own scale; shaped as
    ``got``. The measure ``chip_smoke.py`` phase 20a and the variant tools
    hold the bfloat16 kernels to."""
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().amax(-1, keepdim=True)
    top = top.clamp(min=float(top.max()) * BF16_ROW_FLOOR)
    unit = torch.exp2(torch.floor(torch.log2(top)) - 7)     # 0 where all of want is 0
    return torch.where(diff == 0, 0.0, diff / unit)
