"""Measured kernel microbenchmarks: each hand-written kernel against its
plain PyTorch version.

The port's counterpart of ``tpu_ddp/ops/microbench.py``. For every kernel in
the ops registry with a strategy-level switch (``fused_quant`` is K2,
``fused_dequant`` K3 with ``add_to``, ``fused_update`` K1), sweep element
counts and measure both implementations on the same inputs, each kernel
called through the wrapper the trainer's ``--kernels`` and
``--grad-compress int8`` paths call. The sweeps fit per-kernel cost lines
(``ops/model.py``) and are emitted as the JAX schema-versioned artifact,
which ``registry record`` classifies as kind ``"ops"`` and ``bench
compare`` gates. The JAX key names stay: in each row ``fused_s`` is the
kernel's time and ``xla_s`` the time of the path without the kernel, which
in the port is the plain version (``quantize_chunk``, ``acc +
dequantize_chunk``, the optimizer's plain chain and ``p + u``).

Timing: after one warm call, ``reps`` repetitions of ``INNER`` back-to-back
calls, each repetition timed by CUDA events on the card (the host clock on
the CPU), the minimum over the repetitions divided by ``INNER`` (the JAX
``_time_best`` idiom). A point makes ``calls_per_point(reps)`` calls of
each implementation.

Every benched kernel carries an in-bench PARITY verdict: the kernel's
output is compared with the plain version's, bitwise (K1 and K2/K3 are
bitwise their plain versions on the card). A kernel that fails parity
poisons the artifact (``parity_ok: false``) and ``ops bench`` exits
nonzero naming it; the ``corrupt`` hook bumps the kernel's first output
element by one quantum, to prove that the gate trips.

No fallback: the JAX ``run_sweeps`` turns any exception into a ``skipped``
row; here only an unknown kernel name is skipped, and a kernel that fails
to build or launch on the card raises. On a CPU tensor the wrapper takes
the plain version (``--device cpu``), so a CPU sweep times plain against
plain, its speedups sit near 1, and its artifact says so in a note.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_ddp_torch.ops.model import OPS_SCHEMA_VERSION, fit_cost_line

#: the strategy-level kernels this bench sweeps (registry names)
BENCH_KERNELS = ("fused_quant", "fused_dequant", "fused_update")

#: element counts per sweep point: divisible by the default int8 block
#: (256) and by the update leaf's 128 columns
DEFAULT_SIZES = (8192, 65536)
DEFAULT_REPS = 3
DEFAULT_BLOCK = 256
#: back-to-back calls a timed repetition
INNER = 10

#: the artifact's note on a CPU sweep
CPU_NOTE = ("device cpu: every wrapper takes its plain version on a CPU "
            "tensor, so fused_s times the plain version too (speedups near 1)")


def calls_per_point(reps: int) -> int:
    """Calls of each implementation at one sweep point: the parity call,
    the warm call and the timed repetitions."""
    return 2 + max(reps, 1) * INNER


def _time_best(fn, *args, reps: int, device) -> float:
    import torch

    fn(*args)                                   # warm
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(reps, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(INNER):
                fn(*args)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(INNER):
                fn(*args)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / INNER)
    return best


def _bitwise_equal(a: Sequence, b: Sequence) -> bool:
    """Same shapes, dtypes and bits, element for element (floats compared
    as their int32 or int16 patterns, so a NaN equals the same NaN)."""
    import torch

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            view = {4: torch.int32, 2: torch.int16, 8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(view), y.contiguous().view(view)
        if not torch.equal(x, y):
            return False
    return True


def _poison(leaves: List) -> List:
    """Deliberately corrupt a kernel's output (the gate's proof): bump
    the first leaf's first element by one quantum of its dtype."""
    first = leaves[0].clone()
    flat = first.view(-1)
    flat[0] = flat[0] + 1
    return [first] + list(leaves[1:])


def _chunk_input(size: int, device):
    import torch

    # irrational-ish spread with sign flips and a zero block so the
    # quantizer's zero-guard path is exercised
    x = (torch.arange(size, dtype=torch.float32, device=device) % 257.0 - 128.0) * 0.173
    x[: min(size, 64)] = 0.0
    return x


def _quant_leaves(payload: dict) -> List:
    return [payload["q"], payload["scale"]]


def _bench_quant(sizes, reps, block, corrupt, device):
    from tpu_ddp_torch.ops.fused_quant import fused_quant
    from tpu_ddp_torch.parallel.compression import quantize_chunk

    def fused(x):
        return fused_quant(x, block)

    def plain(x):
        return quantize_chunk(x, "int8", block)

    rows = []
    for size in sizes:
        x = _chunk_input(size, device)
        got = _quant_leaves(fused(x))
        want = _quant_leaves(plain(x))
        if corrupt:
            got = _poison(got)
        ok = _bitwise_equal(got, want)
        rows.append({
            "kernel": "fused_quant", "elements": size,
            "fused_s": _time_best(fused, x, reps=reps, device=device),
            "xla_s": _time_best(plain, x, reps=reps, device=device),
            "parity_ok": ok,
        })
    return rows


def _bench_dequant(sizes, reps, block, corrupt, device):
    import torch

    from tpu_ddp_torch.ops.fused_quant import fused_dequant
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    def fused(p, acc):
        return fused_dequant(p, block, acc.shape[0], add_to=acc)

    def plain(p, acc):
        return acc + dequantize_chunk(p, "int8", block, acc.shape[0])

    rows = []
    for size in sizes:
        payload = quantize_chunk(_chunk_input(size, device), "int8", block)
        acc = torch.linspace(-1.0, 1.0, size, dtype=torch.float32, device=device)
        got = [fused(payload, acc)]
        want = [plain(payload, acc)]
        if corrupt:
            got = _poison(got)
        ok = _bitwise_equal(got, want)
        rows.append({
            "kernel": "fused_dequant", "elements": size,
            "fused_s": _time_best(fused, payload, acc, reps=reps, device=device),
            "xla_s": _time_best(plain, payload, acc, reps=reps, device=device),
            "parity_ok": ok,
        })
    return rows


#: the JAX bench's update recipe (``tpu_ddp/ops/microbench.py:156-158``)
UPDATE_RECIPE = dict(lr=1e-2, weight_decay=1e-4, grad_clip_norm=1.0, optimizer="adamw",
                     ema_decay=0.999)


def update_leaf(size: int, device):
    """The JAX bench's one 2-D leaf and its gradient (``:202-205``):
    ``{"w": p}``, ``{"w": g}`` of ``(size // 128, 128)``."""
    import torch

    n = torch.arange(size, dtype=torch.float32, device=device)
    p = {"w": (n % 97.0 * 1e-2).reshape(size // 128, 128)}
    g = {"w": torch.cos(n).reshape(size // 128, 128) * 1e-2}
    return p, g


def _update_leaves(p, s) -> List:
    return [p["w"], s.mu["w"], s.nu["w"], s.ema["w"], s.count]


def _bench_update(sizes, reps, corrupt, device, optimizer="adamw"):
    from tpu_ddp_torch.train.optim import make_optimizer

    kwargs = dict(UPDATE_RECIPE, optimizer=optimizer)
    if optimizer == "sgd":
        kwargs["momentum"] = 0.9
    tx_ref = make_optimizer(**kwargs)
    tx_k = make_optimizer(kernels=True, **kwargs)

    def fused(g, s, p):
        tx_k.apply(g, s, p)

    def plain(g, s, p):
        tx_ref.apply(g, s, p)

    def fresh(size):
        p, g = update_leaf(size, device)
        return g, tx_ref.init(p), p

    rows = []
    for size in sizes:
        g, s, p = fresh(size)
        fused(g, s, p)
        got = _update_leaves(p, s)
        g, s, p = fresh(size)
        plain(g, s, p)
        want = _update_leaves(p, s)
        if corrupt:
            got = _poison(got)
        ok = _bitwise_equal(got, want)
        # the update runs in place: each implementation steps its own copy
        rows.append({
            "kernel": "fused_update", "variant": optimizer,
            "elements": size,
            "fused_s": _time_best(fused, *fresh(size), reps=reps, device=device),
            "xla_s": _time_best(plain, *fresh(size), reps=reps, device=device),
            "parity_ok": ok,
        })
    return rows


def run_sweeps(
    *,
    kernels: Sequence[str] = BENCH_KERNELS,
    sizes: Sequence[int] = DEFAULT_SIZES,
    reps: int = DEFAULT_REPS,
    block: int = DEFAULT_BLOCK,
    corrupt: Optional[str] = None,
    progress=None,
    device=None,
) -> Tuple[List[dict], List[dict]]:
    """Measure every (kernel, elements) combination on ``device`` (default
    the current card); returns ``(sweeps, skipped)``. Only an unknown
    kernel name is recorded in ``skipped``; a kernel that fails to build
    or launch raises (module docstring). ``corrupt`` names a kernel whose
    output is deliberately perturbed before the parity comparison."""
    from tpu_ddp_torch.runtime import resolve_device

    device = resolve_device("cuda") if device is None else device
    sweeps: List[dict] = []
    skipped: List[dict] = []
    benchers = {
        "fused_quant": lambda: _bench_quant(
            sizes, reps, block, corrupt == "fused_quant", device),
        "fused_dequant": lambda: _bench_dequant(
            sizes, reps, block, corrupt == "fused_dequant", device),
        "fused_update": lambda: _bench_update(
            sizes, reps, corrupt == "fused_update", device),
    }
    for name in kernels:
        bench = benchers.get(name)
        if bench is None:
            skipped.append({"kernel": name,
                            "error": f"unknown bench kernel {name!r}"})
            continue
        rows = bench()
        sweeps.extend(rows)
        if progress:
            for row in rows:
                progress(row)
    return sweeps, skipped


def fit_kernels(sweeps: Sequence[dict]) -> Dict[str, dict]:
    """Per-kernel fused/xla cost-line fits plus the parity verdict;
    kernels with fewer than two distinct sizes are dropped (no line
    through one point)."""
    grouped: Dict[str, List[dict]] = {}
    for row in sweeps:
        grouped.setdefault(row["kernel"], []).append(row)
    out: Dict[str, dict] = {}
    for name, rows in grouped.items():
        xs = [r["elements"] for r in rows]
        if len(set(xs)) < 2:
            continue
        fused = fit_cost_line(xs, [r["fused_s"] for r in rows])
        xla = fit_cost_line(xs, [r["xla_s"] for r in rows])
        speedups = [r["xla_s"] / r["fused_s"]
                    for r in rows if r["fused_s"] > 0]
        out[name] = {
            "fused": fused.to_json(),
            "xla": xla.to_json(),
            "parity_ok": all(r["parity_ok"] for r in rows),
            # headline per kernel: best measured plain/kernel ratio (>1
            # means the kernel wins here)
            "speedup": max(speedups) if speedups else 0.0,
        }
    return out


def bench_artifact(sweeps: Sequence[dict], skipped: Sequence[dict],
                   *, reps: int = DEFAULT_REPS, device=None) -> dict:
    """The schema-versioned ``ops bench --json`` artifact (the JAX keys).
    The headline key is the median per-kernel speedup (quality, higher is
    better); per-kernel ``rows`` trend through the registry's measured
    channel; ``parity_ok`` is the gate ``ops bench`` exits nonzero on.
    ``backend`` is ``"cuda"`` or ``"cpu"``; a CPU artifact carries
    ``note`` (module docstring)."""
    import statistics

    import torch

    from tpu_ddp_torch.ops.model import _chip_key
    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    cuda = device.type == "cuda"
    device_kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    n_devices = torch.cuda.device_count() if cuda else 1
    chip = _chip_key(device_kind) or device_kind
    fitted = fit_kernels(sweeps)
    parity_ok = (all(k["parity_ok"] for k in fitted.values())
                 and all(r["parity_ok"] for r in sweeps))
    failing = sorted({r["kernel"] for r in sweeps if not r["parity_ok"]})
    speedups = [k["speedup"] for k in fitted.values() if k["speedup"] > 0]
    ops = {
        "chip": chip,
        "device_kind": device_kind,
        "backend": "cuda" if cuda else "cpu",
        "n_devices": n_devices,
        "reps": reps,
        # headline gate: the median per-kernel speedup (quality, higher
        # is better; near 1 on the CPU, where both sides are plain)
        "speedup": statistics.median(speedups) if speedups else 0.0,
        "parity_ok": parity_ok,
        "parity_failures": failing,
        "kernels": {k: v for k, v in sorted(fitted.items())},
        # registry trend channel: one measured row per kernel
        "rows": {f"ops/{name}": {"value": fitted[name]["speedup"]}
                 for name in sorted(fitted)},
        "sweeps": list(sweeps),
        "skipped": list(skipped),
    }
    if not cuda:
        ops["note"] = CPU_NOTE
    return {
        "type": "ops",
        "ops_schema_version": OPS_SCHEMA_VERSION,
        "provenance": artifact_provenance(
            descriptor={"artifact": "ops_bench", "chip": chip,
                        "backend": ops["backend"],
                        "n_devices": n_devices},
            device_kind=device_kind, torch_version=torch.__version__,
        ),
        "ops": ops,
    }
