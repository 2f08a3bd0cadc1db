"""Measured per-stage loader microbenchmarks (``tpu-ddp-torch data bench``).

Counterpart of ``tpu_ddp/datapath/microbench.py`` (``run_stage_bench``,
``bench_artifact``, ``format_bench``). Times each input-pipeline stage
**standalone**: the stage bodies the live loader runs
(``ShardedBatchLoader``'s stage methods, ``data/loader.py``), the minimum over
reps after a warm-up pass, over a synthetic CIFAR-shaped dataset, plus the
end-to-end staged pipeline, and emits a schema-versioned artifact that
``registry record`` classifies as kind ``"data"`` and ``bench compare``
gates (per-stage batches/s and bytes/s higher-better, the end-to-end batch
time a size key).

The headline number is ``per_image_s``, seconds of host input work per
image at the benched batch size; the per-stage ``batches_per_s`` table is
the DAT001 alert's collapse baseline.

The ``h2d`` stage is a copy of the collated batch from pinned host memory
to the card followed by a synchronisation. It is skipped only where that
was asked for: ``--no-h2d``, or ``--device cpu`` (no card to copy to). On
``cuda`` a missing card or a failed copy raises, where the JAX bench turns
any h2d failure into a skipped row (:165-182).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tpu_ddp_torch.data.loader import ShardedBatchLoader
from tpu_ddp_torch.datapath.model import DATA_SCHEMA_VERSION
from tpu_ddp_torch.datapath.stages import HOST_STAGES, STAGES

DEFAULT_N = 4096
DEFAULT_BATCH = 256
DEFAULT_REPS = 20
#: CIFAR-shaped samples: 32x32x3 f32 image + int32 label
DEFAULT_IMAGE_SHAPE = (32, 32, 3)


def reference_host_augment(
    images: np.ndarray, labels: np.ndarray, *, pad: int = 4, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """A host-side random crop and flip of the shape the in-step augment
    applies (``data/augment.py``), benched so the ``augment`` stage has a
    cost number even though the live pipeline keeps it a passthrough."""
    rng = np.random.default_rng(seed)
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    padded = np.pad(
        images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect"
    )
    ys = rng.integers(0, 2 * pad + 1, size=b)
    xs = rng.integers(0, 2 * pad + 1, size=b)
    out = np.empty_like(images)
    for i in range(b):
        out[i] = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
    flips = rng.random(b) < 0.5
    out[flips] = out[flips, :, ::-1]
    return out, labels


def synthetic_dataset(
    n: int, image_shape: Tuple[int, ...], *, classes: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    images = rng.random((n, *image_shape), dtype=np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    return images, labels


def _time_best(fn: Callable[[], object], reps: int) -> float:
    fn()  # warm caches / lazy imports
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _per_batch_epoch_time(run_epoch: Callable[[], int], reps: int) -> float:
    """Best-of-reps full-epoch time divided by the epoch's batch count —
    the honest shape for stages whose cost amortizes over the epoch
    (the index stage pays its permutation at generator start)."""
    steps = run_epoch()  # warmup; also yields the step count
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        run_epoch()
        best = min(best, time.perf_counter() - t0)
    return best / max(steps, 1)


def run_stage_bench(
    *,
    n: int = DEFAULT_N,
    world_size: int = 1,
    per_shard_batch: int = DEFAULT_BATCH,
    image_shape: Tuple[int, ...] = DEFAULT_IMAGE_SHAPE,
    reps: int = DEFAULT_REPS,
    seed: int = 0,
    host_augment: Optional[Callable] = reference_host_augment,
    h2d: bool = True,
    device: str = "cuda",
    progress: Optional[Callable[[str, float], None]] = None,
) -> Tuple[Dict[str, Dict[str, float]], List[dict], Dict[str, float]]:
    """Bench every stage standalone; returns ``(stages, skipped,
    headline)``. The h2d stage runs with ``h2d`` on ``device`` "cuda" and
    is skipped, with the reason, otherwise (module docstring); a failure
    raises."""
    images, labels = synthetic_dataset(n, image_shape, seed=seed)
    loader = ShardedBatchLoader(
        images,
        labels,
        world_size=world_size,
        per_shard_batch=per_shard_batch,
        shuffle=True,
        seed=seed,
        host_augment=host_augment,
    )
    # fixed representative inputs for the per-batch stages
    idx, mask = next(loader.epoch_index_batches(0))
    g_images, g_labels = loader.gather(idx)
    collated = loader._stage_collate(g_images, g_labels, mask)
    batch_nbytes = sum(int(v.nbytes) for v in collated.values())

    stages: Dict[str, Dict[str, float]] = {}
    skipped: List[dict] = []

    def _record(stage: str, seconds: float, nbytes: int) -> None:
        seconds = max(seconds, 1e-9)
        stages[stage] = {
            "seconds_per_batch": seconds,
            "batches_per_s": 1.0 / seconds,
            "bytes_per_s": nbytes / seconds,
        }
        if progress:
            progress(stage, seconds)

    def _index_epoch() -> int:
        steps = 0
        for _ in loader.epoch_index_batches(0):
            steps += 1
        return steps

    bodies: Dict[str, Callable[[], float]] = {
        "index": lambda: _per_batch_epoch_time(_index_epoch, reps),
        "gather": lambda: _time_best(lambda: loader.gather(idx), reps),
        "augment": lambda: _time_best(
            lambda: loader._stage_augment(g_images, g_labels), reps
        ),
        "collate": lambda: _time_best(
            lambda: loader._stage_collate(g_images, g_labels, mask), reps
        ),
        "shard": lambda: _time_best(lambda: loader._stage_shard(collated), reps),
    }
    bytes_of = {
        "index": int(idx.nbytes + mask.nbytes),
        "gather": int(g_images.nbytes + g_labels.nbytes),
        "augment": int(g_images.nbytes + g_labels.nbytes),
        "collate": batch_nbytes,
        "shard": batch_nbytes,
    }
    for stage in HOST_STAGES:
        _record(stage, bodies[stage](), bytes_of[stage])

    device_kind = "host-cpu"
    if not h2d:
        skipped.append({"stage": "h2d", "error": "disabled (--no-h2d)"})
    elif device == "cpu":
        skipped.append({"stage": "h2d", "error": "--device cpu: no card to copy to"})
    else:
        import torch

        from tpu_ddp_torch.runtime import resolve_device

        dev = resolve_device(device)
        device_kind = torch.cuda.get_device_name(dev)
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in collated.items()}

        def _h2d() -> None:
            for t in pinned.values():
                t.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)

        _record("h2d", _time_best(_h2d, reps), batch_nbytes)

    # end-to-end: the staged host pipeline as the live sync path runs it
    def _pipeline_epoch() -> int:
        steps = 0
        for _ in loader.epoch_batches(0):
            steps += 1
        return steps

    batch_time = _per_batch_epoch_time(_pipeline_epoch, reps)
    if "h2d" in stages:
        batch_time += stages["h2d"]["seconds_per_batch"]
    batch_time = max(batch_time, 1e-9)
    local_batch = loader.local_batch
    headline = {
        "batch_time_s": batch_time,
        "per_image_s": batch_time / max(local_batch, 1),
        "batches_per_s": 1.0 / batch_time,
        "bytes_per_s": batch_nbytes / batch_time,
        "device_kind": device_kind,
        "local_batch": local_batch,
        "global_batch": loader.global_batch,
        "sample_bytes": batch_nbytes // max(local_batch, 1),
    }
    return stages, skipped, headline


def bench_artifact(
    stages: Dict[str, Dict[str, float]],
    skipped: List[dict],
    headline: Dict[str, float],
    *,
    n: int = DEFAULT_N,
    world_size: int = 1,
    per_shard_batch: int = DEFAULT_BATCH,
    reps: int = DEFAULT_REPS,
) -> dict:
    """The schema-versioned ``data bench --json`` artifact. Headline
    keys gate in ``bench compare`` (per-stage batches/s: quality,
    higher-better; end-to-end batch time: unit-scale size); per-stage
    ``rows`` trend through the registry's measured channel."""
    import torch

    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    device_kind = str(headline.get("device_kind", "host-cpu"))
    # dominant stage: the slowest measured per-batch stage
    dominant = (
        max(stages, key=lambda s: stages[s]["seconds_per_batch"])
        if stages
        else None
    )
    data = {
        "device_kind": device_kind,
        "n": int(n),
        "world_size": int(world_size),
        "per_shard_batch": int(per_shard_batch),
        "global_batch": int(headline.get("global_batch", 0)),
        "local_batch": int(headline.get("local_batch", 0)),
        "sample_bytes": int(headline.get("sample_bytes", 0)),
        "reps": int(reps),
        # headline gates
        "batch_time_s": float(headline["batch_time_s"]),
        "per_image_s": float(headline["per_image_s"]),
        "batches_per_s": float(headline["batches_per_s"]),
        "bytes_per_s": float(headline["bytes_per_s"]),
        "dominant_stage": dominant,
        "stages": {s: dict(v) for s, v in sorted(stages.items())},
        # registry trend channel: one measured row per stage
        "rows": {
            f"stage/{s}": {"value": v["batches_per_s"]}
            for s, v in sorted(stages.items())
        },
        "skipped": list(skipped),
    }
    return {
        "type": "data",
        "data_schema_version": DATA_SCHEMA_VERSION,
        "provenance": artifact_provenance(
            descriptor={
                "artifact": "data_bench",
                "n": int(n),
                "world_size": int(world_size),
                "per_shard_batch": int(per_shard_batch),
                "stages": sorted(stages),
            },
            device_kind=device_kind,
            torch_version=torch.__version__,
        ),
        "data": data,
    }


def format_bench(art: dict) -> str:
    data = art.get("data", art)
    lines = [
        "data-path stage microbenchmark "
        f"(n={data.get('n')}, global_batch={data.get('global_batch')}, "
        f"reps={data.get('reps')}, device={data.get('device_kind')})",
        f"  {'stage':<10} {'ms/batch':>10} {'batches/s':>11} {'MiB/s':>10}",
    ]
    stages = data.get("stages", {})
    for stage in STAGES:
        v = stages.get(stage)
        if v is None:
            continue
        lines.append(
            f"  {stage:<10} {v['seconds_per_batch'] * 1e3:>10.3f} "
            f"{v['batches_per_s']:>11.1f} "
            f"{v['bytes_per_s'] / 2**20:>10.1f}"
        )
    lines.append(
        f"  end-to-end: {data.get('batch_time_s', 0.0) * 1e3:.3f} ms/batch "
        f"({data.get('per_image_s', 0.0) * 1e6:.2f} us/image), "
        f"dominant stage: {data.get('dominant_stage')}"
    )
    for s in data.get("skipped", []):
        lines.append(f"  skipped {s.get('stage')}: {s.get('error')}")
    return "\n".join(lines)
