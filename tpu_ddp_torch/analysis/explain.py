"""``tpu-ddp-torch analyze`` — where the step time must go, and where it went.

The port's counterpart of ``tpu_ddp/analysis/explain.py``, with its names,
report, JSON and exit codes (0, 1 a fingerprint failure, 2 a refusal).

Static mode (a strategy/model): build the strategy's train step as a run
builds it (``train/strategy.py::build_step_program``: a ``Trainer`` at the
``TrainConfig`` the strategy names), run ONE step of it and take its
:class:`~tpu_ddp_torch.analysis.anatomy.StepAnatomy`
(``analysis/anatomy.py``), attribute it on the chip roofline
(``analysis/roofline.py``), verify the strategy's expected collective
fingerprint, and render the report. A step of N ranks (``--n-devices``,
default 8 as the JAX package's 8 virtual CPU devices) runs as rank 0
against a group that does not communicate (``anatomy.fake_world``); the
step runs on ``--device`` (default ``cuda``), so its allocator bytes are
the card's. The JAX tiny per-family models are the default; ``--model``
names a zoo model, or ``lm_32k``, the causal LM at LM-32k's widths
(``--seq-len`` tokens a row), whose DP step (``train/lm_steps.py``) the
JAX analyzer has no counterpart of.

Run-dir mode (a directory a ``--telemetry-dir`` run wrote): read the
run-metadata header from the JSONL trace, rebuild the SAME step at the
recorded ``TrainConfig`` and mesh on the device the run recorded, and
JOIN the anatomy against the
measured per-phase telemetry: achieved-vs-roofline, MFU, comm share and
the data-wait share. The port's measured step is a step's dispatch
(``compiled_step``, the JAX name for an eager step's issue) plus the wait
for the card behind it (``device_sync``), per step; the JAX join divides
by ``compiled_step`` alone, which in the port would read the dispatch as
the step. Runs whose program cannot be rebuilt (``--steps-per-call`` above
1) are refused with an explanation, as in JAX; so is a run recorded on the
card read where there is none, or rebuilt on another device: the CPU runs
each kernel's plain version op by op, another program to count.

The **fingerprints** are a parallelism-correctness net: each strategy has a
pinned set of collective kinds its step must (and must not) issue. The
port's table keeps the JAX rows where the port's steps issue the JAX kinds;
where they issue others by design, the row says so (``ROADMAP.md`` section 3
lists each difference).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, Dict, Optional, Sequence

from tpu_ddp_torch.analysis.anatomy import StepAnatomy
from tpu_ddp_torch.analysis.roofline import RooflineReport, roofline
from tpu_ddp_torch.memtrack.reconcile import read_run_meta  # noqa: F401  (the JAX name)

#: the analyzer's strategy surface: every parallelism family, plus the
#: dp-family layout variants that change the collective story
STRATEGIES = ("dp", "zero1", "zero3", "grad_compress", "sp", "fsdp", "tp",
              "fsdp_tp", "pp", "ep")

#: the causal LMs ``--model`` takes (LM-32k: the widths of the JAX
#: ``benchmarks/aot_v5e.py`` lm_causal_32k program)
LM_MODELS = {"lm_32k": dict(vocab_size=32_000, hidden_dim=512, depth=4, num_heads=8,
                            mlp_ratio=4)}

#: Expected collective fingerprint per strategy (the JAX shape: a list of
#: alternation groups of (kind, dtype-or-None), one of each group must
#: appear; ``forbidden`` kinds must not). The port's rows, against the JAX
#: ones (ROADMAP.md section 3):
#: - zero1: grads reduce-scatter, params all-gather; the port's
#:   reduce-scatter is the real op (JAX may lower it as an all-reduce).
#: - zero3: block all-gathers on the prefetch schedule, grads
#:   reduce-scatter; the clip's and the loss's sums are all-reduces.
#: - grad_compress: the int8 ring's hops are s8 permutes (the JAX row);
#:   its gather phase is ONE s8 all-gather of the quantized rows, where the
#:   JAX ring permutes that phase too, and the scales ride inside the same
#:   s8 message.
#: - sp: K/V hop permutes over the sequence ring, grads all-reduce.
#: - fsdp: ZeRO-3's block all-gathers over the data group, reduce-scatter
#:   of the grads (JAX's GSPMD may pick any reshard; the port's are fixed).
#: - tp/fsdp_tp: the model axis' activation all-reduces (fsdp_tp also
#:   ZeRO-3's all-gathers over data), as the JAX rows.
#: - pp: stage-to-stage permutes.
#: - ep (differs): the combine is ONE all-reduce over the expert group and
#:   there is no all-to-all or all-gather, because the group's ranks hold
#:   the same tokens (``parallel/expert_parallel.py``); the JAX row requires all-to-all | all-gather.
EXPECTED_FINGERPRINTS: Dict[str, Dict[str, Sequence]] = {
    "dp": {"required": [[("all-reduce", None)]],
           "forbidden": ["reduce-scatter", "all-gather",
                         "collective-permute", "all-to-all"]},
    "zero1": {"required": [[("reduce-scatter", None), ("all-reduce", None)],
                           [("all-gather", None)]],
              "forbidden": ["collective-permute", "all-to-all"]},
    "zero3": {"required": [[("all-gather", None)],
                           [("reduce-scatter", None), ("all-reduce", None)]],
              "forbidden": ["collective-permute", "all-to-all"]},
    "grad_compress": {"required": [[("collective-permute", "s8")]],
                      "forbidden": ["all-to-all"]},
    "grad_compress_bf16": {"required": [[("collective-permute", None)]],
                           "forbidden": ["all-to-all"]},
    "sp": {"required": [[("collective-permute", None)],
                        [("all-reduce", None)]],
           "forbidden": ["all-to-all"]},
    "fsdp": {"required": [[("all-gather", None)]],
             "forbidden": []},
    "tp": {"required": [[("all-reduce", None)]],
           "forbidden": ["all-to-all"]},
    "fsdp_tp": {"required": [[("all-gather", None)], [("all-reduce", None)]],
                "forbidden": []},
    "pp": {"required": [[("collective-permute", None)]],
           "forbidden": ["all-to-all"]},
    "ep": {"required": [[("all-reduce", None)]],
           "forbidden": ["all-to-all"]},
}


def check_fingerprint(anatomy: StepAnatomy,
                      strategy: Optional[str] = None) -> dict:
    """Verify ``anatomy`` against its strategy's expected fingerprint.
    Returns ``{ok, strategy, missing, unexpected}`` — ``missing`` entries
    fail the analyze exit code; ``unexpected`` are forbidden kinds that
    appeared (equally fatal)."""
    strategy = strategy or anatomy.strategy
    expected = EXPECTED_FINGERPRINTS.get(strategy)
    if expected is None:
        return {"ok": None, "strategy": strategy, "missing": [],
                "unexpected": [],
                "note": f"no pinned fingerprint for {strategy!r}"}
    present = {(c.kind, c.dtype) for c in anatomy.collectives}
    present_kinds = {k for k, _ in present}
    missing = []
    for group in expected["required"]:
        hit = any(
            (kind in present_kinds if dtype is None
             else (kind, dtype) in present)
            for kind, dtype in group
        )
        if not hit:
            missing.append(" | ".join(
                kind + (f"[{dtype}]" if dtype else "")
                for kind, dtype in group
            ))
    unexpected = sorted(
        k for k in present_kinds if k in expected["forbidden"]
    )
    return {"ok": not missing and not unexpected, "strategy": strategy,
            "missing": missing, "unexpected": unexpected}


# -- building a strategy's step ---------------------------------------------

def _tiny_model(strategy: str, num_classes: int, dtype):
    """The JAX small per-family models for fast analysis (pass
    ``model_name`` for the real zoo)."""
    if strategy in ("sp", "pp", "tp", "fsdp_tp", "fsdp"):
        from tpu_ddp_torch.models.vit import ViT

        return ViT(patch_size=8, hidden_dim=32, depth=2, num_heads=2,
                   num_classes=num_classes, dtype=dtype), "vit_tiny"
    if strategy == "ep":
        from tpu_ddp_torch.models.moe import MoEViT

        return MoEViT(patch_size=8, hidden_dim=32, depth=2, num_heads=2,
                      num_experts=4, top_k=1, moe_every=2,
                      num_classes=num_classes, dtype=dtype), "vit_moe_tiny"
    from tpu_ddp_torch.models.resnet import NetResDeep

    return NetResDeep(n_chans1=8, n_blocks=2, num_classes=num_classes,
                      dtype=dtype), "netresdeep_tiny"


#: the config's model name for each tiny model (the trainer's guards read
#: the model object; the name labels the config)
_TINY_CONFIG_MODEL = {"vit_tiny": "vit_s4", "vit_moe_tiny": "vit_moe_s4",
                      "netresdeep_tiny": "netresdeep"}


@dataclasses.dataclass
class StrategyProgram:
    """One strategy's step, ready to run (``prepare_strategy_program``):
    ``step()`` runs one optimizer step in place (what
    ``anatomy.count_step`` counts), ``close()`` (None: nothing to release)
    releases the trainer. ``mesh`` is the rank grid's axis sizes,
    ``n_devices`` their product (the group's size). The graph lint's
    inputs (``analysis/lint.py``): ``leaves()`` the rank's state by
    section (``params``, ``opt_state``, ``batch_stats``, ``step``: each
    leaf's tensor, whole-leaf element count and whether the layout cuts
    it; ``train/state.py::StateLayout.leaves``), ``batch`` the step's
    batch on the device, and ``zero`` the ZeRO partition (None without
    one)."""

    strategy: str
    parallelism: str
    step: Any
    mesh: Dict[str, int]
    n_devices: int
    model_name: str
    compute_dtype: str
    per_shard_batch: int
    device: Any
    close: Any = None
    leaves: Any = None
    batch: Any = None
    zero: Any = None

    @property
    def device_kind(self) -> str:
        import torch

        return (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")


def _mesh_for(strategy: str, n_devices: int, axis_size: Optional[int]) -> Dict[str, int]:
    """The JAX static mesh: data over every device, or the family's axis
    at ``axis_size`` and data the rest. The default axis is 2 for pp, sp,
    tp and fsdp_tp (JAX: min(4, n) for tp and fsdp_tp, but a port tp rank
    holds whole heads and the tiny ViT has 2), else min(4, n)."""
    from tpu_ddp_torch.parallel.mesh import resolve
    from tpu_ddp_torch.train.strategy import MODE_AXIS

    axis = MODE_AXIS.get(strategy)
    if axis is None:
        return resolve({"data": -1}, n_devices)
    if axis_size is None:
        axis_size = 2 if strategy in ("pp", "sp", "tp", "fsdp_tp") else min(4, n_devices)
    if n_devices % axis_size:
        raise ValueError(
            f"axis_size {axis_size} does not divide {n_devices} devices")
    return resolve({"data": n_devices // axis_size, axis: axis_size}, n_devices)


def _lm_program(strategy: str, model_name: str, *, per_shard_batch: int, seq_len: int,
                compute_dtype: str, attention: str, kernels: bool, device):
    """The causal LM's DP step (``train/lm_steps.py``, AdamW lr 1e-3 as
    the LM's recipe), its state's leaves (``StateLayout.leaves``) and its
    one batch of random tokens."""
    import torch

    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import StateLayout

    if strategy != "dp":
        raise ValueError(f"--model {model_name} analyzes the LM's dp step only, "
                         f"not {strategy!r}")
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    model = CausalTransformerLM(**LM_MODELS[model_name], seq_len=seq_len,
                                use_flash=attention == "flash", dtype=dtype,
                                generator=torch.Generator().manual_seed(0))
    tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=kernels)
    state = create_lm_train_state(model, tx, device)
    step = make_lm_train_step(tx)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, LM_MODELS[model_name]["vocab_size"],
                                     (per_shard_batch, seq_len), generator=gen).to(device)}
    holder = [state]

    def run():
        holder[0], metrics = step(holder[0], batch)
        return metrics

    return run, (lambda: StateLayout().leaves(holder[0])), batch


def strategy_config(strategy: str, *, mesh: Dict[str, int], model: str,
                    per_shard_batch: int, compute_dtype: str, device: str,
                    grad_accum_steps: int = 1, remat: bool = False,
                    compress_mode: str = "int8", compress_block: int = 256,
                    n_microbatches: int = 2, kernels: bool = False,
                    attention: str = "full", momentum: float = 0.9,
                    ema_decay: float = 0.0, num_classes: int = 10):
    """The ``TrainConfig`` of a static strategy (the JAX
    ``prepare_strategy_program``'s recipe: SGD lr 0.1, momentum 0.9;
    ``grad_compress`` without error feedback), on synthetic data of one
    global batch."""
    from tpu_ddp_torch.train.strategy import MODE_AXIS
    from tpu_ddp_torch.train.trainer import TrainConfig

    parallelism = {"zero1": "dp", "zero3": "dp", "grad_compress": "dp"}.get(
        strategy, strategy)
    return TrainConfig(
        sp_flash=strategy == "sp" and attention == "flash",
        device=device, synthetic_data=True,
        synthetic_size=per_shard_batch * mesh["data"], epochs=1,
        per_shard_batch=per_shard_batch, lr=1e-1, momentum=momentum,
        ema_decay=ema_decay, num_classes=num_classes,
        kernels=kernels, zero1=strategy == "zero1", zero3=strategy == "zero3",
        grad_compress=compress_mode if strategy == "grad_compress" else "none",
        grad_compress_block=compress_block, parallelism=parallelism,
        mesh=dict(mesh) if MODE_AXIS.get(strategy) else None,
        n_microbatches=n_microbatches, model=model, attention=attention,
        compute_dtype=compute_dtype, remat=remat, grad_accum_steps=grad_accum_steps,
        prefetch_depth=0, log_every_epochs=1)


def prepare_strategy_program(
    strategy: str,
    *,
    n_devices: int = 8,
    device: str = "cuda",
    model_name: Optional[str] = None,
    model=None,
    per_shard_batch: int = 8,
    compute_dtype: str = "float32",
    num_classes: int = 10,
    axis_size: Optional[int] = None,
    grad_accum_steps: int = 1,
    remat: bool = False,
    compress_mode: str = "int8",
    compress_block: int = 256,
    n_microbatches: int = 2,
    kernels: bool = False,
    attention: str = "full",
    seq_len: int = 4096,
    momentum: float = 0.9,
    ema_decay: float = 0.0,
    loss_fn=None,
    in_place: bool = True,
) -> StrategyProgram:
    """Build the strategy's step (module docstring) over the process group
    that is up, which must hold ``n_devices`` ranks (one process: 1).
    ``model``: a model object in place of the tiny one or ``model_name``.
    ``loss_fn`` and ``in_place`` are the graph lint's injected faults (a
    loss in place of the config's; a step that updates out of place:
    ``train/strategy.py::StepProgram``)."""
    import torch

    from tpu_ddp_torch.parallel.runtime import world_size
    from tpu_ddp_torch.runtime import resolve_device
    from tpu_ddp_torch.train.strategy import build_step_program

    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r}; choose from {STRATEGIES}"
        )
    if world_size() != n_devices:
        raise ValueError(f"the process group holds {world_size()} ranks, "
                         f"the program {n_devices}")
    dev = resolve_device(device)
    parallelism = {"zero1": "dp", "zero3": "dp", "grad_compress": "dp"}.get(
        strategy, strategy)
    mesh = _mesh_for(strategy, n_devices, axis_size)
    common = dict(strategy=strategy, parallelism=parallelism, mesh=mesh,
                  n_devices=n_devices, compute_dtype=compute_dtype,
                  per_shard_batch=per_shard_batch, device=dev)
    if model_name in LM_MODELS:
        if loss_fn is not None or not in_place:
            raise ValueError(f"--model {model_name}: no injected fault in the LM's step")
        run, leaves, batch = _lm_program(
            strategy, model_name, per_shard_batch=per_shard_batch, seq_len=seq_len,
            compute_dtype=compute_dtype, attention=attention, kernels=kernels, device=dev)
        return StrategyProgram(step=run, model_name=model_name, leaves=leaves, batch=batch,
                               **common)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    config_model = model_name
    if model is None and not model_name:
        model, model_name = _tiny_model(strategy, num_classes, dtype)
        config_model = _TINY_CONFIG_MODEL[model_name]
        if attention == "flash":       # build_model's binding, for the tiny model
            if not hasattr(model, "attention_impl"):
                raise ValueError(f"--attention flash needs an attention model (ViT "
                                 f"family); {strategy}'s {model_name} has none")
            from tpu_ddp_torch.ops.flash_attention import flash_attention

            model.attention_impl = flash_attention
    cfg = strategy_config(
        strategy, mesh=mesh, model=config_model or "netresdeep",
        per_shard_batch=per_shard_batch, compute_dtype=compute_dtype, device=device,
        grad_accum_steps=grad_accum_steps, remat=remat, compress_mode=compress_mode,
        compress_block=compress_block, n_microbatches=n_microbatches, kernels=kernels,
        attention=attention, momentum=momentum, ema_decay=ema_decay,
        num_classes=num_classes)
    prog = build_step_program(cfg, model=model, loss_fn=loss_fn, in_place=in_place)
    return StrategyProgram(step=prog.step, model_name=model_name or "custom",
                           close=prog.close, leaves=prog.leaves, batch=prog.batch,
                           zero=prog.trainer.layout.zero, **common)


def _anatomy_of(prog: StrategyProgram, strategy_label: str) -> StepAnatomy:
    from tpu_ddp_torch.analysis.anatomy import anatomy_from_counts, count_step, world_axis

    try:
        counts = count_step(prog.step, world=world_axis(prog.mesh), device=prog.device)
    finally:
        if prog.close is not None:
            prog.close()
    return anatomy_from_counts(
        counts, strategy=strategy_label, model=prog.model_name,
        device_kind=prog.device_kind, mesh=prog.mesh,
        per_shard_batch=prog.per_shard_batch, compute_dtype=prog.compute_dtype)


def anatomy_for_strategy(strategy: str, **kwargs) -> StepAnatomy:
    """Run the strategy's step once and take its anatomy. Accepts every
    :func:`prepare_strategy_program` keyword; a step of more than one rank
    runs against a fake group (``anatomy.fake_world``) when no group is
    up."""
    from tpu_ddp_torch.analysis.anatomy import fake_world
    from tpu_ddp_torch.parallel.runtime import world_size

    n = kwargs.get("n_devices", 8)
    if n > 1 and world_size() == 1:
        with fake_world(n):
            return _anatomy_of(prepare_strategy_program(strategy, **kwargs), strategy)
    return _anatomy_of(prepare_strategy_program(strategy, **kwargs), strategy)


def run_strategy_label(meta: dict) -> str:
    """The analyzer's strategy label for a recorded run: the run's
    parallelism family, refined to the dp-family layout variant when the
    config says so (``grad_compress`` wins the LABEL when composed with
    ``zero1`` — the fingerprint to hold is the s8 ring's)."""
    config = meta.get("config") or {}
    strategy = meta.get("strategy", "dp")
    if strategy == "dp":
        mode = config.get("grad_compress", "none")
        if mode not in (None, "none"):
            return "grad_compress_bf16" if mode == "bf16" else "grad_compress"
        if config.get("zero3"):
            return "zero3"
        if config.get("zero1"):
            return "zero1"
    return strategy


#: the recorded config's fields a rebuild turns off: where the run wrote
#: and what it watched, none of which shapes the step
_REBUILD_OFF = dict(
    telemetry_dir=None, checkpoint_dir=None, resume=False, keep_best=False,
    jsonl_path=None, tensorboard_dir=None, health_dir=None, profile_dir=None,
    profile_steps=None, monitor_port=0, chaos_spec=None, comms_monitor=False,
    plot_curves=None, dump_predictions=None, pretrained_dir=None, n_devices=None,
    prefetch_depth=0, prefetch_batches=0, watchdog_deadline_seconds=0.0,
    watchdog_abort=False, synthetic_data=True, download=False, log_every_steps=None)


def recorded_device(meta: dict) -> str:
    """The device the recorded run trained on (its ``TrainConfig.device``;
    the field's default, ``cuda``, when the header lacks it)."""
    return (meta.get("config") or {}).get("device") or "cuda"


def run_meta_config(meta: dict, device: Optional[str] = None):
    """The recorded run's ``TrainConfig``, rebuilt to run one step here
    (``_REBUILD_OFF``; synthetic data of one global batch) on the device
    it recorded (``device``: None, or that device). Raises for a program
    the rebuild does not reproduce: a step recorded on the card runs its
    kernels as single launches, and the CPU rebuild would run their plain
    versions op by op, so it is refused, as is a card run read where
    there is no card."""
    import torch

    from tpu_ddp_torch.train.trainer import TrainConfig

    config_rec = dict(meta.get("config") or {})
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in config_rec.items() if k in fields}
    if kw.get("freeze_prefixes") is not None:
        kw["freeze_prefixes"] = tuple(kw["freeze_prefixes"])
    parallelism = meta.get("strategy", "dp")
    if parallelism == "dp" and int(kw.get("steps_per_call", 1) or 1) > 1:
        raise ValueError(
            f"run fused steps_per_call={kw['steps_per_call']} optimizer "
            "steps per dispatch (a fused call this rebuild does "
            "not reproduce); analyze the family statically via "
            "--strategy instead"
        )
    recorded = recorded_device(meta)
    if device not in (None, recorded):
        raise ValueError(
            f"run recorded on {recorded}: a rebuild on {device} runs another "
            f"program; rebuild it on {recorded}")
    if recorded == "cuda" and not torch.cuda.is_available():
        raise ValueError("recorded on cuda, no card here")
    mesh = {a: int(s) for a, s in (meta.get("mesh") or {}).items()}
    data = mesh.get("data", 1)
    kw.update(_REBUILD_OFF, device=recorded, epochs=1,
              synthetic_size=max(int(kw.get("per_shard_batch", 32)) * data, 1))
    return TrainConfig(**kw)


def anatomy_for_run_meta(meta: dict, device: Optional[str] = None) -> StepAnatomy:
    """Rebuild the step a recorded run trained with, from its run-metadata
    header (the recorded ``TrainConfig``: model, optimizer chain, layout,
    health, pp's schedule, sp's flash ring), run it once on the device it
    recorded (``run_meta_config``) as rank 0 of a group of the recorded
    size, and take its anatomy. Raises for programs the rebuild cannot
    reproduce: refusing beats mis-attributing."""
    from tpu_ddp_torch.analysis.anatomy import fake_world

    prog_mesh = run_meta_mesh(meta)
    with fake_world(prog_mesh[1]) if prog_mesh[1] > 1 else contextlib.nullcontext():
        return _anatomy_of(program_for_run_meta(meta, device), run_strategy_label(meta))


def run_meta_mesh(meta: dict) -> tuple:
    """``(mesh, n_devices)`` of a recorded run: its axis sizes and their
    product, the ranks its step is rebuilt for."""
    mesh = {a: int(s) for a, s in (meta.get("mesh") or {}).items()}
    n = 1
    for s in mesh.values():
        n *= s
    return mesh, n


def program_for_run_meta(meta: dict, device: Optional[str] = None) -> StrategyProgram:
    """The recorded run's step (``run_meta_config``: its ``TrainConfig``
    rebuilt on the device it recorded, which raises for a program the
    rebuild does not reproduce) as a :class:`StrategyProgram` over the
    process group that is up, which must hold the recorded rank count
    (``run_meta_mesh``; ``anatomy.fake_world`` for a static rebuild). The
    unit ``analyze``'s run-dir mode and the memory plan of a recorded run
    (``memtrack/postmortem.py::plan_for_run_meta``) run once."""
    from tpu_ddp_torch.runtime import resolve_device
    from tpu_ddp_torch.train.strategy import build_step_program

    cfg = run_meta_config(meta, device)
    mesh, n = run_meta_mesh(meta)
    prog = build_step_program(cfg)
    return StrategyProgram(
        strategy=run_strategy_label(meta), parallelism=meta.get("strategy", "dp"),
        step=prog.step, mesh=mesh, n_devices=n, model_name=cfg.model,
        compute_dtype=cfg.compute_dtype, per_shard_batch=cfg.per_shard_batch,
        device=resolve_device(cfg.device), close=prog.close, leaves=prog.leaves,
        batch=prog.batch, zero=prog.trainer.layout.zero)


# -- run-dir metadata + measured-phase join -------------------------------

def measured_phases(run_dir: str) -> Dict[str, dict]:
    """Aggregate the run's span records into per-phase totals, a per-STEP
    ``compiled_step`` median (scan-fused spans carry a ``steps`` attr: one
    span covers K fused steps), and the port's per-step median of a call's
    dispatch plus the ``device_sync`` that follows it in its trace file
    (``compiled_step``'s ``with_device_sync_p50_s``: the port's step time,
    module docstring)."""
    from tpu_ddp_torch.telemetry.registry import Histogram
    from tpu_ddp_torch.telemetry.summarize import find_trace_files, read_records

    phases: Dict[str, Histogram] = {}
    per_step = Histogram()
    synced = Histogram()
    for path in find_trace_files(run_dir):
        pending = None                 # the call waiting for its device_sync
        for rec in read_records([path]):
            if rec.get("type") != "span":
                continue
            name, dur = rec.get("name"), rec.get("dur_s")
            if not isinstance(name, str) or not isinstance(dur, (int, float)):
                continue
            phases.setdefault(name, Histogram()).record(dur)
            if name == "compiled_step":
                if pending is not None:
                    synced.record(pending[0] / pending[1])
                steps = max(int((rec.get("attrs") or {}).get("steps", 1)), 1)
                per_step.record(dur / steps)
                pending = (dur, steps)
            elif name == "device_sync" and pending is not None:
                synced.record((pending[0] + dur) / pending[1])
                pending = None
        if pending is not None:
            synced.record(pending[0] / pending[1])
    out = {
        name: {"count": h.count, "total_s": h.sum,
               "p50_s": h.percentile(50)}
        for name, h in phases.items()
    }
    if per_step.count:
        out["compiled_step"]["per_step_p50_s"] = per_step.percentile(50)
        out["compiled_step"]["with_device_sync_p50_s"] = synced.percentile(50)
    return out


def join_measurements(anatomy: StepAnatomy, rl: RooflineReport,
                      run_dir: str, *, chip: Optional[str] = None) -> dict:
    """Static-vs-measured join: what fraction of the roofline the run
    achieved, MFU, and where host time went. The step is a step's
    dispatch plus its device wait (module docstring)."""
    from tpu_ddp_torch.analysis.roofline import chip_spec

    phases = measured_phases(run_dir)
    step = phases.get("compiled_step", {})
    step_s = (step.get("with_device_sync_p50_s") or step.get("per_step_p50_s")
              or step.get("p50_s"))
    joined: Dict[str, Any] = {"phases": phases, "step_p50_s": step_s}
    if step_s:
        if rl.predicted_step_s:
            joined["roofline_fraction"] = rl.predicted_step_s / step_s
        spec = chip_spec(chip or anatomy.device_kind)
        if anatomy.flops and spec and spec.peak_bf16_flops:
            joined["mfu"] = anatomy.flops / step_s / spec.peak_bf16_flops
            joined["mfu_vs"] = spec.key
        if rl.ici_s is not None:
            joined["comm_share_of_step"] = min(rl.ici_s / step_s, 1.0)
    loop = [phases.get(p, {}).get("total_s", 0.0)
            for p in ("data_wait", "h2d", "compiled_step", "device_sync")]
    if sum(loop):
        joined["data_wait_share"] = loop[0] / sum(loop)
    # measured exposed-comm attribution (`tpu-ddp-torch comms exposure`):
    # the comm share that actually stayed exposed, to set against the
    # modeled comm_share_of_step above
    from tpu_ddp_torch.comms.exposure import read_exposure

    exp = read_exposure(run_dir)
    if exp is not None:
        joined["measured_comm_share"] = exp.get("measured_comm_share")
        joined["exposed_comm_s"] = exp.get("exposed_comm_s")
    return joined


# -- rendering ------------------------------------------------------------

def _human_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    from tpu_ddp_torch.telemetry.summarize import _human_bytes as fmt

    return fmt(n)


def _human_time(s: Optional[float]) -> str:
    if s is None:
        return "n/a"
    if s >= 1:
        return f"{s:.2f} s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f} ms"
    return f"{s * 1e6:.1f} us"


def render_report(anatomy: StepAnatomy, rl: RooflineReport,
                  fingerprint: Optional[dict] = None,
                  joined: Optional[dict] = None) -> str:
    mesh = ",".join(f"{a}={s}" for a, s in anatomy.mesh.items() if s != 1)
    lines = [
        f"step anatomy: strategy={anatomy.strategy} model={anatomy.model} "
        f"mesh={mesh or 'n/a'} device={anatomy.device_kind}",
        f"  flops/step/device     = "
        + (f"{anatomy.flops:.3e}" if anatomy.flops else "n/a"),
        f"  hbm bytes accessed    = {_human_bytes(anatomy.bytes_accessed)}",
        f"  argument/output/temp  = {_human_bytes(anatomy.argument_bytes)}"
        f" / {_human_bytes(anatomy.output_bytes)}"
        f" / {_human_bytes(anatomy.temp_bytes)}",
        f"  est peak (args+temp)  = {_human_bytes(anatomy.peak_bytes)}",
        f"  fusions               = {anatomy.fusion_count}",
        "",
    ]
    if anatomy.collectives:
        header = (f"  {'kind':<20} {'dtype':<6} {'axis':<9} {'count':>5} "
                  f"{'payload':>10} {'wire/step':>10}")
        lines += ["collective inventory (per device per step):",
                  header, "  " + "-" * (len(header) - 2)]
        for c in anatomy.collectives:
            lines.append(
                f"  {c.kind:<20} {c.dtype:<6} {c.axis:<9} {c.count:>5} "
                f"{_human_bytes(c.payload_bytes):>10} "
                f"{_human_bytes(c.wire_bytes):>10}"
            )
    else:
        lines.append("collective inventory: none (single-device program)")
    lines.append("")
    fr = rl.fractions()
    lines.append(
        f"roofline ({rl.chip or 'no chip spec'}, {rl.overlap}):"
    )
    for term, label in (("compute", "compute (MXU)"),
                        ("hbm", "hbm"), ("ici", "ici")):
        val = getattr(rl, f"{term}_s")
        mark = "  <- bound" if rl.bound == term else ""
        frac = f"  ({fr[term]:.0%})" if term in fr else ""
        lines.append(f"  {label:<14} = {_human_time(val):>10}{frac}{mark}")
    lines.append(
        f"  predicted step time = {_human_time(rl.predicted_step_s)} "
        f"(bound: {rl.bound})"
    )
    for note in rl.notes:
        lines.append(f"  note: {note}")
    from tpu_ddp_torch.ops import kernel_hints

    hints = kernel_hints(anatomy.strategy)
    if hints:
        lines.append("")
        lines.append("kernel candidates (hand-written Hopper kernels, opt-in "
                     "via --kernels):")
        for h in hints:
            avail = ("available" if h["available"]
                     else "NOT available here (no card: the plain version runs)")
            lines.append(f"  {h['kernel']:<16} {avail} "
                         f"[backend: {h['backend'] or 'none'}]")
            lines.append(f"      fuses: {h['hint']}")
    if fingerprint is not None and fingerprint.get("ok") is not None:
        lines.append("")
        if fingerprint["ok"]:
            lines.append(
                f"fingerprint: OK ({fingerprint['strategy']}: expected "
                "collective set present, no forbidden kinds)"
            )
        else:
            problems = []
            if fingerprint["missing"]:
                problems.append("missing " + ", ".join(fingerprint["missing"]))
            if fingerprint["unexpected"]:
                problems.append(
                    "unexpected " + ", ".join(fingerprint["unexpected"]))
            lines.append(
                f"fingerprint: FAIL ({fingerprint['strategy']}: "
                + "; ".join(problems) + ")"
            )
    if joined is not None:
        lines.append("")
        lines.append("measured (telemetry join):")
        step_s = joined.get("step_p50_s")
        lines.append(f"  compiled step p50     = {_human_time(step_s)}")
        if "roofline_fraction" in joined:
            lines.append(
                f"  roofline achieved     = "
                f"{joined['roofline_fraction']:.0%} of predicted"
            )
        if "mfu" in joined:
            lines.append(
                f"  mfu                   = {joined['mfu']:.1%} "
                f"(vs {joined['mfu_vs']} bf16 peak)"
            )
        if "comm_share_of_step" in joined:
            lines.append(
                f"  comm share of step    = "
                f"{joined['comm_share_of_step']:.1%} (MODELED: roofline "
                "ici / measured step)"
            )
        if joined.get("measured_comm_share") is not None:
            lines.append(
                f"  exposed comm share    = "
                f"{joined['measured_comm_share']:.1%} (MEASURED: "
                f"{_human_time(joined.get('exposed_comm_s'))} vs the "
                "comm-stripped twin, tpu-ddp-torch comms exposure)"
            )
        if "data_wait_share" in joined:
            lines.append(
                f"  data-wait share       = {joined['data_wait_share']:.1%}"
                " of the step loop (input pipeline / stragglers)"
            )
    return "\n".join(lines)


# -- CLI ------------------------------------------------------------------

def _analyze_run_dir(args) -> int:
    meta = read_run_meta(args.path)
    strategy = run_strategy_label(meta)
    if args.strategy and args.strategy != strategy:
        print(
            f"tpu-ddp-torch analyze: refusing: run {args.path} recorded "
            f"strategy {strategy!r}, but --strategy {args.strategy!r} "
            "was requested", flush=True,
        )
        return 2
    anatomy = anatomy_for_run_meta(meta, args.device)
    rl = roofline(anatomy, args.chip, overlap=args.overlap)
    fp = check_fingerprint(anatomy)
    joined = join_measurements(anatomy, rl, args.path, chip=args.chip)
    _emit(args, anatomy, rl, fp, joined, run_meta=meta)
    return 0 if (fp.get("ok") is not False) else 1


def _provenance_for(anatomy, run_meta=None) -> dict:
    """The artifact provenance header (git commit/dirty + config
    digest): the run's deterministic ``run_id`` when analyzing a run
    dir, else a digest of what was analyzed."""
    import torch

    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    return artifact_provenance(
        run_id=(run_meta or {}).get("run_id"),
        descriptor={"artifact": "analyze", "strategy": anatomy.strategy,
                    "model": anatomy.model, "mesh": anatomy.mesh},
        device_kind=anatomy.device_kind,
        torch_version=torch.__version__,
        strategy=anatomy.strategy,
        mesh=anatomy.mesh,
    )


def _emit(args, anatomy, rl, fp, joined=None, run_meta=None) -> None:
    if getattr(args, "json", None):
        from tpu_ddp_torch.ops import kernel_hints

        payload = {
            "anatomy": anatomy.to_json(),
            "roofline": rl.to_json(),
            "fingerprint": fp,
            "kernel_candidates": kernel_hints(anatomy.strategy),
            "provenance": _provenance_for(anatomy, run_meta),
        }
        if run_meta is not None:
            payload["run_meta"] = run_meta
        if joined is not None:
            payload["measured"] = joined
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"tpu-ddp-torch analyze: wrote {args.json}", flush=True)
    print(render_report(anatomy, rl, fp, joined), flush=True)


def _analyze_static(args) -> int:
    strategies = (list(STRATEGIES) if args.strategy == "all"
                  else [args.strategy or "dp"])
    rc = 0
    programs: Dict[str, dict] = {}
    for i, strategy in enumerate(strategies):
        if i:
            print("\n" + "=" * 72 + "\n", flush=True)
        anatomy = anatomy_for_strategy(
            strategy,
            n_devices=args.n_devices,
            device=args.device or "cuda",
            model_name=args.model,
            per_shard_batch=args.batch_size,
            compute_dtype=args.compute_dtype,
            grad_accum_steps=args.grad_accum_steps,
            remat=args.remat,
            kernels=args.kernels,
            attention=args.attention,
            seq_len=args.seq_len,
        )
        rl = roofline(anatomy, args.chip, overlap=args.overlap)
        fp = check_fingerprint(anatomy)
        if len(strategies) == 1:
            _emit(args, anatomy, rl, fp)
        else:
            # multi-strategy: ONE "programs" artifact (the shape bench
            # compare diffs per program)
            programs[strategy] = {**anatomy.to_json(),
                                  "roofline": rl.to_json(),
                                  "fingerprint": fp}
            print(render_report(anatomy, rl, fp), flush=True)
        if fp.get("ok") is False:
            rc = 1
    if programs and getattr(args, "json", None):
        import torch

        from tpu_ddp_torch.telemetry.provenance import artifact_provenance

        with open(args.json, "w") as f:
            json.dump({
                "programs": programs,
                "provenance": artifact_provenance(
                    descriptor={"artifact": "analyze-all",
                                "strategies": sorted(programs),
                                "model": args.model,
                                "compute_dtype": args.compute_dtype},
                    torch_version=torch.__version__,
                ),
            }, f, indent=1)
        print(f"tpu-ddp-torch analyze: wrote {args.json} "
              f"({len(programs)} programs)", flush=True)
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``tpu-ddp-torch analyze [run_dir] [--strategy ...] ...``"""
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch analyze",
        description="step-time anatomy of one step that runs (FLOPs, "
                    "bytes, collective inventory) on the chip roofline, "
                    "optionally joined against a run dir's measured "
                    "telemetry",
    )
    ap.add_argument("path", nargs="?", default=None,
                    help="run dir holding trace-p*.jsonl (telemetry join "
                         "mode); omit for static mode")
    ap.add_argument("--strategy", default=None,
                    help=f"one of {', '.join(STRATEGIES)}, or 'all' "
                         "(static mode); in run-dir mode a mismatch with "
                         "the recorded strategy is refused")
    ap.add_argument("--model", default=None,
                    help="zoo model name, or lm_32k (default: tiny "
                         "per-family model)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per-shard batch (static mode; rows for lm_32k)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--grad-accum-steps", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--kernels", action="store_true",
                    help="the optimizer update through K1 (static mode)")
    ap.add_argument("--attention", default="full", choices=["full", "flash"],
                    help="attention models: flash runs K4-K6 (static mode)")
    ap.add_argument("--seq-len", type=int, default=4096,
                    help="tokens a row for --model lm_32k")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="ranks of the static program (rank 0 runs against "
                         "a group that does not communicate)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the step runs (static default cuda: a GPU "
                         "is required unless --device cpu; a run dir's step "
                         "runs where the run recorded, and another device "
                         "is refused)")
    ap.add_argument("--chip", default=None,
                    help="chip spec to attribute against (h100, v2..v6e); "
                         "default: the device's kind — pass this on CPU "
                         "hosts to classify the bound")
    ap.add_argument("--overlap", default="overlapped",
                    choices=["overlapped", "serial"])
    ap.add_argument("--json", "--out", dest="json", default=None,
                    help="also write the anatomy+roofline(+measured) JSON "
                         "here (bench-compare-able)")
    args = ap.parse_args(list(argv) if argv is not None else None)

    try:
        if args.path:
            return _analyze_run_dir(args)
        return _analyze_static(args)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch analyze: {e}", flush=True)
        return 2
