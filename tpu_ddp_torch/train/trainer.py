"""Trainer: data, model, optimizer and the epoch loop, on one rank or
data-parallel over several.

Counterpart of ``tpu_ddp/train/trainer.py`` (``TrainConfig`` :61,
``build_model`` :546, ``load_dataset`` :582, ``_build_compressor`` :1099,
the epoch loop in ``_run_loop`` :1964, ``evaluate`` :2642) for this slice.
Per-step losses stay on the device during an epoch and are fetched once at
its end. The log lines are the reference's: ``Epoch N, Training loss X``
and ``training time: ... seconds``, printed by rank 0 alone.

With ``n`` ranks (a process group joined by ``parallel/runtime.py``), the
loaders shard over ``n``: each rank takes its own ``per_shard_batch`` rows
of the shard-major global batch, and the step averages the gradients over
the ranks (``train/steps.py``). Steady-state images/sec counts this rank's
images. ``--zero1`` shards the update over the ranks
(``parallel/zero.py``; the JAX trainer's :893-925 and :1171-1237): the
decay mask is taken from the params' original shapes before the optimizer
is built, the optimizer state is built in shard space, the compressor (if
any) runs the partition's reduce-scatter, and evaluation under
``--ema-decay`` gathers the EMA shards first (``_eval_params``, the JAX
``_eval_source_state`` :2603-2640). ``--zero3`` (the JAX :1171-1237)
scatters the params too (``parallel/zero.py::Zero3Partition``, in
``self.zero1`` as ZeRO-1's partition is): the state is built with the full
init copy transient, the compressor is built over the original shapes, the
step streams the params through each forward, and evaluation and
``predict`` gather the params (or the EMA shadow) once a pass.

Checkpoints (``--checkpoint-dir``; ``checkpoint/manager.py``) hold one
layout whatever the run's (``_ckpt_state``, the JAX ``_ckpt_state``
:2585-2601): ZeRO-1's optimizer state de-sharded, and the error-feedback
residual in param layout from one rank, or every rank's row from several
(whose sum is the param-layout residual); ``--zero3``'s params gathered
whole (``train/state.py::full_model_state``). ``--resume`` restores
through that layout and lays it out again for this run (:1006-1074), so
``--zero3``, ``--zero1`` and replicated runs, runs with and without error feedback, and
runs at other rank counts resume from each other's checkpoints; at the
same rank count a resumed run is bitwise the uninterrupted one. Saves come
on log epochs (``epoch % checkpoint_every_epochs in (0, 1)``), every
``checkpoint_steps`` global steps, and once at the end (``wait=True``).
``_ckpt_state`` is a collective: every rank calls it at the same steps.

SIGTERM and SIGINT drain the run (:1820-1870, :2269-2285): one rank stops
at the next batch boundary; several ranks agree at the epoch boundary
(``parallel/runtime.py::agree_any``), so no rank is left in the next
step's collectives. The final checkpoint is then saved and
``metrics["preempted"]`` is set. A second signal skips the final
checkpoint (the ranks agree on that too); a third gets the handler that was
there before.

Fine-tuning (the JAX trainer's :887-943 and ``_init_dp_steps`` :1158-1215):
``--pretrained-dir`` builds the state through
``train/finetune.py::load_pretrained_for_finetune`` (a foreign torchvision
file or a checkpoint directory, merged into the fresh model by name and
shape), on the replicated path, under ``--zero1`` and with
``--grad-compress``; ``--freeze PREFIX...`` trains only the params whose
top-level module starts with a prefix; ``--loss bce`` trains multi-hot
targets (``synthetic_multilabel`` under ``--synthetic-data``) and reports
no accuracy. ``num_classes`` comes from ``--dataset`` unless given.

``--compute-dtype bfloat16`` builds every model in bfloat16 compute (the
JAX ``build_model`` :553; params, optimizer state, gradients and the loss
stay float32; the models' ``Dense`` layers apply the bfloat16 precision
policy, ``models/layers.py``); ``--remat`` recomputes the forward in the
backward (``train/steps.py``: per block where the model has it).

The numerics flight recorder (``--health on``; the JAX trainer's
:315-332, :356-371, :728-760, :2206-2216, :2285-2295, :2430-2445 and
``_on_health`` :2513-2556): the step builds the stats on the device
(``train/steps.py``), and ``health.stats.HealthFeed`` copies the scalars to
the host once a step (the per-layer norms only on a stride step or when a
sentinel trips, the batch only when a dump is written) into a
``health.monitor.HealthMonitor``, which writes ``health-p<rank>.jsonl`` and
the anomaly dump under ``--health-dir`` (without one it writes nothing, and
the trainer says so). Under ``warn`` and ``skip_step`` a step's copy is
read once the next step is enqueued, so the read does not drain the
device's queue; each epoch's end reads the last. The verdicts:
``skip_step`` was applied in the step already; ``halt`` drains the run as
preemption does, at once on every rank (the stats are the same on every
rank, so is the verdict), and the final checkpoint is refused when the
params are non-finite (the poisoned update was applied) and kept when they
are finite (a loss spike).
``--no-shuffle`` (``TrainConfig.shuffle``) keeps the train loader's order.

The step variants (the JAX trainer's :1243-1300, ``_epoch_stream``
:1439-1531 and its loop :2110-2130): ``--grad-accum-steps`` builds the
accumulating step; ``--steps-per-call K`` (clamped to the epoch's length)
runs each run of K batches as one fused call over a stacked group, one
host-to-device copy a group, and the epoch's remainder as single steps;
``host_step``, the step-cadence saves and the flight recorder advance by
the call (one record a step, ``HealthFeed`` reading a call's K records one
call late); a resume skips whole groups and replays a group that straddles
the resume point, as the JAX trainer does. ``--augment`` and
``--mixup-alpha`` run in the step. ``predict`` is the batch inference of
``--dump-predictions`` (``cli/train.py``), ``--plot-curves`` the loss curves
written at the end of ``run``.

The host data path (the JAX ``_epoch_stream`` :1439-1477,
``_host_batch_stream`` :1496 and ``_prefetched_stream`` :1539-1631;
``Trainer._epoch_stream`` here): the train loader is process-local (each
rank samples the global order and gathers only its own rows). With
``--prefetch-batches N`` the loader's batches come from
``datapath/prefetch.py``'s background thread; else with
``--prefetch-depth D`` (2 by default) from the native ring of
``native/prefetch.py``: D gathers run ahead of the step in C++, a fused
``--steps-per-call`` group is ONE submission of the concatenated indices
(its slot is the stacked ``(K * B, ...)`` layout), and on the card each
slot is pinned host memory copied to the card asynchronously on a copy
stream; the slot goes back to the ring once a CUDA event behind the copy
has completed. On the CPU the slot's rows are copied first
(``torch.from_numpy`` would alias them). With both 0 the batches are
gathered on the training thread. All three give the same batches, bit for
bit. ``metrics["data_ms"]`` holds the training thread's host ms a step
waiting for a batch and issuing its host-to-device copy.

``--sync-bn`` builds the model with ``bn_cross_replica_axis`` (the JAX
:552-566; ``models/resnet.py``): BatchNorm statistics over every rank. The
JAX trainer and this one refuse it outside data parallelism (:1309-1322).
``--n-devices N`` must equal the launched world size (a process owns one
card here, where a JAX process drives every device of its host and
``n_devices`` slices them), and under a mesh data x sequence; 1 is
``main_no_ddp``'s one-rank run. ``--log-every-steps N`` logs the
reference's in-epoch line ``Epoch E, iter N, loss L`` every N steps, with
one host read of that step's loss (:2221-2233). ``--download`` fetches the
dataset first (``data/download.py``). ``--cv-mode`` (k-fold,
``train/kfold.py``) is driven by the CLI.

Sequence parallelism (``--parallelism sp``, ``--mesh data=D,sequence=S``,
``--sp-flash``; the JAX ``_init_strategy_steps`` :1302-1370): the ranks
form the grid of ``parallel/mesh.py`` and ``train/strategy.py`` builds the
step. The loaders shard over the data axis (the JAX :1375-1380), so the S
ranks of a data row load the same rows and each cuts its stripe of every
image (``parallel/sequence_parallel.py``); evaluation and ``predict`` run
the plain module on whole images, each rank its data shard's rows. Under
``--zero1`` and ``--grad-compress`` the strategy builds the partition and
the compressor over the data group (``self.layout.zero``,
``self.compress``), and checkpoints de-shard them as under dp. ``--augment``, ``--mixup-alpha`` and
``--sync-bn`` raise with the JAX message, ``--steps-per-call`` warns and
runs 1, ``--pretrained-dir`` goes through ``train/finetune.py``.

The GSPMD families (``--parallelism tp``, ``fsdp``, ``fsdp_tp``, ``--mesh
data=D,model=M``; ``parallel/tensor_parallel.py``) take the same route,
with the same guards: the loaders shard over the data axis (the M ranks of
a model group load the same rows), and the strategy lays the replicated
state out (``self.layout``). Every family's checkpoints, evaluation's
weights and final-params check go through its ``train/state.py::
StateLayout``: the state gathered whole on save and cut again on restore,
so dp, tp, fsdp and fsdp_tp runs resume from each other's checkpoints.

The pipeline (``--parallelism pp``, ``--microbatches``, ``--pp-schedule``;
``parallel/pipeline.py``) and expert parallelism (``--parallelism ep`` on
the MoE ViT; ``parallel/expert_parallel.py``) take the same route and
guards: a pp rank holds its stage, and checkpoints, ``--resume`` and
evaluation go through its layout as for the other families (the params
gathered over the pipeline); ``--aux-weight`` weighs the MoE ViT's
load-balance loss in every family, dp included.

Telemetry (``--telemetry-dir``, ``--telemetry-sinks``,
``--telemetry-snapshot-steps``, ``--watchdog-deadline``,
``--watchdog-abort``, ``--no-data-digests``; the JAX trainer's :664-725,
:850-882, :1488-1631, :1648-1730 and :1964-2511; ``telemetry/``): with a
run dir each rank writes ``trace-p<rank>[.i<k>].jsonl`` (the run header
first: ``run_id``, ``quality_digest``, the incarnation, the config, torch's
and CUDA's versions, the card, strategy, mesh and git identity) and the
Chrome trace, and rank 0 prints the phase table at ``close()``. Every step
family shares the loop, so every step carries the same spans:
``data_wait`` and ``h2d`` around the regions ``data_seconds`` times,
``compiled_step`` around the step's dispatch (``steps=K`` for a fused
group; the name is the JAX package's, for an eager step here), and
``device_sync``, which waits for the step's work on the stream it ran on
(an event recorded behind the step: the copy stream's next batch is not
waited for). That fence is made only under telemetry; without it the loop
makes no host read it did not make before. The counters ``train/steps``
and ``train/images`` advance a step, a ``counters_snapshot`` (with the
goodput gauges) lands every ``telemetry_snapshot_steps``; each epoch's end
has ``epoch_metrics_fetch`` and ``eval`` spans, the eval gauges and
instant, ``train/steps_per_sec``, ``train/images_per_sec_per_chip``, the
``comm/*`` wire counters under ``--grad-compress``, the memory gauges
(``metrics/memory.py``) and a counters record; ``train/mfu``
(``metrics/mfu.py``, also ``metrics["mfu"]``) at the end, on a card with a
known peak. ``--watchdog-deadline`` beats the hang watchdog a step (its
heartbeat file under the run dir); each rank also writes
``data-p<rank>[.i<k>].jsonl``, a digest of every batch it trains
(``datapath/audit.py``; on the native ring hashed row by row in its gather
thread), unless ``--no-data-digests``. The health monitor writes into the
run dir when no ``--health-dir`` is given, and mirrors its stats into the
telemetry; the checkpointer and the loaders emit theirs.
``record_final_eval`` folds the CLI's final evaluation into the final
snapshot, which ``close()`` writes before it closes the sinks.

The live observatories (``--monitor-port``, ``--monitor-bind``,
``--monitor-allow-remote-trigger``, ``--profile-dir``, ``--profile-steps``,
``--profile-window-steps``, ``--profile-host-hz`` and the
``mem_sample_steps`` field; the JAX trainer's :763-790, :830-846,
:1645-1683, :1885-1925, :2017-2048, :2075-2082, :2184-2195 and
:2243-2268): with a run dir the trainer builds the profiler's capture
manager (``profiler/capture.py``; ``--profile-steps A:B`` arms its window)
and the memory sampler (``memtrack/sampler.py``, ``mem-p<rank>.jsonl``).
``run`` starts the rank's HTTP exporter (``monitor/exporter.py``: a bind
failure is a warning); after each call's watchdog beat the capture
manager opens or closes its window and the sampler takes its reading.
``--profile-dir`` traces the first steady epoch with ``torch.profiler``
and emits ``profiler_trace_written``; one profiler session runs at a time,
so a capture window that overlaps it degrades to a note, as in the JAX
package. An allocation failure in ``run`` (``torch.cuda.OutOfMemoryError``
included) takes one last memory sample, writes
``oom/step_<n>-p<rank>/``, counts ``memory/oom_events``, emits the
``oom_abort`` instant and re-raises (``_handle_possible_oom``). ``close``
stops the exporter and writes an open window as a truncated bundle.

Forensics and chaos (the JAX trainer's :790-871, :1657-1679, :1990-2016
and :2172-2184): with a run dir the trainer builds, before the loaders,
``chaos/inject.py``'s ``ChaosInjector`` under ``--chaos SPEC.JSON`` (its
``save_fault_hook`` is the checkpointer's ``fault_hook``), then under
``--comms-monitor`` ``comms/forensics.py``'s ``HopMonitor`` with the
injector's ``comm_stall_hook`` as its fault hook (installed as the ring's
hop hook, ``parallel/collectives.py::set_ring_hop_hook``, as the last act
of ``__init__``, so a failed build leaves no hook behind), then
``datapath/stages.py``'s ``StageMonitor`` (``data-health-p<rank>.json``)
with the injector's ``data_stall_hook``, the train loader's ``observer``.
After each call's watchdog beat the injector's ``on_step`` runs (so a
``hang`` fault blocks the next beat), then both monitors take the step.
The watchdog's ``on_hang`` writes ``hang-forensics-p<rank>.json``
(``comms/forensics.py::write_hang_bundle``) whenever there is a run dir.
``close`` clears the hop hook before it closes the hop monitor, and closes
the stage monitor. ``tpu-ddp-torch elastic train`` supervises the CLI's
runs (``elastic/supervisor.py``): a life it restarts resumes with
``--resume`` at the surviving ``--n-devices``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import logging
import os
import signal
import time
import warnings
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from tpu_ddp_torch.checkpoint.manager import Checkpointer
from tpu_ddp_torch.data.cifar10 import (
    load_cifar10,
    load_cifar100,
    synthetic_cifar10,
    synthetic_cifar10_hard,
    synthetic_multilabel,
)
from tpu_ddp_torch.data.download import ensure_dataset
from tpu_ddp_torch.data.loader import ShardedBatchLoader, step_groups
from tpu_ddp_torch.datapath.audit import xor_row_digests
from tpu_ddp_torch.health.monitor import POLICIES as HEALTH_POLICIES
from tpu_ddp_torch.health.monitor import HealthMonitor
from tpu_ddp_torch.health.monitor import next_incarnation as health_incarnation
from tpu_ddp_torch.health.stats import HealthConfig, HealthFeed
from tpu_ddp_torch.metrics.logging import MetricLogger
from tpu_ddp_torch.metrics.timing import Throughput
from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
from tpu_ddp_torch.models.layers import DTYPES as COMPUTE_DTYPES
from tpu_ddp_torch.parallel.compression import MODES as COMPRESS_MODES
from tpu_ddp_torch.parallel.collectives import all_gather_bytes, set_ring_hop_hook
from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
from tpu_ddp_torch.parallel.runtime import (
    agree_any,
    barrier,
    is_primary_process,
    peer_lost,
    rank,
    world_size,
)
from tpu_ddp_torch.parallel.mesh import create_mesh
from tpu_ddp_torch.parallel.mesh import resolve as resolve_mesh
from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition, Zero3Partition
from tpu_ddp_torch.runtime import resolve_device, set_float32_precision
from tpu_ddp_torch.telemetry import (
    DEFAULT_SINKS,
    EVAL_POINT_SCHEMA_VERSION,
    RUN_META_SCHEMA_VERSION,
    HangWatchdog,
    build_telemetry,
    config_digest,
    git_provenance,
    next_incarnation,
    quality_digest,
)
from tpu_ddp_torch.train.finetune import load_pretrained_for_finetune
from tpu_ddp_torch.train.losses import binary_cross_entropy_with_logits, cross_entropy_loss
from tpu_ddp_torch.train.optim import decay_mask, freeze_all_but, make_optimizer
from tpu_ddp_torch.train.state import (
    COUNTS,
    SLOTS,
    StateLayout,
    checkpoint_state,
    copy_opt_state_,
    create_train_state,
    split_checkpoint,
)
from tpu_ddp_torch.train.strategy import (
    build_strategy,
    check_strategy,
    default_mesh_sizes,
    infer_parallelism,
)
from tpu_ddp_torch.train.steps import (
    batch_to_device,
    make_eval_step,
    make_grad_accum_train_step,
    make_predict_step,
    make_train_step,
    scan,
)

log = logging.getLogger(__name__)

#: the JAX ``validate``'s refusal of ``--comms-monitor`` with
#: ``--lint-on-start`` (``TrainConfig.__post_init__``)
COMMS_MONITOR_LINT_REFUSAL = (
    "--comms-monitor does not compose with "
    "--lint-on-start: the per-hop host callback is a "
    "deliberate host transfer inside the step, which "
    "the lint's host-transfer rule would (correctly) "
    "refuse"
)


@dataclasses.dataclass
class TrainConfig:
    """The fields the port's CLI flags set (names and defaults as in the
    JAX ``TrainConfig``)."""

    device: str = "cuda"
    data_dir: str = "data/CIFAR-10"
    download: bool = False                # fetch + md5-verify when absent
    dataset: str = "cifar10"              # cifar10 | cifar100
    synthetic_data: bool = False
    synthetic_size: int = 2048
    synthetic_task: str = "easy"          # easy | hard (synthetic_cifar10_hard)
    synthetic_label_noise: float = 0.1    # hard task: train labels flipped
    epochs: int = 99
    per_shard_batch: int = 32
    lr: float = 1e-2
    optimizer: str = "sgd"
    momentum: float = 0.0
    weight_decay: float = 0.0
    schedule: Optional[str] = None
    warmup_steps: int = 0
    grad_clip_norm: float = 0.0
    ema_decay: float = 0.0
    kernels: bool = False
    zero1: bool = False                   # ZeRO-1 update sharding
    zero3: bool = False                   # ZeRO-3 parameter streaming
    grad_compress: str = "none"           # none | bf16 | int8 (the ring)
    grad_compress_block: int = 256
    grad_compress_error_feedback: bool = False
    dist_backend: Optional[str] = None    # None: nccl on cuda, gloo on cpu
    parallelism: Optional[str] = None     # dp|fsdp|tp|fsdp_tp|pp|sp|ep;
                                          # None = infer from mesh (default dp)
    mesh: Optional[dict] = None           # axis sizes, e.g. {"data": 2,
                                          # "model": 2}; None = the mode's default
    sp_flash: bool = False                # SP: flash-kernel ring blocks
    n_microbatches: int = 4               # pipeline microbatches (pp only)
    pp_schedule: str = "gpipe"            # "gpipe" | "1f1b" (pp only)
    aux_weight: float = 0.01              # MoE load-balance loss weight
    n_devices: Optional[int] = None       # None: the launched world; else == it
    model: str = "netresdeep"
    attention: str = "full"               # full | flash (CUDA kernels K4-K6)
    compute_dtype: str = "float32"        # float32 | bfloat16 (params stay f32)
    remat: bool = False                   # recompute the forward in the backward
    n_chans1: int = 32
    n_blocks: int = 10
    tied_blocks: bool = True
    num_classes: int = 10
    loss: str = "ce"                      # ce | bce (multi-label fine-tune)
    label_smoothing: float = 0.0          # soft CE targets
    freeze_prefixes: Optional[tuple] = None  # e.g. ("head",): train the head only
    pretrained_dir: Optional[str] = None  # fine-tune: partial restore + head swap
    seed: int = 0
    eval_each_epoch: bool = False
    log_every_epochs: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 10     # save on log epochs, main.py:45
    checkpoint_steps: int = 0             # >0: ALSO save every N global steps
    keep_best: bool = False               # <checkpoint_dir>/best: best test acc
    resume: bool = False
    jsonl_path: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    shuffle: bool = True                  # False: the train loader's fixed order
    reshuffle_each_epoch: bool = True     # False: the epoch-0 order every epoch
    sync_bn: bool = False                 # BatchNorm statistics over all ranks
    prefetch_depth: int = 2               # >0: the native ring, D gathers ahead
    prefetch_batches: int = 0             # >0: the staged background prefetcher
    log_every_steps: Optional[int] = None  # in-epoch loss lines (a host read each)
    health: str = "off"                   # "on": the numerics flight recorder
    health_policy: str = "warn"           # warn | skip_step | halt
    health_per_layer_stride: int = 0      # >0: per-layer norms every N steps
    health_dir: Optional[str] = None      # health JSONL + anomalies/ run dir
    health_window: int = 128              # spike detector rolling window
    health_spike_threshold: float = 10.0  # spike at median + K * MAD
    augment: bool = False                 # in-step random crop + flip
    mixup_alpha: float = 0.0              # >0: in-step mixup, Beta(a, a)
    steps_per_call: int = 1               # >1: K optimizer steps a call
    grad_accum_steps: int = 1             # >1: K microbatches a step
    plot_curves: Optional[str] = None     # loss-curve PNG at the end
    dump_predictions: Optional[str] = None  # predictions JSON after the eval
    telemetry_dir: Optional[str] = None   # run dir of the trace sinks; None: off
    telemetry_sinks: str = DEFAULT_SINKS  # comma-separated subset
    telemetry_snapshot_steps: int = 50    # >0: a counters snapshot every N steps
    watchdog_deadline_seconds: float = 0.0  # >0: the hang watchdog's deadline
    watchdog_abort: bool = False          # exit HANG_EXIT_CODE after the dump
    data_digests: bool = True             # data-p<rank>.jsonl under telemetry
    profile_dir: Optional[str] = None     # torch.profiler trace of ONE steady
                                          # epoch (the first after the first)
    profile_steps: Optional[str] = None   # "A:B": a capture window over global
                                          # steps (A, B] into
                                          # <telemetry_dir>/profiles/
    profile_window_steps: int = 8         # live-triggered windows' length
    profile_host_hz: float = 97.0         # the host stack sampler's rate
    monitor_port: int = 0                 # >0: the rank's HTTP endpoint on this
                                          # port; -1: ephemeral (written to
                                          # exporter-p<rank>.json); 0: off
    monitor_bind: str = "0.0.0.0"         # the endpoint's bind address
    monitor_allow_remote_trigger: bool = False  # POST /profile from any peer
    mem_sample_steps: int = 1             # >0: the memory sampler's stride
                                          # (mem-p<rank>.jsonl under telemetry)
    chaos_spec: Optional[str] = None      # --chaos SPEC.JSON: fault injection
    comms_monitor: bool = False           # the ring's hop monitor
    lint_on_start: bool = False           # the graph lint over the run's step first

    def __post_init__(self):
        valid_sinks = tuple(DEFAULT_SINKS.split(","))
        for name in (self.telemetry_sinks or "").split(","):
            name = name.strip()
            if name and name not in valid_sinks:
                raise ValueError(
                    f"unknown telemetry sink {name!r}; valid sinks: "
                    f"{', '.join(valid_sinks)}"
                )
        if self.telemetry_snapshot_steps < 0:
            raise ValueError(
                "telemetry_snapshot_steps must be >= 0, got "
                f"{self.telemetry_snapshot_steps}"
            )
        if self.watchdog_abort and self.watchdog_deadline_seconds <= 0:
            raise ValueError(
                "--watchdog-abort needs --watchdog-deadline > 0: there "
                "is no hang detector to escalate from"
            )
        if self.comms_monitor:
            if not self.telemetry_dir:
                raise ValueError(
                    "--comms-monitor needs --telemetry-dir: the per-axis "
                    "health records and the hang-forensics suspect live "
                    "in the run dir"
                )
            if self.lint_on_start:
                raise ValueError(COMMS_MONITOR_LINT_REFUSAL)
        if self.chaos_spec:
            if not self.telemetry_dir:
                raise ValueError(
                    "--chaos needs --telemetry-dir: the fire-once fault "
                    "state lives in the run dir (and an unobserved "
                    "chaos run proves nothing)"
                )
            from tpu_ddp_torch.chaos.inject import load_spec

            # parse and validate NOW: a typo'd fault spec must refuse the
            # launch, not detonate at its trigger step
            spec = load_spec(self.chaos_spec)
            if any(f.get("kind") == "comm_stall" for f in spec["faults"]) \
                    and not self.comms_monitor:
                raise ValueError(
                    "chaos spec contains a comm_stall fault but "
                    "--comms-monitor is off: the stall fires from the "
                    "per-hop callback seam, so without the monitor the "
                    "fault can never trigger"
                )
            if any(f.get("kind") == "data_stall" and f.get("stage")
                   for f in spec["faults"]) \
                    and self.prefetch_depth > 0 \
                    and self.prefetch_batches <= 0:
                raise ValueError(
                    "chaos spec contains a stage-targeted data_stall "
                    "fault but the staged loader pipeline is off: the "
                    "stall fires from the per-stage observer seam, which "
                    "runs only with --prefetch-batches N or "
                    "--prefetch-depth 0"
                )
        if self.health not in ("off", "on"):
            raise ValueError(
                f"unknown health mode {self.health!r}; valid modes: off, on")
        if self.health_policy not in HEALTH_POLICIES:
            raise ValueError(
                f"unknown health policy {self.health_policy!r}; valid "
                f"policies: {', '.join(HEALTH_POLICIES)}")
        if self.health_per_layer_stride < 0:
            raise ValueError(
                "health_per_layer_stride must be >= 0, got "
                f"{self.health_per_layer_stride}")
        if self.health_window < 4:
            raise ValueError(f"health_window must be >= 4, got {self.health_window}")
        if self.checkpoint_steps < 0:
            raise ValueError(
                f"checkpoint_steps must be >= 0, got {self.checkpoint_steps}"
            )
        if self.checkpoint_steps and not self.checkpoint_dir:
            raise ValueError(
                "--checkpoint-steps needs --checkpoint-dir: there is "
                "nowhere to save the step-cadence checkpoints"
            )
        if self.monitor_port < -1 or self.monitor_port > 65535:
            raise ValueError(
                f"monitor_port must be -1 (ephemeral), 0 (disabled), or "
                f"a TCP port, got {self.monitor_port}"
            )
        from tpu_ddp_torch.profiler.capture import parse_profile_steps

        # raises on a malformed window spec — at parse time, not step A
        parse_profile_steps(self.profile_steps)
        if self.profile_steps and not self.telemetry_dir:
            raise ValueError(
                "--profile-steps needs --telemetry-dir: the capture "
                "bundle is written under <telemetry_dir>/profiles/"
            )
        if self.profile_window_steps < 1:
            raise ValueError(
                "profile_window_steps must be >= 1, got "
                f"{self.profile_window_steps}"
            )
        if self.profile_host_hz <= 0:
            raise ValueError(
                f"profile_host_hz must be > 0, got {self.profile_host_hz}"
            )
        if self.loss not in ("ce", "bce"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {self.compute_dtype!r}")
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.keep_best and not (self.checkpoint_dir and self.eval_each_epoch
                                   and self.loss == "ce"):
            raise ValueError(
                "--keep-best needs --checkpoint-dir and --eval-each-epoch "
                "(and a CE loss: 'best' is keyed on test accuracy)"
            )
        if self.zero1 and self.optimizer == "lamb":
            raise ValueError(
                "--zero1 does not compose with --optimizer lamb (the "
                "layer-wise trust ratio needs whole-parameter norms; "
                "the 1/N update shards cannot provide them)"
            )
        if self.zero1 and self.parallelism not in (None, "dp", "sp"):
            raise ValueError(
                f"--zero1 is not supported with --parallelism "
                f"{self.parallelism}: fsdp/fsdp_tp already scatter the "
                "optimizer state (ZeRO-3 subsumes ZeRO-1); tp/pp/ep own "
                "their state layout"
            )
        if self.zero3 and self.zero1:
            raise ValueError(
                "--zero3 subsumes --zero1 (parameters AND optimizer "
                "state live scattered in the same flat update space); "
                "drop --zero1"
            )
        if self.zero3 and self.optimizer == "lamb":
            raise ValueError(
                "--zero3 does not compose with --optimizer lamb (the "
                "layer-wise trust ratio needs whole-parameter norms; "
                "the 1/N update shards cannot provide them)"
            )
        if self.zero3 and self.parallelism not in (None, "dp"):
            raise ValueError(
                f"--zero3 is not supported with --parallelism "
                f"{self.parallelism}: fsdp/fsdp_tp already stream "
                "scattered parameters (GSPMD owns that schedule — use "
                "them directly); tp/pp/ep/sp own their state layout. "
                "Use --zero3 with dp"
            )
        if self.grad_compress not in COMPRESS_MODES:
            raise ValueError(
                f"unknown grad-compress mode {self.grad_compress!r}; "
                f"valid modes: {', '.join(COMPRESS_MODES)}"
            )
        if self.grad_compress_block < 1:
            raise ValueError(
                "grad_compress_block must be >= 1, got "
                f"{self.grad_compress_block}"
            )
        if self.prefetch_batches < 0:
            raise ValueError(
                f"prefetch_batches must be >= 0 (0 disables the staged "
                f"background prefetcher), got {self.prefetch_batches}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0 (0 disables the native "
                f"prefetcher), got {self.prefetch_depth}")
        if (self.grad_compress != "none"
                and self.parallelism not in (None, "dp", "sp")):
            raise ValueError(
                f"--grad-compress is not supported with --parallelism "
                f"{self.parallelism}: the GSPMD/pipeline families' grad "
                "movement is partitioner-internal, not a pmean this "
                "framework owns. Use --grad-compress with dp or sp"
            )
        if self.grad_compress_error_feedback and self.grad_compress == "none":
            raise ValueError(
                "--grad-compress-error-feedback needs --grad-compress "
                "bf16 or int8 (there is no quantization error to feed "
                "back without compression)"
            )


#: dataset -> its loader and class count
DATASETS = {"cifar10": (load_cifar10, 10), "cifar100": (load_cifar100, 100)}


def build_model(c: TrainConfig, image_size: int = 32) -> torch.nn.Module:
    """NetResDeep, or a registry model (``models/zoo.py``) for square
    inputs of ``image_size`` (CIFAR's 32 by default), with weights from
    ``c.seed``, computing in ``c.compute_dtype``. ``attention == "flash"``
    binds the port's
    ``flash_attention`` into the model's ``attention_impl`` (the JAX
    ``build_model`` :564-578); on a model without one, NetResDeep included,
    it raises (the JAX package builds NetResDeep before it reads the flag
    and ignores it there). ``sync_bn`` passes the data axis as
    ``bn_cross_replica_axis`` (the JAX :552)."""
    generator = torch.Generator().manual_seed(c.seed)
    dtype = COMPUTE_DTYPES[c.compute_dtype]
    name = c.model.lower()
    sync = {"bn_cross_replica_axis": DATA_AXIS} if c.sync_bn else {}
    if name == "netresdeep":
        model = NetResDeep(n_chans1=c.n_chans1, n_blocks=c.n_blocks,
                           num_classes=c.num_classes, tied=c.tied_blocks,
                           generator=generator, dtype=dtype, **sync)
    elif name in MODEL_REGISTRY:
        model = MODEL_REGISTRY[name](num_classes=c.num_classes, generator=generator,
                                     image_size=image_size, dtype=dtype, **sync)
    else:
        raise ValueError(f"unknown model {c.model!r}")
    if c.attention == "flash":
        if not hasattr(model, "attention_impl"):
            raise ValueError(
                f"--attention flash needs an attention model (ViT "
                f"family); {c.model!r} has none")
        from tpu_ddp_torch.ops.flash_attention import flash_attention

        model.attention_impl = flash_attention
    elif c.attention != "full":
        raise ValueError(f"unknown attention {c.attention!r}")
    return model


def load_dataset(c: TrainConfig):
    """(train, test) ``(images, labels)`` tuples, as the JAX trainer's
    (:582-620): under ``--synthetic-data`` multi-hot targets for BCE, the
    hard task's (label noise on the train split only) or the easy one's."""
    if c.synthetic_data:
        test_size = max(c.synthetic_size // 5, 64)
        k = c.num_classes
        if c.loss == "bce":
            return (synthetic_multilabel(c.synthetic_size, k, c.seed),
                    synthetic_multilabel(test_size, k, c.seed + 1))
        if c.synthetic_task == "hard":
            return (synthetic_cifar10_hard(c.synthetic_size, k, c.seed,
                                           label_noise=c.synthetic_label_noise),
                    synthetic_cifar10_hard(test_size, k, c.seed + 1, label_noise=0.0))
        return (synthetic_cifar10(c.synthetic_size, k, c.seed),
                synthetic_cifar10(test_size, k, c.seed + 1))
    # a no-op unless --download and the data is absent (the JAX :612-616)
    ensure_dataset(c.data_dir, c.dataset, download=c.download)
    load = DATASETS[c.dataset][0]
    return load(c.data_dir, train=True), load(c.data_dir, train=False)


class Trainer:
    def __init__(self, config: TrainConfig, *, train_data=None, test_data=None,
                 model: Optional[torch.nn.Module] = None,
                 loss_fn: Optional[Callable] = None):
        """``train_data``/``test_data``: ``(images, labels)`` that replace the
        configured dataset's splits (the JAX trainer's); the test split
        defaults to ``train_data`` when only that is given. ``model``: a
        model to train in place of ``build_model(config)`` (the analyzer's
        small per-family models, ``analysis/explain.py``). ``loss_fn``: a
        loss ``(logits, labels, mask)`` in place of the config's (the
        graph lint's planted host read, ``analysis/lint.py``; the JAX
        builders' ``loss_fn``)."""
        c = self.config = config
        self.device = resolve_device(c.device)
        set_float32_precision()
        self.logger = MetricLogger(c.jsonl_path, tensorboard_dir=c.tensorboard_dir)
        self.rank, self.world_size = rank(), world_size()
        if c.n_devices is not None and c.n_devices != self.world_size:
            raise ValueError(
                f"--n-devices {c.n_devices} but {self.world_size} rank(s) were "
                "launched: in the port a rank owns one card, so --n-devices must "
                "equal the launcher's world size (1: one process, main_no_ddp)")
        # the rank grid: built for a family other than dp, whose data axis
        # the loaders shard over (every rank builds its groups here)
        self.parallelism = infer_parallelism(c.mesh, c.parallelism)
        self.strategy_line = None     # the line a family printed (pp's schedule)
        sizes = dict(c.mesh or default_mesh_sizes(self.parallelism))
        self.mesh_sizes = resolve_mesh(sizes, self.world_size)
        if self.parallelism == "dp":
            self.mesh, self.data_size, self.data_index = None, self.world_size, self.rank
        else:
            self.mesh = create_mesh(sizes)
            self.data_size, self.data_index = self.mesh.data_size, self.mesh.data_index
        # telemetry first: the loaders and checkpointers emit into it; the
        # forensics next, so the train loader is born with its observer
        self._init_telemetry()
        self._init_forensics()
        if train_data is None:
            train_data, test_data = load_dataset(c)
        elif test_data is None:
            test_data = train_data
        if c.loss == "bce" and np.asarray(train_data[1]).ndim != 2:
            raise ValueError(
                "--loss bce needs multi-hot (N, C) targets; this dataset "
                "yields class indices. Use --synthetic-data (multi-label "
                "generator) or pass multi-hot train_data.")
        # process-local: this rank samples the global order and gathers only
        # its own rows (the test loader stays global: predict reads its order)
        self.train_loader = ShardedBatchLoader(
            *train_data, world_size=self.data_size,
            per_shard_batch=c.per_shard_batch, shuffle=c.shuffle,
            reshuffle_each_epoch=c.reshuffle_each_epoch, seed=c.seed,
            process_index=self.data_index, process_count=self.data_size,
            telemetry=self.telemetry, observer=self._datapath)
        self.test_loader = ShardedBatchLoader(
            *test_data, world_size=self.data_size,
            per_shard_batch=c.per_shard_batch, shuffle=False,
            exclude_sampler_pad=True, telemetry=self.telemetry)
        model = build_model(c) if model is None else model
        if self.mesh is not None:
            self._check_strategy(model)
        params = dict(model.named_parameters())
        sharded = c.zero1 or c.zero3 or self.parallelism in ("fsdp", "fsdp_tp")
        # ZeRO's chain runs on flat shards, where ndim says nothing: the
        # decay mask comes from the original shapes, here (FSDP's partition
        # sums each leaf's norms over its pieces, ``leaf_sums``, so lamb runs
        # there, and the optimizer is not built for ZeRO's axis)
        self.tx = make_optimizer(
            lr=c.lr, optimizer=c.optimizer, momentum=c.momentum,
            weight_decay=c.weight_decay, schedule=c.schedule,
            total_steps=self.train_loader.steps_per_epoch * c.epochs,
            warmup_steps=c.warmup_steps, grad_clip_norm=c.grad_clip_norm,
            ema_decay=c.ema_decay, kernels=c.kernels,
            decay_mask=decay_mask(params) if sharded else None,
            zero1_axis=DATA_AXIS if c.zero1 or c.zero3 else None,
            freeze_predicate=(freeze_all_but(tuple(c.freeze_prefixes))
                              if c.freeze_prefixes else None),
        )
        # the partition: ZeRO-1's, or ZeRO-3's (params scattered too); on a
        # rank grid the strategy builds the state's layout instead
        self.zero1 = ((Zero3Partition if c.zero3 else Zero1Partition)(
            self.tx, params, self.world_size)
            if (c.zero1 or c.zero3) and self.mesh is None else None)
        self.layout = StateLayout(zero=self.zero1)
        if c.pretrained_dir:
            self.state = load_pretrained_for_finetune(
                c.pretrained_dir, model, self.tx, self.device, zero1=self.zero1)
        else:
            self.state = create_train_state(model, self.tx, self.device,
                                            zero1=self.zero1)
        self.compress = self._build_compressor()
        if self.zero1 is not None and self.compress is not None:
            self.zero1.set_compression(self.compress)
        if self.compress is not None and c.grad_compress_error_feedback:
            self.state.grad_residual = self.compress.init_residual(self.device)
        if c.loss == "bce":
            default_loss, self.with_accuracy = binary_cross_entropy_with_logits, False
        else:
            default_loss, self.with_accuracy = cross_entropy_loss, True
            if c.label_smoothing:
                default_loss = functools.partial(cross_entropy_loss,
                                                 label_smoothing=c.label_smoothing)
        loss_fn = loss_fn or default_loss
        self.health_monitor = None
        self._health_halted = None    # the step a halt verdict stopped at
        health = None
        if c.health != "off":
            health = HealthConfig(per_layer=c.health_per_layer_stride > 0,
                                  skip_nonfinite=c.health_policy == "skip_step")
            if not (c.health_dir or c.telemetry_dir):
                log.warning(
                    "health=on with neither health_dir nor telemetry_dir:"
                    " detection and the %r policy are active, but no "
                    "health JSONL or anomaly dumps will be written",
                    c.health_policy)
            # a life's health file takes its trace's incarnation; without a
            # trace, one past the health files already in the dir
            self.health_monitor = HealthMonitor(
                run_dir=c.health_dir or c.telemetry_dir, policy=c.health_policy,
                per_layer_stride=c.health_per_layer_stride,
                telemetry=self.telemetry,
                process_index=self.rank, window=c.health_window,
                spike_threshold=c.health_spike_threshold,
                run_meta=dataclasses.asdict(c),
                incarnation=(self.incarnation if c.telemetry_dir
                             else health_incarnation(c.health_dir, self.rank)))
            self.health_feed = HealthFeed(self.health_monitor, lag=c.health_policy != "halt")
        if self.mesh is None:
            self._init_steps(loss_fn, health)
            self.eval_step = make_eval_step(loss_fn, compute_accuracy=self.with_accuracy)
            self.predict_step = make_predict_step()
        else:
            self._init_strategy_steps(model, loss_fn, health)
        # the ring's static wire bytes a step, for the comm/* counters: the
        # reduce-scatter under ZeRO, the whole all-reduce otherwise
        self._comm_bytes_per_step = None
        if self.compress is not None:
            acct = self.compress.accounting()
            key = "reduce_scatter" if c.zero1 or c.zero3 else "all_reduce"
            self._comm_bytes_per_step = (acct[f"{key}_bytes_on_wire_per_device"],
                                         acct[f"{key}_bytes_f32_per_device"])
        self._watchdog = None
        self._init_observatories()
        self.history = {"train_loss": [], "step_loss": [], "epoch": []}
        self._prefetcher = None       # the native ring, built at first use
        self._stream = None           # the epoch's batch stream while it runs
        self._copy_stream = None
        self.data_seconds = {"data_wait": 0.0, "h2d": 0.0}
        self.eval_batches = 0  # eval steps run so far (every evaluate call)
        self._preempted = self._force_abort = False
        self.preflight_launches = {}  # kernel launches of lint_preflight's audits

        self.checkpointer = None
        self.best_checkpointer = None
        self.resumed_step = None      # set iff --resume restored a checkpoint
        self.save_ms = []             # [step, wait, ms] a save (``_save``)
        self._best_acc = float("-inf")
        if c.checkpoint_dir:
            self.checkpointer = Checkpointer(
                c.checkpoint_dir, telemetry=self.telemetry,
                fault_hook=self._chaos.save_fault_hook if self._chaos is not None else None)
            if c.keep_best:
                best_dir = os.path.join(c.checkpoint_dir, "best")
                self.best_checkpointer = Checkpointer(best_dir, max_to_keep=1,
                                                      telemetry=self.telemetry)
                meta = os.path.join(best_dir, "metadata.json")
                if c.resume and os.path.isfile(meta):
                    # a torn metadata file resets the best to unset, with a
                    # warning, instead of killing the resume
                    try:
                        with open(meta) as f:
                            self._best_acc = json.load(f)["test_accuracy"]
                    except (OSError, ValueError, KeyError) as e:
                        log.warning("unreadable best metadata %s (%s); treating "
                                    "best accuracy as unset", meta, e)
            if c.resume and self.checkpointer.latest_step() is not None:
                self._restore(self.checkpointer.restore())
                self.resumed_step = int(self.state.step)
                self.logger.log_text(f"resumed from step {self.resumed_step}")
        if self._comms_monitor is not None:
            # installed last: an __init__ that raises leaves no process-wide
            # hook writing through a monitor that no close will clear
            set_ring_hop_hook(self._comms_monitor.on_hop)

    def _init_telemetry(self) -> None:
        """The run header, the ``Telemetry`` of ``--telemetry-dir`` (the
        inert ``NULL`` without one) and the data-digest writer (the JAX
        trainer's :664-725 and :850-882; module docstring)."""
        c = self.config
        snapshot = dataclasses.asdict(c)
        # which life of the run this is: one past the traces in the dir
        self.incarnation = next_incarnation(c.telemetry_dir, self.rank)
        cuda = self.device.type == "cuda"
        self.run_meta = {
            "run_meta_schema_version": RUN_META_SCHEMA_VERSION,
            "run_id": config_digest(snapshot),
            "quality_digest": quality_digest(snapshot, data_size=self.data_size),
            "incarnation": self.incarnation,
            "config": snapshot,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_kind": torch.cuda.get_device_name(self.device) if cuda else "cpu",
            "strategy": self.parallelism,
            "mesh": dict(self.mesh_sizes),
            "n_devices": self.world_size,
            "process_count": self.world_size,
            **git_provenance(),
        }
        self.telemetry = build_telemetry(
            c.telemetry_dir, c.telemetry_sinks, process_index=self.rank,
            run_meta=self.run_meta, incarnation=self.incarnation)
        self._data_digests = None
        if c.telemetry_dir and c.data_digests:
            from tpu_ddp_torch.datapath.audit import DataDigestWriter

            self._data_digests = DataDigestWriter(
                c.telemetry_dir, process_index=self.rank, incarnation=self.incarnation,
                seed=c.seed, run_id=self.run_meta["run_id"],
                global_batch=c.per_shard_batch * self.data_size)

    def _init_forensics(self) -> None:
        """The chaos injector, the ring's hop monitor and the loader's stage
        monitor, in the JAX order (:790-871; module docstring). The hop
        monitor's ``n_devices`` is 1: a rank drives one card, and its hook
        hears only its own hops."""
        c = self.config
        self._chaos = self._comms_monitor = self._datapath = None
        if c.chaos_spec:
            from tpu_ddp_torch.chaos.inject import ChaosInjector

            self._chaos = ChaosInjector(
                c.chaos_spec, c.telemetry_dir, process_index=self.rank,
                checkpoint_dir=c.checkpoint_dir, telemetry=self.telemetry)
        if c.comms_monitor:
            from tpu_ddp_torch.comms.forensics import HopMonitor

            self._comms_monitor = HopMonitor(
                c.telemetry_dir, process_index=self.rank, n_devices=1,
                fault_hook=(self._chaos.comm_stall_hook
                            if self._chaos is not None else None),
                telemetry=self.telemetry)
        if c.telemetry_dir:
            from tpu_ddp_torch.datapath.stages import StageMonitor

            self._datapath = StageMonitor(
                c.telemetry_dir, process_index=self.rank,
                stall_hook=(self._chaos.data_stall_hook
                            if self._chaos is not None else None),
                telemetry=self.telemetry)

    def _init_observatories(self) -> None:
        """The objects the JAX trainer builds around a telemetry run dir
        for the live observatories (its :763-790 and :830-846): the
        profiler's capture manager (armed by ``--profile-steps``, ``POST
        /profile`` or the ``capture_profile`` alert action) and the
        memory sampler, each exactly when ``--telemetry-dir`` is set; the
        ``--profile-dir`` directory, made now so a bad path fails before
        training. The exporter starts in ``run``."""
        c = self.config
        self._exporter = None
        self._epoch_tracing = False   # --profile-dir's session is running
        self._last_host_step = 0      # the step an OOM postmortem is stamped
        if c.profile_dir:
            os.makedirs(c.profile_dir, exist_ok=True)
        self._capture = self._memtrack = None
        if not c.telemetry_dir:
            return
        from tpu_ddp_torch.memtrack.sampler import MemorySampler
        from tpu_ddp_torch.profiler.capture import CaptureManager, parse_profile_steps

        self._capture = CaptureManager(
            c.telemetry_dir, process_index=self.rank,
            window_steps=c.profile_window_steps, host_hz=c.profile_host_hz,
            telemetry=self.telemetry, run_meta=self.run_meta,
            cuda=self.device.type == "cuda")
        window = parse_profile_steps(c.profile_steps)
        if window:
            self._capture.arm_window(*window)
        if c.mem_sample_steps > 0:
            self._memtrack = MemorySampler(
                c.telemetry_dir, process_index=self.rank,
                incarnation=self.incarnation, telemetry=self.telemetry,
                every=c.mem_sample_steps, run_meta=self.run_meta,
                device=self.device)

    def _init_steps(self, loss_fn, health) -> None:
        """``train_step``, and ``multi_step`` (the fused K-step call) under
        ``--steps-per-call``, with the JAX trainer's guards (:1243-1300):
        accumulation takes neither augment nor mixup, and is the opposite
        trade of fused steps; ``steps_per_call`` is clamped to the epoch's
        length (a longer group would never fill)."""
        c = self.config
        common = dict(compress=self.compress, zero1=self.zero1, loss_fn=loss_fn,
                      compute_accuracy=self.with_accuracy, remat=c.remat, health=health,
                      aux_weight=c.aux_weight)
        if c.grad_accum_steps > 1:
            if c.augment or c.mixup_alpha > 0:
                raise ValueError("--augment/--mixup-alpha are not yet supported with "
                                 "--grad-accum-steps")
            self.train_step = make_grad_accum_train_step(
                self.tx, accum_steps=c.grad_accum_steps, **common)
        else:
            self.train_step = make_train_step(self.tx, augment=c.augment, augment_seed=c.seed,
                                              mixup_alpha=c.mixup_alpha, **common)
        self.steps_per_call = min(c.steps_per_call, self.train_loader.steps_per_epoch)
        if self.steps_per_call > 1 and c.grad_accum_steps > 1:
            raise ValueError(
                "--steps-per-call and --grad-accum-steps are opposite trades (fuse "
                "more steps per dispatch vs split one step into microbatches); pick one")
        # the fused call runs the single step's body (and its skip guard)
        self.multi_step = (scan(self.train_step, self.steps_per_call)
                           if self.steps_per_call > 1 else None)

    def _compress_fields(self) -> Optional[dict]:
        """The ``GradCompression`` fields of this run, None without
        ``--grad-compress``."""
        c = self.config
        if c.grad_compress == "none":
            return None
        return {"mode": c.grad_compress, "block": c.grad_compress_block,
                "error_feedback": c.grad_compress_error_feedback, "kernels": c.kernels}

    def _check_strategy(self, model) -> None:
        """The guards of a family other than dp (the JAX
        ``_init_strategy_steps`` :1302-1336, then ``build_strategy``'s),
        before the optimizer and the state are built."""
        c = self.config
        for flag, name in (
            (c.augment, "--augment"),
            (c.mixup_alpha > 0, "--mixup-alpha"),
            (c.sync_bn, "--sync-bn"),
        ):
            if flag:
                raise ValueError(
                    f"{name} is only supported with data parallelism "
                    f"(got --parallelism {self.parallelism})"
                )
        if c.steps_per_call > 1:
            warnings.warn(
                f"steps_per_call={c.steps_per_call} ignored: scan "
                "fusion is dp-only",
                stacklevel=2,
            )
        check_strategy(self.parallelism, model, remat=c.remat,
                       grad_accum_steps=c.grad_accum_steps, zero1=c.zero1,
                       grad_compress=self._compress_fields())

    def _init_strategy_steps(self, model, loss_fn, health) -> None:
        """``build_strategy``'s state and steps (module docstring)."""
        c = self.config
        strategy = build_strategy(
            self.parallelism, self.mesh, model, self.tx, self.device, loss_fn=loss_fn,
            compute_accuracy=self.with_accuracy, sp_flash=c.sp_flash,
            initial_state=self.state, remat=c.remat, grad_accum_steps=c.grad_accum_steps,
            health=health, zero1=c.zero1, grad_compress=self._compress_fields(),
            aux_weight=c.aux_weight, n_microbatches=c.n_microbatches,
            pp_schedule=c.pp_schedule)
        self.strategy_line = strategy.line
        self.state = strategy.state
        self.compress, self.layout = strategy.compress, strategy.layout
        self.train_step = strategy.train_step
        self.eval_step = strategy.eval_step
        self.predict_step = strategy.predict_step
        self.multi_step, self.steps_per_call = None, 1

    def _build_compressor(self) -> Optional[GradCompressor]:
        """The ``GradCompressor`` of this run's ``--grad-compress`` knobs over
        the ranks, or None without compression. ``kernels`` reaches it as in
        the JAX trainer: K2 and K3 run the int8 payloads. It is built over
        the params' original shapes (under ZeRO-3 the partition's slots: the
        module holds placeholders, the JAX :1224-1232)."""
        c = self.config
        if c.grad_compress == "none" or self.mesh is not None:
            return None           # a rank grid's compressor is the strategy's
        template = self.zero1.param_slots if c.zero3 else self.state.params()
        return GradCompressor(
            GradCompression(
                mode=c.grad_compress,
                block=c.grad_compress_block,
                error_feedback=c.grad_compress_error_feedback,
                kernels=c.kernels,
            ),
            template, self.world_size,
        )

    # ---- checkpoints -------------------------------------------------------

    def model_state(self) -> dict:
        """The model's state dict with the params whole (under ``--zero3``
        and the GSPMD families gathered from the ranks' shards: a
        collective, every rank calls it)."""
        return self.layout.model_state(self.state)

    def _ckpt_state(self) -> dict:
        """The checkpoint's flat dict (``train/state.py``) in the one layout
        (module docstring). A collective under ``--zero1``, ``--zero3`` and
        with a residual at several ranks: every rank calls it at the same
        steps."""
        model_state = self.model_state()
        state = dataclasses.replace(
            self.state, opt_state=self.layout.deshard_opt_state(self.state.opt_state))
        residual = rows = None
        if state.grad_residual is not None and self.compress.n_shards > 1:
            rows = self.compress.residual_rows(state.grad_residual)
        elif state.grad_residual is not None:
            residual = self.compress.unflatten(state.grad_residual)
        return checkpoint_state(int(state.step), model_state,
                                state.opt_state, residual, rows)

    def _save(self, step: int, wait: bool = False) -> None:
        """``checkpointer.save`` of ``_ckpt_state()``. The training thread's
        time in the two (the collectives, the wait for the save before, the
        device-to-host copy with its synchronisation, and with ``wait`` the
        commit) is appended to ``save_ms`` as ``[step, wait, ms]``."""
        t0 = time.perf_counter()
        self.checkpointer.save(step, self._ckpt_state(), wait=wait)
        self.save_ms.append([step, wait, (time.perf_counter() - t0) * 1e3])

    def _restore(self, flat: dict) -> None:
        """Write a checkpoint's state INTO this run's tensors (the ring and
        ZeRO-1's rows read views of them): the model in place (under
        ``--zero3`` the params into this rank's shards), the optimizer state
        through this rank's shards under ``--zero1`` and ``--zero3``, and
        the residual with the JAX trainer's tolerance (:1043-1074): none in
        the checkpoint starts an error-feedback run from zero, one this run
        does not use is discarded, each with a warning."""
        ck = split_checkpoint(flat)
        self.layout.load_model_state_(self.state, ck["model"])
        self.state.step.fill_(ck["step"])
        copy_opt_state_(self.state.opt_state, self.layout.shard_opt_state(ck["opt_state"]))
        residual, rows = ck["grad_residual"], ck["grad_residual_rows"]
        if self.state.grad_residual is None:
            if residual is not None or rows is not None:
                log.warning("checkpoint carries a grad-compress residual this run "
                            "does not use; discarding it")
        elif residual is None and rows is None:
            log.warning("checkpoint carries no grad_residual; starting the "
                        "error-feedback residual from zero")
        else:
            self.compress.shard_residual(residual, self.state.grad_residual,
                                         rows=rows)

    def _save_best(self, acc: float) -> None:
        """``--keep-best``: a new best test accuracy replaces the best
        checkpoint (``save_as_only``: a resumed run can replay a new best at
        an older step) and ``best/metadata.json``, written atomically."""
        self._best_acc = acc
        step = int(self.state.step)
        self.best_checkpointer.save_as_only(step, self._ckpt_state())
        if is_primary_process():
            meta = os.path.join(self.config.checkpoint_dir, "best", "metadata.json")
            tmp = f"{meta}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"step": step, "test_accuracy": acc}, f)
            os.replace(tmp, meta)

    # ---- the loop ----------------------------------------------------------

    def to_device(self, batch: dict):
        return batch_to_device(batch, self.device)

    # ---- the host data path ------------------------------------------------

    def _epoch_stream(self, K: int, start: int):
        """Yield ``(kind, device_batch, n_real)`` for this rank's batches of
        the loader's current epoch from index batch ``start`` on: "stacked"
        for a fused K-step group (a leading (K,) axis), "single" for a lone
        step (module docstring); ``n_real`` is the host's count of unmasked
        rows. The staged prefetcher takes precedence, then the native ring,
        then the synchronous path (the JAX ``_epoch_stream``)."""
        c = self.config
        if c.prefetch_batches > 0:
            from tpu_ddp_torch.datapath.prefetch import BackgroundPrefetcher

            pf = BackgroundPrefetcher(lambda: self._digested_batches(start),
                                      depth=c.prefetch_batches, telemetry=self.telemetry)
            try:
                yield from self._host_batch_stream(pf, K)
            finally:
                pf.close()
            return
        if c.prefetch_depth > 0:
            yield from self._prefetched_stream(K, c.prefetch_depth, start)
            return
        yield from self._host_batch_stream(self._digested_batches(start), K)

    def _digested_batches(self, start: int):
        """The train loader's batches of the epoch from index batch
        ``start`` on, each one's content digest recorded against its global
        step under telemetry (the JAX ``_digested_batches`` :1488-1502; on
        the staged prefetcher's thread under ``--prefetch-batches``)."""
        loader = self.train_loader
        base = (max(loader._epoch, 1) - 1) * loader.steps_per_epoch + start
        for i, batch in enumerate(loader.epoch_batches(start=start)):
            if self._data_digests is not None:
                self._data_digests.record(base + i, batch)
            yield batch

    def _host_batch_stream(self, batches, K: int):
        """The consuming half of the synchronous and staged paths: draw host
        batches (``data_wait``: on the synchronous path the gather runs in
        it) and copy them to the device (``h2d``), K-step groups stacked."""
        it = step_groups(batches, K)
        clock = time.perf_counter
        span = self.telemetry.span
        while True:
            t0 = clock()
            with span("data_wait"):
                item = next(it, None)
            t1 = clock()
            self.data_seconds["data_wait"] += t1 - t0
            if item is None:
                return
            kind, batch = item
            with span("h2d"):
                dev = self.to_device(batch)
            self.data_seconds["h2d"] += clock() - t1
            yield kind, dev, int(batch["mask"].sum())

    def _prefetched_stream(self, K: int, depth: int, start: int):
        """The native ring's ``_epoch_stream`` (the JAX ``_prefetched_stream``
        :1539-1631): ``depth`` submissions run ahead of the one being
        consumed; a fused group is one submission of K index batches.

        Slot lifetime: on the card the slot's rows go to the device on
        ``_copy_stream`` (asynchronous: the slots are pinned), the step's
        stream waits for the copy, and an event recorded behind the copy is
        waited on before the slot is released, which happens just before
        the next submission needs a free slot (so the wait is for a copy
        long done, not for the step). On the CPU the rows are copied out of
        the slot and the slot is released at once. A stream closed early
        acquires and releases what it left in flight, so the ring is empty
        for the next epoch."""
        loader = self.train_loader
        cuda = self.device.type == "cuda"
        if self._prefetcher is None:
            from tpu_ddp_torch.native.prefetch import BatchPrefetcher

            # depth + 1 slots: depth in flight and the one being consumed
            # with digests on, the gather thread hashes the rows it copies
            self._prefetcher = BatchPrefetcher(
                loader.images, loader.labels, max_batch=K * loader.local_batch,
                depth=depth + 1, pin_memory=cuda,
                digest_seed=None if self._data_digests is None else self.config.seed)
            if cuda:
                self._copy_stream = torch.cuda.Stream(self.device)
        pf = self._prefetcher
        img_tail, lbl_tail = loader.images.shape[1:], loader.labels.shape[1:]
        clock = time.perf_counter
        span, digests = self.telemetry.span, self._data_digests
        # the global step of the epoch's first batch (digest anchors)
        step_base = (max(loader._epoch, 1) - 1) * loader.steps_per_epoch

        def submissions():
            index = itertools.islice(loader.epoch_index_batches(), start, None)
            pending, seq = [], start
            for idx, mask in index:
                if K <= 1:
                    yield "single", idx, mask, seq
                    seq += 1
                    continue
                pending.append((idx, mask))
                if len(pending) == K:
                    yield ("stacked", np.concatenate([i for i, _ in pending]),
                           np.stack([m for _, m in pending]), seq)
                    seq += K
                    pending = []
            for idx, mask in pending:
                yield "single", idx, mask, seq
                seq += 1

        in_flight = deque()          # (kind, mask, seq) a submission, FIFO
        held = []                    # [(slot, event)] copies not yet known done

        def release_held():
            for slot, event in held:
                event.synchronize()
                pf.release(slot)
            held.clear()

        def emit():
            kind, mask, seq = in_flight.popleft()
            t0 = clock()
            with span("data_wait"):
                img, lbl, slot = pf.acquire()
            self.data_seconds["data_wait"] += clock() - t0
            if kind == "stacked":
                img = img.view((K, -1) + img_tail)
                lbl = lbl.view((K, -1) + lbl_tail)
            if digests is not None:
                # the slot's row digests, before the slot can go back to
                # the ring: one XOR of the mask-true rows a step
                masks = mask if kind == "stacked" else [mask]
                rows = pf.row_digests(slot, np.size(mask)).reshape(len(masks), -1, 8)
                for k, (dg, mk) in enumerate(zip(rows, masks)):
                    digests.record_digest(step_base + seq + k, *xor_row_digests(dg, mk))
            t1 = clock()
            with span("h2d"):
                if cuda:
                    step_stream = torch.cuda.current_stream(self.device)
                    with torch.cuda.stream(self._copy_stream):
                        dev_img = img.to(self.device, non_blocking=True)
                        dev_lbl = lbl.to(self.device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._copy_stream)
                    step_stream.wait_event(event)
                    # allocated on the copy stream, used on the step's
                    dev_img.record_stream(step_stream)
                    dev_lbl.record_stream(step_stream)
                    held.append((slot, event))
                else:
                    dev_img, dev_lbl = img.clone(), lbl.clone()
                    pf.release(slot)
                dev = {"image": dev_img, "label": dev_lbl,
                       "mask": torch.as_tensor(mask).to(self.device, non_blocking=True)}
            self.data_seconds["h2d"] += clock() - t1
            return kind, dev, int(mask.sum())

        try:
            for kind, idx, mask, seq in submissions():
                release_held()
                pf.submit(idx)
                in_flight.append((kind, mask, seq))
                if len(in_flight) > depth:
                    yield emit()
            while in_flight:
                yield emit()
        finally:
            release_held()
            while in_flight:          # a stream closed early (a drain, a halt)
                in_flight.popleft()
                pf.release(pf.acquire()[2])


    def run(self) -> dict:
        """Train from ``state.step`` to ``epochs``, draining on SIGTERM and
        SIGINT (module docstring). The handler only sets flags, and is
        installed only on the main thread."""
        self._preempted = self._force_abort = False
        old_handlers = {}

        def _on_signal(signum, frame):
            del frame
            # async-signal-safe: flags and os.write only; the loop logs
            if self._preempted:
                self._force_abort = True
                os.write(2, b"\ntpu_ddp_torch: second signal - force-abort: "
                            b"skipping the final checkpoint (send again to kill "
                            b"outright)\n")
                signal.signal(signum, old_handlers.get(signum, signal.SIG_DFL))
                return
            self._preempted = True
            os.write(2, b"\ntpu_ddp_torch: signal received - draining, will "
                        b"checkpoint and exit (send again to force-abort without "
                        b"the final checkpoint)\n")

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread
            old_handlers = {}
        try:
            if self.config.lint_on_start:
                self.lint_preflight()
            return self._run_loop()
        except Exception as e:
            # an allocation failure writes its postmortem bundle and the
            # oom_abort instant (the ledger's `oom` exit) before the
            # re-raise; a collective that lost its peer closes the trace
            # without `run_end` (the ledger's `killed`); any other
            # exception passes untouched
            self._handle_possible_oom(e)
            if peer_lost(e):
                self.telemetry.peer_lost()
            raise
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _preflight_batch(self, stacked: int = 0) -> dict:
        """A batch of the run's shapes and dtypes on the device (this rank's
        ``per_shard_batch`` rows; ``stacked`` > 0: that many stacked, the
        fused call's), made from a generator of its own: the loader is not
        touched."""
        gen = torch.Generator().manual_seed(0)
        rows = self.config.per_shard_batch
        lead = (stacked, rows) if stacked else (rows,)
        images, labels = self.train_loader.images, self.train_loader.labels
        batch = {
            "image": torch.rand(lead + images.shape[1:], generator=gen).to(
                torch.from_numpy(images[:1]).dtype),
            "label": torch.zeros(lead + labels.shape[1:],
                                 dtype=torch.from_numpy(labels[:1]).dtype),
            "mask": torch.ones(lead, dtype=torch.bool)}
        return self.to_device(batch)

    def _audited(self, step, batch, label: str, program: str):
        """Lint ``step`` over ``batch`` as this run's program ``label``
        (``analysis/lint.py::lint_program``), every state tensor, the RNG
        states and the launch counts put back after it."""
        from tpu_ddp_torch import ops
        from tpu_ddp_torch.analysis.explain import StrategyProgram
        from tpu_ddp_torch.analysis.lint import lint_program

        c = self.config

        def run():
            self.state, metrics = step(self.state, batch)
            return metrics

        prog = StrategyProgram(
            strategy=label, parallelism=self.parallelism, step=run,
            mesh=dict(self.mesh_sizes), n_devices=self.world_size, model_name=c.model,
            compute_dtype=c.compute_dtype, per_shard_batch=c.per_shard_batch,
            device=self.device, leaves=lambda: self.layout.leaves(self.state),
            batch=batch, zero=self.layout.zero)
        state, opt = self.state, self.state.opt_state
        fields = {f: getattr(opt, f) for f in SLOTS + COUNTS}
        residual, step_t = state.grad_residual, state.step
        tensors = ([t for _, _, t, _, _ in self.layout.leaves(state)]
                   + list((residual or {}).values()))
        # the snapshot lies in host memory (pinned on the card), so the audit
        # needs no device memory beyond the step's own
        pin = self.device.type == "cuda"
        held = [(t.data, t.untyped_storage().data_ptr(),
                 torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t.detach()))
                for t in tensors]
        rng = torch.get_rng_state()
        cuda_rng = torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None
        launches = ops.launch_counts()
        try:
            findings, _ = lint_program(prog, strategy=label, program=program)
        finally:
            # the run goes on with the very tensors it held, their values
            # as before the audit (a step that replaced one, as an
            # out-of-place update does, gets the old one back)
            self.state, state.opt_state = state, opt
            state.grad_residual, state.step = residual, step_t
            for f, value in fields.items():
                setattr(opt, f, value)
            with torch.no_grad():
                for t, (data, ptr, value) in zip(tensors, held):
                    if t.untyped_storage().data_ptr() != ptr:
                        t.data = data
                    t.copy_(value)
            del held
            torch.set_rng_state(rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
            for name, n in ops.launch_counts().items():
                self.preflight_launches[name] = (self.preflight_launches.get(name, 0)
                                                 + n - launches[name])
                ops.LAUNCHES[name] = launches[name]
        return findings

    def lint_preflight(self, *, raise_on_error: bool = True):
        """The graph lint (``analysis/lint.py``) over THIS run's train step
        (the JAX ``lint_preflight``, :1730-1812), under ``--steps-per-call``
        its fused call too (``<label>+scan``), and KRN001 under
        ``--kernels``; returns the findings. With ``raise_on_error`` (the
        ``--lint-on-start`` path) an error finding on any rank refuses the
        launch on every rank (``parallel/runtime.py::agree_any``: a rank
        that went on would wait in its first collective).

        The port's audit runs the step (the JAX one compiles it): once, on
        a synthetic batch of the run's shapes (``_preflight_batch``), with
        every state tensor, the error-feedback residual and the RNG states
        snapshotted before (the tensors into host memory, pinned on the
        card, so the audit holds no second copy of the state on the device)
        and copied back in place after, so the run trains bitwise as it
        would without the preflight. The preflight's
        kernel launches are accounted apart: ``ops.LAUNCHES`` is put back
        to its count before the audit and the preflight's launches are in
        ``preflight_launches``."""
        from tpu_ddp_torch.analysis.explain import run_strategy_label
        from tpu_ddp_torch.analysis.lint import lint_kernels, render_findings

        label = run_strategy_label(self.run_meta)
        findings = self._audited(self.train_step, self._preflight_batch(), label, label)
        if self.config.kernels:
            findings = findings + lint_kernels(True, device=self.device, program=label)
        if self.multi_step is not None:
            findings = findings + self._audited(
                self.multi_step, self._preflight_batch(self.steps_per_call), label,
                f"{label}+scan")
        if self.rank == 0 or findings:     # every rank that found one says so
            print(render_findings(f"preflight ({label})", findings), flush=True)
        errors = [f for f in findings if f.severity == "error"]
        if agree_any(bool(errors)) and raise_on_error:
            raise RuntimeError(
                f"lint preflight refused the launch: {len(errors)} "
                "error finding(s) in this rank's step"
                + ("" if errors else " (none here; another rank's)")
                + " (see above; the rule table and fix hints are in "
                "tpu_ddp_torch/analysis/lint.py)")
        return findings

    def _handle_possible_oom(self, exc: BaseException) -> None:
        """Classify and document an allocation-failure death (the JAX
        ``_handle_possible_oom`` :1885-1925): one last memory sample, the
        postmortem bundle under ``<telemetry_dir>/oom/``, the
        ``memory/oom_events`` counter and the ``oom_abort`` instant. Never
        raises: forensics must not mask the original exception."""
        try:
            from tpu_ddp_torch.memtrack.postmortem import (
                is_resource_exhausted,
                write_postmortem,
            )

            if not is_resource_exhausted(exc):
                return
            c = self.config
            step = int(self._last_host_step or 0)
            samples = []
            if self._memtrack is not None:
                try:
                    # one last reading at death: allocator statistics are
                    # host-side reads, still served when the card is full
                    self._memtrack.sample(step)
                except Exception:
                    pass
                samples = self._memtrack.recent()
            path = None
            if c.telemetry_dir:
                path = write_postmortem(
                    c.telemetry_dir, step=step, process_index=self.rank,
                    incarnation=self.incarnation, error=exc, samples=samples,
                    config_snapshot=dataclasses.asdict(c), run_meta=self.run_meta)
            tel = self.telemetry
            if tel.enabled:
                tel.count("memory/oom_events")
                tel.instant("oom_abort", step=step, bundle=path, error=str(exc)[:300])
            log.error("allocation failure at step %d (%s); %s", step, type(exc).__name__,
                      (f"postmortem bundle -> {path}" if path else
                       "no --telemetry-dir, postmortem bundle NOT written"))
        except Exception:
            pass

    def _run_loop(self) -> dict:
        c = self.config
        start = time.time()
        spe = self.train_loader.steps_per_epoch
        host_step = first_step = int(self.state.step)
        self.data_seconds = dict.fromkeys(self.data_seconds, 0.0)
        first_epoch = host_step // spe + 1
        # mid-epoch resume: skip the batches the cut run trained; the order
        # is a function of (seed, epoch), so they are exactly its prefix
        skip = host_step % spe
        # --steps-per-call: whole fused groups are skipped; a group that
        # straddles the resume point is replayed whole, as the JAX trainer
        # replays it (:2114-2121)
        K = self.steps_per_call if self.multi_step is not None else 1
        if K > 1 and skip < spe // K * K:
            skip -= skip % K
        if skip:
            self.logger.log_text(
                f"mid-epoch resume: skipping the first {skip} already-trained "
                f"steps of epoch {first_epoch}")
        # steady state: every epoch after the first one this run trains
        # (which pays the kernel build and cuDNN's first-call setup); a
        # 1-epoch run times it all
        tel = self.telemetry
        throughput = Throughput(self.device, tel.registry if tel.enabled else None)
        timed_steps = 0
        metrics, out = {}, {}
        self._start_telemetry()
        # --profile-dir traces the first steady epoch (the JAX :2075-2082):
        # the second this run trains; a one-epoch run traces what it has
        profile_epoch = min(first_epoch + 1, c.epochs) if c.profile_dir else None
        for epoch in range(first_epoch, c.epochs + 1):
            timed = epoch > first_epoch or c.epochs == first_epoch
            traced_epoch = epoch == profile_epoch and self._start_epoch_trace()
            if timed:
                throughput.start()
            epoch_t0 = time.perf_counter()
            self.train_loader.set_epoch(epoch)
            tel.current_step = host_step
            step_losses = []
            n_steps = 0                   # steps this run trained this epoch
            stream = self._stream = self._epoch_stream(K, skip if epoch == first_epoch else 0)
            for kind, dev_batch, n_real in stream:
                # one rank drains at a call boundary; several agree at the
                # epoch's end first, or a rank would block in the next
                # step's collectives
                if self.world_size == 1 and self._preempted:
                    break
                dn = K if kind == "stacked" else 1
                step = self.multi_step if kind == "stacked" else self.train_step
                with tel.span("compiled_step", **({"steps": K} if kind == "stacked" else {})):
                    self.state, metrics = step(self.state, dev_batch)
                step_losses.append(metrics["loss"].reshape(-1))
                host_step += dn
                n_steps += dn
                self._last_host_step = host_step
                if tel.enabled:
                    self._traced_step(metrics["loss"], host_step, dn, n_real)
                if self._watchdog is not None:
                    self._watchdog.beat(host_step)
                # after the beat (the JAX :2172-2184): an injected hang
                # blocks here, so the beat above is the last one; the
                # monitors stamp the step on their next records
                if self._chaos is not None:
                    self._chaos.on_step(host_step)
                if self._comms_monitor is not None:
                    self._comms_monitor.set_step(host_step)
                if self._datapath is not None:
                    self._datapath.set_step(host_step)
                # after the beat, in the JAX order (:2184-2195): the capture
                # window opens and closes on call boundaries, then the
                # memory sample (host-side allocator reads, no sync)
                if self._capture is not None:
                    self._capture.on_step(host_step)
                if self._memtrack is not None:
                    self._memtrack.on_step(host_step)
                if (self.health_monitor is not None and self.health_feed.push(
                        host_step - dn, metrics.pop("health"), dev_batch) == "halt"):
                    # the stats are the same on every rank, so is the
                    # verdict: every rank stops at the end of this call
                    self._health_halted = host_step
                    break
                if timed:
                    throughput.add(n_real)
                    timed_steps += dn
                if (c.log_every_steps and n_steps // c.log_every_steps
                        > (n_steps - dn) // c.log_every_steps):
                    # the reference's in-epoch line; this read is its one sync
                    cur = float(metrics["loss"].reshape(-1)[-1])
                    self.logger.log_text(f"Epoch {epoch}, iter {n_steps}, loss {cur:.4f}")
                # a fused group saves once, at the boundary it crosses
                if (self.checkpointer is not None and c.checkpoint_steps
                        and host_step // c.checkpoint_steps
                        > (host_step - dn) // c.checkpoint_steps):
                    self._save(host_step)
            stream.close()                # the ring's in-flight gathers back
            if self.health_monitor is not None:
                self.health_feed.flush()
            # one sync an epoch
            with tel.span("epoch_metrics_fetch", epoch=epoch):
                losses = (torch.cat(step_losses).cpu().numpy() if step_losses
                          else np.zeros(0, np.float32))
            if timed:
                throughput.stop()
            if traced_epoch:
                # the fetch above waited for the epoch's steps; stopping
                # here covers a drain during the traced epoch too
                self._stop_epoch_trace(epoch)
            self.history["step_loss"].extend(float(x) for x in losses)
            if agree_any(self._preempted):
                self.logger.log_text(
                    f"preempted at step {host_step} (epoch {epoch}): "
                    + ("saving final checkpoint" if self.checkpointer else
                       "no --checkpoint-dir, progress will NOT survive"))
                out["preempted"] = True
                tel.instant("preempt_drain", step=host_step)
                break
            if self._health_halted is not None:
                self.logger.log_text(
                    f"health anomaly at step {self._health_halted} with policy "
                    "'halt': stopping training"
                    + (" (saving final checkpoint)" if self.checkpointer else ""))
                out["health_halted"] = True
                tel.instant("health_halt_drain", step=self._health_halted)
                break                             # the drain of a preemption
            mean_loss = float(np.mean(losses))
            self.history["epoch"].append(epoch)
            self.history["train_loss"].append(mean_loss)
            if epoch == 1 or epoch % c.log_every_epochs == 0:
                self.logger.log_text(f"Epoch {epoch}, Training loss {mean_loss}")
                self.logger.log(host_step, epoch=epoch, train_loss=mean_loss,
                                **({"train_accuracy": float(metrics["accuracy"].reshape(-1)[-1])}
                                   if "accuracy" in metrics else {}))
                if self.checkpointer and epoch % c.checkpoint_every_epochs in (0, 1):
                    self._save(host_step)
            if c.eval_each_epoch:
                with tel.span("eval", epoch=epoch):
                    acc, loss = self.evaluate()
                self._traced_eval(acc, loss, epoch)
                self.history.setdefault("test_loss", []).append(loss)
                if self.with_accuracy:   # no accuracy for multi-hot targets
                    self.logger.log(host_step, test_accuracy=acc, test_loss=loss)
                    self.history.setdefault("test_accuracy", []).append(acc)
                    if self.best_checkpointer and acc > self._best_acc:
                        self._save_best(acc)
                else:
                    self.logger.log(host_step, test_loss=loss)
            if tel.enabled:
                self._traced_epoch(time.perf_counter() - epoch_t0, n_steps, throughput)
        total = time.time() - start
        self.logger.log_text(f"training time: {total:.3f} seconds")
        self._final_checkpoint(host_step)
        if c.plot_curves and is_primary_process():
            from tpu_ddp_torch.metrics.plotting import plot_loss_curves

            series = {"train_loss": self.history["train_loss"]}
            if self.history.get("test_loss"):
                series["test_loss"] = self.history["test_loss"]
            plot_loss_curves(series, c.plot_curves)
            self.logger.log_text(f"loss curves -> {c.plot_curves}")
        ips = throughput.images_per_sec_per_chip
        per = "chip" if self.world_size == 1 else "rank"
        self.logger.log_text(
            f"steady-state images/sec/{per}: {ips:.1f} "
            f"({throughput.images} images in {throughput.seconds:.3f} s)")
        trained = max(int(self.state.step) - first_step, 1)
        out["mfu"] = self._compute_mfu(timed_steps, throughput.seconds)
        if tel.enabled:
            from tpu_ddp_torch.metrics.mfu import record_mfu

            if throughput.seconds:
                tel.gauge("train/images_per_sec_per_chip").set(ips)
            record_mfu(tel.registry, out["mfu"])
        out.update({"total_seconds": total, "steps": int(self.state.step),
                    "images_per_sec_per_chip": ips,
                    "steady_step_ms": throughput.seconds / max(timed_steps, 1) * 1e3,
                    "data_ms": {k: v / trained * 1e3 for k, v in self.data_seconds.items()},
                    "train_loss": self.history["train_loss"][-1]
                    if self.history["train_loss"] else float("nan"),
                    "step_losses": list(self.history["step_loss"])})
        if self.checkpointer is not None:
            out["checkpoint_save_ms"] = list(self.save_ms)
        return out

    def _final_checkpoint(self, step: int) -> None:
        """The final save (``wait=True``: it raises when its attempts are
        spent), unless every rank's second signal asked to skip it; then a
        barrier, so no rank leaves the group before rank 0 has committed."""
        if self.checkpointer is None:
            return
        if agree_any(self._force_abort):
            self.telemetry.instant("force_abort_drain", step=int(self.state.step))
            prev = self.checkpointer.latest_step()
            self.logger.log_text(
                "force-abort: skipping the final checkpoint ("
                + (f"latest checkpoint remains step {prev}" if prev is not None
                   else "no checkpoint exists") + ")")
            self.checkpointer.wait_until_finished()
        elif self._health_halted is not None and not self._params_finite():
            # halt builds no skip guard: the poisoned update was applied, and
            # NaN params must not become the checkpoint --resume restores
            prev = self.checkpointer.latest_step()
            self.logger.log_text(
                "health halt: final params are non-finite; NOT checkpointing "
                "them (" + (f"latest good checkpoint remains step {prev}"
                            if prev is not None else "no checkpoint exists") + ")")
            self.checkpointer.wait_until_finished()
        else:
            self._save(step, wait=True)
        if self.best_checkpointer:
            self.best_checkpointer.wait_until_finished()
        barrier()

    def _params_finite(self) -> bool:
        """Whether every param is finite (one host read for all of them; the
        params are replicated, so every rank answers the same; under
        ``--zero3`` and the GSPMD families each rank reads what it holds and
        the ranks agree)."""
        params = self.layout.local_params(self.state)
        bad = bool(torch.stack([(~torch.isfinite(p)).any() for p in params.values()]).any())
        return not (agree_any(bad) if self.layout.split else bad)

    # ---- telemetry ---------------------------------------------------------

    def _start_telemetry(self) -> None:
        """At the start of ``_run_loop``: the goodput baseline and its
        ``counters_baseline`` record (the registry is process-wide, so the
        gauges measure against it), the hang watchdog under
        ``--watchdog-deadline`` (the JAX :1980-2016) and the monitor
        exporter under ``--monitor-port`` (:2017-2048)."""
        c, tel = self.config, self.telemetry
        reg = tel.registry
        self._goodput_baseline = {
            "wall": time.time(),
            "compiled": reg.histogram("phase/compiled_step").sum,
            "sync": reg.histogram("phase/device_sync").sum,
        }
        if tel.enabled:
            tel.emit_counters(name="counters_baseline")
        if c.watchdog_deadline_seconds > 0 and self._watchdog is None:
            on_hang = None
            if c.telemetry_dir:
                # the hang bundle names the suspect collective and loader
                # stage; written before the abort, after which there is
                # no process left to ask
                from tpu_ddp_torch.comms.forensics import write_hang_bundle

                def on_hang(dump: str, _dir=c.telemetry_dir, _p=self.rank) -> None:
                    write_hang_bundle(_dir, process_index=_p, dump_text=dump)

            self._watchdog = HangWatchdog(
                c.watchdog_deadline_seconds, heartbeat_dir=c.telemetry_dir,
                process_index=self.rank, telemetry=tel, on_hang=on_hang,
                abort_on_hang=c.watchdog_abort).start()
        if c.monitor_port and self._exporter is None:
            self._start_exporter()

    def _start_exporter(self) -> None:
        """The rank's live scrape endpoint (``monitor/exporter.py``). A bind
        failure (the port taken) is a warning, as in the JAX trainer:
        observability must never take down the training it observes."""
        from tpu_ddp_torch.monitor.exporter import MonitorExporter

        c = self.config
        try:
            self._exporter = MonitorExporter(
                registry=self.telemetry.registry, run_meta=self.run_meta,
                port=max(c.monitor_port, 0), host=c.monitor_bind,
                process_index=self.rank, watchdog_provider=lambda: self._watchdog,
                run_dir=c.telemetry_dir,
                profile_trigger=(self._capture.request
                                 if self._capture is not None else None),
                allow_remote_trigger=c.monitor_allow_remote_trigger,
            ).start()
            log.info("monitor exporter on port %d (/metrics /snapshot.json /healthz)",
                     self._exporter.port)
        except OSError as e:
            log.warning("monitor exporter failed to bind port %s: %s (continuing "
                        "without the live endpoint)", c.monitor_port, e)

    def _start_epoch_trace(self) -> bool:
        """Arm ``--profile-dir``'s ``torch.profiler`` session for this
        epoch; False, with a warning, when it cannot start (a capture
        window's session already running: one at a time)."""
        from tpu_ddp_torch.profiler.device import start_device_trace

        note = start_device_trace(self.config.profile_dir, cuda=self.device.type == "cuda")
        if note is not None:
            log.warning("--profile-dir: no epoch trace (%s)", note)
        self._epoch_tracing = note is None
        return self._epoch_tracing

    def _stop_epoch_trace(self, epoch: int) -> None:
        """Write the epoch's trace into ``--profile-dir`` and say where:
        the ``profiler_trace_written`` instant under telemetry, else a log
        line (the JAX :2243-2268)."""
        from tpu_ddp_torch.profiler.device import stop_device_trace

        c, tel = self.config, self.telemetry
        self._epoch_tracing = False
        t0 = time.perf_counter()
        note = stop_device_trace()
        dump_seconds = time.perf_counter() - t0
        if note is not None:
            log.warning("--profile-dir: %s", note)
        elif tel.enabled:
            tel.instant("profiler_trace_written", path=os.path.abspath(c.profile_dir),
                        epoch=epoch, dump_seconds=round(dump_seconds, 3))
        else:
            self.logger.log_text(f"profiler trace -> {c.profile_dir}")

    def _traced_step(self, loss: torch.Tensor, host_step: int, dn: int, n_real: int) -> None:
        """A traced step's tail (the JAX :2143-2165): the ``device_sync``
        fence, the step counters and the periodic snapshot."""
        tel = self.telemetry
        with tel.span("device_sync"):
            if loss.is_cuda:
                # the step's own work on the stream it ran on: an event
                # behind it, not a synchronize of every stream
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(loss.device))
                done.synchronize()
        tel.current_step = host_step
        tel.count("train/steps", dn)
        tel.count("train/images", n_real)
        every = self.config.telemetry_snapshot_steps
        if every and host_step // every > (host_step - dn) // every:
            self._update_goodput_gauges()
            tel.emit_counters(name="counters_snapshot")

    def _traced_eval(self, acc: float, loss: float, epoch: int) -> None:
        """An epoch's eval gauges and eval point (the JAX :2332-2350)."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.gauge("eval/test_loss").set(loss)
        if self.with_accuracy:
            tel.gauge("eval/test_accuracy").set(acc)
        tel.instant("eval", step=int(self.state.step),
                    eval_schema_version=EVAL_POINT_SCHEMA_VERSION, epoch=epoch,
                    test_loss=loss, **({"test_accuracy": acc} if self.with_accuracy else {}))

    def _traced_epoch(self, seconds: float, n_steps: int, throughput: Throughput) -> None:
        """An epoch's end under telemetry (the JAX :2384-2408): the rate
        gauges, the ``comm/*`` wire counters, the memory and goodput gauges,
        and a counters record."""
        from tpu_ddp_torch.metrics.memory import record_memory_gauges

        tel = self.telemetry
        if seconds > 0 and n_steps:
            tel.gauge("train/steps_per_sec").set(n_steps / seconds)
            if throughput.seconds:
                tel.gauge("train/images_per_sec_per_chip").set(
                    throughput.images_per_sec_per_chip)
        if self._comm_bytes_per_step is not None and n_steps:
            wire, base = self._comm_bytes_per_step
            tel.count("comm/grad_bytes_on_wire", n_steps * wire)
            tel.count("comm/grad_bytes_uncompressed", n_steps * base)
        record_memory_gauges(tel.registry, self.device)
        self._update_goodput_gauges()
        tel.emit_counters()

    def _update_goodput_gauges(self) -> None:
        """The share of this life's wall time spent in the steps
        (``compiled_step`` and ``device_sync`` span time), against the run's
        baseline (the JAX ``_update_goodput_gauges`` :2485-2511; no compile
        term: the port compiles no step)."""
        base = getattr(self, "_goodput_baseline", None)
        if base is None:
            return
        tel = self.telemetry
        reg = tel.registry
        elapsed = time.time() - base["wall"]
        if elapsed <= 0:
            return
        productive = ((reg.histogram("phase/compiled_step").sum - base["compiled"])
                      + (reg.histogram("phase/device_sync").sum - base["sync"]))
        productive = min(max(productive, 0.0), elapsed)
        tel.gauge("goodput/fraction").set(productive / elapsed)
        tel.gauge("goodput/productive_seconds").set(productive)
        tel.gauge("goodput/elapsed_seconds").set(elapsed)

    def _compute_mfu(self, steps: int, seconds: float) -> Optional[float]:
        """MFU of the timed epochs (the JAX ``_compute_mfu`` :2558-2583),
        or None: gated on a known peak before the FLOPs are counted. A rank
        of a model group is charged its share of its data shard's rows
        (``metrics/mfu.py``)."""
        from tpu_ddp_torch.metrics.mfu import flops_per_step, mfu, peak_flops_per_chip

        if not steps or seconds <= 0 or peak_flops_per_chip(self.device) is None:
            return None
        c = self.config
        full = dataclasses.replace(c, attention="full", sync_bn=False)
        try:
            flops = flops_per_step(lambda: build_model(full), c.per_shard_batch,
                                   num_classes=c.num_classes, loss=c.loss,
                                   share=self.data_size / self.world_size)
        except Exception:
            log.warning("MFU not computed: the FLOP count of %r on the meta device "
                        "failed", c.model, exc_info=True)
            return None
        return mfu(flops, steps / seconds, self.device)

    def record_final_eval(self, *, accuracy=None, loss=None) -> None:
        """Mirror the end-of-run evaluation into telemetry gauges
        (``eval/final_test_*``, and ``eval/best_test_accuracy`` under
        ``--keep-best``) and the final eval point, so the final counters
        snapshot ``close()`` writes carries them (the JAX
        ``record_final_eval`` :1704-1730). No-op without telemetry."""
        tel = self.telemetry
        if not tel.enabled:
            return
        if accuracy is not None:
            tel.gauge("eval/final_test_accuracy").set(accuracy)
        if loss is not None:
            tel.gauge("eval/final_test_loss").set(loss)
        if self._best_acc != float("-inf"):
            tel.gauge("eval/best_test_accuracy").set(self._best_acc)
        tel.instant(
            "eval", step=int(self.state.step),
            eval_schema_version=EVAL_POINT_SCHEMA_VERSION, final=True,
            **({"test_loss": loss} if loss is not None else {}),
            **({"test_accuracy": accuracy} if accuracy is not None else {}))

    def close(self) -> None:
        """Stop the native prefetcher, the monitor exporter, the capture
        manager (it writes an open window as a truncated bundle) and the
        watchdog, finish in-flight saves, close the memory record, the
        metric sinks, the health record and the digest sink, then the
        telemetry sinks (the final counters snapshot, the Chrome trace, the
        phase table). Idempotent."""
        if self._stream is not None:
            # a run that raised mid-epoch left its stream open: its gathers
            # go back to the ring before the ring closes
            self._stream.close()
            self._stream = None
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        if self._capture is not None:
            # a window still open when the run ends is written as a
            # truncated bundle: a preempted run's capture is evidence too
            self._capture.close()
        if self._epoch_tracing:          # the run raised in the traced epoch
            from tpu_ddp_torch.profiler.device import stop_device_trace

            self._epoch_tracing = False
            stop_device_trace()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._comms_monitor is not None:
            # clear the hop hook BEFORE closing: a later ring must not
            # write through a closed monitor
            set_ring_hop_hook(None)
            self._comms_monitor.close()
            self._comms_monitor = None
        if self._datapath is not None:
            self._datapath.close()
        for ck in (self.checkpointer, self.best_checkpointer):
            if ck is not None:
                ck.close()
        if self._memtrack is not None:
            self._memtrack.close()
        if self.health_monitor is not None:
            self.health_monitor.close()
        if self._data_digests is not None:
            self._data_digests.close()
        self.logger.close()
        self.telemetry.close()

    def _eval_params(self):
        """The weights evaluation reads in place of the model's: the EMA
        shadow when ``ema_decay`` is on (under ZeRO-1 and ZeRO-3 gathered
        from the ranks' shards and unflattened, a collective), under
        ``--zero3`` without it the params gathered from their shards (the
        JAX ``_eval_source_state`` :2615-2640: one gather a pass), else
        None: ``StateLayout.eval_params``."""
        return self.layout.eval_params(self.state, bool(self.config.ema_decay))

    def evaluate(self) -> tuple:
        """(accuracy, loss) over the test set; the EMA weights when
        ``ema_decay`` is on. One host sync for the whole pass."""
        ema = self._eval_params()
        outs = [self.eval_step(self.state, self.to_device(b), ema)
                for b in self.test_loader.epoch_batches(epoch=0, shard=self.data_index)]
        self.eval_batches += len(outs)
        sums = {k: float(torch.stack([o[k] for o in outs]).sum())
                for k in ("correct", "count", "loss_sum")}
        n = max(sums["count"], 1.0)
        return sums["correct"] / n, sums["loss_sum"] / n

    def predict(self, loader: Optional[ShardedBatchLoader] = None) -> tuple:
        """Batch inference over ``loader`` (the test loader by default):
        ``(logits, labels)`` as host numpy arrays without the sampler's and
        the batches' padding, the EMA shadow's logits under ``ema_decay``
        (the JAX ``predict`` :2660-2692). Each rank runs its own rows; the
        ranks' logits are gathered (one all-gather for the whole pass, a
        collective) into the global shard-major batches, so every rank
        returns every row, in sampler order: dataset order at one rank, the
        sampler's interleave (rank r takes rows r::n) at n."""
        loader = self.test_loader if loader is None else loader
        params = self._eval_params()
        outs = [self.predict_step(self.state, self.to_device(b), params)
                for b in loader.epoch_batches(epoch=0, shard=self.data_index)]
        local = torch.stack(outs).float()                # (batches, rows, classes)
        if self.world_size > 1:
            gathered = all_gather_bytes(local.reshape(-1))
            # rank r = d * S + s: one copy of each data shard's rows, s = 0's
            S = self.world_size // self.data_size
            gathered = gathered.view(self.data_size, S, *local.shape)[:, 0]
            local = gathered.transpose(0, 1)
        logits = local.reshape(-1, local.shape[-1]).cpu().numpy()
        index = list(loader.epoch_index_batches(epoch=0))
        mask = np.concatenate([m for _, m in index])
        labels = np.asarray(loader.labels)[np.concatenate([i for i, _ in index])]
        return logits[mask], labels[mask]
