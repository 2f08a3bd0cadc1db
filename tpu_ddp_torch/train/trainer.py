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
``_eval_source_state`` :2603-2640).

Checkpoints (``--checkpoint-dir``; ``checkpoint/manager.py``) hold one
layout whatever the run's (``_ckpt_state``, the JAX ``_ckpt_state``
:2585-2601): ZeRO-1's optimizer state de-sharded, and the error-feedback
residual in param layout from one rank, or every rank's row from several
(whose sum is the param-layout residual). ``--resume`` restores
through that layout and lays it out again for this run (:1006-1074), so
``--zero1`` and replicated runs, runs with and without error feedback, and
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

Not ported yet: telemetry (and the health gauges it carries), the elastic
supervisor, k-fold, the host prefetchers, and the strategies other than
data parallelism (zero3, fsdp, tp, pp).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import signal
import time
from typing import Optional

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
from tpu_ddp_torch.data.loader import ShardedBatchLoader, step_groups
from tpu_ddp_torch.health.monitor import POLICIES as HEALTH_POLICIES
from tpu_ddp_torch.health.monitor import HealthMonitor, next_incarnation
from tpu_ddp_torch.health.stats import HealthConfig, HealthFeed
from tpu_ddp_torch.metrics.logging import MetricLogger
from tpu_ddp_torch.metrics.timing import Throughput
from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
from tpu_ddp_torch.models.layers import DTYPES as COMPUTE_DTYPES
from tpu_ddp_torch.parallel.compression import MODES as COMPRESS_MODES
from tpu_ddp_torch.parallel.collectives import all_gather_bytes
from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
from tpu_ddp_torch.parallel.runtime import (
    agree_any,
    barrier,
    is_primary_process,
    rank,
    world_size,
)
from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition
from tpu_ddp_torch.runtime import resolve_device, set_float32_precision
from tpu_ddp_torch.train.finetune import load_pretrained_for_finetune
from tpu_ddp_torch.train.losses import binary_cross_entropy_with_logits, cross_entropy_loss
from tpu_ddp_torch.train.optim import decay_mask, freeze_all_but, make_optimizer
from tpu_ddp_torch.train.state import (
    checkpoint_state,
    copy_opt_state_,
    create_train_state,
    split_checkpoint,
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


@dataclasses.dataclass
class TrainConfig:
    """The fields the port's CLI flags set (names and defaults as in the
    JAX ``TrainConfig``)."""

    device: str = "cuda"
    data_dir: str = "data/CIFAR-10"
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
    grad_compress: str = "none"           # none | bf16 | int8 (the ring)
    grad_compress_block: int = 256
    grad_compress_error_feedback: bool = False
    dist_backend: Optional[str] = None    # None: nccl on cuda, gloo on cpu
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

    def __post_init__(self):
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
    and ignores it there)."""
    generator = torch.Generator().manual_seed(c.seed)
    dtype = COMPUTE_DTYPES[c.compute_dtype]
    name = c.model.lower()
    if name == "netresdeep":
        model = NetResDeep(n_chans1=c.n_chans1, n_blocks=c.n_blocks,
                           num_classes=c.num_classes, tied=c.tied_blocks,
                           generator=generator, dtype=dtype)
    elif name in MODEL_REGISTRY:
        model = MODEL_REGISTRY[name](num_classes=c.num_classes, generator=generator,
                                     image_size=image_size, dtype=dtype)
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
    load = DATASETS[c.dataset][0]
    return load(c.data_dir, train=True), load(c.data_dir, train=False)


class Trainer:
    def __init__(self, config: TrainConfig, *, train_data=None, test_data=None):
        """``train_data``/``test_data``: ``(images, labels)`` that replace the
        configured dataset's splits (the JAX trainer's); the test split
        defaults to ``train_data`` when only that is given."""
        c = self.config = config
        self.device = resolve_device(c.device)
        set_float32_precision()
        self.logger = MetricLogger(c.jsonl_path, tensorboard_dir=c.tensorboard_dir)
        self.rank, self.world_size = rank(), world_size()
        if train_data is None:
            train_data, test_data = load_dataset(c)
        elif test_data is None:
            test_data = train_data
        if c.loss == "bce" and np.asarray(train_data[1]).ndim != 2:
            raise ValueError(
                "--loss bce needs multi-hot (N, C) targets; this dataset "
                "yields class indices. Use --synthetic-data (multi-label "
                "generator) or pass multi-hot train_data.")
        self.train_loader = ShardedBatchLoader(
            *train_data, world_size=self.world_size,
            per_shard_batch=c.per_shard_batch, shuffle=c.shuffle, seed=c.seed)
        self.test_loader = ShardedBatchLoader(
            *test_data, world_size=self.world_size,
            per_shard_batch=c.per_shard_batch, shuffle=False,
            exclude_sampler_pad=True)
        model = build_model(c)
        params = dict(model.named_parameters())
        # ZeRO-1's chain runs on flat shards, where ndim says nothing: the
        # decay mask comes from the original shapes, here
        self.tx = make_optimizer(
            lr=c.lr, optimizer=c.optimizer, momentum=c.momentum,
            weight_decay=c.weight_decay, schedule=c.schedule,
            total_steps=self.train_loader.steps_per_epoch * c.epochs,
            warmup_steps=c.warmup_steps, grad_clip_norm=c.grad_clip_norm,
            ema_decay=c.ema_decay, kernels=c.kernels,
            decay_mask=decay_mask(params) if c.zero1 else None,
            zero1_axis=DATA_AXIS if c.zero1 else None,
            freeze_predicate=(freeze_all_but(tuple(c.freeze_prefixes))
                              if c.freeze_prefixes else None),
        )
        self.zero1 = (Zero1Partition(self.tx, params, self.world_size)
                      if c.zero1 else None)
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
            loss_fn, self.with_accuracy = binary_cross_entropy_with_logits, False
        else:
            loss_fn, self.with_accuracy = cross_entropy_loss, True
            if c.label_smoothing:
                loss_fn = functools.partial(cross_entropy_loss,
                                            label_smoothing=c.label_smoothing)
        self.health_monitor = None
        self._health_halted = None    # the step a halt verdict stopped at
        health = None
        if c.health != "off":
            health = HealthConfig(per_layer=c.health_per_layer_stride > 0,
                                  skip_nonfinite=c.health_policy == "skip_step")
            if not c.health_dir:
                log.warning(
                    "health=on without --health-dir: detection and the %r "
                    "policy are active, but no health JSONL or anomaly dumps "
                    "will be written", c.health_policy)
            self.health_monitor = HealthMonitor(
                run_dir=c.health_dir, policy=c.health_policy,
                per_layer_stride=c.health_per_layer_stride,
                process_index=self.rank, window=c.health_window,
                spike_threshold=c.health_spike_threshold,
                run_meta=dataclasses.asdict(c),
                incarnation=next_incarnation(c.health_dir, self.rank) if c.health_dir else 0)
            self.health_feed = HealthFeed(self.health_monitor, lag=c.health_policy != "halt")
        self._init_steps(loss_fn, health)
        self.eval_step = make_eval_step(loss_fn, compute_accuracy=self.with_accuracy)
        self.predict_step = make_predict_step()
        self.history = {"train_loss": [], "step_loss": [], "epoch": []}
        self.eval_batches = 0  # eval steps run so far (every evaluate call)
        self._preempted = self._force_abort = False

        self.checkpointer = None
        self.best_checkpointer = None
        self.resumed_step = None      # set iff --resume restored a checkpoint
        self.save_ms = []             # [step, wait, ms] a save (``_save``)
        self._best_acc = float("-inf")
        if c.checkpoint_dir:
            self.checkpointer = Checkpointer(c.checkpoint_dir)
            if c.keep_best:
                best_dir = os.path.join(c.checkpoint_dir, "best")
                self.best_checkpointer = Checkpointer(best_dir, max_to_keep=1)
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

    def _init_steps(self, loss_fn, health) -> None:
        """``train_step``, and ``multi_step`` (the fused K-step call) under
        ``--steps-per-call``, with the JAX trainer's guards (:1243-1300):
        accumulation takes neither augment nor mixup, and is the opposite
        trade of fused steps; ``steps_per_call`` is clamped to the epoch's
        length (a longer group would never fill)."""
        c = self.config
        common = dict(compress=self.compress, zero1=self.zero1, loss_fn=loss_fn,
                      compute_accuracy=self.with_accuracy, remat=c.remat, health=health)
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

    def _build_compressor(self) -> Optional[GradCompressor]:
        """The ``GradCompressor`` of this run's ``--grad-compress`` knobs over
        the ranks, or None without compression. ``kernels`` reaches it as in
        the JAX trainer: K2 and K3 run the int8 payloads."""
        c = self.config
        if c.grad_compress == "none":
            return None
        return GradCompressor(
            GradCompression(
                mode=c.grad_compress,
                block=c.grad_compress_block,
                error_feedback=c.grad_compress_error_feedback,
                kernels=c.kernels,
            ),
            self.state.params(), self.world_size,
        )

    # ---- checkpoints -------------------------------------------------------

    def _ckpt_state(self) -> dict:
        """The checkpoint's flat dict (``train/state.py``) in the one layout
        (module docstring). A collective under ``--zero1`` and with a
        residual at several ranks: every rank calls it at the same steps."""
        state = self.state
        if self.zero1 is not None:
            state = self.zero1.deshard_state(state)
        residual = rows = None
        if state.grad_residual is not None and self.world_size > 1:
            rows = self.compress.residual_rows(state.grad_residual)
        elif state.grad_residual is not None:
            residual = self.compress.unflatten(state.grad_residual)
        return checkpoint_state(int(state.step), state.model.state_dict(),
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
        ZeRO-1's rows read views of them): the model in place, the
        optimizer state through this rank's shards under ``--zero1``, and
        the residual with the JAX trainer's tolerance (:1043-1074): none in
        the checkpoint starts an error-feedback run from zero, one this run
        does not use is discarded, each with a warning."""
        ck = split_checkpoint(flat)
        self.state.model.load_state_dict(ck["model"])
        self.state.step.fill_(ck["step"])
        restored = dataclasses.replace(self.state, opt_state=ck["opt_state"])
        if self.zero1 is not None:
            restored = self.zero1.shard_state(restored)
        copy_opt_state_(self.state.opt_state, restored.opt_state)
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
            return self._run_loop()
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _run_loop(self) -> dict:
        c = self.config
        start = time.time()
        spe = self.train_loader.steps_per_epoch
        host_step = int(self.state.step)
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
        throughput = Throughput(self.device)
        timed_steps = 0
        metrics, out = {}, {}
        for epoch in range(first_epoch, c.epochs + 1):
            timed = epoch > first_epoch or c.epochs == first_epoch
            if timed:
                throughput.start()
            self.train_loader.set_epoch(epoch)
            step_losses = []
            batches = self.train_loader.epoch_batches(
                shard=self.rank, start=skip if epoch == first_epoch else 0)
            for kind, batch in step_groups(batches, K):
                # one rank drains at a call boundary; several agree at the
                # epoch's end first, or a rank would block in the next
                # step's collectives
                if self.world_size == 1 and self._preempted:
                    break
                dev_batch = self.to_device(batch)
                dn = K if kind == "stacked" else 1
                step = self.multi_step if kind == "stacked" else self.train_step
                self.state, metrics = step(self.state, dev_batch)
                step_losses.append(metrics["loss"].reshape(-1))
                host_step += dn
                if (self.health_monitor is not None and self.health_feed.push(
                        host_step - dn, metrics.pop("health"), dev_batch) == "halt"):
                    # the stats are the same on every rank, so is the
                    # verdict: every rank stops at the end of this call
                    self._health_halted = host_step
                    break
                if timed:
                    throughput.add(int(batch["mask"].sum()))
                    timed_steps += dn
                # a fused group saves once, at the boundary it crosses
                if (self.checkpointer is not None and c.checkpoint_steps
                        and host_step // c.checkpoint_steps
                        > (host_step - dn) // c.checkpoint_steps):
                    self._save(host_step)
            if self.health_monitor is not None:
                self.health_feed.flush()
            # one sync an epoch
            losses = (torch.cat(step_losses).cpu().numpy() if step_losses
                      else np.zeros(0, np.float32))
            if timed:
                throughput.stop()
            self.history["step_loss"].extend(float(x) for x in losses)
            if agree_any(self._preempted):
                self.logger.log_text(
                    f"preempted at step {host_step} (epoch {epoch}): "
                    + ("saving final checkpoint" if self.checkpointer else
                       "no --checkpoint-dir, progress will NOT survive"))
                out["preempted"] = True
                break
            if self._health_halted is not None:
                self.logger.log_text(
                    f"health anomaly at step {self._health_halted} with policy "
                    "'halt': stopping training"
                    + (" (saving final checkpoint)" if self.checkpointer else ""))
                out["health_halted"] = True
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
                acc, loss = self.evaluate()
                self.history.setdefault("test_loss", []).append(loss)
                if self.with_accuracy:   # no accuracy for multi-hot targets
                    self.logger.log(host_step, test_accuracy=acc, test_loss=loss)
                    self.history.setdefault("test_accuracy", []).append(acc)
                    if self.best_checkpointer and acc > self._best_acc:
                        self._save_best(acc)
                else:
                    self.logger.log(host_step, test_loss=loss)
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
        out.update({"total_seconds": total, "steps": int(self.state.step),
                    "images_per_sec_per_chip": ips,
                    "steady_step_ms": throughput.seconds / max(timed_steps, 1) * 1e3,
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
        params are replicated, so every rank answers the same)."""
        params = list(self.state.params().values())
        bad = torch.stack([(~torch.isfinite(p)).any() for p in params]).any()
        return not bool(bad)

    def close(self) -> None:
        """Finish in-flight saves and close the metric sinks and the health
        record."""
        for ck in (self.checkpointer, self.best_checkpointer):
            if ck is not None:
                ck.close()
        if self.health_monitor is not None:
            self.health_monitor.close()
        self.logger.close()

    def _eval_params(self):
        """The weights evaluation reads in place of the model's: the EMA
        shadow when ``ema_decay`` is on (under ZeRO-1 gathered from the
        ranks' shards and unflattened, a collective), else None."""
        if not self.config.ema_decay:
            return None
        ema = self.state.opt_state.ema
        return ema if self.zero1 is None else self.zero1.gather_params(ema)

    def evaluate(self) -> tuple:
        """(accuracy, loss) over the test set; the EMA weights when
        ``ema_decay`` is on. One host sync for the whole pass."""
        ema = self._eval_params()
        outs = [self.eval_step(self.state, self.to_device(b), ema)
                for b in self.test_loader.epoch_batches(epoch=0, shard=self.rank)]
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
                for b in loader.epoch_batches(epoch=0, shard=self.rank)]
        local = torch.stack(outs).float()                # (batches, rows, classes)
        if self.world_size > 1:
            gathered = all_gather_bytes(local.reshape(-1))
            local = gathered.view(self.world_size, *local.shape).transpose(0, 1)
        logits = local.reshape(-1, local.shape[-1]).cpu().numpy()
        index = list(loader.epoch_index_batches(epoch=0))
        mask = np.concatenate([m for _, m in index])
        labels = np.asarray(loader.labels)[np.concatenate([i for i, _ in index])]
        return logits[mask], labels[mask]
