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

Not ported yet: checkpointing and resume, telemetry, health, preemption,
the strategies other than data parallelism (zero3, fsdp, tp, pp).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpu_ddp_torch.data.cifar10 import load_cifar10, synthetic_cifar10
from tpu_ddp_torch.data.loader import ShardedBatchLoader
from tpu_ddp_torch.metrics.logging import MetricLogger
from tpu_ddp_torch.metrics.timing import Throughput
from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
from tpu_ddp_torch.parallel.compression import MODES as COMPRESS_MODES
from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
from tpu_ddp_torch.parallel.runtime import rank, world_size
from tpu_ddp_torch.runtime import resolve_device, set_float32_precision
from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_eval_step, make_train_step


@dataclasses.dataclass
class TrainConfig:
    """The fields the port's CLI flags set (names and defaults as in the
    JAX ``TrainConfig``)."""

    device: str = "cuda"
    data_dir: str = "data/CIFAR-10"
    synthetic_data: bool = False
    synthetic_size: int = 2048
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
    n_chans1: int = 32
    n_blocks: int = 10
    tied_blocks: bool = True
    seed: int = 0
    eval_each_epoch: bool = False
    log_every_epochs: int = 10

    def __post_init__(self):
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


NUM_CLASSES = 10  # CIFAR-10


def build_model(c: TrainConfig, image_size: int = 32) -> torch.nn.Module:
    """NetResDeep, or a registry model (``models/zoo.py``) for square
    inputs of ``image_size`` (CIFAR's 32 by default), with weights from
    ``c.seed``. ``attention == "flash"`` binds the port's
    ``flash_attention`` into the model's ``attention_impl`` (the JAX
    ``build_model`` :564-578); on a model without one, NetResDeep included,
    it raises (the JAX package builds NetResDeep before it reads the flag
    and ignores it there)."""
    generator = torch.Generator().manual_seed(c.seed)
    name = c.model.lower()
    if name == "netresdeep":
        model = NetResDeep(n_chans1=c.n_chans1, n_blocks=c.n_blocks,
                           num_classes=NUM_CLASSES, tied=c.tied_blocks,
                           generator=generator)
    elif name in MODEL_REGISTRY:
        model = MODEL_REGISTRY[name](num_classes=NUM_CLASSES, generator=generator,
                                     image_size=image_size)
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
    """(train, test) ``(images, labels)`` tuples, as the JAX trainer's."""
    if c.synthetic_data:
        test_size = max(c.synthetic_size // 5, 64)
        return (synthetic_cifar10(c.synthetic_size, NUM_CLASSES, c.seed),
                synthetic_cifar10(test_size, NUM_CLASSES, c.seed + 1))
    return load_cifar10(c.data_dir, train=True), load_cifar10(c.data_dir, train=False)


class Trainer:
    def __init__(self, config: TrainConfig):
        c = self.config = config
        self.device = resolve_device(c.device)
        set_float32_precision()
        self.logger = MetricLogger()
        self.rank, self.world_size = rank(), world_size()
        train_data, test_data = load_dataset(c)
        self.train_loader = ShardedBatchLoader(
            *train_data, world_size=self.world_size,
            per_shard_batch=c.per_shard_batch, seed=c.seed)
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
        )
        self.zero1 = (Zero1Partition(self.tx, params, self.world_size)
                      if c.zero1 else None)
        self.state = create_train_state(model, self.tx, self.device, zero1=self.zero1)
        self.compress = self._build_compressor()
        if self.zero1 is not None and self.compress is not None:
            self.zero1.set_compression(self.compress)
        if self.compress is not None and c.grad_compress_error_feedback:
            self.state.grad_residual = self.compress.init_residual(self.device)
        self.train_step = make_train_step(self.tx, compress=self.compress,
                                          zero1=self.zero1)
        self.eval_step = make_eval_step()
        self.history = {"train_loss": [], "step_loss": []}
        self.eval_batches = 0  # eval steps run so far (every evaluate call)

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

    def to_device(self, batch: dict):
        return batch_to_device(batch, self.device)

    def run(self) -> dict:
        c = self.config
        start = time.time()
        # steady state: every epoch after the first (which pays the kernel
        # build and cuDNN's first-call setup); a 1-epoch run times it all
        throughput = Throughput(self.device)
        timed_steps = 0
        metrics = {}
        for epoch in range(1, c.epochs + 1):
            timed = epoch >= 2 or c.epochs == 1
            if timed:
                throughput.start()
            self.train_loader.set_epoch(epoch)
            step_losses = []
            for batch in self.train_loader.epoch_batches(shard=self.rank):
                self.state, metrics = self.train_step(self.state, self.to_device(batch))
                step_losses.append(metrics["loss"])
                if timed:
                    throughput.add(int(batch["mask"].sum()))
                    timed_steps += 1
            losses = torch.stack(step_losses).cpu().numpy()  # one sync an epoch
            if timed:
                throughput.stop()
            mean_loss = float(np.mean(losses))
            self.history["train_loss"].append(mean_loss)
            self.history["step_loss"].extend(float(x) for x in losses)
            if epoch == 1 or epoch % c.log_every_epochs == 0:
                self.logger.log_text(f"Epoch {epoch}, Training loss {mean_loss}")
                self.logger.log(int(self.state.step), epoch=epoch,
                                train_loss=mean_loss,
                                train_accuracy=float(metrics["accuracy"]))
            if c.eval_each_epoch:
                acc, loss = self.evaluate()
                self.logger.log(int(self.state.step), test_accuracy=acc,
                                test_loss=loss)
        total = time.time() - start
        self.logger.log_text(f"training time: {total:.3f} seconds")
        ips = throughput.images_per_sec_per_chip
        per = "chip" if self.world_size == 1 else "rank"
        self.logger.log_text(
            f"steady-state images/sec/{per}: {ips:.1f} "
            f"({throughput.images} images in {throughput.seconds:.3f} s)")
        return {"total_seconds": total, "steps": int(self.state.step),
                "images_per_sec_per_chip": ips,
                "steady_step_ms": throughput.seconds / max(timed_steps, 1) * 1e3,
                "train_loss": self.history["train_loss"][-1]
                if self.history["train_loss"] else float("nan"),
                "step_losses": list(self.history["step_loss"])}

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
