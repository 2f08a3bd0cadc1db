"""``python -m tpu_ddp_torch.cli.train`` — the port's training CLI.

Counterpart of ``tpu_ddp/cli/train.py`` (``build_parser``, ``main`` :609,
``_run_and_report`` :635) for this slice's flags, with the JAX CLI's names,
defaults and help. It trains on the GPU unless ``--device cpu`` is given,
and refuses to start without one otherwise. A run drained by SIGTERM or
SIGINT has saved its checkpoint and skips the final evaluation;
``--resume`` continues it at the step it stopped at. Started by
``python -m tpu_ddp_torch.cli.launch``, it joins the launcher's process
group first and trains data-parallel over the ranks (``--dist-backend``,
a flag the JAX CLI does not need: one JAX process drives every device).
"""

from __future__ import annotations

import argparse

from tpu_ddp_torch.models import MODEL_REGISTRY
from tpu_ddp_torch.parallel.runtime import BACKENDS, initialize_distributed, shutdown
from tpu_ddp_torch.runtime import DEVICES
from tpu_ddp_torch.train.trainer import COMPUTE_DTYPES, DATASETS, TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpu_ddp_torch trainer")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="cuda (default) demands a GPU; cpu runs on the CPU")
    p.add_argument("--data-dir", default="data/CIFAR-10")
    p.add_argument("--dataset", choices=sorted(DATASETS), default="cifar10",
                   help="cifar100 = the scale-out recipe (its 100 fine "
                        "labels; --num-classes follows)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="class-conditional synthetic CIFAR (no dataset needed)")
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--synthetic-task", choices=["easy", "hard"], default="easy",
                   help="easy: color blobs (saturates at 1.0); hard: "
                        "shift-invariant zero-mean textures + train-label "
                        "noise (bounded ceiling)")
    p.add_argument("--synthetic-label-noise", type=float, default=0.1,
                   help="hard task: fraction of TRAIN labels flipped to "
                        "uniform-random classes")
    p.add_argument("--epochs", type=int, default=99)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-device batch (the reference's per-process 32)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--optimizer", choices=["sgd", "adamw"], default="sgd")
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--schedule", choices=["constant", "cosine"], default="constant")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-clip-norm", type=float, default=0.0,
                   help="clip the global gradient norm before the update (0 = off)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="exponential moving average of the params (0 = off); "
                        "eval uses the averaged weights")
    p.add_argument("--kernels", action="store_true",
                   help="send the optimizer update through the fused CUDA "
                        "kernel (ops/csrc/fused_update.cu), one pass per "
                        "leaf, and the int8 ring's quantize and "
                        "dequantize(-accumulate) through the CUDA kernels "
                        "of ops/csrc/fused_quant.cu")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding (dp): reduce-"
                        "scatter gradients instead of all-reducing them, "
                        "apply the optimizer to only this replica's 1/N "
                        "shard of params + optimizer state (the state "
                        "lives scattered — ~1/N the optimizer HBM and "
                        "update FLOPs), then all-gather the updated "
                        "params. Identical training math")
    p.add_argument("--grad-compress", choices=["none", "bf16", "int8"],
                   default="none",
                   help="quantize the gradient sync's wire payloads: the "
                        "all-reduce becomes a ring whose hops carry "
                        "block-scaled int8 (~4x fewer bytes) or bf16 (2x) "
                        "while accumulation stays f32 on the device")
    p.add_argument("--grad-compress-block", type=int, default=256,
                   metavar="N",
                   help="int8 mode: elements sharing one f32 max-abs "
                        "scale (smaller = tighter error, more scale "
                        "bytes on the wire)")
    p.add_argument("--grad-compress-error-feedback", action="store_true",
                   help="carry each rank's quantization error and add it "
                        "back into the next step's gradient (keeps "
                        "long-run convergence unbiased)")
    p.add_argument("--dist-backend", choices=BACKENDS, default=None,
                   help="process-group backend under the launcher: nccl "
                        "(default on cuda; one card a rank) or gloo "
                        "(default on cpu; on cuda ranks may share a card "
                        "and the ring's wire bytes go through host memory)")
    p.add_argument("--model", choices=["netresdeep", *sorted(MODEL_REGISTRY)],
                   default="netresdeep")
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: derived from --dataset (cifar10=10, "
                        "cifar100=100)")
    p.add_argument("--freeze", nargs="*", default=None, metavar="PREFIX",
                   help="train ONLY params whose top module starts with one "
                        "of these prefixes (e.g. --freeze head)")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="soft CE targets (0.1 typical)")
    p.add_argument("--loss", choices=["ce", "bce"], default="ce",
                   help="bce = multi-label (the fine-tune workload)")
    p.add_argument("--pretrained-dir", default=None,
                   help="fine-tune: partial restore + head swap from this "
                        "checkpoint dir, or from a torchvision-layout state "
                        "dict file (.pt/.pth/.npz), strict=False semantics")
    p.add_argument("--attention", choices=["full", "flash"], default="full",
                   help="flash = the CUDA flash-attention kernels "
                        "(ops/csrc/flash_attention.cu, forward and backward), "
                        "ViT-family models")
    p.add_argument("--compute-dtype", choices=list(COMPUTE_DTYPES),
                   default="float32",
                   help="bfloat16 runs the forward/backward in bf16 on the "
                        "tensor cores (K4-K6's bf16 kernels under --attention "
                        "flash); params/loss stay f32")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the forward in backward: per block "
                        "for the ViT family, the whole forward otherwise "
                        "(BatchNorm's running stats move once a step)")
    p.add_argument("--n-chans1", type=int, default=32, help="NetResDeep width")
    p.add_argument("--n-blocks", type=int, default=10, help="NetResDeep depth")
    p.add_argument("--untied-blocks", action="store_true",
                   help="independent ResBlocks (the reference ties them)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--eval-each-epoch", action="store_true")
    p.add_argument("--log-every-epochs", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every-epochs", type=int, default=10)
    p.add_argument("--checkpoint-steps", type=int, default=0, metavar="N",
                   help=">0: ALSO save a checkpoint every N global steps "
                        "(mid-epoch, async)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training: restore (--resume from "
                        "--checkpoint-dir) and run the test-set eval")
    p.add_argument("--keep-best", action="store_true",
                   help="also retain the best-test-accuracy checkpoint "
                        "under <checkpoint-dir>/best (needs "
                        "--eval-each-epoch; best step + accuracy recorded "
                        "in best/metadata.json)")
    p.add_argument("--jsonl", default=None, help="metrics JSONL path")
    p.add_argument("--tensorboard-dir", default=None,
                   help="write TensorBoard scalar events here "
                        "(process-0 only), alongside --jsonl")
    p.add_argument("--health", choices=["off", "on"], default="off",
                   help="numerics flight recorder: global grad/param/"
                        "update norms + NaN/Inf sentinels computed on the "
                        "device inside the step every step, recorded to "
                        "health-p<rank>.jsonl (under --health-dir), with a "
                        "loss-spike detector and a one-shot anomaly dump to "
                        "<dir>/anomalies/. Read back with `python -m "
                        "tpu_ddp_torch.health DIR`")
    p.add_argument("--health-policy",
                   choices=["warn", "skip_step", "halt"], default="warn",
                   help="on an anomaly: warn (log + dump), skip_step "
                        "(a guard in the step discards NaN/Inf updates — "
                        "optimizer state stays in sync, training "
                        "continues; loss spikes are recorded but still "
                        "applied), halt (drain + final checkpoint on any "
                        "anomaly)")
    p.add_argument("--health-per-layer-stride", type=int, default=0,
                   metavar="N",
                   help=">0: also compute the per-layer grad/param norm "
                        "breakdown in the step, recording it every N steps "
                        "(and always into anomaly dumps)")
    p.add_argument("--health-dir", default=None, metavar="DIR",
                   help="where health records + anomaly dumps go (none: "
                        "nothing is written)")
    p.add_argument("--health-window", type=int, default=128,
                   help="loss-spike detector rolling window (steps)")
    p.add_argument("--health-spike-threshold", type=float, default=10.0,
                   metavar="K",
                   help="spike when loss > median + K * MAD of the window")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        device=args.device,
        data_dir=args.data_dir,
        dataset=args.dataset,
        synthetic_data=args.synthetic_data,
        synthetic_size=args.synthetic_size,
        synthetic_task=args.synthetic_task,
        synthetic_label_noise=args.synthetic_label_noise,
        epochs=args.epochs,
        per_shard_batch=args.batch_size,
        lr=args.lr,
        optimizer=args.optimizer,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        schedule=None if args.schedule == "constant" else args.schedule,
        warmup_steps=args.warmup_steps,
        grad_clip_norm=args.grad_clip_norm,
        ema_decay=args.ema_decay,
        kernels=args.kernels,
        zero1=args.zero1,
        grad_compress=args.grad_compress,
        grad_compress_block=args.grad_compress_block,
        grad_compress_error_feedback=args.grad_compress_error_feedback,
        dist_backend=args.dist_backend,
        model=args.model,
        attention=args.attention,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        n_chans1=args.n_chans1,
        n_blocks=args.n_blocks,
        tied_blocks=not args.untied_blocks,
        num_classes=(args.num_classes if args.num_classes is not None
                     else DATASETS[args.dataset][1]),
        loss=args.loss,
        label_smoothing=args.label_smoothing,
        freeze_prefixes=tuple(args.freeze) if args.freeze else None,
        pretrained_dir=args.pretrained_dir,
        seed=args.seed,
        eval_each_epoch=args.eval_each_epoch,
        log_every_epochs=args.log_every_epochs,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_epochs=args.checkpoint_every_epochs,
        checkpoint_steps=args.checkpoint_steps,
        keep_best=args.keep_best,
        resume=args.resume,
        jsonl_path=args.jsonl,
        tensorboard_dir=args.tensorboard_dir,
        shuffle=not args.no_shuffle,
        health=args.health,
        health_policy=args.health_policy,
        health_per_layer_stride=args.health_per_layer_stride,
        health_dir=args.health_dir,
        health_window=args.health_window,
        health_spike_threshold=args.health_spike_threshold,
    )


def run(argv=None) -> tuple:
    """``main``, returning ``(trainer, metrics)``."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    initialize_distributed(config.device, config.dist_backend)
    try:
        if args.eval_only and not (config.resume and config.checkpoint_dir
                                   or config.pretrained_dir):
            raise SystemExit(
                "--eval-only needs weights: --checkpoint-dir ... --resume, "
                "or --pretrained-dir ..."
            )
        trainer = Trainer(config)
        try:
            metrics = _run_and_report(args, config, trainer)
        finally:
            trainer.close()
    finally:
        shutdown()
    return trainer, metrics


def _run_and_report(args, config, trainer) -> dict:
    if args.eval_only and config.resume and trainer.resumed_step is None:
        # the mode whose whole purpose is loading weights must not evaluate
        # the random initialisation when the checkpoint dir is empty
        raise SystemExit(
            f"--eval-only: no checkpoint found under "
            f"{config.checkpoint_dir!r} to resume from"
        )
    metrics = {"eval_only": True} if args.eval_only else trainer.run()
    if metrics.get("preempted"):
        # drained: the checkpoint is written, and every second of the final
        # eval eats into the kill's grace window
        trainer.logger.log_text(
            "preempted: skipping final eval/prediction outputs "
            "(resume with --resume)")
        metrics.setdefault("test_accuracy", float("nan"))
        return metrics
    acc, loss = trainer.evaluate()
    if trainer.with_accuracy:
        trainer.logger.log_text(
            f"final test accuracy: {acc:.4f}, test loss: {loss:.4f}")
        metrics["test_accuracy"] = acc
    else:   # accuracy is undefined for multi-hot targets
        trainer.logger.log_text(f"final test loss: {loss:.4f}")
    metrics.update(test_loss=loss, eval_batches=trainer.eval_batches)
    return metrics


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
