"""``python -m tpu_ddp_torch.cli.train`` — the port's training CLI.

Counterpart of ``tpu_ddp/cli/train.py`` (``build_parser``, ``main`` :609,
``_run_and_report`` :635) for this slice's flags, with the JAX CLI's names,
defaults and help. After the final evaluation ``--dump-predictions`` and
``--viz-predictions`` run the test set's batch inference (:670-737). It
trains on the GPU unless ``--device cpu`` is given, and refuses to start
without one otherwise. A run drained by SIGTERM or
SIGINT has saved its checkpoint and skips the final evaluation;
``--resume`` continues it at the step it stopped at. Started by
``python -m tpu_ddp_torch.cli.launch``, it joins the launcher's process
group first and trains data-parallel over the ranks (``--dist-backend``,
a flag the JAX CLI does not need: one JAX process drives every device).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tpu_ddp_torch.metrics.evaluation import mean_average_precision, multilabel_predictions
from tpu_ddp_torch.models import MODEL_REGISTRY
from tpu_ddp_torch.parallel.runtime import (
    BACKENDS,
    initialize_distributed,
    is_primary_process,
    shutdown,
)
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
    p.add_argument("--mixup-alpha", type=float, default=0.0,
                   help="on-device mixup: one Beta(alpha,alpha) lambda per "
                        "shard step blends images and the CE loss "
                        "(0 = off, typical 0.2); composes with --augment")
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
    p.add_argument("--augment", action="store_true",
                   help="on-device random crop+flip (the reference has no "
                        "augmentation; needed for the 93%% target)")
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--eval-each-epoch", action="store_true")
    p.add_argument("--log-every-epochs", type=int, default=10)
    p.add_argument("--viz-predictions", default=None, metavar="DIR",
                   help="write predictions.png (pred-vs-true image grid) + "
                        "confusion_matrix.png after the final eval — the "
                        "classification analogue of the reference's "
                        "prediction drawing (ppe_main_ddp.py:355-396)")
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
    p.add_argument("--plot-curves", default=None, metavar="PNG",
                   help="write loss-curve PNG at end (ppe_main_ddp.py:176-181)")
    p.add_argument("--dump-predictions", default=None, metavar="JSON",
                   help="batch-infer the test set and dump predictions "
                        "(ppe_main_ddp.py:310-396)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help=">1 runs K optimizer steps per call over K stacked "
                        "batches (one host-to-device copy a group) — "
                        "semantics unchanged")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help=">1 splits each optimizer step into K sequential "
                        "microbatches (gradient accumulation): same "
                        "semantics, ~1/K activation memory — the big-"
                        "global-batch knob")
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
        augment=args.augment,
        mixup_alpha=args.mixup_alpha,
        steps_per_call=args.steps_per_call,
        grad_accum_steps=args.grad_accum_steps,
        plot_curves=args.plot_curves,
        dump_predictions=args.dump_predictions,
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
    if args.dump_predictions or args.viz_predictions:
        _predictions(args, config, trainer, metrics)
    return metrics


def _predictions(args, config, trainer, metrics) -> None:
    """The post-training batch inference of the JAX CLI (:670-737): the
    test set's predictions (argmax, or BCE's thresholded sigmoid with the
    mAP logged) dumped as JSON, and the prediction grid and confusion
    matrix; ``Trainer.predict`` is a collective, every rank runs it, rank 0
    writes."""
    logits, labels = trainer.predict()
    if config.loss == "bce":
        scores = 1.0 / (1.0 + np.exp(-logits))
        ap = mean_average_precision(scores, labels)
        trainer.logger.log_text(f"test mAP: {ap['mAP']:.4f}")
        metrics["test_mAP"] = ap["mAP"]
        preds = multilabel_predictions(scores)
    else:
        preds = np.argmax(logits, axis=-1)
    if not is_primary_process():
        return
    if args.dump_predictions:
        with open(args.dump_predictions, "w") as f:
            json.dump({"predictions": np.asarray(preds).tolist(),
                       "labels": np.asarray(labels).tolist()}, f)
        trainer.logger.log_text(f"predictions -> {args.dump_predictions}")
    if args.viz_predictions:
        if config.loss != "ce":
            trainer.logger.log_text(
                "--viz-predictions skipped: class-grid/confusion images need "
                "class-index labels (--loss ce); use the mAP/PR plots for multi-label")
            return
        from tpu_ddp_torch.metrics.visualization import save_prediction_artifacts

        # predict() gives rows in sampler order, not dataset order: each
        # prediction's dataset row comes from the loader's own index stream
        row_order = np.concatenate([idx[mask] for idx, mask in
                                    trainer.test_loader.epoch_index_batches(epoch=0)])
        paths = save_prediction_artifacts(
            trainer.test_loader.images[row_order], np.asarray(labels), np.asarray(preds),
            args.viz_predictions, num_classes=config.num_classes)
        trainer.logger.log_text(
            f"prediction viz -> {paths['grid']}, {paths['confusion_matrix']}")


def main(argv=None) -> dict:
    return run(argv)[1]


if __name__ == "__main__":
    main()
