"""``python -m tpu_ddp_torch.cli.train`` — the port's training CLI.

Counterpart of ``tpu_ddp/cli/train.py`` (``build_parser``, ``main`` :609,
``_run_and_report`` :635, ``run_cv`` :546) for this slice's flags, with the
JAX CLI's names, defaults and help. ``--global-batch-size`` is divided by the
mesh's data axis (the JAX :426-450), of the launched world size or
``--n-devices`` where given. ``--parallelism``, ``--mesh`` and
``--sp-flash`` (the JAX :64, :123, :158) route the run to a family
(``train/strategy.py``): dp; sp, sequence parallelism with ring
attention over the ``sequence`` axis; tp, fsdp and fsdp_tp, the GSPMD
families over the ``data`` and ``model`` axes
(``parallel/tensor_parallel.py``); pp, the pipeline over the ``pipeline``
axis (``--microbatches``, ``--pp-schedule``, :128-138); ep, the MoE ViT's
experts over the ``expert`` axis (``--aux-weight`` :139 weighs its
load-balance loss under every family). ``--cv-mode K`` runs k-fold cross-validation
over the train split instead of one run. After the final evaluation ``--dump-predictions`` and
``--viz-predictions`` run the test set's batch inference (:670-737). It
trains on the GPU unless ``--device cpu`` is given, and refuses to start
without one otherwise. A run drained by SIGTERM or
SIGINT has saved its checkpoint and skips the final evaluation;
``--resume`` continues it at the step it stopped at. ``--telemetry-dir``
and its flags (the JAX :237-252, :273-285, :387-391) turn the trainer's
telemetry on; the sinks close after the final evaluation is recorded
(``Trainer.record_final_eval``, the JAX :629), so the trace is a whole run
record. The live observatories' flags (the JAX :218-270:
``--profile-dir``, ``--profile-steps``, ``--profile-window-steps``,
``--profile-host-hz``, ``--monitor-port``, ``--monitor-bind``,
``--monitor-allow-remote-trigger``) reach the trainer's capture manager,
epoch trace and exporter; ``mem_sample_steps`` is a config field with no
flag, as in JAX. ``--chaos SPEC.JSON`` and ``--comms-monitor`` (the JAX
:287-301) turn on fault injection and the ring's hop monitor. Started by
``python -m tpu_ddp_torch.cli.launch``, it joins the launcher's process
group first and trains data-parallel over the ranks (``--dist-backend``,
a flag the JAX CLI does not need: one JAX process drives every device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

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
from tpu_ddp_torch.train.strategy import default_mesh_sizes, infer_parallelism, parse_mesh_arg
from tpu_ddp_torch.train.trainer import COMPUTE_DTYPES, DATASETS, TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tpu_ddp_torch trainer")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="cuda (default) demands a GPU; cpu runs on the CPU")
    p.add_argument("--data-dir", default="data/CIFAR-10")
    p.add_argument("--download", action="store_true",
                   help="fetch + md5-verify the canonical dataset tarball "
                        "into --data-dir when absent (the reference's "
                        "datasets.CIFAR10 download=True convenience)")
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
    p.add_argument("--global-batch-size", type=int, default=None,
                   help="fix the GLOBAL batch instead (sane mode; divided "
                        "across devices)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--optimizer", choices=["sgd", "adamw", "lamb"],
                   default="sgd",
                   help="sgd = the reference family (main.py:27); adamw = "
                        "the ViT-family recipe; lamb = layer-wise-adaptive "
                        "large-global-batch training (no --kernels: K1 has "
                        "no lamb branch)")
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
    p.add_argument("--n-devices", type=int, default=None,
                   help="1 == the main_no_ddp.py single-device baseline; "
                        "a rank owns one card, so N must equal the "
                        "launched world size")
    p.add_argument("--parallelism",
                   choices=["dp", "fsdp", "tp", "fsdp_tp", "pp", "sp", "ep"],
                   default=None,
                   help="scale-out strategy: dp (default), sp (sequence "
                        "parallel + ring attention over the sequence axis), "
                        "tp (tensor parallel over the model axis), fsdp "
                        "(params and optimizer state scattered over data), "
                        "fsdp_tp (both), pp (pipeline stages over the "
                        "pipeline axis, ViT family), ep (MoE experts over "
                        "the expert axis). Default: inferred from --mesh, "
                        "else dp")
    p.add_argument("--mesh", default=None, metavar="AXES",
                   help="rank grid axis sizes, e.g. data=2,sequence=2 "
                        "(axes: data, pipeline, expert, sequence, model; "
                        "-1 = rest). Naming a "
                        "non-data axis infers the matching --parallelism")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (pp only); more "
                        "microbatches = smaller bubble, and under "
                        "--pp-schedule 1f1b activation memory stays O(S) "
                        "regardless")
    p.add_argument("--pp-schedule", choices=["gpipe", "1f1b"],
                   default="gpipe",
                   help="pipeline schedule (pp only): gpipe = autodiff "
                        "backward, O(M) stored activations; 1f1b = "
                        "interleaved manual backward with per-stage "
                        "recompute, O(S) in-flight activations")
    p.add_argument("--aux-weight", type=float, default=0.01,
                   help="MoE load-balance loss weight (MoE models only)")
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
    p.add_argument("--zero3", action="store_true",
                   help="ZeRO-3 parameter streaming (dp): params live "
                        "permanently scattered in the same flat update "
                        "space as --zero1's optimizer state (1/N param + "
                        "1/N optimizer HBM per chip); the forward "
                        "all-gathers them block by block with the next "
                        "block's gather prefetched under the current "
                        "block's compute, and the backward reduce-"
                        "scatters grads straight into shard space — no "
                        "full-param re-gather. Same training math; "
                        "checkpoints stay in the replicated layout so "
                        "--resume composes across zero3/zero1/replicated "
                        "and device counts")
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
    p.add_argument("--sync-bn", action="store_true",
                   help="BatchNorm statistics over all ranks (one "
                        "all-reduce a BatchNorm call, and one in the "
                        "backward)")
    p.add_argument("--attention", choices=["full", "flash"], default="full",
                   help="flash = the CUDA flash-attention kernels "
                        "(ops/csrc/flash_attention.cu, forward and backward), "
                        "ViT-family models")
    p.add_argument("--sp-flash", action="store_true",
                   help="sequence-parallel runs with flash-kernel "
                        "ring-attention blocks (K4-K6 a ring hop; the "
                        "long-context config)")
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
    p.add_argument("--faithful-epoch-order", action="store_true",
                   help="reproduce the missing set_epoch(): same order every epoch")
    p.add_argument("--eval-each-epoch", action="store_true")
    p.add_argument("--log-every-epochs", type=int, default=10)
    p.add_argument("--log-every-steps", type=int, default=None,
                   help="also log an in-epoch progress line every N steps "
                        "(the reference's per-100-iter print, "
                        "ppe_main_ddp.py:151-152); each line costs one "
                        "host sync")
    p.add_argument("--cv-mode", type=int, default=None, metavar="K",
                   help="k-fold cross-validation over the train split "
                        "(the reference's -cv_mode, ppe_main_ddp.py:28-37,"
                        "91-93): trains K models, reports per-fold and "
                        "mean val accuracy; checkpointing disabled per fold")
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
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches assembled ahead on the native host "
                        "prefetcher (C++ ring buffer, pinned slots on the "
                        "card; 0 disables)")
    p.add_argument("--prefetch-batches", type=int, default=0,
                   help="batches buffered ahead by the STAGED background "
                        "prefetcher: the loader's own generator on a thread, "
                        "bit-identical batch stream; takes precedence over "
                        "--prefetch-depth (0 = off)")
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
                        "tpu_ddp_torch.cli.main health DIR`")
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
    p.add_argument("--telemetry-dir", default=None, metavar="DIR",
                   help="enable structured telemetry into this run dir: "
                        "per-rank schema-versioned JSONL trace + Chrome "
                        "trace_event JSON (Perfetto-loadable) + terminal "
                        "phase summary; read back with `python -m "
                        "tpu_ddp_torch.cli.main trace summarize DIR`. Adds a "
                        "per-step device fence for phase attribution")
    p.add_argument("--telemetry-sinks", default="jsonl,chrome,summary",
                   metavar="LIST",
                   help="comma-separated subset of jsonl,chrome,summary")
    p.add_argument("--telemetry-snapshot-steps", type=int, default=50,
                   metavar="N",
                   help="flush a counters snapshot into the JSONL trace "
                        "every N steps so a killed run leaves a usable tail "
                        "(0 disables; epoch-end and final snapshots always "
                        "happen)")
    p.add_argument("--watchdog-deadline", type=float, default=0.0,
                   metavar="SECONDS",
                   help=">0: hang watchdog — every rank writes a heartbeat "
                        "file (under --telemetry-dir) per step and dumps all "
                        "thread stacks when no step completes within the "
                        "deadline")
    p.add_argument("--watchdog-abort", action="store_true",
                   help="escalate a watchdog firing: after the stack dump, "
                        "exit the wedged process with code 113 so a "
                        "supervisor can restart it")
    p.add_argument("--chaos", default=None, metavar="SPEC.JSON",
                   help="deterministic fault injection: step-triggered "
                        "kill-host / hang / checkpoint-corrupt / "
                        "save-io-flake / data-stall faults on configured "
                        "hosts, seeded and fire-once per logical run "
                        "(state in --telemetry-dir) — the elastic "
                        "runtime's CI harness (docs/resilience.md)")
    p.add_argument("--comms-monitor", action="store_true",
                   help="instrument the quantized ring collectives with "
                        "a per-hop host callback: live per-axis achieved "
                        "bandwidth + the in-flight collective land in "
                        "comms-health-p<host>.json (under "
                        "--telemetry-dir), and a watchdog hang writes a "
                        "forensics bundle naming the suspect collective "
                        "(docs/comms.md). Changes the traced program, so "
                        "it refuses --lint-on-start")
    p.add_argument("--no-data-digests", dest="data_digests",
                   action="store_false", default=True,
                   help="skip the per-step batch-content digest sink "
                        "(data-p<i>.jsonl) under --telemetry-dir")
    p.add_argument("--profile-dir", default=None,
                   help="emit a torch.profiler trace (Chrome trace JSON, "
                        "Perfetto-loadable) for one steady-state epoch")
    p.add_argument("--profile-steps", default=None, metavar="A:B",
                   help="arm an anomaly-profiler capture window over "
                        "global steps (A, B]: host stack sampling + "
                        "device trace + measured phases, bundled under "
                        "<telemetry-dir>/profiles/ and read back with "
                        "`tpu-ddp-torch profile`. Windows can also be armed "
                        "on a LIVE run: POST /profile?steps=N to "
                        "--monitor-port, or the capture_profile alert "
                        "action on `tpu-ddp-torch watch`")
    p.add_argument("--profile-window-steps", type=int, default=8,
                   metavar="N",
                   help="window length (steps) for live-triggered "
                        "captures (POST /profile or alert-armed)")
    p.add_argument("--profile-host-hz", type=float, default=97.0,
                   metavar="HZ",
                   help="host stack sampler rate inside a capture window")
    p.add_argument("--monitor-port", type=int, default=0, metavar="PORT",
                   help="per-rank live monitor HTTP endpoint: /metrics "
                        "(OpenMetrics, labeled with run id/strategy/"
                        "mesh/rank), /snapshot.json, /healthz (watchdog "
                        "heartbeat freshness). 0 = disabled, -1 = "
                        "ephemeral port (recorded in exporter-p<i>.json "
                        "under --telemetry-dir). See `tpu-ddp-torch watch`")
    p.add_argument("--monitor-bind", default="0.0.0.0", metavar="ADDR",
                   help="monitor endpoint bind address. The endpoint is "
                        "UNauthenticated and /snapshot.json serves the "
                        "run config — bind 127.0.0.1 (and scrape via a "
                        "tunnel) on untrusted networks")
    p.add_argument("--monitor-allow-remote-trigger", action="store_true",
                   help="accept POST /profile from non-loopback peers "
                        "(default: loopback-only — the endpoint is "
                        "unauthenticated, and this route mutates run "
                        "behavior)")
    return p


def data_world(n_devices=None, mesh_sizes=None, parallelism=None) -> int:
    """The data axis the run will have: of ``--n-devices`` ranks where
    given, else of the launcher's ``WORLD_SIZE`` (1 without the launcher),
    the mesh's data axis, including the default mesh a bare
    ``--parallelism`` implies (the JAX :426-445)."""
    total = n_devices or int(os.environ.get("WORLD_SIZE", "1"))
    sizes = mesh_sizes or default_mesh_sizes(infer_parallelism(mesh_sizes, parallelism))
    data = sizes.get("data", -1)
    if data == -1:
        data = total // math.prod(v for v in sizes.values() if v != -1)
    return data


def config_from_args(args) -> TrainConfig:
    per_shard = args.batch_size
    mesh_sizes = None if args.mesh is None else parse_mesh_arg(args.mesh)
    if args.global_batch_size:
        data = data_world(args.n_devices, mesh_sizes, args.parallelism)
        if args.global_batch_size % data:
            raise ValueError(f"global batch {args.global_batch_size} not divisible by "
                             f"{data} data shards")
        per_shard = args.global_batch_size // data
    return TrainConfig(
        device=args.device,
        data_dir=args.data_dir,
        download=args.download,
        dataset=args.dataset,
        synthetic_data=args.synthetic_data,
        synthetic_size=args.synthetic_size,
        synthetic_task=args.synthetic_task,
        synthetic_label_noise=args.synthetic_label_noise,
        epochs=args.epochs,
        per_shard_batch=per_shard,
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
        zero3=args.zero3,
        grad_compress=args.grad_compress,
        grad_compress_block=args.grad_compress_block,
        grad_compress_error_feedback=args.grad_compress_error_feedback,
        dist_backend=args.dist_backend,
        parallelism=args.parallelism,
        mesh=mesh_sizes,
        sp_flash=args.sp_flash,
        n_microbatches=args.microbatches,
        pp_schedule=args.pp_schedule,
        aux_weight=args.aux_weight,
        n_devices=args.n_devices,
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
        reshuffle_each_epoch=not args.faithful_epoch_order,
        sync_bn=args.sync_bn,
        prefetch_depth=args.prefetch_depth,
        prefetch_batches=args.prefetch_batches,
        log_every_steps=args.log_every_steps,
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
        telemetry_dir=args.telemetry_dir,
        telemetry_sinks=args.telemetry_sinks,
        telemetry_snapshot_steps=args.telemetry_snapshot_steps,
        watchdog_deadline_seconds=args.watchdog_deadline,
        watchdog_abort=args.watchdog_abort,
        data_digests=args.data_digests,
        profile_dir=args.profile_dir,
        profile_steps=args.profile_steps,
        profile_window_steps=args.profile_window_steps,
        profile_host_hz=args.profile_host_hz,
        monitor_port=args.monitor_port,
        monitor_bind=args.monitor_bind,
        monitor_allow_remote_trigger=args.monitor_allow_remote_trigger,
        chaos_spec=args.chaos,
        comms_monitor=args.comms_monitor,
    )


def run(argv=None) -> tuple:
    """``main``, returning ``(trainer, metrics)`` (no trainer under
    ``--cv-mode``, which builds one a fold)."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    initialize_distributed(config.device, config.dist_backend)
    try:
        if args.cv_mode:
            return None, run_cv(args, config)
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


def run_cv(args, config) -> dict:
    """k-fold cross-validation (the JAX ``run_cv`` :546-606, the
    reference's ``-cv_mode``): one fresh ``Trainer`` a fold, data-parallel
    over the ranks, with no checkpoints and no resume; each fold's health
    record and telemetry go to ``<health-dir>/fold<i>`` and
    ``<telemetry-dir>/fold<i>`` (the records open with mode "w"). Reports
    each fold's validation accuracy and their mean."""
    from tpu_ddp_torch.train.kfold import run_kfold
    from tpu_ddp_torch.train.trainer import load_dataset

    (images, labels), _ = load_dataset(config)
    fold_config = dataclasses.replace(config, checkpoint_dir=None, resume=False)
    say = print if is_primary_process() else (lambda *a, **k: None)

    def make_trainer(train_data, val_data, fold):
        say(f"[cv] fold {fold + 1}/{args.cv_mode}")
        cfg = dataclasses.replace(
            fold_config,
            telemetry_dir=(os.path.join(fold_config.telemetry_dir, f"fold{fold}")
                           if fold_config.telemetry_dir else None),
            health_dir=(os.path.join(fold_config.health_dir, f"fold{fold}")
                        if fold_config.health_dir else None))
        return Trainer(cfg, train_data=train_data, test_data=val_data)

    results = run_kfold(np.asarray(images), np.asarray(labels), k=args.cv_mode,
                        make_trainer=make_trainer, seed=config.seed)
    preempted = any(r.get("preempted") for r in results)
    # a drained fold carries no val metrics and stays out of the aggregate
    accs = [r["val_accuracy"] for r in results if "val_accuracy" in r]
    if preempted:
        say(f"[cv] preempted after {len(accs)}/{args.cv_mode} completed folds; "
            "aggregate covers completed folds only")
    if accs:
        say("[cv] val accuracy per fold: " + ", ".join(f"{a:.4f}" for a in accs)
            + f" | mean {np.mean(accs):.4f} +- {np.std(accs):.4f}")
    return {
        "cv_results": results,
        "preempted": preempted,
        "completed_folds": len(accs),
        "mean_val_accuracy": float(np.mean(accs)) if accs else None,
        "std_val_accuracy": float(np.std(accs)) if accs else None,
    }


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
        trainer.record_final_eval(accuracy=acc, loss=loss)
    else:   # accuracy is undefined for multi-hot targets
        trainer.logger.log_text(f"final test loss: {loss:.4f}")
        trainer.record_final_eval(loss=loss)
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
