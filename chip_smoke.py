#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpu_ddp_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Environment: Python, torch and CUDA versions, and the card's name and
   power limit from ``nvidia-smi``.
2. Build: every CUDA kernel of the port from the sources in the checkout
   (``tpu_ddp_torch/ops/csrc``, one ``nvcc`` per source, all in parallel).
3. Kernel vs plain: K1 (``fused_update``) against its plain PyTorch version
   on the card, for SGD, SGD+momentum+decay+clip+EMA, AdamW+decay+clip+EMA
   and the ViT and LM paths' AdamW (no decay, clip or EMA), each under a
   constant and a cosine schedule, at NetResDeep's nine leaf shapes, at
   ViT-S/4's 79 leaf shapes, at the LM-32k path's 54, at ragged sizes (1,
   127, 1,000,003, and 1,000,003 at an unaligned address), at one large
   leaf (2**24 elements) and at a mixed group (aligned and unaligned
   leaves, decayed and not, leaves spanning several blocks' chunks), at
   ResNet-50's 161 (two launches), and with frozen rows (``--freeze``): half
   of NetResDeep's and of the mixed group's leaves frozen, all of
   NetResDeep's, and ResNet-50's head-only fine-tune. A frozen leaf's p holds
   some -0.0, which ``p + 0.0`` must turn into +0.0. Each group of up to 128
   leaves goes through one multi-tensor launch. Expected: bitwise equal
   (the signs of zeros too), every leaf, and exactly ceil(leaves / 128)
   launches a group.
3b. K1 with ZeRO-1's pad mask against its plain version
   (``update_math_masked``), bitwise, one launch a group: every recipe of
   phase 3 under both schedules, over NetResDeep's and ViT-S/4's shards at
   every rank of 2, 3, 4 and 8 ranks, LM-default's (phase 18c) at both
   ranks of two, and over the mask's edge cases (the
   live count inside a float4, in a shard's second chunk, at a chunk's
   end, zero, and unaligned shards on the scalar path); frozen shards:
   ResNet-18's head-only fine-tune (phase 19d) at every rank of 2 and 3
   ranks, and the edge cases with every other leaf frozen. Prints the rows
   with a live mask and the frozen ones among them; neither may be 0.
4. Main path: ``tpu_ddp_torch.cli.train.main`` with ``--device cuda
   --synthetic-data --kernels`` at NetResDeep's full width (n_chans1=32,
   n_blocks=10, tied), batch 32, SGD lr 1e-2, 2 epochs of 200 steps. The
   losses must be finite and falling, and K1 must have launched once a
   step (all nine parameter leaves in one launch).
5. Same steps, plain update: the first steps again without ``--kernels``;
   the per-step losses agree with phase 4 within ``rtol=1e-5`` over the
   first 5 steps (cuDNN's default backward sums in a run-dependent order,
   and the difference grows as training goes on). Then, with cuDNN's
   deterministic algorithms, 30 steps with K1 and 30 with the plain update
   from the same start must give bitwise equal losses and weights.
6. Timing: CUDA-event times of K1, of its plain version and of
   ``torch._fused_sgd_`` / ``torch._fused_adamw_`` as a yardstick (never
   called by the port, and with other semantics: no EMA, no clip in the
   pass, torch's AdamW decay), at the main path's shapes and at the large
   leaf, beside the least time the card could take (the bound). CUDA events
   around back-to-back calls measure what the caller waits for, which at
   small shapes is the host's launch rate; each row also carries the device
   time alone (``device_ms``, ``plain_device_ms``, ``library_device_ms``:
   the kernels' own times under ``torch.profiler``).
7. Flash attention, kernel vs plain: K4 (``flash_forward``: out and row
   log-sum-exp), K5 (``flash_dq``) and K6 (``flash_dkv``) against
   ``forward_plain``/``dq_plain``/``dkv_plain`` on the same inputs (K5 and
   K6 get the plain forward's lse and ``di``), at the ViT-S/4 path's
   (32, 64, 3, 64) as views of one qkv product, ViT-B/16's 196 tokens
   (8, 196, 12, 64), D=48, a prime T=67, causal at (4, 512, 4, 64), causal
   with a key mask that leaves rows with no visible key (their output and dq
   must be exactly 0, and the masked keys' dk and dv too), the long regime
   (4, 2048, 8, 128), the LM-32k path's causal (4, 4096, 8, 64) as views of
   one qkv product, and (3, 77, 2, 37): D not a multiple of 4 (4-byte
   copies) and T not a multiple of any tile. Tolerances
   (``|got - want| <= atol + rtol * |want|``) are those of
   ``tests/test_ops.py`` everywhere: forward and lse ``atol=2e-5``,
   gradients ``atol=5e-5``, ``rtol=1e-4``. A second call of K5 and of K6
   on the same inputs must give the same bits (no atomics).
8. The ViT main path: ``tpu_ddp_torch.cli.train.main`` with ``--device cuda
   --synthetic-data --model vit_s4 --attention flash --kernels --optimizer
   adamw --lr 1e-3`` (full width: patch 4, hidden 192, depth 6, 3 heads of
   64, 64 tokens), batch 32, 2 epochs of 100 steps with eval each epoch and
   at the end. Losses finite and falling; launches exact: K4 6 x (train
   steps + eval batches), K5 = K6 = 6 x train steps, K1 once a train step.
   Then the same run with ``--attention full``: no flash launch, K1 as
   before, and its first 5 per-step losses within ``rtol=1e-5`` of the flash
   run's (the two attentions sum in other orders; AdamW's normalised update
   carries the difference on). Steady-state images/sec/chip of both.
9. Timing on the ViT path: K1 at ViT-S/4's 79 leaves under the path's
   recipe, as in phase 6, with phase 8's flash run's launches. K4, K5 and
   K6 at the main path's shape and at (4, 2048, 8, 128), each in turns with
   its plain version, beside its bound (bytes over 3.35 TB/s against
   float32 operations over 67 TFLOP/s; also ``bound_tc_ms``, the same bytes
   against its products in 3xTF32, three TF32 products each, over the
   tensor cores' 495 TFLOP/s: two products for K4, three for K5, four for
   K6; and each kernel's launch: tile rows, registers, shared memory and
   blocks an SM) and ``torch.nn.functional.scaled_dot_product_attention``
   as the yardstick (forward for K4, its backward, which gives dq, dk and
   dv at once, for K5 and for K6; never called by the port). One line a
   shape gives K5 + K6 beside SDPA's backward, by events and device time.

10. K2/K3 against plain on the card. The one-segment case: ``fused_quant``
    and ``fused_dequant`` (bare and with ``add_to``) against
    ``quantize_chunk`` and ``dequantize_chunk`` at NetResDeep's 9 ring chunks
    at every rank count the run drives (2 and 3; N under ``--nccl N``),
    ViT-S/4's 79 leaves halved, sizes 1, 255, 257, 1,000,003 (also from an
    unaligned address) and 2**24 at block 256, blocks 1, 64, 256, 1,000 and
    4,096, and blocks holding NaN, +Inf, -Inf and only zeros. The segment
    form, every leaf of a ring hop in one launch (``segment_quant`` with and
    without the error, ``segment_dequant`` accumulating, into the shard row,
    and over the n gathered rows) against ``segment_quant_plain`` /
    ``segment_dequant_plain`` at every chunk: NetResDeep's and LM-default's
    (78 leaves, phase 18c) tables at those rank counts, ViT-S/4's 79 leaves and ViT-B/16's 151 (past K1's table of
    128) at two ranks, NetResDeep at 3 ranks (and N) with NaN, +Inf, -Inf
    and all-zero blocks, and six ragged leaves at four ranks with block 7
    (an odd number of message bytes: the gathered rows start unaligned),
    finite and not. Bitwise, except the int8 bytes of a block whose scale is
    not finite: there the scales must agree (NaN with NaN, +-Inf equal), the
    block must dequantize non-finite and its error be non-finite.
11. The ring on the card: two ranks on ``cuda:0`` over gloo (spawned) run
    ``ring_all_reduce`` int8 with ``with_error`` at NetResDeep's 9 leaves and
    one 2**22 leaf each alone, and ``GradCompressor.all_reduce_mean`` and
    ``reduce_scatter_mean_flat`` over NetResDeep's 9 and ViT-S/4's 79 leaves
    (error feedback), through K2/K3 and through the plain versions on the
    same inputs: outputs and errors bitwise equal on each rank, the one-leaf
    outputs identical across ranks. Then one step's ring over each tree,
    timed by the host clock, with its launches (one K2 and one K3 a hop and
    for the gather: 2 each at two ranks), its wire calls (one exchange and
    one all-gather) and its device time split by ``torch.profiler`` into
    K2/K3, host-device copies and other kernels.
12. The main path on two ranks: ``python -m tpu_ddp_torch.cli.launch
    --nproc-per-node 2 -- python -m tpu_ddp_torch.cli.train --device cuda
    --dist-backend gloo --synthetic-data --kernels --grad-compress int8
    --grad-compress-error-feedback --eval-each-epoch``, NetResDeep at full
    width, batch 32 a rank, SGD lr 1e-2, 2 epochs of 25 steps, both ranks
    sharing the card. Losses finite and falling; launches exact on each rank
    (K1 1, K2 2 and K3 2 a step, nothing else); the ring's wire calls one
    exchange and one all-gather a step; params bitwise equal on both ranks
    at the end. The same run without ``--grad-compress`` (plain DP over
    gloo, no ring) keeps its first 5 step losses within 0.05 of the int8
    run's. Steady-state step time per rank of both.
13. Timing of K2 and K3: one main-path step's calls on one rank at two
    ranks (K2 over the 9 leaves with the error, twice; K3 accumulating one
    hop's message, once; K3 over the two gathered rows, once) and one
    2**24 chunk (K2, K3 bare and with ``add_to``: the one-segment case),
    each in turns with its plain version, beside the bound (bytes over 3.35
    TB/s). No single PyTorch call quantizes block-scaled int8 or
    dequantizes into a ring's running sums, so those rows have no library
    time; the 2**24 dequantize has ``torch.mul(q.view(nb, block), scale[:,
    None])`` bare and ``torch.addcmul(add_to.view(nb, block), q.view(nb,
    block), scale[:, None])`` with ``add_to`` as yardsticks (never called by
    the port; whether each equals K3 to the bit is printed).
14. ``--zero1`` on three ranks: NetResDeep ``--zero1 --kernels`` through
    the launcher, three ranks sharing the card over gloo, the recipe and 2
    x 25 steps a rank of phase 12 (at three ranks seven of its nine leaves
    pad, so the mask runs on the path), in float32 and with ``--grad-compress
    int8 --grad-compress-error-feedback``; plain DP on three ranks beside
    them. Each: the step count, finite and falling losses, params bitwise
    equal on all ranks, launches exact (K1 once a step; with int8, K2 2 and
    K3 2 a step, and the ring's two exchanges). All three under deterministic
    cuDNN: the first 5 steps of zero1 and of plain DP within ``rtol=1e-5`` at
    three ranks (``rtol=1e-4`` at other rank counts, under ``--nccl``).
    Phases 14 and 15 run in one three-rank job, which also takes phase 17's
    cut at three ranks (``rank_change_runs``).
15. ViT-S/4 ``--zero1 --kernels --attention flash --optimizer adamw --lr 1e-3
    --weight-decay 0.05 --grad-clip-norm 1.0 --ema-decay 0.999`` on three
    ranks over gloo, one epoch of 20 steps, and the same without
    ``--zero1``, both under deterministic cuDNN: replicas bitwise equal, K1
    once a step, K4-K6 as in phase 8, the EMA evaluation finite, the first 5
    losses within ``rtol=1e-5``. Then ``Zero1Partition.accounting()`` of
    both paths at three ranks.
16. Timing of K1 with the pad mask at the zero1 paths' shards (rank 2 of
    three, the recipes of phases 14 and 15): masked, the same shards
    unmasked, the plain version and ``torch._fused_sgd_`` /
    ``torch._fused_adamw_`` as the yardstick, in turns, beside the bound.
    The step times of phases 14 and 15 per rank close the run.
17. Checkpoint and resume on the card, NetResDeep at full width, 25 steps
    an epoch a rank, under deterministic cuDNN: two ranks sharing the card
    over gloo with ``--kernels --zero1 --grad-compress int8
    --grad-compress-error-feedback``, two epochs uninterrupted, then one
    with ``--checkpoint-dir`` and ``--resume`` to two: the resumed run's
    per-step losses and final params bitwise the uninterrupted run's,
    replicas bitwise equal, its launches exactly 25 times phase 14's
    per-step counts, both steps verified by their manifests. One rank in
    this process (``--kernels``), SIGTERMed as it takes batch 35: it drains
    there, saves, and ``--resume`` ends bitwise where the uninterrupted run
    ends, K1 once a resumed step. A checkpoint cut at three ranks (in phase
    14's job) resumes at two (in this phase's two-rank job) with finite,
    falling losses. Then the host-clock times of save
    initiation (device to host), commit (write, fsync, manifest), manifest
    verification and restore, and the sizes, of NetResDeep's state and of
    ViT-B/16 at 224 with AdamW state, each after one step on the card.

18. The causal LM on the card (``tpu_ddp_torch/models/lm.py``,
    ``train/lm_steps.py``). (a) LM-32k widths (vocab 32,000, hidden 512,
    depth 4, 8 heads of 64; ``benchmarks/aot_v5e.py:543-547``), B x T = 4 x
    4,096 float32, AdamW lr 1e-3 ``--kernels``, 30 steps with ``use_flash``
    and 30 with the plain causal attention from the same seeded weights on
    the same batches of ``tests/test_lm.py``'s permutation task at vocab
    32,000: launches exact (K1 30; K4 = K5 = K6 = 4 x 30 with flash, none
    without), the first 5 losses within ``rtol=1e-5``, every loss finite and
    the last 10 below the first 10; each run's steady ms a step (host clock,
    steps 10-30), tokens/sec, ``max_memory_allocated`` and, under
    ``torch.profiler`` over 5 more steps, K4-K6's device ms a step and share
    of busy, the idle share and kernels a step. (b) ``greedy_generate`` on
    the trained flash model from a (4, 4,088) prompt, 8 new tokens: K4
    exactly 4 x 8 launches, and the tokens equal the plain-attention
    decode's at every position whose plain top-2 logit margin is 1e-3 or
    more (a row is compared until it diverges under the margin). (c)
    LM-default (vocab 256, hidden 192, depth 6, 3 heads) at T = 256, 8 rows
    a rank, ``--kernels`` with ZeRO-1 and the int8 ring with error
    feedback, on two ranks sharing the card over gloo through the launcher,
    20 steps: replicas bitwise equal, launches a rank exact (K1 20, K2 = K3
    = 20, K4-K6 6 x 20), the ring's wire calls exact, losses finite and
    falling. (d) Timing: K1 at LM-32k's 54 leaves, and K4, K5 and K6 at
    (4, 4096, 8, 64) causal, each against its plain version and
    ``scaled_dot_product_attention(..., is_causal=True)``, beside bounds
    that count the causal call's T(T+1)/2 visible pairs a head, with (a)'s
    flash launches; then each kernel's device time causal against full at
    that shape, in turns.

19. Fine-tuning (``models/resnet_family.py``, ``train/finetune.py``,
    ``checkpoint/import_foreign.py``, ``--freeze``, ``--loss bce``) at
    ResNet-50's full width (CIFAR stem; 23,705,252 params at 100 classes,
    161 leaves, 106 BatchNorm stats), under cuDNN's deterministic
    algorithms, all through the train CLI. (a) Pretraining: ``--model
    resnet50 --num-classes 100 --synthetic-data --kernels --optimizer sgd
    --momentum 0.9``, batch 32, 2 epochs of 15 steps, ``--checkpoint-dir``:
    K1 exactly 2 x 30 (161 leaves, two launches a step), finite losses with
    the last 10 below the first 10, steady ms a step and images/s (host
    clock, epoch 2), ``max_memory_allocated``, and the device idle share and
    kernels a step over 5 profiled steps. (b) Its final state exported by
    ``export_state_dict`` to a torchvision-layout ``.pt`` (with
    torchvision's ``num_batches_tracked`` entries, which the import reports
    unmapped), then ``--pretrained-dir FILE --num-classes 3 --loss bce
    --freeze head --kernels`` on ``synthetic_multilabel``, 30 steps: every
    backbone param bitwise the file's (``p + 0.0``), the head and every
    BatchNorm running stat moved, K1 exactly 2 x 30, BCE losses finite and
    falling; the same from (a)'s checkpoint directory restores the backbone
    bitwise. (c) (b) again without ``--kernels``: per-step losses and the
    final state bitwise (b)'s. (d) ResNet-18 at CIFAR-100 widths
    (11,220,132 params, 62 leaves) fine-tuned from a file with ``--zero1
    --grad-compress int8 --grad-compress-error-feedback --freeze head
    --kernels`` on two ranks sharing the card over gloo, 20 steps a rank:
    replicas bitwise, frozen params the file's, launches a rank exact (K1
    20, K2 = K3 = 20) and the ring's wire calls. (e) K1 at ResNet-50's 161
    leaves under SGD with momentum, all trainable and head-only, in turns
    with the plain version, ``torch._fused_sgd_`` over the trainable leaves
    and the bound (a frozen element moves 12 bytes: read p, write p and u).

20. bfloat16 compute and ``--remat`` (K4-K6's bfloat16 kernels, on TMA, an
    mbarrier ring and ``wgmma``; bf16 products with float32 accumulators). (a) Each kernel
    against its plain version in bfloat16 (the same dtype flow: p and ds
    rounded to bf16 for the second products; ``tpu_ddp_torch/ops/
    flash_attention.py``) at ViT-S/4's (32, 64, 3, 64) as qkv views, the
    same with a key mask that hides all of batch 1's keys (its rows: out 0,
    lse NEG, zero gradients, exactly), the LM-32k path's causal (4, 4096, 8,
    64) views, (8, 100, 4, 48), (3, 77, 2, 36) causal with dead rows (D not
    a multiple of 8: the kernels read a padded copy, ``tma_operand``) and
    (3, 200, 2, 128) causal with dead rows (D = 128, T not a multiple of
    the 128-row query tile): out, dq, dk and dv bfloat16 within
    ``BF16_ULPS`` = 2 bf16 units in the last place of each row's own largest
    value (a query row of out and dq, a key row of dk and dv; at least
    ``BF16_ROW_FLOOR`` of the tensor's largest: ``tools/variants.py``), lse
    float32 within ``atol=2e-5``; two controls that must fail that check (K4 on a v
    with a key of every tile past 1,024 zeroed; K6 on a dO with a query of every
    tile past 1,024 zeroed, in dk and in dv); each kernel's launch (registers,
    spill, shared memory, blocks an SM) at D = 64 and 128. (b) Timing at
    the LM and ViT shapes, as phase 9's: events and device time, the plain
    version, SDPA in bfloat16, and the bound: bf16 bytes over 3.35 TB/s
    against the products over 989 TFLOP/s (and the softmax's float32 work
    over 67), with causal pairs T(T+1)/2 a head. (c) ViT-S/4 through the
    CLI with ``--compute-dtype bfloat16 --attention flash --kernels
    --optimizer adamw``, 2 epochs of 50 steps, and the same with
    ``--attention full``: launches exact (the ``_bf16`` kernels alone, K1
    once a step), first 5 losses within ``BF16_LOSS_RTOL``, images/sec;
    then flash without and with ``--remat`` under deterministic cuDNN:
    losses and weights bitwise, K4 once more a block a train step. (d)
    LM-32k in bfloat16 with flash, 30 steps as 18a (tokens/sec, idle share,
    kernels a step, top kernels, K4-K6's share of busy, peak memory), its
    first 5 losses within ``BF16_LM_RTOL`` of 18a's float32 flash run; then
    ``remat=True``: peak memory, step time, losses bitwise the run
    without. Both loss bands must reject K4 made wrong on purpose
    (``BF16_FAULTS``: k and v exchanged, the score scale 1/D) for one run.
    (e) NetResDeep ``--compute-dtype bfloat16 --kernels`` through the CLI,
    20 steps under deterministic cuDNN, K1 once a step on the float32
    params; with ``--remat`` the losses, params and BatchNorm running
    buffers bitwise the run without. (f) K4's, K5's and K6's bfloat16
    kernels against the parent commit's, built from a copy of its sources
    under ``build/parent_csrc/`` (``PARENT_FILES``: ``flash_forward.cu``,
    ``flash_attention.cu`` and the headers ``bf16_tiles.cuh``,
    ``flash_wg.cuh``, ``hopper.cuh``; ``git show
    <parent>:tpu_ddp_torch/ops/csrc/<file>``) when that copy is there, in
    turns in one process (parent, this, this, parent) at the LM-32k and
    ViT-S/4 shapes: CUDA events and device time, K4's and K5's outputs
    equal to the parent's to the bit (else the phase fails), and how many
    bf16 units of a row K6's lie from the parent's; with the host time of
    one tensor map's encode, which each call of K4-K6 makes once an operand.
    Without the copy the phase says so and is skipped.

21. The numerics flight recorder (``tpu_ddp_torch/health/``; the step's
    stats and skip-step guard, ``train/steps.py``). (a) NetResDeep at full
    width through the train CLI's arguments and the trainer's ``run``:
    ``--synthetic-data --kernels --no-shuffle --momentum 0.9 --health on
    --health-policy skip_step --health-per-layer-stride 1 --health-dir``,
    one epoch of 40 steps with the fifth batch all NaN (``poison_batch``),
    under deterministic cuDNN: exactly one non-finite step; the params,
    momentum and BatchNorm buffers after it bitwise as before it; K1 once
    every step, the skipped one included; the dump (meta, health, batch)
    written and the dir rendered by ``health/summarize.py``; the final
    params finite. The same steps without ``--kernels``: the health records,
    per-layer norms included, equal to the bit. (b) Two ranks sharing the
    card over gloo through the launcher, ``--kernels --zero1 --grad-compress
    int8`` without error feedback (K2 computes its error for health alone),
    ``skip_step``, 20 steps a rank with rank 0's fifth batch all NaN: both
    ranks' health records equal, the same step skipped on both, replicas
    bitwise, ``compress_error_norm`` finite and above 0 on the healthy
    steps, launches (K1, K2 and K3 once a step) and the ring's wire calls
    exact. (c) The cost: LM-32k in bfloat16 (phase 20d's run, K4-K6 and K1)
    with health off, ``warn`` and ``skip_step`` (one run each), each step
    followed by the trainer's one copy of the scalars to the host: ms a
    step, tokens/s, launches and kernels a step, device busy time and peak
    memory, the losses of the three runs equal to the bit; then NetResDeep
    ``--kernels`` with health off and on in turns (2 epochs of 50 steps,
    epoch 2 timed; kernels a step over 5 profiled steps, two turns of
    each).
22. The step variants and the in-step data path, through the train CLI. (a)
    NetResDeep ``--kernels --steps-per-call 8`` against ``--steps-per-call
    1`` under deterministic cuDNN, in turns (8, 1, 1, 8), 2 epochs of 48
    steps (6 fused calls an epoch): per-step losses equal to the bit, K1
    once an optimizer step (96), the steady ms a step (epoch 2) and, in the
    second turn of each, over 16 more profiled steps (2 fused calls, or 16
    single steps), kernels a step, device busy ms a step and the idle share:
    no capture, so both should match within noise. (b) ViT-S/4 ``--attention
    flash --kernels --optimizer adamw --batch-size 128 --grad-accum-steps
    4`` against ``--grad-accum-steps 1``, 20 steps: the first 5 losses
    within ``rtol=1e-4`` (LayerNorm only, so accumulation is exact up to
    rounding), K4 6 x (4 x steps + eval batches), K5 = K6 = 6 x 4 x steps (6
    x steps without accumulation), K1 once a step, peak memory of both. (c)
    NetResDeep ``--kernels --augment --mixup-alpha 0.2``, 2 epochs of 30
    steps under deterministic cuDNN; the same run SIGTERMed at batch 35
    drains and saves, and ``--resume`` ends with the uninterrupted run's
    losses and params to the bit, K1 once a resumed step; the draws on the
    card (20,000 crop offsets and flips at one step) cover 0..8, flip about
    half (within 4 sigma) and equal the CPU's draws to the bit. (d)
    ``--dump-predictions`` after a short NetResDeep run: one row a test
    image, the predictions the argmax of the eval-mode forward's logits,
    their accuracy the trainer's ``final test accuracy``. (e) Two gloo ranks
    sharing the card through the launcher, ``--steps-per-call 4 --grad-
    compress int8 --grad-compress-error-feedback --kernels``, one epoch of
    20 steps: K2 and K3 2 a step a rank, K1 1, the ring's wire calls exact,
    replicas bitwise.

23. The trainer, CLI and optimizer remainder and the host data path. (a)
    NetResDeep ``--kernels`` at full width (batch 32, SGD lr 1e-2,
    deterministic cuDNN, 2 epochs of 16 steps) on each host data path:
    ``--prefetch-depth 0`` (the gather on the training thread), the default
    ``--prefetch-depth 2`` (the native ring: pinned slots, the copy to the
    card on a copy stream), ``--prefetch-batches 2`` (the staged prefetcher)
    and ``--prefetch-depth 2 --steps-per-call 8`` (one ring submission a
    group): per-step losses equal to the bit across the four, K1 once a
    step; host ms a step of the wait for a batch, its copy and the gather,
    steady ms a step, images/sec, and on the first two paths a profiled
    third epoch's device busy ms and idle share; the two gathers alone over
    200 batches. (b)
    ``--sync-bn --kernels`` on two gloo ranks sharing the card through the
    launcher (``--sync-bn-child``), 2 epochs of 5 steps at 32 rows a rank,
    against one rank at batch 64 on the same data order (each step's 64 rows
    are the same set), stepped from the very state the two ranks started
    each step from (the two runs' rounding differs, as the convolutions at 32
    and at 64 rows sum in other orders, and a free run amplifies it): every
    step's loss within ``rtol=1e-5``, replicas bitwise; the same ranks
    without ``--sync-bn``, held to one rank along their own states, differ
    by more than that; 10 BatchNorm
    all-reduces a step forward and 10 backward; K1 once a step; what the
    sync adds to the step. (c) ``--optimizer lamb``: two NetResDeep updates
    on the card against the plain chain on the CPU on the same gradients
    within 1e-6; 20 steps through the CLI with a falling loss;
    ``--kernels --optimizer lamb`` refused (K1 has no lamb branch). (d)
    ``--cv-mode 2``, one epoch a fold of 128 rows: both folds complete,
    their validation sets disjoint and covering the 256 rows, K1 once a
    step.

24. ZeRO-3 (``--zero3``: the params scattered, gathered block by block on
    the prefetch schedule) on three gloo ranks sharing the card, under
    deterministic cuDNN, in one job. (a) NetResDeep ``--zero3 --kernels``
    with phase 14's arguments, float32 and int8 with error feedback: the
    first losses within ``ZERO1_RTOL`` of phase 14's ``--zero1`` runs (and
    whether all are equal to the bit), K1 once a step a rank, K2/K3 at
    ZeRO-1's counts, the ring's wire calls ZeRO-1's, one block gather a
    block (4) a step. (b) ViT-S/4 with phase 15's arguments over two
    epochs (the second timed), replicated, ``--zero1`` and ``--zero3``: K1
    once a step, K4 6 x (steps + eval
    batches), K5 = K6 = 6 a step, 10 block gathers a step under
    ``--zero3``; its losses against this job's and phase 15's ``--zero1``;
    each rank's memory allocated between steps and its peak for the three
    layouts, the drop from ``--zero1`` to ``--zero3`` at least 0.9 of
    ``params_bytes_replicated - params_bytes_per_device_sharded``
    (``Zero3Partition.accounting()``); ms a step a rank each. (c) (a)'s int8
    run cut after its first epoch and resumed: losses and params bitwise the
    uncut run's; the checkpoint then resumed under ``--zero1`` at two ranks.
    (d) ``skip_step`` under ``--zero3 --grad-compress int8`` at two ranks,
    rank 0's fifth batch all NaN: the step skipped on both, each rank's
    state (shards, slots, counts, buffers, residual) bitwise across it.
    (c)'s two-rank resume and (d) run in one two-rank job, (d) first.
25. Sequence parallelism (``--parallelism sp``, ring attention). (a) The
    ring on four gloo ranks sharing the card in one job, as two rings of 2
    and then one ring of 4: ``ring_flash_attention`` (K4 a forward hop, K5
    and K6 a backward hop) against the same ring with the plain tiles and
    against one-rank ``flash_attention`` on the whole sequence, out, lse
    and the gradients of q, k and v, at ViT-S/4's (32, 64, 3, 64) float32
    (causal and not, and with a key mask that leaves a batch row with no
    key) and bfloat16, and LM-32k's (4, 4096, 8, 64) causal float32 and
    bfloat16, each cut into n chunks of the sequence. Every K4-K6 call of
    the ring against its plain version on the same inputs: phase 7's
    float32 tolerances, bfloat16 within 2 units of each row's largest value
    (phase 20a's check), lse ``atol=2e-5``. The ring's results: phase 7's
    float32 tolerances; in bfloat16 the ring sums tiles each rounded to
    bfloat16, so a row is held within ``2 m + 1`` units of its scale (m
    tiles summed into it; ``sp_ring_child`` says which scale), ``2 m + 3``
    against one-rank flash. K4, K5 and K6 n times a pass on each rank,
    ``s + 1`` times causal (s: the rank's place on the ring). (b) and (c)
    in one launcher job on two gloo ranks sharing the card. (b) ViT-S/4
    through the CLI with ``--parallelism sp --mesh data=1,sequence=2
    --sp-flash --kernels --optimizer adamw --lr 1e-3`` at batch 32, two
    epochs of 12 steps (the second timed): the first 5 losses within
    ``rtol=1e-5`` of a one-rank ``--attention flash`` run in this process
    on the same data, order and init, K1 once a step, K4 = K5 = K6 = 12 a
    step a rank, replicas bitwise, ms a step and peak memory a rank against
    the one-rank run's; then 10 steps under ``--health on --health-policy
    warn``. (c) LM-32k through ``make_sp_lm_train_step`` with ``sp_flash``
    at sequence=2, 6 steps in float32 and 6 in bfloat16 from phase 18a's
    seeded weights on its batches: the first 5 losses within ``rtol=1e-5``
    of 18a's float32 run and 5e-3 of 20d's bfloat16 run, K4-K6 4 a step on
    rank 0 and 8 on rank 1, the ranks' params equal to the bit, ms a step,
    tokens/sec and peak memory a rank against the one-rank run, and the
    flash ring's forward + backward at a layer timed first. Over gloo every
    exchange is staged through host memory and
    synchronises the stream first, so no transfer overlaps a tile there.
26. The SP overlays and the GSPMD families (``parallel/tensor_parallel.py``),
    every run through the CLI on ranks sharing the card over gloo, two
    epochs of 5 steps (the second timed) at a global batch of 64 under
    cuDNN's deterministic algorithms. First K4-K6 against their plain
    versions, with phase 7's tolerances, at the shapes a tensor-parallel
    rank gives them: (32, 64, 2, 64), (32, 64, 1, 64) and (64, 64, 1, 64),
    q, k and v views of the rank's qkv columns. (a)
    ViT-S/4 ``--parallelism sp --mesh data=2,sequence=2 --sp-flash
    --kernels`` replicated, with ``--zero1`` (the partition over the data
    group) and with ``--grad-compress int8 --grad-compress-error-feedback``
    (the ring over the data group): ``--zero1``'s first 5 losses within
    ``rtol=1e-5`` of the replicated run's, int8's within 0.05 (phase 12's
    band), replicas bitwise, K1 once a step, K2 and K3 2 a step, K4-K6 12 a
    step a rank; then LM-32k at depth 2 through ``make_sp_lm_train_step``
    with ``sp_flash``, replicated and ``--zero1``, 6 steps each, losses
    within ``rtol=1e-5``, params bitwise over the ranks. (b) ViT-S/4 at full
    width ``--parallelism tp --attention flash --kernels`` (AdamW) at
    ``data=2,model=2`` (2 heads and 1 a rank) and ``data=1,model=3`` (1 head
    a rank); (c) NetResDeep at full width ``tp --mesh data=2,model=2
    --kernels``, ViT-S/4 ``--parallelism fsdp --mesh data=2`` and
    ``fsdp_tp --mesh data=2,model=2``. Each of (b) and (c): the first 5
    losses within ``rtol=1e-5`` of one rank's whole model on the same
    global batches (run in this process; NetResDeep's, whose ten tied
    BatchNorm blocks part the two trajectories by 2e-5 in three steps, each
    step taken from the state the sharded run started it from, phase 23b's
    oracle, with the trajectories' differences printed), K1 once a step,
    K4 6 a step and a test batch and K5 and K6 6 a step a rank (each rank's
    own heads), the gathered params bitwise over the ranks; ms a step,
    param and optimizer bytes and peak memory a rank against the one-rank
    run's. ``python3 chip_smoke.py --phase 26`` runs phase 26 alone (the
    kernels built first), ``--nccl N --phase 26`` its N-rank job alone.
27. Pipeline and experts (``run_phase27``). (a) K4-K6 against their plain
    versions at the pp microbatch shape (8, 64, 3, 64) with phase 7's
    tolerances; then ViT-S/4 at full width on two gloo ranks sharing the
    card, ``--parallelism pp --mesh data=1,pipeline=2 --attention flash
    --kernels --optimizer adamw``, batch 32, ``--microbatches 4``, two
    epochs of ``PP_STEPS``, under gpipe and 1f1b: losses finite, the
    schedules' within 1e-5 of each other, each step's within ``rtol=1e-5``
    of one rank's whole model on the same batch from the state the pp run
    started it from (``--save-states``); a step a rank K4 = K5 = K6 = 12
    under gpipe, K4 = 24 and K5 = K6 = 12 under 1f1b, K1 1, and the final
    evaluation's K4 6 a test batch (the plain module, on the params
    gathered over the pipeline); the printed schedule line (bubble 20.0%
    and in-flight 4, 33.3% and 3). (b) K1 bitwise against its plain
    version at ``vit_moe_s4``'s 85 leaves (one launch); ``vit_moe_s4`` and
    ``vit_moe_s4_top2`` at full width on one rank, ``--kernels --optimizer
    adamw``, two epochs of ``MOE_STEPS`` steps: losses finite and falling,
    ``aux_loss`` at least ``1 - 1e-5`` every step, K1 once a step. (c)
    ``vit_moe_s4 --parallelism ep --mesh data=1,expert=2`` on two gloo
    ranks: losses held to one rank's from the same states, K1 once a step,
    each rank holding 4 of the 8 experts (its param bytes against the
    one-rank run's: 3,550,464 expert parameters less). ``python3
    chip_smoke.py --phase 27`` runs it alone; ``--nccl N --phase 27`` its
    job alone at N ranks, one card each, over NCCL (pp on
    ``data=N/2,pipeline=2`` at the same global batch of 32, ep on
    ``data=1,expert=N``), losses held to one rank's as here.
28. Telemetry (``run_phase28``). (a) NetResDeep at full width ``--kernels``,
    two epochs of ``TEL_STEPS`` steps, without ``--telemetry-dir``, with it
    (the default sinks, ``--watchdog-deadline 300``) and with it and
    ``--no-data-digests``, in turns, twice, under deterministic cuDNN: the
    six runs' launches (K1 once a step) and losses are the same, to the
    bit; of each traced run: every step carries ``data_wait``,
    ``compiled_step`` and ``device_sync``; ``train/steps`` is the steps
    taken; the Chrome trace loads; the heartbeat's
    step is the last step; ``memory/high_water_bytes`` is
    ``torch.cuda.max_memory_allocated()`` as the gauge read it;
    ``train/mfu`` is in (0, 1); ``data-p0.jsonl`` has one digest a step;
    the steady ms a step of the three arms printed (telemetry's cost, and
    its split between the digests and the rest), and a batch digest's host
    time in Python, in the native ring's gather thread, and on the training
    thread's side of the ring (``digest_cost``).
    (b) ViT-S/4 ``--attention flash --kernels``, the same six runs of
    ``TEL_VIT_STEPS`` steps an epoch: K4-K6's launches unchanged by
    telemetry, MFU and the three arms' steady ms printed. (c) two gloo
    ranks sharing the card through the launcher, ``--grad-compress int8
    --kernels --telemetry-dir`` under deterministic cuDNN, a counting hop
    hook in each rank (``rank_child``'s ``--hop-hook``): n hop calls a step (the ring's n - 1
    and the gather phase), ``wire_bytes`` the hop's ``chunk_wire_bytes``
    over NetResDeep's leaves (n - 1 of them for the gather), K2 and K3 n a
    step as without a hook, each rank's ``trace-p<rank>.jsonl``, the
    summary sink on rank 0 alone; the job also runs ``--monitor-port -1
    --monitor-bind 127.0.0.1``, which phase 30c reads. ``python3
    chip_smoke.py --phase 28`` runs it alone.
29. The run-dir readers (``run_phase29``: ``tpu_ddp_torch/ledger``,
    ``curves``, ``registry``, ``analysis/regress.py``, through
    ``tpu_ddp_torch.cli.main``), on what the card wrote, in a scratch
    directory under ``build/``. (a) NetResDeep at full width ``--kernels
    --telemetry-dir D --health on --checkpoint-steps 5``, two epochs of 10
    steps at batch 32, under deterministic cuDNN, in a child process
    (``--life-child``) SIGKILLed as it takes batch 8, once its step-5
    checkpoint has committed; then ``--resume`` to the end in this process.
    ``goodput D --json``: two lives, killed then clean, 3 replayed steps,
    the category seconds summing to ``elapsed_s`` within 1e-6 s, the compile
    category at 0 s, a checkpoint; K1's launches in each life equal the
    steps it trained (8 and 15). (b) ``curves D --json``: each of the 20
    steps exactly once, finite. (c) The same recipe and seed without
    ``--kernels``, uninterrupted: ``curves diff D D_plain`` passes with a
    trajectory drift of 0.0 (K1 is bitwise its plain version and the resume
    bitwise the uninterrupted run). (d) The ledger, curve and ``trace
    summarize --json`` of both runs recorded into a registry: ``registry
    list`` and ``registry trend`` exit 0; ``bench compare --against`` the
    registry (``--allow-dirty``: the copy has no git identity) of D's
    ledger exits 0, D_plain's ledger against D's exits 1, naming the kill's
    restart gap, replayed steps and ``killed`` exit. Prints the goodput,
    the category seconds, the curve's points and each reader command's host
    seconds. ``python3 chip_smoke.py --phase 29`` runs it alone.
30. The live observatories (``run_phase30``: ``tpu_ddp_torch/monitor``,
    ``profiler``, ``memtrack``), in a scratch directory under ``build/``.
    (a) NetResDeep at full width ``--kernels --telemetry-dir D
    --monitor-port -1 --monitor-bind 127.0.0.1 --watchdog-deadline 60
    --profile-steps 4:8 --profile-dir P``, three epochs of 12 steps at batch
    32, in a child process (``--obs-child``) held at step 27 while this
    process reads ``exporter-p0.json``, GETs ``/metrics`` five times
    (``train_steps_total`` 27 and a ``memory_d<i>_bytes_in_use`` above 0),
    ``/healthz`` (ok) and POSTs ``/profile?steps=3`` (200, and 429 a second
    time). After the run: two bundles (config 4..8, http 27..30), each with
    folded stacks and a ``torch.profiler`` trace naming K1's
    ``fused_update_kernel`` once a window step; P's trace of epoch 2 with 12
    and the ``profiler_trace_written`` instant; K1 36 in 36 steps;
    ``mem-p0.jsonl``'s ``memory_stats`` records with ``bytes_in_use`` <=
    ``peak_bytes_in_use`` <= the card's memory; ``watch D --once --json``,
    ``mem D --json`` and ``profile D`` exit 0. Prints the scrapes' ms, the
    step p50 (``compiled_step`` + ``device_sync``) in the windows, in the
    traced epoch and outside both, the memory sample's ms, each bundle's
    bytes and its parts' ms. (b) A child (``--oom-child``), started first and
    running beside (a)'s, capped at 2% of the card, trains a batch of 4,096
    that cannot fit: it exits 1 with
    ``torch.OutOfMemoryError``, leaves ``oom/step_0-p0/``, ``goodput
    --json`` books its life ``oom`` and ``mem`` exits 1. (c) In phase 28c's
    job: each rank's ``exporter-p<rank>.json`` on its own port, ``watch
    --once --json`` over both ranks. ``python3 chip_smoke.py --phase 30``
    runs (a), (b) and 28c's job alone.
31. The comms and data-path observatories and chaos injection
    (``tpu_ddp_torch/comms``, ``datapath``, ``chaos``; ``phase31_checks``),
    (a) and (b) in phase 28c's two-rank job. (a) 28c's run again with
    ``--comms-monitor --prefetch-batches 2 --watchdog-deadline 4 --chaos``:
    a ``comm_stall`` of 6 s on rank 0's first ring hop of step 3 (past the
    deadline, no abort) and a 1.5 s ``data_stall`` on the gather from step
    5: each rank leaves ``comms-health-p<r>.json``, ``data-health-p<r>.json``
    and a hang bundle naming ``ring-all-reduce``/``s8``/``data``; the run
    finishes, K1 1, K2 2 and K3 2 a step a rank, both faults fired once, the
    losses and weights bitwise 28c's; the step p50 against 28c's. (b)
    ``tpu-ddp-torch comms bench`` on the job's group (``rank_child``'s
    ``--comms-bench``): all-reduce f32 and the f32 and int8 rings at 2**16
    and 2**20 elements a rank, K2 and K3 counted exactly; ``registry
    record`` takes the artifact as ``comms``, ``watch --once
    --comms-baseline`` reads both ranks' comms views; prints the α-β lines.
    (c) In this process: ``data bench --device cuda`` with the real h2d
    copy, the stage monitor's five writes a batch timed alone, and ``data
    report`` on (a)'s run dir naming the gather dominant. (d) In 28c's job
    (``phase31_cost``), the monitors priced end to end: 32 steps of the
    two-rank int8 run on the synchronous loader in four arms, each twice
    (A B C D D C B A): without the stage monitor, with it (every telemetry
    run's default), with ``--comms-monitor`` too, and the same with the
    hook handed no probe to read; launches exact in each; prints each
    arm's step period, the three differences and the hook's ms inside the
    live step. ``python3 chip_smoke.py --phase 31`` runs it alone with
    28c's job.

Launcher jobs carry several runs each (``launch_dp_runs``; a run's own
``rank_child`` options let unlike runs share a job): phase 26's three-rank
run rides phases 14, 15 and 17's job, its two-rank run phase 27's, and 19d,
21b and 22e share one; the smoke prints each job's start-up seconds (launch
to the last rank's process group) and, at the end, the jobs and child
processes it started (``print_jobs``).

Phase 2 also builds the native data-path library (``tpu_ddp_torch/native``)
with g++ from the checkout. The NetResDeep phases before 17 keep their
sizes; the whole run aims at ten minutes on the card, the build included. ``python3 chip_smoke.py
--nccl N``, on a machine with N cards, runs phases 10 (at N ranks' chunks),
12, 14, 24 (a)-(c) (with ViT-S/4 ``--zero3`` timed again with the gathers
serialized), 17's two-rank part, 18c, 19d, 21b, 22e, 25 (b) and (c) (at
data=N/2, sequence=2), 26's N-rank job (without the one-rank baselines)
and 27's job alone at N ranks, one card each, over NCCL. The line
before the last is one JSON object
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import re
import subprocess
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside the
# tensor cores, the rate K1's element-wise float32 work runs at.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# dense TF32 on the tensor cores, K4's products (3xTF32: three TF32 products
# for each float32 one)
TF32_OPS_PER_S = 495e12

LARGE = 1 << 24
NETRESDEEP_LEAVES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32,),
                     (32, 2048), (32,), (10, 32), (10,)]
RAGGED = [(1,), (127,), (1_000_003,)]
#: (shape, offset in floats from a 16-byte boundary, decayed): aligned and
#: unaligned leaves, decayed and not, small and spanning several chunks
MIXED = [((4096,), 0, True), ((333,), 0, False), ((1000,), 1, True),
         ((100_003,), 1, False), ((65_541,), 0, True), ((7,), 3, False),
         ((16_384,), 2, True), ((16_385,), 0, False), ((64, 3, 3, 3), 0, True)]
VARIANTS = {
    "sgd": dict(kind="sgd", momentum=0.0, wd=0.0, max_norm=0.0, ema=0.0),
    "sgd_mom_wd_clip_ema": dict(kind="sgd", momentum=0.9, wd=5e-4,
                                max_norm=1.0, ema=0.99),
    "adamw_wd_clip_ema": dict(kind="adamw", momentum=0.0, wd=0.05,
                              max_norm=1.0, ema=0.99),
    # the ViT and LM paths' recipe (phases 8 and 18): --optimizer adamw and
    # nothing else
    "adamw": dict(kind="adamw", momentum=0.0, wd=0.0, max_norm=0.0, ema=0.0),
    # the fine-tune path's recipe (phase 19): --momentum 0.9 and nothing else
    "sgd_mom": dict(kind="sgd", momentum=0.9, wd=0.0, max_norm=0.0, ema=0.0),
}
VIT_RECIPE = "adamw"
MAIN_STEPS_PER_EPOCH = 200
PLAIN_STEPS = 30
PLAIN_STEPS_RTOL = 5

VIT_STEPS_PER_EPOCH = 100
VIT_DEPTH = 6
VIT_LEAVES = 79
FULL_STEPS_RTOL = 1e-5
FWD_TOL = dict(atol=2e-5, rtol=0.0)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
#: name -> (B, T, H, D, causal, key mask kind, q/k/v as views of one qkv)
FLASH_CASES = {
    "vit_s4": (32, 64, 3, 64, False, None, True),
    "vit_b16_t196": (8, 196, 12, 64, False, None, False),
    "d48": (8, 128, 4, 48, False, None, False),
    "t67": (8, 67, 3, 64, False, None, False),
    "causal_t512": (4, 512, 4, 64, True, None, False),
    "causal_dead_rows": (4, 256, 4, 64, True, "dead", False),
    "t2048_d128": (4, 2048, 8, 128, False, None, False),
    # the LM-32k path's attention (phase 18): causal, q/k/v views of one qkv
    "lm_causal": (4, 4096, 8, 64, True, None, True),
    # D not a multiple of 4 (4-byte copies, zero-filled columns) and T not a
    # multiple of any tile
    "d37_t77": (3, 77, 2, 37, False, None, False),
}
FLASH_TIMED = {"vit_s4": 50, "t2048_d128": 20}   # case -> timed iterations
# dense bf16 on the tensor cores: the bfloat16 K4-K6's products
BF16_OPS_PER_S = 989e12
#: phase 20a: K4-K6's bfloat16 kernels against their plain versions, with
#: FLASH_CASES' keys; "dead_batch" hides every key of batch 1 (its rows see
#: none: out 0, zero gradients)
BF16_CASES = {
    "vit_s4": (32, 64, 3, 64, False, None, True),
    "vit_s4_dead_batch": (32, 64, 3, 64, False, "dead_batch", True),
    "lm_causal": (4, 4096, 8, 64, True, None, True),
    "t100_d48": (8, 100, 4, 48, False, None, False),
    # D not a multiple of 8: the kernels read a padded copy (tma_operand)
    "d36_t77_causal_dead": (3, 77, 2, 36, True, "dead", False),
    # D = 128 (two 64-column boxes a row), T not a multiple of 128
    "d128_t200_causal_dead": (3, 200, 2, 128, True, "dead", False),
}
BF16_ULPS = 2     # the bf16 tolerance: units in the last place of a row's largest |value|
#: phase 20b: case -> (timed iterations, the path whose launches its rows carry)
BF16_TIMED = {"lm_causal": (10, "lm"), "vit_s4": (50, "vit")}


T_START = time.perf_counter()


def stamp(what):
    """The run's elapsed host time after ``what``, for the time budget."""
    print(f"[chip_smoke: {what} done at {time.perf_counter() - T_START:.1f} s]",
          flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=10):
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device milliseconds per call of ``fn``: the sum of the times of
    the kernels (and copies) it ran, from ``torch.profiler``, without the
    host time between them. At small shapes the host's launch rate, not the
    device, sets ``time_ms``; this is the device's share. The profile is
    taken twice and the larger reading kept: the profiler can drop a
    kernel's events (torch 2.11 once read K1 at 0.24 us beside 4.8 us
    readings of the same call) but never adds any. Two profiles that
    recorded no device event at all give None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        readings.append(sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA))
    return max(readings) / iters * 1e-3 if max(readings) > 0 else None


def leaf_config(variant, schedule, wd_apply):
    from tpu_ddp_torch.ops.fused_update import LeafConfig

    v = VARIANTS[variant]
    lr = 1e-3 if v["kind"] == "adamw" else 1e-2
    return LeafConfig(kind=v["kind"], momentum=v["momentum"], wd=v["wd"],
                      wd_apply=bool(wd_apply and v["wd"] > 0),
                      has_clip=v["max_norm"] > 0, max_norm=v["max_norm"],
                      step_const=-1 * lr if schedule == "constant" else None,
                      ema_decay=v["ema"], b1=0.9, b2=0.999, eps=1e-8)


def leaf_bytes_ops(cfg, n, frozen=False):
    """Bytes K1 must move (each operand read once, each result written
    once, plus the 16-byte scalar vector) and float operations it does. A
    frozen leaf reads p (and e) and writes p and u (and e): 12 bytes an
    element, 20 with the EMA; p + 0, and the EMA's four operations."""
    if frozen:
        ema = bool(cfg.ema_decay)
        return 4 * n * (3 + 2 * ema) + 16, (1 + 4 * ema) * n
    slots = 2 + int(cfg.has_m) + int(cfg.has_v) + int(bool(cfg.ema_decay))
    ops = 2                                          # scale, p + u
    ops += 2 if cfg.has_clip else 0                  # (g / norm) * max
    if cfg.kind == "adamw":
        ops += 3 + 4 + 2 + 3 + (2 if cfg.wd_apply else 0)
    else:
        ops += (2 if cfg.wd_apply else 0) + (2 if cfg.has_m else 0)
    ops += 4 if cfg.ema_decay else 0
    return 4 * n * 2 * slots + 16, ops * n


def bound(items):
    """(bound_ms, bound_by) for a list of (cfg, n) or (cfg, n, frozen)
    leaves."""
    total_bytes = sum(leaf_bytes_ops(*it)[0] for it in items)
    total_ops = sum(leaf_bytes_ops(*it)[1] for it in items)
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = total_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Leaf:
    """One leaf's operands on the card, made from a seeded generator. A
    ``frozen`` leaf has no m or v (K1's frozen rows; its p holds some
    ``-0.0``, which ``p + 0.0`` turns into ``+0.0``)."""

    def __init__(self, shape, cfg, gen, offset=0, frozen=False):
        import torch

        n = math.prod(shape)
        self.frozen = frozen

        def make(scale=1.0, positive=False):
            buf = torch.randn(n + offset, generator=gen, device="cuda") * scale
            buf = buf.abs() if positive else buf
            return buf[offset:].view(shape)

        self.cfg, self.n = cfg, n
        self.valid = n              # live elements (ZeRO-1's pad mask past them)
        self.g, self.p = make(), make()
        if frozen:
            self.p[::7] = -0.0
        self.m = make(0.1) if cfg.has_m and not frozen else None
        self.v = make(0.01, positive=True) if cfg.has_v and not frozen else None
        self.e = make() if cfg.ema_decay else None
        self.u = torch.empty(n + offset, device="cuda")[offset:].view(shape)

    def clone(self):
        import copy

        c = copy.copy(self)
        for k in ("g", "p", "m", "v", "e", "u"):
            t = getattr(self, k)
            if t is not None:
                setattr(c, k, t.clone())
        return c


def scalars_for(leaf_list, cfg, schedule):
    import torch

    from tpu_ddp_torch.ops.fused_update import global_norm

    trainable = [lf.g for lf in leaf_list if not lf.frozen]
    g_norm = (global_norm(trainable) if trainable
              else torch.zeros((), device="cuda"))
    step = torch.tensor(-0.7e-2 if schedule == "cosine" else 0.0, device="cuda")
    bc = (1 - 0.9 ** 3, 1 - 0.999 ** 3) if cfg.kind == "adamw" else (1.0, 1.0)
    return torch.stack([g_norm.float(), step.float(),
                        torch.tensor(bc[0], device="cuda"),
                        torch.tensor(bc[1], device="cuda")]).float()


def ulp_diff(a, b):
    """Max distance in units in the last place between two float32 tensors."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude float order onto a monotonic integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def leaf_batch(leaves):
    """K1's multi-tensor wrapper over ``leaves`` (their step's flags, each
    leaf's decay flag)."""
    from tpu_ddp_torch.ops.fused_update import LeafBatch

    return LeafBatch([lf.p for lf in leaves], [lf.m for lf in leaves],
                     [lf.v for lf in leaves], [lf.e for lf in leaves],
                     leaves[0].cfg, [lf.cfg.wd_apply for lf in leaves],
                     us=[lf.u for lf in leaves], valid=[lf.valid for lf in leaves],
                     frozen=[lf.frozen for lf in leaves])


def plain_outputs(lf, scalars):
    """The plain version's ``(u, p, m, v, e)`` for one leaf, flat: the
    update, then the pad mask past ``lf.valid`` (``update_math_masked``);
    a frozen leaf's ``update_math_frozen``."""
    from tpu_ddp_torch.ops.fused_update import update_math_frozen, update_math_masked

    flat = [None if t is None else t.reshape(-1) for t in (lf.g, lf.p, lf.m, lf.v, lf.e)]
    if lf.frozen:
        return update_math_frozen(flat[1], flat[4], lf.cfg)
    return update_math_masked(*flat, scalars, lf.cfg, start=0,
                              mask_size=lf.valid if lf.valid < lf.n else None)


def compare(leaves, scalars):
    """K1 over all of ``leaves`` in one multi-tensor call and the plain
    version leaf by leaf, on copies; (max_abs_err, max_ulp, launches), each
    output of all leaves compared at once, bit for bit (``ulp_diff`` maps
    -0.0 and +0.0 to 0, so the signs of zeros are compared too)."""
    import torch

    from tpu_ddp_torch import ops

    refs, krns = [lf.clone() for lf in leaves], [lf.clone() for lf in leaves]
    before = ops.LAUNCHES["fused_update"]
    leaf_batch(krns).run([k.g for k in krns], scalars)
    launches = ops.LAUNCHES["fused_update"] - before
    got, want = {k: [] for k in "upmve"}, {k: [] for k in "upmve"}
    for ref, krn in zip(refs, krns):
        for k, w in zip("upmve", plain_outputs(ref, scalars)):
            if w is not None:
                want[k].append(w)
                got[k].append(getattr(krn, k).reshape(-1))
    worst_abs, worst_ulp = 0.0, 0
    for k in "upmve":
        if not want[k]:
            continue
        g, w = torch.cat(got[k]), torch.cat(want[k])
        if not bool((g.isfinite() == w.isfinite()).all()):
            fail(f"K1 {k}: finite pattern differs from the plain version")
        if not bool((g.signbit() == w.signbit()).all()):
            fail(f"K1 {k}: the sign of a value (or of a zero) differs from the "
                 "plain version")
        if g.numel():
            worst_abs = max(worst_abs, float((g - w).abs().nan_to_num().max()))
            worst_ulp = max(worst_ulp, ulp_diff(g, w))
    return worst_abs, worst_ulp, launches


def vit_leaf_shapes():
    """ViT-S/4's parameter shapes, in the model's order."""
    from tpu_ddp_torch.models import MODEL_REGISTRY

    shapes = [tuple(p.shape) for _, p in
              MODEL_REGISTRY["vit_s4"]().named_parameters()]
    if len(shapes) != VIT_LEAVES:
        fail(f"vit_s4 has {len(shapes)} parameter leaves, expected {VIT_LEAVES}")
    return shapes


def resnet_leaf_shapes(name, num_classes, leaves):
    """The parameter names and shapes of the registry's ``name`` at
    ``num_classes``, in the model's order."""
    import torch

    from tpu_ddp_torch.models import MODEL_REGISTRY

    with torch.device("meta"):
        model = MODEL_REGISTRY[name](num_classes=num_classes)
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    if len(named) != leaves:
        fail(f"{name} has {len(named)} parameter leaves, expected {leaves}")
    return named


def head_only(named):
    """(shape, frozen) a leaf of ``named``: all but the head frozen, as
    ``--freeze head`` leaves them."""
    return [(shape, not n.startswith("head.")) for n, shape in named]


def phase_kernel_vs_plain():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    vit_shapes = vit_leaf_shapes()
    lm_shapes = lm_leaf_shapes(LM_32K, LM_SEQ, LM_LEAVES)
    r50 = head_only(resnet_leaf_shapes("resnet50", FT_CLASSES, R50_LEAVES))
    results = {}
    print("phase 3: K1 vs plain version, one launch a group (max |diff|, max ulp, "
          "launches)", flush=True)
    for variant in VARIANTS:
        for schedule in ("constant", "cosine"):
            groups = {
                "netresdeep": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                               for s in NETRESDEEP_LEAVES],
                "vit_s4": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                           for s in vit_shapes],
                "lm_32k": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                           for s in lm_shapes],
                "ragged": [Leaf(s, leaf_config(variant, schedule, True), gen)
                           for s in RAGGED],
                "unaligned": [Leaf((1_000_003,), leaf_config(variant, schedule, True),
                                   gen, offset=1)],
                "large": [Leaf((LARGE,), leaf_config(variant, schedule, True), gen)],
                "mixed": [Leaf(s, leaf_config(variant, schedule, wd), gen, offset=off)
                          for s, off, wd in MIXED],
                # frozen rows (--freeze): half of NetResDeep's and of the mixed
                # group's leaves, all of NetResDeep's, and ResNet-50's head-only
                # fine-tune (161 leaves: two launches)
                "netresdeep_frozen": [
                    Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen,
                         frozen=i % 2 == 0) for i, s in enumerate(NETRESDEEP_LEAVES)],
                "all_frozen": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen,
                                    frozen=True) for s in NETRESDEEP_LEAVES],
                "mixed_frozen": [
                    Leaf(s, leaf_config(variant, schedule, wd), gen, offset=off,
                         frozen=i % 2 == 1) for i, (s, off, wd) in enumerate(MIXED)],
                "resnet50": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2), gen)
                             for s, _ in r50],
                "resnet50_head": [Leaf(s, leaf_config(variant, schedule, len(s) >= 2),
                                       gen, frozen=f) for s, f in r50],
            }
            for group, leaves in groups.items():
                scalars = scalars_for(leaves, leaves[0].cfg, schedule)
                err, ulp, launches = compare(leaves, scalars)
                want_launches = -(-len(leaves) // MAX_K1_LEAVES)
                torch.cuda.synchronize()
                results[(variant, schedule, group)] = (err, ulp)
                print(f"  {variant:20s} {schedule:8s} {group:10s} "
                      f"max|diff|={err:.3g} max_ulp={ulp} launches={launches}",
                      flush=True)
                if ulp:
                    fail(f"K1 {variant}/{schedule}/{group}: {ulp} ulp from the "
                         "plain version (must be bitwise)")
                if launches != want_launches:
                    fail(f"K1 {variant}/{schedule}/{group}: {launches} launches "
                         f"for {len(leaves)} leaves, expected {want_launches}")
            del groups
    bitwise = all(ulp == 0 for _, ulp in results.values())
    print(f"  K1 bitwise equal to its plain version everywhere: {bitwise}",
          flush=True)
    return results


#: ZeRO-1 (phases 3b, 14, 15): rank counts whose shards phase 3b checks,
#: and the mask's edge cases as (leaf size, ranks, rank, offset in floats):
#: the live count inside a float4 (1,022 of 1,024), in a shard's second
#: 16,384-element chunk (NetResDeep's fc1.weight at 3 ranks: 21,844 of
#: 21,846), at a chunk's end (16,384 of 16,385), 0 (a 1-element leaf's
#: shards past rank 0), and unaligned shards on the scalar path
ZERO1_SHARDS = (2, 3, 4, 8)
ZERO1_EDGES = [(4094, 4, 3, 0), (65_536, 3, 2, 0), (32_769, 2, 1, 0),
               (1, 4, 1, 0), (1, 4, 3, 0), (10, 3, 2, 0), (1003, 2, 1, 1),
               (1003, 2, 0, 1), (100_001, 3, 2, 3)]


def shard_leaf(shape, n, r, cfg, gen, offset=0, frozen=False):
    """Rank r's shard of a leaf of ``shape`` over n ranks (ceil(size / n)
    elements), its live count set as ``Zero1Partition`` sets it."""
    from tpu_ddp_torch.ops.fused_update import shard_valid

    size = math.prod(shape)
    s = -(-size // n)
    lf = Leaf((s,), cfg, gen, offset, frozen=frozen)
    lf.valid = shard_valid(size, r * s, s)
    return lf


def phase_masked_vs_plain():
    """Phase 3b: K1 with ZeRO-1's pad mask against its plain version,
    bitwise, one launch a group: every recipe of phase 3, NetResDeep's and
    ViT-S/4's shards at every rank of 2, 3, 4 and 8, and the edge cases;
    then frozen shards: ResNet-18's head-only fine-tune (phase 19d) at every
    rank of 2 and 3, and the edge cases with every other leaf frozen."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    models = {"netresdeep": NETRESDEEP_LEAVES, "vit_s4": vit_leaf_shapes()}
    lm_shapes = lm_leaf_shapes({}, LM_RANK_SEQ, LM_DEFAULT_LEAVES)
    r18 = head_only(resnet_leaf_shapes("resnet18", 100, R18_LEAVES))
    results, live_mask_rows, frozen_mask_rows, groups = {}, 0, 0, 0
    print("phase 3b: K1 with the ZeRO-1 pad mask vs plain version, one launch a "
          "group (max |diff|, max ulp)", flush=True)
    for variant in VARIANTS:
        for schedule in ("constant", "cosine"):
            cases = {f"{model} {n} ranks rank {r}":
                     [(s, n, r, 0, len(s) >= 2) for s in shapes]
                     for model, shapes in models.items()
                     for n in ZERO1_SHARDS for r in range(n)}
            cases.update({f"lm_default {LM_RANKS} ranks rank {r}":
                          [(s, LM_RANKS, r, 0, len(s) >= 2) for s in lm_shapes]
                          for r in range(LM_RANKS)})
            cases["edges"] = [((size,), n, r, off, True)
                              for size, n, r, off in ZERO1_EDGES]
            cases.update({f"resnet18 head-only {n} ranks rank {r}":
                          [(s, n, r, 0, len(s) >= 2, f) for s, f in r18]
                          for n in (2, 3) for r in range(n)})
            cases["frozen edges"] = [((size,), n, r, off, True, i % 2 == 0)
                                     for i, (size, n, r, off) in enumerate(ZERO1_EDGES)]
            worst = (0.0, 0)
            for name, spec in cases.items():
                leaves = [shard_leaf(shape, n, r, leaf_config(variant, schedule, wd),
                                     gen, off, *cold)
                          for shape, n, r, off, wd, *cold in spec]
                scalars = scalars_for(leaves, leaves[0].cfg, schedule)
                err, ulp, launches = compare(leaves, scalars)
                live_mask_rows += sum(lf.valid < lf.n for lf in leaves)
                frozen_mask_rows += sum(lf.frozen and lf.valid < lf.n for lf in leaves)
                groups += 1
                results[(variant, schedule, name)] = (err, ulp)
                worst = (max(worst[0], err), max(worst[1], ulp))
                if ulp:
                    fail(f"masked K1 {variant}/{schedule}/{name}: {ulp} ulp from "
                         "the plain version (must be bitwise)")
                if launches != 1:
                    fail(f"masked K1 {variant}/{schedule}/{name}: {launches} "
                         "launches, expected 1")
                del leaves
            torch.cuda.synchronize()
            print(f"  {variant:20s} {schedule:8s} {len(cases)} groups: "
                  f"max|diff|={worst[0]:.3g} max_ulp={worst[1]}", flush=True)
    print(f"  {groups} groups, one launch each; rows with a live mask "
          f"{live_mask_rows}, of them frozen {frozen_mask_rows}; bitwise equal "
          "everywhere: True", flush=True)
    if not live_mask_rows or not frozen_mask_rows:
        fail("phase 3b ran no leaf with a live mask, or no frozen one")
    return results


def library_call(variant, leaves):
    """One PyTorch multi-tensor optimizer call over ``leaves`` (yardstick)."""
    import torch

    v = VARIANTS[variant]
    params = [lf.p for lf in leaves]
    grads = [lf.g for lf in leaves]
    if v["kind"] == "sgd":
        moms = [lf.m for lf in leaves] if v["momentum"] else []
        return lambda: torch._fused_sgd_(
            params, grads, moms, weight_decay=v["wd"], momentum=v["momentum"],
            lr=1e-2, dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
    steps = [torch.tensor(3.0, device="cuda") for _ in leaves]
    return lambda: torch._fused_adamw_(
        params, grads, [lf.m for lf in leaves], [lf.v for lf in leaves], [],
        steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=v["wd"], eps=1e-8,
        amsgrad=False, maximize=False)


def time_group(variant, shapes, iters, frozen=None):
    """(kernel_ms, plain_ms, library_ms, bound_ms, bound_by) for one step's
    worth of K1 over ``shapes`` (constant schedule): one multi-tensor call
    against the plain version leaf by leaf. ``frozen`` (one flag a shape)
    marks frozen leaves; the yardstick then updates the trainable ones."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops.fused_update import update_math_frozen

    update_math = ops.resolve("fused_update")["plain"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    frozen = frozen or [False] * len(shapes)
    leaves = [Leaf(s, leaf_config(variant, "constant", len(s) >= 2), gen, frozen=f)
              for s, f in zip(shapes, frozen)]
    scalars = scalars_for(leaves, leaves[0].cfg, "constant")
    batch, grads = leaf_batch(leaves), [lf.g for lf in leaves]

    def kernel():
        # what FusedUpdate.apply runs a step after its prologue: the grads'
        # check and one launch
        batch.run(grads, scalars)

    def plain():
        for lf in leaves:
            if lf.frozen:
                update_math_frozen(lf.p, lf.e, lf.cfg)
                continue
            u = update_math(lf.g, lf.p, lf.m, lf.v, lf.e, scalars, lf.cfg)[0]
            lf.p + u

    lib = library_call(variant, [lf for lf in leaves if not lf.frozen])
    # turns: kernel, plain, plain, kernel (and the yardstick between)
    k1 = time_ms(kernel, iters)
    p1 = time_ms(plain, iters)
    lib_ms = time_ms(lib, iters)
    p2 = time_ms(plain, iters)
    k2 = time_ms(kernel, iters)
    b_ms, b_by = bound([(lf.cfg, lf.n, lf.frozen) for lf in leaves])
    dev = {"device_ms": device_ms(kernel, 10), "plain_device_ms": device_ms(plain, 10),
           "library_device_ms": device_ms(lib, 10)}
    return (k1 + k2) / 2, (p1 + p2) / 2, lib_ms, b_ms, b_by, dev


def k1_row(name, variant, shapes, group, iters, launches, results, label,
           frozen=None):
    """One ``kernels`` row of K1 over ``shapes`` under ``variant`` (with
    ``frozen`` leaves, ``time_group``)."""
    from tpu_ddp_torch import ops

    entry = ops.KERNELS["fused_update"]
    k_ms, p_ms, l_ms, b_ms, b_by, dev = time_group(variant, shapes, iters, frozen)
    err = max(results[(variant, s, group)][0] for s in ("constant", "cosine"))
    print(f"  {name:36s} kernel {k_ms:.5f} ms  plain {p_ms:.5f} ms  "
          f"library {l_ms:.5f} ms  bound {b_ms:.5f} ms ({b_by}); device "
          f"only: kernel {dev['device_ms']}, plain {dev['plain_device_ms']}, "
          f"library {dev['library_device_ms']} ms", flush=True)
    return {
        "name": name, "route": entry["route"], "source": entry["source"],
        "replaces": entry["replaces"], "launches": launches,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
        "shapes": label, "recipe": variant, **dev,
    }


def phase_timing(results, main_launches):
    print("phase 6: K1 timing (CUDA events; ms per step of the listed leaves)",
          flush=True)
    rows = [k1_row("fused_update", "sgd", NETRESDEEP_LEAVES, "netresdeep", 500,
                   main_launches, results, "netresdeep 9 leaves (76,074)")]
    for variant in VARIANTS:
        rows.append(k1_row(f"fused_update[{variant},2^24]", variant, [(LARGE,)],
                           "large", 50, main_launches, results, "one leaf of 2^24"))
    return rows


def phase_main_path():
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * MAIN_STEPS_PER_EPOCH), "--epochs", "2", "--kernels",
            "--eval-each-epoch", "--log-every-epochs", "1",
            "--n-chans1", "32", "--n-blocks", "10", "--batch-size", "32",
            "--lr", "1e-2", "--optimizer", "sgd"]
    print(f"phase 4: main path: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    ops.reset_launch_counts()
    metrics = cli.main(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = metrics["steps"]
    losses = metrics["step_losses"]
    print(f"  steps {steps}, K1 launches {counts['fused_update']} "
          f"(one a step: {steps}), images/sec/chip "
          f"{metrics['images_per_sec_per_chip']:.1f}, training time "
          f"{metrics['total_seconds']:.3f} s, final test accuracy "
          f"{metrics['test_accuracy']:.4f}", flush=True)
    if steps != 2 * MAIN_STEPS_PER_EPOCH:
        fail(f"main path ran {steps} steps, expected {2 * MAIN_STEPS_PER_EPOCH}")
    if any(n for name, n in counts.items() if name != "fused_update"):
        fail(f"the NetResDeep path launched attention kernels: {counts}")
    if counts["fused_update"] != steps:
        fail(f"K1 launched {counts['fused_update']} times in {steps} steps, "
             f"expected {steps}")
    if not all(math.isfinite(x) for x in losses):
        fail("main path produced a non-finite loss")
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}",
          flush=True)
    if not last < first:
        fail("main path losses did not fall")
    # the reference model's eval-mode accuracy on this synthetic task sits
    # near 0.3 (tied BatchNorm running stats; the JAX trainer shows the same
    # on the CPU): require it clearly above chance (0.1)
    if not math.isfinite(metrics["test_loss"]) or metrics["test_accuracy"] < 0.2:
        fail(f"final eval out of range: {metrics['test_accuracy']}, "
             f"{metrics['test_loss']}")
    return args, metrics, counts["fused_update"]


def run_steps(args, n_steps):
    """A fresh Trainer for ``args``; its first ``n_steps`` train steps of
    epoch 1. Returns (trainer, per-step losses)."""
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
    trainer.train_loader.set_epoch(1)
    losses = []
    for batch in trainer.train_loader.epoch_batches():
        if len(losses) == n_steps:
            break
        trainer.state, m = trainer.train_step(trainer.state, trainer.to_device(batch))
        losses.append(m["loss"])
    return trainer, [float(x) for x in losses]


def phase_plain_same_steps(args, metrics):
    """(a) the first steps of phase 4 again with the plain update, under
    cuDNN's default algorithms, whose backward sums in a run-dependent
    order: losses within rtol 1e-5 for PLAIN_STEPS_RTOL steps. (b) with
    cuDNN's deterministic algorithms, a K1 run and a plain-update run of
    PLAIN_STEPS steps from the same start: losses and final weights equal
    bit for bit (K1 is bitwise equal to the plain update)."""
    import torch

    plain_args = [a for a in args if a != "--kernels"]
    trainer, got = run_steps(plain_args, PLAIN_STEPS)
    if trainer.tx.fused is not None:
        fail("the plain run was built with K1")
    want = metrics["step_losses"][:PLAIN_STEPS]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"phase 5a: {PLAIN_STEPS} steps with the plain update, relative loss "
          f"difference to phase 4 per step: {' '.join(f'{r:.2g}' for r in rel)}",
          flush=True)
    worst = max(rel[:PLAIN_STEPS_RTOL])
    print(f"  max over the first {PLAIN_STEPS_RTOL} steps {worst:.3g} "
          "(limit 1e-5)", flush=True)
    if not worst <= 1e-5:
        fail("plain-update losses disagree with the K1 run")

    torch.backends.cudnn.deterministic = True
    try:
        k_trainer, k_losses = run_steps(args, PLAIN_STEPS)
        p_trainer, p_losses = run_steps(plain_args, PLAIN_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    k_sd, p_sd = k_trainer.state.model.state_dict(), p_trainer.state.model.state_dict()
    same = k_losses == p_losses and all(torch.equal(k_sd[n], p_sd[n]) for n in k_sd)
    print(f"phase 5b: deterministic cuDNN, {PLAIN_STEPS} steps K1 vs plain "
          f"update: losses and weights bitwise equal: {same} "
          f"(last loss {k_losses[-1]:.6f} vs {p_losses[-1]:.6f})", flush=True)
    if not same:
        fail("K1 run and plain-update run differ under deterministic cuDNN")


def close(got, want, atol, rtol):
    """(max |got - want|, all within atol + rtol * |want|)."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.abs()).all())


def flash_inputs(case, seed=0, bf16=False, cases=None):
    """q, k, v, do and the key mask of ``FLASH_CASES[case]`` on the card, or
    of ``BF16_CASES[case]`` in bfloat16 (drawn in float32, then rounded);
    ``cases``: another table of the same form."""
    import torch

    if cases is None:
        cases = BF16_CASES if bf16 else FLASH_CASES
    B, T, H, D, causal, mask_kind, views = cases[case]
    dtype = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if views:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(dtype)
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
    do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
    mask = None
    if mask_kind is not None:
        mask = torch.ones((B, T), device="cuda")
    if mask_kind == "dead":
        # batch 0 hides its last quarter of keys; batch 1 its first quarter,
        # so under causal its first T/4 queries see no key at all
        mask[0, 3 * T // 4:] = 0
        mask[1, :T // 4] = 0
    elif mask_kind == "dead_batch":
        # batch 0 hides its last quarter of keys; batch 1 every key
        mask[0, 3 * T // 4:] = 0
        mask[1] = 0
    return q, k, v, do, mask, causal


def phase_flash_vs_plain(cases=None, label="phase 7"):
    """K4-K6 against their plain versions at each of ``cases``' shapes
    (default ``FLASH_CASES``), float32, with ``FWD_TOL`` and ``GRAD_TOL``."""
    import torch

    from tpu_ddp_torch.ops import flash_attention as fa

    cases = FLASH_CASES if cases is None else cases
    print(f"{label}: K4/K5/K6 vs plain versions (max |diff|)", flush=True)
    results, failed = {}, []
    for case in cases:
        q, k, v, do, mask, causal = flash_inputs(case, cases=cases)
        want_out, want_lse = fa.forward_plain(q, k, v, mask, causal)
        di = fa.row_dot(do, want_out)
        want_dq = fa.dq_plain(q, k, v, do, want_lse, di, mask, causal)
        want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di, mask, causal)
        out, lse = fa.flash_forward(q, k, v, mask, causal)
        dq = fa.flash_dq(q, k, v, do, want_lse, di, mask, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal)
        # each output row is written once by its block (no atomics): a
        # second call gives the same bits
        again = (fa.flash_dq(q, k, v, do, want_lse, di, mask, causal),
                 *fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal))
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
        if not repeat:
            failed.append(f"{case}: two calls of K5/K6 differ")
        errs, size = {}, {}
        for name, got, want, tol in (
                ("out", out, want_out, FWD_TOL), ("lse", lse, want_lse, FWD_TOL),
                ("dq", dq, want_dq, GRAD_TOL), ("dk", dk, want_dk, GRAD_TOL),
                ("dv", dv, want_dv, GRAD_TOL)):
            err, ok = close(got, want, **tol)
            errs[name], size[name] = err, float(want.abs().max())
            if not ok or not bool(torch.isfinite(got).all()):
                failed.append(f"{case} {name} (max |diff| {err:.3g})")
        if mask is not None:
            T = q.shape[1]
            dead = (bool((out[1, :T // 4] == 0).all())
                    and bool((dq[1, :T // 4] == 0).all())
                    and bool((lse[1, :, :T // 4] == fa.NEG).all()))
            if not dead:
                failed.append(f"{case}: rows with no visible key are not exactly 0")
            hidden = mask == 0
            if not (bool((dk[hidden] == 0).all()) and bool((dv[hidden] == 0).all())):
                failed.append(f"{case}: masked keys' dk/dv are not exactly 0")
        results[case] = errs
        print(f"  {case:18s} {tuple(q.shape)} causal={causal} mask={mask is not None} "
              + " ".join(f"{n}={e:.3g} (of {size[n]:.3g})" for n, e in errs.items())
              + f" K5/K6 bitwise on a second call: {repeat}", flush=True)
        del q, k, v, do, want_out, want_lse, want_dq, want_dk, want_dv, again
    if failed:
        fail("flash kernels disagree with their plain versions: " + "; ".join(failed))
    return results


def vit_args(attention):
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * VIT_STEPS_PER_EPOCH), "--epochs", "2", "--model", "vit_s4",
            "--attention", attention, "--kernels", "--optimizer", "adamw",
            "--lr", "1e-3", "--batch-size", "32", "--eval-each-epoch",
            "--log-every-epochs", "1"]


def phase_vit_main_path():
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    runs = {}
    for attention in ("flash", "full"):
        args = vit_args(attention)
        print(f"phase 8: ViT main path: tpu_ddp_torch.cli.train {' '.join(args)}",
              flush=True)
        ops.reset_launch_counts()
        metrics = cli.main(args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps, evals = metrics["steps"], metrics["eval_batches"]
        losses = metrics["step_losses"]
        print(f"  steps {steps}, eval batches {evals}, launches {counts}, "
              f"images/sec/chip {metrics['images_per_sec_per_chip']:.1f}, "
              f"training time {metrics['total_seconds']:.3f} s, final test "
              f"accuracy {metrics['test_accuracy']:.4f}", flush=True)
        if steps != 2 * VIT_STEPS_PER_EPOCH:
            fail(f"ViT path ran {steps} steps, expected {2 * VIT_STEPS_PER_EPOCH}")
        flash = attention == "flash"
        want = {name: 0 for name in counts}
        want.update({"fused_update": steps,
                     "flash_attention_fwd": VIT_DEPTH * (steps + evals) if flash else 0,
                     "flash_attention_dq": VIT_DEPTH * steps if flash else 0,
                     "flash_attention_dkv": VIT_DEPTH * steps if flash else 0})
        if counts != want:
            fail(f"ViT --attention {attention}: launches {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"ViT --attention {attention} produced a non-finite loss")
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}",
              flush=True)
        if not last < first:
            fail(f"ViT --attention {attention} losses did not fall")
        if not math.isfinite(metrics["test_loss"]) or metrics["test_accuracy"] < 0.2:
            fail(f"ViT final eval out of range: {metrics['test_accuracy']}, "
                 f"{metrics['test_loss']}")
        runs[attention] = (metrics, counts)
    got = runs["full"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    want = runs["flash"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"  --attention full vs flash, relative loss difference per step: "
          f"{' '.join(f'{r:.2g}' for r in rel)} (limit {FULL_STEPS_RTOL})", flush=True)
    if not max(rel) <= FULL_STEPS_RTOL:
        fail("--attention full and flash losses disagree over the first steps")
    return runs


def attention_work(kind, B, T, H, D, causal=False, elem=4):
    """(bytes, product operations, other float32 operations) of one
    unmasked call: each input read once, each output written once (the
    (B, T, H, D) tensors ``elem`` bytes an element, lse and di 4); two
    operations per multiply-add of its products (forward: S and P V; dq: S,
    dP and dS K; dk/dv: S, dP, P^T dO and dS^T Q), and the per-score softmax
    work, over the (query, key) pairs the call needs: all T^2 of a head, or
    under ``causal`` the T(T+1)/2 visible ones."""
    n, rows = B * T * H * D, B * H * T
    pairs = B * H * T * (T + 1) // 2 if causal else B * H * T * T
    if kind == "fwd":        # read q, k, v; write out, lse
        return elem * 4 * n + 4 * rows, 4 * pairs * D, 5 * pairs
    if kind == "dq":         # read q, k, v, dO, lse, di; write dq
        return elem * 5 * n + 8 * rows, 6 * pairs * D, 6 * pairs
    # read q, k, v, dO, lse, di; write dk, dv
    return elem * 6 * n + 8 * rows, 8 * pairs * D, 6 * pairs


def attention_bound(kind, B, T, H, D, causal=False):
    """(bound_ms, bound_by) of one call: its bytes over the HBM rate
    against all its float32 operations over the float32 rate."""
    nbytes, products, other = attention_work(kind, B, T, H, D, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products + other) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_tc(kind, B, T, H, D, causal=False):
    """(bound_ms, bound_by) of one call of K4, K5 or K6 in 3xTF32: its bytes
    against its products as three TF32 products each over the tensor
    cores' rate."""
    nbytes, products, _ = attention_work(kind, B, T, H, D, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * products / TF32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_bf16(kind, B, T, H, D, causal=False):
    """(bound_ms, bound_by) of one bfloat16 call of K4, K5 or K6: its bytes
    (bf16 tensors, float32 lse and di) over the HBM rate, against its
    products over the bf16 tensor-core rate and its other float32
    operations over the float32 rate (they run on other units: the larger
    of the two)."""
    nbytes, products, other = attention_work(kind, B, T, H, D, causal, elem=2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(products / BF16_OPS_PER_S, other / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_timing_rows(case, iters, errors, counts, bf16=False):
    """K4, K5 and K6 at ``FLASH_CASES[case]`` (or, ``bf16``, their bfloat16
    kernels at ``BF16_CASES[case]``), each in turns with its plain version
    and beside ``scaled_dot_product_attention`` in the same dtype (forward
    for K4, its backward for K5 and K6) and the bounds: one ``kernels`` row
    each, with the errors of the kernel-against-plain phase at the case and
    the path's launch ``counts``."""
    import torch
    import torch.nn.functional as F

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops import flash_attention as fa

    q, k, v, do, _, causal = flash_inputs(case, seed=1, bf16=bf16)
    B, T, H, D = q.shape
    suffix, label = ("_bf16", f"bf16,{case}") if bf16 else ("", case)
    out, lse = fa.forward_plain(q, k, v, causal=causal)
    di = fa.row_dot(do, out)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves),
                                              is_causal=causal)
    sdpa_do = do.transpose(1, 2)
    library = {
        "fwd": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal),
        "bwd": lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_do,
                                           retain_graph=True),
    }
    lib_ms = {key: time_ms(fn, iters) for key, fn in library.items()}
    lib_dev = {key: device_ms(fn, iters) for key, fn in library.items()}
    timed = {
        "flash_attention_fwd": (
            "fwd", lambda: fa.flash_forward(q, k, v, causal=causal),
            lambda: fa.forward_plain(q, k, v, causal=causal), ("out", "lse")),
        "flash_attention_dq": (
            "dq", lambda: fa.flash_dq(q, k, v, do, lse, di, causal=causal),
            lambda: fa.dq_plain(q, k, v, do, lse, di, causal=causal), ("dq",)),
        "flash_attention_dkv": (
            "dkv", lambda: fa.flash_dkv(q, k, v, do, lse, di, causal=causal),
            lambda: fa.dkv_plain(q, k, v, do, lse, di, causal=causal), ("dk", "dv")),
    }
    rows = []
    for name, (kind, kernel, plain, outputs) in timed.items():
        entry = ops.KERNELS[name + suffix]
        k1 = time_ms(kernel, iters)
        p1 = time_ms(plain, iters)
        p2 = time_ms(plain, iters)
        k2 = time_ms(kernel, iters)
        lib_key = "fwd" if kind == "fwd" else "bwd"
        l_ms = lib_ms[lib_key]
        dev = {"device_ms": device_ms(kernel, iters),
               "plain_device_ms": device_ms(plain, iters),
               "library_device_ms": lib_dev[lib_key],
               "launch": fa.forward_launch_info(D, q.dtype) if kind == "fwd"
               else fa.backward_launch_info(kind, D, q.dtype)}
        if bf16:
            b_ms, b_by = attention_bound_bf16(kind, B, T, H, D, causal)
        else:
            b_ms, b_by = attention_bound(kind, B, T, H, D, causal)
            tc_ms, tc_by = attention_bound_tc(kind, B, T, H, D, causal)
            dev.update(bound_tc_ms=tc_ms, bound_tc_by=tc_by)
            print(f"  {name + '[' + label + ']':36s} 3xTF32 bound {tc_ms:.5f} ms "
                  f"({tc_by})", flush=True)
        print(f"  {name + '[' + label + ']':36s} launch {dev['launch']}", flush=True)
        rows.append({
            "name": f"{name}[{label}]", "route": entry["route"],
            "source": entry["source"], "replaces": entry["replaces"],
            "launches": counts[name + suffix],
            "max_abs_err": max(errors[case][o] for o in outputs),
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "shapes": f"(B, T, H, D) = {(B, T, H, D)}, causal={causal}, {q.dtype}",
            "library": "scaled_dot_product_attention "
                       + ("forward" if kind == "fwd" else "backward (dq, dk, dv)")
                       + (" is_causal=True" if causal else "") + f", {q.dtype}",
            **dev,
        })
        dev_share = ("" if dev["device_ms"] is None
                     else f", {100 * b_ms / dev['device_ms']:.1f}% by device time")
        print(f"  {name + '[' + label + ']':36s} kernel {(k1 + k2) / 2:.5f} ms  "
              f"plain {(p1 + p2) / 2:.5f} ms  library {l_ms:.5f} ms  "
              f"bound {b_ms:.5f} ms ({b_by}; {200 * b_ms / (k1 + k2):.1f}% of it by "
              f"events{dev_share}); device only: kernel "
              f"{dev['device_ms']}, plain {dev['plain_device_ms']}, "
              f"library {dev['library_device_ms']} ms", flush=True)
    k5, k6 = rows[-2], rows[-1]
    dev_sum = (None if k5["device_ms"] is None or k6["device_ms"] is None
               else k5["device_ms"] + k6["device_ms"])
    print(f"  K5 + K6 [{label}]: events {k5['ms'] + k6['ms']:.5f} ms, device {dev_sum} ms; "
          f"SDPA backward (dq, dk, dv): events {lib_ms['bwd']:.5f} ms, device "
          f"{lib_dev['bwd']} ms", flush=True)
    return rows


def phase_flash_timing(results, counts):
    print("phase 9: timing on the ViT path (CUDA events; ms per call)", flush=True)
    rows = [k1_row("fused_update[vit_s4]", VIT_RECIPE, vit_leaf_shapes(), "vit_s4",
                   100, counts["fused_update"], results["k1"],
                   f"vit_s4 {VIT_LEAVES} leaves (2,693,194)")]
    for case, iters in FLASH_TIMED.items():
        rows += flash_timing_rows(case, iters, results["flash"], counts)
    return rows


def causal_against_full(case, iters):
    """K4, K5 and K6 at ``FLASH_CASES[case]``'s shape with and without
    ``causal``, ms by CUDA events in turns (causal, full, full, causal; the
    profiler drops events late in the run, and at a few ms a call the
    events measure the device). A causal call needs (T + 1) / 2T of the
    full call's (query, key) pairs, so a ratio near that says the skipped
    tiles cost nothing and the diagonal's partly visible tiles and the last
    blocks leave no tail."""
    from tpu_ddp_torch.ops import flash_attention as fa

    q, k, v, do, _, _ = flash_inputs(case, seed=1)
    T = q.shape[1]
    calls = {}
    for causal in (True, False):
        out, lse = fa.forward_plain(q, k, v, causal=causal)
        di = fa.row_dot(do, out)
        calls[causal] = {
            "flash_attention_fwd": lambda c=causal: fa.flash_forward(q, k, v, causal=c),
            "flash_attention_dq": lambda c=causal, lse=lse, di=di: fa.flash_dq(
                q, k, v, do, lse, di, causal=c),
            "flash_attention_dkv": lambda c=causal, lse=lse, di=di: fa.flash_dkv(
                q, k, v, do, lse, di, causal=c),
        }
    ratios = {}
    for name in calls[True]:
        c1 = time_ms(calls[True][name], iters)
        f1 = time_ms(calls[False][name], iters)
        f2 = time_ms(calls[False][name], iters)
        c2 = time_ms(calls[True][name], iters)
        ratios[name] = (c1 + c2) / (f1 + f2)
        print(f"  {name + '[' + case + ']':36s} ms causal {c1:.5f}, {c2:.5f}; "
              f"full {f1:.5f}, {f2:.5f}; causal / full {ratios[name]:.4f} (the pairs' "
              f"ratio {(T + 1) / (2 * T):.4f})", flush=True)
    return ratios


def phase_lm_timing(k1_results, flash_results, counts):
    """Phase 18 (d): K1 at LM-32k's 54 leaves under the LM's recipe, and
    K4-K6 at its causal (4, 4,096, 8, 64), with phase 18 (a)'s flash run's
    launches; then K4-K6 causal against full at that shape."""
    print("phase 18d: timing on the LM path (CUDA events; ms per call)", flush=True)
    rows = [k1_row("fused_update[lm_32k]", VIT_RECIPE,
                   lm_leaf_shapes(LM_32K, LM_SEQ, LM_LEAVES), "lm_32k", 20,
                   counts["fused_update"], k1_results,
                   f"lm_32k {LM_LEAVES} leaves (47,507,712)")]
    rows += flash_timing_rows("lm_causal", LM_TIMED_ITERS, flash_results, counts)
    causal_against_full("lm_causal", LM_TIMED_ITERS)
    return rows


# ---- phases 10-13: the compressed gradient ring on two ranks (K2, K3) ----

QUANT_BLOCK = 256                      # --grad-compress-block default
QUANT_SIZES = [1, 255, 257, 1_000_003, LARGE]
QUANT_BLOCKS = [1, 64, 256, 1000, 4096]   # 4096: one thread block a scale block
RING_LEAVES = [math.prod(s) for s in NETRESDEEP_LEAVES] + [1 << 22]
#: steps an epoch a rank of phases 12 and 14 (100 until phase 17 came:
#: the launches, not the steps, take most of their time)
DP_STEPS_PER_EPOCH = 25
DP_LOSS_ATOL = 0.05
VIT_B16_LEAVES = 151


def ring_layout(shapes, n):
    """The flat ring's layout (``collectives.FlatLayout``) of leaves of
    ``shapes`` at ``n`` ranks, as ``GradCompressor`` builds it."""
    import torch

    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    template = {str(i): torch.empty(s, device="meta") for i, s in enumerate(shapes)}
    return GradCompressor(GradCompression(block=QUANT_BLOCK), template, n).layout


def vit_b16_leaf_shapes():
    """ViT-B/16's (224x224) parameter shapes: more leaves than K1's table
    of 128 holds."""
    import torch

    from tpu_ddp_torch.models import MODEL_REGISTRY

    with torch.device("meta"):
        model = MODEL_REGISTRY["vit_b16"](image_size=224)
    shapes = [tuple(p.shape) for p in model.parameters()]
    if len(shapes) != VIT_B16_LEAVES:
        fail(f"vit_b16 has {len(shapes)} parameter leaves, expected {VIT_B16_LEAVES}")
    return shapes


def quant_case(x, block, gen, failed, label):
    """K2 and K3 (bare and accumulating) against their plain versions on
    ``x``. Bitwise, except the int8 bytes of a block whose scale is not
    finite: there the scales must agree (NaN with NaN, +-Inf equal) and
    every dequantized element must be non-finite. Returns max |diff|."""
    import torch

    from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    size = x.numel()
    want = quantize_chunk(x, "int8", block)
    got = fused_quant(x, block)
    s_k, s_p = got["scale"], want["scale"]
    finite = torch.isfinite(s_p)
    same_scale = bool((torch.isnan(s_k) == torch.isnan(s_p)).all()) and bool(
        (s_k[~torch.isnan(s_p)] == s_p[~torch.isnan(s_p)]).all())
    rows = finite.repeat_interleave(block)
    same_q = torch.equal(got["q"][rows], want["q"][rows])
    acc = torch.randn(size, generator=gen, device="cuda")
    worst = 0.0
    for add in (None, acc):
        d_k = fused_dequant(got, block, size, add_to=add)
        d_p = dequantize_chunk(got, "int8", block, size)
        d_p = d_p if add is None else add + d_p
        fin = torch.isfinite(d_p)
        bad_block = ~finite.repeat_interleave(block)[:size]
        if not torch.equal(fin, torch.isfinite(d_k)) or bool(fin[bad_block].any()):
            failed.append(f"{label}: K3 non-finite pattern")
        if not torch.equal(d_k[fin].view(torch.int32), d_p[fin].view(torch.int32)):
            failed.append(f"{label}: K3{' +add_to' if add is not None else ''} "
                          "differs from its plain version")
        if size:
            worst = max(worst, float((d_k[fin] - d_p[fin]).abs().max()))
    if not (same_scale and same_q):
        failed.append(f"{label}: K2 scale equal {same_scale}, q equal {same_q}")
    return worst


def _bits(t):
    import torch

    return t.view(torch.int32)


def _same_finite(a, b):
    """Same non-finite pattern, and the same bits wherever finite."""
    import torch

    fin = torch.isfinite(b)
    return torch.equal(fin, torch.isfinite(a)) and torch.equal(_bits(a[fin]), _bits(b[fin]))


def bad_blocks(layout, msg, c):
    """Leaf-major mask of chunk c's elements whose scale block in the int8
    message ``msg`` is not finite."""
    import torch

    bad = torch.zeros(layout.total, dtype=torch.bool, device=msg.device)
    for i, views in enumerate(layout.payload(msg, "int8")):
        nonfinite = ~torch.isfinite(views["scale"])
        if bool(nonfinite.any()):
            layout.chunk(bad, i, c).copy_(
                nonfinite.repeat_interleave(layout.block)[:layout.shard[i]])
    return bad


def segment_case(layout, x, failed, label):
    """Segment K2 (with and without the error) and K3 (accumulating, into
    the shard row, and the n-row gather) over every leaf of ``layout``, at
    every chunk, against their plain versions. Bitwise, except the int8
    bytes of a block whose scale is not finite: there the scales agree (NaN
    with NaN, +-Inf equal) and the error is non-finite in both; K3, given
    the same message, has the same non-finite pattern and the same bits
    elsewhere. Returns max |diff| over finite values."""
    import torch

    from tpu_ddp_torch.ops.fused_quant import (
        segment_dequant,
        segment_dequant_plain,
        segment_quant,
        segment_quant_plain,
    )

    n, nb, block = layout.n, layout.n_blocks, layout.block
    worst, msgs = 0.0, []

    def check(ok, what):
        if not ok:
            failed.append(f"{label}: {what} differs from its plain version")

    for c in range(n):
        err_k, err_p = torch.zeros_like(x), torch.zeros_like(x)
        msg = segment_quant(x, layout, c, err=err_k)
        want = segment_quant_plain(x, layout, c, "int8", err=err_p)
        s_k, s_p = msg[:4 * nb].view(torch.float32), want[:4 * nb].view(torch.float32)
        nan = torch.isnan(s_p)
        check(torch.equal(torch.isnan(s_k), nan) and torch.equal(s_k[~nan], s_p[~nan]),
              f"K2 scale at chunk {c}")
        rows = torch.isfinite(s_p).repeat_interleave(block)
        check(torch.equal(msg[4 * nb:][rows], want[4 * nb:][rows]), f"K2 q at chunk {c}")
        bad = bad_blocks(layout, want, c)
        check(torch.equal(_bits(err_k[~bad]), _bits(err_p[~bad]))
              and not bool(torch.isfinite(err_k[bad]).any())
              and not bool(torch.isfinite(err_p[bad]).any()), f"K2's error at chunk {c}")
        check(torch.equal(segment_quant(x, layout, c), msg), f"K2 without the error at {c}")
        c2 = (c + 1) % n
        acc_k, acc_p = x.clone(), x.clone()
        segment_dequant(msg, layout, acc_k, add=x, add_chunk=c2, out_chunk=c2)
        segment_dequant_plain(msg, layout, "int8", acc_p, add=x, add_chunk=c2, out_chunk=c2)
        check(_same_finite(acc_k, acc_p), f"K3 +add_to at chunk {c2}")
        row_k = torch.zeros(layout.rows.width, device=x.device)
        row_p = torch.zeros_like(row_k)
        segment_dequant(msg, layout, row_k, add=x, add_chunk=c, to_rows=True)
        segment_dequant_plain(msg, layout, "int8", row_p, add=x, add_chunk=c, to_rows=True)
        check(_same_finite(row_k, row_p), f"K3 into the shard row at chunk {c}")
        for a, b in ((acc_k, acc_p), (row_k, row_p)):
            fin = torch.isfinite(b)
            if bool(fin.any()):
                worst = max(worst, float((a[fin] - b[fin]).abs().max()))
        msgs.append(msg)
    gathered = torch.stack(msgs)
    out_k = segment_dequant(gathered, layout, torch.empty_like(x))
    out_p = segment_dequant_plain(gathered, layout, "int8", torch.empty_like(x))
    check(_same_finite(out_k, out_p), f"K3 gather of {n} rows")
    return worst


def phase_quant_vs_plain(rank_counts):
    """Phase 10, with NetResDeep's ring chunks at each of ``rank_counts``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(10)
    failed, worst = [], {}

    def run(label, x, block):
        err = quant_case(x, block, gen, failed, label)
        torch.cuda.synchronize()
        worst[label] = err

    print("phase 10: K2/K3 vs plain versions (bitwise; non-finite blocks by "
          "the sentinel contract)", flush=True)
    for ranks in rank_counts:
        for i, n in enumerate(ring_layout(NETRESDEEP_LEAVES, ranks).shard):
            run(f"netresdeep chunk {i} at {ranks} ranks ({n})",
                torch.randn(n, generator=gen, device="cuda"), QUANT_BLOCK)
    for i, shape in enumerate(vit_leaf_shapes()):
        n = math.prod(shape)
        run(f"vit_s4 chunk {i} ({(n + n % 2) // 2})",
            torch.randn((n + n % 2) // 2, generator=gen, device="cuda") * 0.02, QUANT_BLOCK)
    for n in QUANT_SIZES:
        run(f"size {n}", torch.randn(n, generator=gen, device="cuda") * 3, QUANT_BLOCK)
    buf = torch.randn(1_000_004, generator=gen, device="cuda")
    run("size 1000003 unaligned", buf[1:], QUANT_BLOCK)
    for block in QUANT_BLOCKS:
        run(f"block {block} (size 100003)",
            torch.randn(100_003, generator=gen, device="cuda"), block)
    x = torch.randn(8 * 256, generator=gen, device="cuda")
    x[3], x[300], x[600], x[1024:1280] = float("nan"), float("inf"), -float("inf"), 0.0
    x[1300], x[1301] = float("inf"), float("nan")
    run("nan, +inf, -inf and all-zero blocks", x, QUANT_BLOCK)
    run("nan, +inf, -inf and all-zero blocks, block 64", x, 64)
    singles = len(worst)

    # the segment form: every leaf of a ring hop in one launch
    def run_layout(label, layout, scale=1.0, poison=False):
        x = torch.randn(layout.total, generator=gen, device="cuda") * scale
        if poison:      # a NaN, a +Inf, a -Inf and an all-zero block, one a leaf
            for i, v in zip(range(0, len(layout.padded), 2), ("nan", "inf", "-inf", "0")):
                chunk = layout.chunk(x, i, i % layout.n)
                if v == "0":
                    chunk[:layout.block] = 0.0
                else:
                    chunk[len(chunk) // 2] = float(v)
        worst[label] = segment_case(layout, x, failed, label)
        torch.cuda.synchronize()

    tables = [(f"netresdeep's 9 leaves at {r} ranks", NETRESDEEP_LEAVES, r, 1.0)
              for r in rank_counts]
    tables += [(f"lm_default's {LM_DEFAULT_LEAVES} leaves at {r} ranks",
                lm_leaf_shapes({}, LM_RANK_SEQ, LM_DEFAULT_LEAVES), r, 0.02)
               for r in rank_counts]
    tables += [(f"vit_s4's {VIT_LEAVES} leaves at 2 ranks", vit_leaf_shapes(), 2, 0.02),
               (f"vit_b16's {VIT_B16_LEAVES} leaves at 2 ranks", vit_b16_leaf_shapes(), 2,
                0.02)]
    for label, shapes, r, scale in tables:
        layout = ring_layout(shapes, r)
        run_layout(f"segments: {label} ({layout.total} elements, {layout.n_blocks} "
                   f"scale blocks)", layout, scale)
    for r in sorted(set(rank_counts) | {3}):
        run_layout(f"segments: netresdeep at {r} ranks with nan, +inf, -inf and zero "
                   "blocks", ring_layout(NETRESDEEP_LEAVES, r), poison=True)
    from tpu_ddp_torch.parallel.collectives import FlatLayout

    # block 7: an odd number of message bytes, so the gathered rows start unaligned
    ragged = FlatLayout([36, 8, 4, 64, 4, 100], 4, 7)
    run_layout("segments: 6 ragged leaves at 4 ranks, block 7", ragged)
    run_layout("segments: 6 ragged leaves at 4 ranks, block 7, non-finite", ragged,
               poison=True)
    print(f"  {singles} single-chunk cases and {len(worst) - singles} segment tables "
          f"(every chunk; K2 with and without the error, K3 +add_to, into the shard "
          f"row and the n-row gather); max |diff| over finite values "
          f"{max(worst.values()):.3g}", flush=True)
    if failed:
        fail("K2/K3 disagree with their plain versions: " + "; ".join(failed[:10]))
    return max(worst.values())


#: phase 11's trees: the main path's and the ViT's, whose 79 leaves were 79
#: rings a step before the flat ring
RING_STEP_ITERS = {"netresdeep": 100, "vit_s4": 30}


def ring_rank(rank, world, out_dir):
    """Phase 11 on one rank (spawned; both ranks on cuda:0 over gloo)."""
    import torch

    from tpu_ddp_torch.parallel.collectives import ring_all_reduce
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.tools.ring_compare import time_ring, wire_counter

    torch.cuda.set_device(0)
    wire = wire_counter()
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    result = {"equal": True, "steps": {}}
    outs = []
    for n in RING_LEAVES:
        x = torch.randn(n + n % 2, generator=gen, device="cuda")
        k_out, k_err = ring_all_reduce(x, mode="int8", block=QUANT_BLOCK,
                                       with_error=True, kernels=True)
        p_out, p_err = ring_all_reduce(x, mode="int8", block=QUANT_BLOCK,
                                       with_error=True, kernels=False)
        result["equal"] &= torch.equal(k_out, p_out) and torch.equal(k_err, p_err)
        outs.append(k_out.cpu())
    for model, shapes in (("netresdeep", NETRESDEEP_LEAVES), ("vit_s4", vit_leaf_shapes())):
        params = {f"leaf{i}": torch.randn(s, generator=gen, device="cuda") * 0.02
                  for i, s in enumerate(shapes)}
        comps = {kernels: GradCompressor(GradCompression(
            mode="int8", block=QUANT_BLOCK, error_feedback=True, kernels=kernels),
            params, world) for kernels in (True, False)}
        residual = comps[True].init_residual("cuda")
        for kind in ("all_reduce_mean", "reduce_scatter_mean_flat"):
            (k, k_err), (p, p_err) = (
                comps[kn].all_reduce_mean(params, residual, True)
                if kind == "all_reduce_mean" else
                comps[kn].reduce_scatter_mean_flat(comps[kn].flatten(params), residual, True)
                for kn in (True, False))
            for a, b in ((k, p), (k_err, p_err)):
                result["equal"] &= all(torch.equal(a[name], b[name]) for name in a)
            outs += [k[name].cpu() for name in k]
        result["steps"][model] = dict(leaves=len(shapes), **time_ring(
            comps[True], params, residual, wire, RING_STEP_ITERS[model]))
    torch.save(outs, f"{out_dir}/ring{rank}.pt")
    with open(f"{out_dir}/ring{rank}.json", "w") as f:
        json.dump(result, f)


def phase_ring_on_card(tmp):
    from tpu_ddp_torch.parallel.runtime import spawn

    import torch

    print("phase 11: the int8 ring with error feedback on two ranks on cuda:0 over "
          "gloo, K2/K3 vs plain versions; one step's ring over all leaves", flush=True)
    out = os.path.join(tmp, "ring")
    os.makedirs(out)
    OTHER_CHILDREN[0] += 2
    spawn(ring_rank, 2, out, init_file=os.path.join(out, "rdzv"), timeout=600)
    res = []
    for r in range(2):
        with open(os.path.join(out, f"ring{r}.json")) as f:
            res.append(json.load(f))
    outs = [torch.load(os.path.join(out, f"ring{r}.pt")) for r in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(outs[0][:len(RING_LEAVES)],
                                                outs[1][:len(RING_LEAVES)]))
    print(f"  one leaf of {RING_LEAVES} and GradCompressor's all_reduce_mean / "
          f"reduce_scatter_mean_flat over NetResDeep's 9 and ViT-S/4's {VIT_LEAVES} leaves: "
          f"kernels == plain on rank 0 {res[0]['equal']}, rank 1 {res[1]['equal']}; "
          f"one-leaf outputs identical across ranks {same}", flush=True)
    failed = []
    for model in RING_STEP_ITERS:
        for r in range(2):
            st = res[r]["steps"][model]
            print(f"  rank {r}: one step's ring over {model}'s {st['leaves']} leaves "
                  f"{st['host_ms']:.4f} ms (host clock); launches {st['launches']}; "
                  f"wire calls {st['wire_calls']}; device ms a step by kind: "
                  f"{st['device_ms']}", flush=True)
            if (st["launches"] != {"fused_quant": 2, "fused_dequant": 2}
                    or st["wire_calls"] != {"exchange": 1, "all_gather_bytes": 1}):
                failed.append(f"rank {r} {model}")
    if not (res[0]["equal"] and res[1]["equal"] and same):
        fail("the ring with K2/K3 differs from the ring with plain versions, "
             "or across ranks")
    if failed:
        fail("a step's ring did not make one K2, one K3 and one wire call a hop: "
             + ", ".join(failed))
    return res


def dp_args(compress, nproc=2, backend="gloo"):
    args = ["--device", "cuda", "--dist-backend", backend, "--synthetic-data",
            "--synthetic-size", str(nproc * 32 * DP_STEPS_PER_EPOCH), "--epochs", "2",
            "--kernels", "--eval-each-epoch", "--log-every-epochs", "1",
            "--n-chans1", "32", "--n-blocks", "10", "--batch-size", "32",
            "--lr", "1e-2", "--optimizer", "sgd"]
    if compress:
        args += ["--grad-compress", "int8", "--grad-compress-error-feedback"]
    return args


def dp_launches(nproc):
    """K1, K2 and K3 launches a step a rank at ``nproc`` ranks with error
    feedback, over NetResDeep's 9 leaves: K1 once (all leaves in one
    launch); the flat ring over all leaves at once: K2 n (n-1 hops and the
    gather phase's quantize, the error in the same pass), K3 n (n-1 hops'
    accumulate and one dequantize of all n gathered rows)."""
    return {"fused_update": 1, "fused_quant": nproc, "fused_dequant": nproc}


def ring_wire_calls(nproc, compress, zero1):
    """The ring's wire calls a step a rank: n-1 exchanges, and for the
    all-reduce one all-gather (the params' all-gather of ``--zero1`` is not
    the ring's)."""
    if not compress:
        return {"exchange": 0, "all_gather_bytes": 0}
    return {"exchange": nproc - 1, "all_gather_bytes": 0 if zero1 else 1}


#: a run of ``rank_child`` whose name ends so gathers ZeRO-3's blocks
#: serialized (``Zero3Partition.prefetch = False``)
SERIAL = "_serial"


def rank_child(out_dir, args):
    """One rank of phases 12, 14, 15, 17, 19d, 21b, 22e, 24, 26, 27, 28c and
    31, started by the launcher: ``[--deterministic] [--poison-batch N]
    [--hop-hook] --run NAME [OPTIONS] ARGS... [--run NAME [OPTIONS]
    ARGS...]``. The options before the first ``--run`` hold for every run;
    a run's own OPTIONS (``run_options``: ``--deterministic``,
    ``--poison-batch N``, ``--hop-hook``, ``--comms-bench``) add to them for
    that run alone, so unlike runs share one job. Joins the process group
    once and trains each run in turn on it, as the train CLI's ``run``
    would (under cuDNN's deterministic algorithms with ``--deterministic``),
    the launch, wire-call and block-gather counts zeroed just before each;
    a ``--comms-bench`` run instead calls ``tpu-ddp-torch comms bench ARGS``
    on the same group and writes its exit code and launches. Writes each
    run's counts, metrics and final weights (under ``--zero3`` gathered:
    every rank takes part) to ``out_dir/NAME``. The metrics also carry the
    device memory allocated just before each train step after the first
    (``memory_between_steps``, bytes) and the run's peak; with
    ``--poison-batch N`` whether the state (ZeRO-3's shards too) was
    bitwise the same just after the N-th step as just before it
    (``poisoned_step_bitwise``). A run named ``*_serial`` gathers ZeRO-3's
    blocks without the prefetch. ``--then-sp-lm D`` runs phase 25c's LM
    steps on the same group after the runs (``sp_lm_runs``, data axis D),
    into ``out_dir/sp_lm``; ``--then-sp-lm-zero1 D`` phase 26a's
    (``sp_lm_zero1_runs``), into ``out_dir/sp_lm_zero1``; ``--save-states
    NAME[,NAME...]`` saves each named run's whole model state
    (``Trainer.model_state``, a collective) before each step and after the
    last, into ``out_dir/NAME/states.pt`` from rank 0. Each run's metrics
    carry the line its strategy printed (``strategy_line``: pp's schedule). Each run's metrics also carry
    the param and optimizer-state bytes this rank holds (``held_bytes``).
    With ``--hop-hook`` a counting hop hook is installed just before the
    run's trainer is built and cleared after it (a ``--comms-monitor``
    trainer installs its own and clears it at its close). With
    ``--cycle-monitors`` (phase 31d) a ``--comms-monitor`` run switches its
    monitors step by step (``MonitorCycle``): the arm of each step and the
    hop hook's ms by arm go into its metrics (``cycle_arms``,
    ``hop_ms_by_arm``). Each run's metrics carry the host clock at each
    train step's call (``step_starts``, s)."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.parallel import collectives, runtime
    from tpu_ddp_torch.telemetry import TerminalSummarySink, reset_default_registry
    from tpu_ddp_torch.tools.ring_compare import wire_counter
    from tpu_ddp_torch.train.trainer import Trainer

    job = {"deterministic": False, "poison": None, "hop_hook": False}
    if args[:1] == ["--deterministic"]:
        job["deterministic"] = True
        args = args[1:]
    if args[:1] == ["--poison-batch"]:
        # job-wide: the job's train batches counted over all its runs
        job["poison"] = int(args[1])
        poison_batch(job["poison"], rank=0)
        args = args[2:]
    sp_lm = sp_lm_zero1 = None
    if args[:1] == ["--then-sp-lm"]:
        sp_lm = int(args[1])
        args = args[2:]
    if args[:1] == ["--then-sp-lm-zero1"]:
        sp_lm_zero1 = int(args[1])
        args = args[2:]
    keep_states = ()
    if args[:1] == ["--save-states"]:
        keep_states = args[1].split(",")
        args = args[2:]
    if args[:1] == ["--hop-hook"]:
        job["hop_hook"] = True
        args = args[1:]
    hops = []

    def count_hop(probe, **kw):
        hops.append([kw["kind"], kw["dtype"], kw["hop"], kw["n_hops"], kw["wire_bytes"]])

    gathers = [0]
    issue = collectives.BlockGather._issue

    def counted_issue(gather, k):
        gathers[0] += 1
        return issue(gather, k)

    collectives.BlockGather._issue = counted_issue
    runs, i = [], 0
    while i < len(args):            # --run NAME ARGS..., up to the next --run
        j = args.index("--run", i + 1) if "--run" in args[i + 1:] else len(args)
        runs.append((args[i + 1], args[i + 2:j]))
        i = j
    rank = int(os.environ["RANK"])
    wire = wire_counter()
    runs = [(name, *run_options(a, job)) for name, a in runs]
    parsed = [(name, opts, a if opts["comms_bench"] else cli.build_parser().parse_args(a))
              for name, opts, a in runs]
    first = next(cli.config_from_args(ns) for _, opts, ns in parsed if not opts["comms_bench"])
    runtime.initialize_distributed(first.device, first.dist_backend)
    mark_started(out_dir)
    try:
        for name, opts, ns in parsed:
            torch.backends.cudnn.deterministic = opts["deterministic"]
            out = os.path.join(out_dir, name)
            if opts["comms_bench"]:
                comms_bench_run(out, rank, ns)
                continue
            config = cli.config_from_args(ns)
            reset_default_registry()
            hops.clear()
            wire.update(dict.fromkeys(wire, 0))
            gathers[0] = 0
            poisoned = opts["poison"]
            undo = poison_batch(poisoned, rank=0) if opts["own_poison"] else None
            if opts["hop_hook"]:
                collectives.set_ring_hop_hook(count_hop)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_run = time.perf_counter()
            trainer = Trainer(config)
            if name.endswith(SERIAL):
                trainer.zero1.prefetch = False
            cycle = MonitorCycle(trainer, collectives) if opts["cycle_monitors"] else None
            between, bits, inner = [], {}, trainer.train_step
            starts = []
            kept = [] if name in keep_states else None
            # a weak reference: the trainer holds this function, and a cycle
            # would keep the run's state alive into the next run's memory
            owner = weakref.ref(trainer)

            def watched(state, batch, inner=inner, between=between, bits=bits, kept=kept,
                        owner=owner, starts=starts, cycle=cycle):
                starts.append(time.perf_counter())
                if cycle is not None:
                    cycle.step(len(starts) - 1)
                if kept is not None:
                    kept.append({k: v.to("cpu", copy=True)
                                 for k, v in owner().model_state().items()})
                between.append(torch.cuda.memory_allocated())
                calls = len(between) - 1
                if calls == poisoned:
                    bits["before"] = state_bits(state)
                out = inner(state, batch)
                if calls == poisoned:
                    bits["after"] = state_bits(state)
                return out

            trainer.train_step = watched
            try:
                metrics = cli._run_and_report(ns, config, trainer)
            finally:
                trainer.close()
                if opts["hop_hook"]:
                    collectives.set_ring_hop_hook(None)
                if undo is not None:
                    undo()
            torch.cuda.synchronize()
            metrics["run_seconds"] = time.perf_counter() - t_run
            metrics["launches"] = ops.launch_counts()
            metrics["wire_calls"] = dict(wire)
            metrics["block_gathers"] = gathers[0]
            metrics["memory_between_steps"] = between[1:]
            metrics["peak_memory"] = torch.cuda.max_memory_allocated()
            metrics["strategy_line"] = trainer.strategy_line
            metrics["summary_sink"] = any(isinstance(s, TerminalSummarySink)
                                          for s in trainer.telemetry.sinks)
            if opts["hop_hook"]:
                metrics["hop_calls"] = list(hops)
            metrics["step_starts"] = starts
            if cycle is not None:
                metrics["cycle_arms"], metrics["hop_ms_by_arm"] = cycle.arms, cycle.hop_ms
            metrics.update(held_bytes(trainer))
            if bits:
                metrics["poisoned_step_bitwise"] = same_state(bits["before"], bits["after"])
            with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
                json.dump(metrics, f)
            torch.save({k: v.cpu() for k, v in trainer.model_state().items()},
                       os.path.join(out, f"rank{rank}.pt"))
            if kept is not None:
                kept.append({k: v.to("cpu", copy=True)
                             for k, v in trainer.model_state().items()})
                if rank == 0:
                    torch.save(kept, os.path.join(out, "states.pt"))
        if sp_lm is not None:
            sp_lm_runs(os.path.join(out_dir, "sp_lm"), sp_lm)
        if sp_lm_zero1 is not None:
            sp_lm_zero1_runs(os.path.join(out_dir, "sp_lm_zero1"), sp_lm_zero1)
    finally:
        runtime.shutdown()


#: rank_child's per-run options and the arguments each takes
RUN_OPTIONS = {"--deterministic": 0, "--poison-batch": 1, "--hop-hook": 0, "--comms-bench": 0,
               "--cycle-monitors": 0}

#: 31d's arms: neither monitor, the stage monitor alone, both, and both
#: with the hop hook handed no probe to read; the order a run cycles
#: through them, one step each
P31_ARMS = ("bare", "stages", "hops", "hops_no_probe")
P31_CYCLE = (0, 1, 2, 3, 3, 2, 1, 0)


class MonitorCycle:
    """Phase 31d inside one ``--comms-monitor`` run: before train step k
    (``step``) the arm ``P31_ARMS[P31_CYCLE[k % 8]]`` sets the loader's
    observer (the trainer's stage monitor, or None for ``bare``) and the
    ring's hop hook (the trainer's ``HopMonitor.on_hop`` behind a timer
    for the two ``hops`` arms, else none). Step k's ring and the load of
    batch k + 1 both run under step k's arm, so the period from step k's
    call to step k + 1's is that arm's. ``hop_ms``: ``[k, ms]`` a hook call
    by arm. The trainer's close clears the hook."""

    def __init__(self, trainer, collectives):
        self.collectives, self.loader = collectives, trainer.train_loader
        self.monitor = trainer._datapath
        self.hook = collectives.set_ring_hop_hook(None)
        if self.hook is None or self.monitor is None:
            fail("--cycle-monitors needs --comms-monitor and --telemetry-dir")
        self.k, self.arm, self.arms = None, None, []
        self.hop_ms = {arm: [] for arm in P31_ARMS[2:]}

    def step(self, k):
        self.k, self.arm = k, P31_ARMS[P31_CYCLE[k % len(P31_CYCLE)]]
        self.arms.append(self.arm)
        self.loader.observer = None if self.arm == "bare" else self.monitor
        self.collectives.set_ring_hop_hook(self.timed if self.arm in self.hop_ms else None)

    def timed(self, probe, **kw):
        t0 = time.perf_counter()
        self.hook(None if self.arm == "hops_no_probe" else probe, **kw)
        self.hop_ms[self.arm].append([self.k, (time.perf_counter() - t0) * 1e3])


def run_options(args, job):
    """``(options, rest)``: a run's leading ``RUN_OPTIONS`` on top of the
    job's (``job``: ``deterministic``, ``poison``, ``hop_hook``), and its
    remaining arguments (the train CLI's, or ``comms bench``'s). A run's own
    ``--poison-batch N`` poisons its own N-th batch (``own_poison``); the
    job's counts the batches of the whole job, as it always has."""
    opts = dict(job, comms_bench=False, own_poison=False, cycle_monitors=False)
    while args and args[0] in RUN_OPTIONS:
        flag, value = args[0], args[1:1 + RUN_OPTIONS[args[0]]]
        args = args[1 + RUN_OPTIONS[flag]:]
        if flag == "--poison-batch":
            opts["poison"], opts["own_poison"] = int(value[0]), True
        else:
            opts[flag[2:].replace("-", "_")] = True
    return opts, args


def comms_bench_run(out, rank, argv):
    """A ``--comms-bench`` run of ``rank_child``: ``tpu-ddp-torch comms
    bench ARGV`` on the job's process group, its launches counted from 0;
    writes ``{"rc", "launches"}`` and an empty weights file for
    ``launch_dp_runs``."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.comms.cli import main as comms_main

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = comms_main(["bench", *argv])
    torch.cuda.synchronize()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "launches": ops.launch_counts(),
                   "seconds": time.perf_counter() - t0}, f)
    torch.save({}, os.path.join(out, f"rank{rank}.pt"))


#: every launcher job of this run: (phase, ranks, start-up s, wall s); and
#: the child processes started without the launcher
JOBS = []
OTHER_CHILDREN = [0]


def mark_started(out_dir):
    """A rank child's marker, once its process group is up:
    ``out_dir/started-rank<r>`` holding the wall time (``smoke_job``)."""
    with open(os.path.join(out_dir, f"started-rank{os.environ.get('RANK', '0')}"), "w") as f:
        f.write(repr(time.time()))


def smoke_job(argv, nproc, phase, out_dir):
    """``chip_smoke.py ARGV`` through the launcher on ``nproc`` ranks, each
    of which marks ``out_dir`` once its group is up (``mark_started``);
    records the job's start-up seconds (launch to the last rank's group up)
    and wall seconds in ``JOBS``, and prints them. Returns the exit code."""
    from tpu_ddp_torch.cli.launch import run_job

    t0, c0 = time.time(), time.perf_counter()
    rc = run_job([sys.executable, os.path.abspath(__file__), *argv], nproc_per_node=nproc)
    wall = time.perf_counter() - c0
    marks = []
    for r in range(nproc):
        try:
            with open(os.path.join(out_dir, f"started-rank{r}")) as f:
                marks.append(float(f.read()))
        except (OSError, ValueError):
            pass
    startup = max(marks) - t0 if len(marks) == nproc else None
    JOBS.append((phase, nproc, startup, wall))
    print(f"  launcher job {len(JOBS)} (phase {phase}): {nproc} ranks, start-up "
          + (f"{startup:.2f} s" if startup is not None else "not measured (a rank did not "
             "start)") + f", {wall:.2f} s in all", flush=True)
    return rc


def print_jobs():
    """The run's launcher jobs, their child processes and start-ups."""
    ranks = sum(n for _, n, _, _ in JOBS)
    ups = [s for _, _, s, _ in JOBS if s is not None]
    print(f"launcher jobs: {len(JOBS)} ({ranks} rank processes), other child processes: "
          f"{OTHER_CHILDREN[0]}; start-up s by job: "
          + ", ".join(f"{p}: {s:.2f}" if s is not None else f"{p}: -"
                      for p, _, s, _ in JOBS)
          + f"; start-up total {sum(ups):.1f} s, job wall total "
          f"{sum(w for _, _, _, w in JOBS):.1f} s", flush=True)


def held_bytes(trainer):
    """``{"param_bytes", "opt_bytes"}``: the bytes of the params and of the
    optimizer slots this rank holds (its cut, its shards or the whole
    tensors: ``trainer.layout``'s)."""
    from tpu_ddp_torch.train.state import SLOTS

    state = trainer.state
    params = trainer.layout.local_params(state)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    return {"param_bytes": nbytes(params.values()),
            "opt_bytes": nbytes([t for slot in SLOTS
                                 for t in (getattr(state.opt_state, slot) or {}).values()])}


def launch_dp_runs(tmp, runs, nproc, phase="12", deterministic=False, poison=None,
                   extra=()):
    """The ``(name, args)`` or ``(name, args, options)`` runs through the
    launcher on ``nproc`` ranks, one after another in one job
    (``rank_child``: one process start and one process group for all of
    them), under deterministic cuDNN, and with rank 0's ``poison``-th batch
    all NaN (``poison_batch``) when asked; a run's ``options`` are
    ``rank_child``'s per-run ones (``run_options``). Returns ``{name:
    (every rank's metrics, whether the ranks' weights are bitwise
    equal)}``. ``extra``: more of ``rank_child``'s job-wide options."""
    import torch

    how = ", deterministic cuDNN" if deterministic else ""
    if poison is not None:
        how += f", rank 0's batch {poison} all NaN"
    argv = []
    os.makedirs(tmp, exist_ok=True)
    for name, args, *options in runs:
        options = options[0] if options else []
        os.makedirs(os.path.join(tmp, name))
        what = ("tpu_ddp_torch.cli.main comms bench" if "--comms-bench" in options
                else "tpu_ddp_torch.cli.train")
        print(f"phase {phase}{how}{' ' + ' '.join(options) if options else ''}: python -m "
              f"tpu_ddp_torch.cli.launch --nproc-per-node {nproc} -- python -m {what} "
              f"{' '.join(args)}", flush=True)
        argv += ["--run", name, *options, *args]
    rc = smoke_job(["--rank-child", tmp,
                    *(["--deterministic"] if deterministic else []),
                    *(["--poison-batch", str(poison)] if poison is not None else []), *extra,
                    *argv], nproc, phase, tmp)
    if rc:
        fail(f"the {nproc}-rank job exited with {rc}")
    out = {}
    for name, *_ in runs:
        metrics = []
        for r in range(nproc):
            with open(os.path.join(tmp, name, f"rank{r}.json")) as f:
                metrics.append(json.load(f))
        weights = [torch.load(os.path.join(tmp, name, f"rank{r}.pt")) for r in range(nproc)]
        out[name] = (metrics, all(torch.equal(weights[0][k], w[k])
                                  for w in weights[1:] for k in w))
    return out


def phase_dp_main_path(tmp, nproc=2, backend="gloo"):
    runs = {}
    jobs = launch_dp_runs(tmp, [("int8" if c else "plain", dp_args(c, nproc, backend))
                                for c in (True, False)], nproc)
    for compress in (True, False):
        metrics, same = jobs["int8" if compress else "plain"]
        m = metrics[0]
        steps, losses = m["steps"], m["step_losses"]
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"  steps {steps}; launches on rank 0 {m['launches']}; params "
              f"bitwise equal on all {nproc} ranks {same}", flush=True)
        step_ms = " / ".join(f"{x['steady_step_ms']:.4f}" for x in metrics)
        print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}; "
              f"final test accuracy {m['test_accuracy']:.4f}; steady-state step "
              f"time per rank: {step_ms} ms", flush=True)
        if steps != 2 * DP_STEPS_PER_EPOCH:
            fail(f"the {nproc}-rank run took {steps} steps, expected "
                 f"{2 * DP_STEPS_PER_EPOCH}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            fail(f"the {nproc}-rank run's losses are not finite and falling")
        if not same:
            fail(f"the {nproc} ranks end with different params")
        want = {name: 0 for name in m["launches"]}
        want["fused_update"] = steps
        if compress:
            want.update({k: v * steps for k, v in dp_launches(nproc).items()})
        wire = {k: v * steps for k, v in ring_wire_calls(nproc, compress, False).items()}
        print(f"  the ring's wire calls on rank 0: {m['wire_calls']}", flush=True)
        for r in range(nproc):
            if metrics[r]["launches"] != want:
                fail(f"rank {r} launched {metrics[r]['launches']}, expected {want}")
            if metrics[r]["wire_calls"] != wire:
                fail(f"rank {r}'s ring made {metrics[r]['wire_calls']} wire calls, "
                     f"expected {wire}")
        runs["int8" if compress else "plain"] = metrics
    got = runs["plain"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    want = runs["int8"][0]["step_losses"][:PLAIN_STEPS_RTOL]
    diff = max(abs(g - w) for g, w in zip(got, want))
    print(f"  plain DP vs int8 + error feedback, first {PLAIN_STEPS_RTOL} step losses: "
          f"max |diff| {diff:.4g} (limit {DP_LOSS_ATOL})", flush=True)
    if not diff <= DP_LOSS_ATOL:
        fail("plain DP and the int8 ring disagree over the first steps")
    return runs


# ---- phases 14-16: --zero1 on three ranks (K1's pad mask on the path) ----

#: three ranks: at two none of NetResDeep's leaves pads; at three seven of
#: its nine do (the four 32-element leaves and the 65,536-, 320- and
#: 10-element ones), so the mask runs on the path itself
ZERO1_RANKS = 3
VIT_ZERO1_STEPS = 20
ZERO1_RTOL = 1e-5          # phase 5a's bound on the first steps' losses
#: the same bound at rank counts other than three (``--nccl N``): there the
#: reduce-scatter sums in another order than the all-reduce, and NetResDeep
#: carries that ulp of gradient to 2.9e-5 of the loss by step 5 on four gloo
#: CPU ranks and 4.17e-5 on four H100s over NCCL
ZERO1_RTOL_OTHER = 1e-4


def zero1_launches(nproc, compress):
    """K1, K2 and K3 launches a step a rank of NetResDeep under ``--zero1``
    at ``nproc`` ranks: K1 once (the shards of all nine leaves in one
    launch). With the int8 ring and error feedback, the reduce-scatter over
    all leaves (``parallel/collectives.py::ring_reduce_scatter_flat``) makes
    n-1 hops, each one K2 (the message and the error) and one K3 (the
    received message into the running sums; the last hop's into the
    gradient row). The params' all-gather moves float32 and runs neither."""
    hops = nproc - 1 if compress else 0
    return {"fused_update": 1, "fused_quant": hops, "fused_dequant": hops}


def check_run(label, metrics, same, want_steps, want_per_step, extra=None):
    """The checks every multi-rank run of phases 14-15 passes: the step
    count, finite losses, params bitwise equal on every rank, and each
    rank's launches exactly ``want_per_step`` times the steps (plus
    ``extra``)."""
    m = metrics[0]
    steps, losses = m["steps"], m["step_losses"]
    step_ms = " / ".join(f"{x['steady_step_ms']:.4f}" for x in metrics)
    print(f"  {label}: steps {steps}; launches on rank 0 {m['launches']}; params "
          f"bitwise equal on all {len(metrics)} ranks {same}; final test accuracy "
          f"{m['test_accuracy']:.4f}, test loss {m['test_loss']:.4f}; steady-state "
          f"step time per rank {step_ms} ms", flush=True)
    if steps != want_steps:
        fail(f"{label} took {steps} steps, expected {want_steps}")
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(m["test_loss"]):
        fail(f"{label}: a loss is not finite")
    if not same:
        fail(f"{label}: the ranks end with different params")
    want = {name: 0 for name in m["launches"]}
    want.update({k: v * steps for k, v in want_per_step.items()})
    want.update(extra or {})
    for r, x in enumerate(metrics):
        if x["launches"] != want:
            fail(f"{label}: rank {r} launched {x['launches']}, expected {want}")


def first_losses_close(label, got, want, rtol=ZERO1_RTOL):
    """The first steps' losses of two runs, held to ``rtol``."""
    got, want = got[:PLAIN_STEPS_RTOL], want[:PLAIN_STEPS_RTOL]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"  {label}, first {PLAIN_STEPS_RTOL} step losses: relative differences "
          f"{' '.join(f'{r:.3g}' for r in rel)} (limit {rtol})", flush=True)
    if len(rel) != PLAIN_STEPS_RTOL or not max(rel) <= rtol:
        fail(f"{label}: the first losses disagree")


def short_args(args, nproc, steps):
    """``args`` cut to one epoch of ``steps`` steps a rank, no evaluation."""
    out = [a for a in args if a != "--eval-each-epoch"]
    out[out.index("--synthetic-size") + 1] = str(nproc * 32 * steps)
    out[out.index("--epochs") + 1] = "1"
    return out


ZERO1_DP_CASES = (("zero1", False, True), ("zero1_int8_ef", True, True),
                  ("plain_dp", False, False))


def zero1_dp_runs(n=ZERO1_RANKS, backend="gloo"):
    """Phase 14's ``(name, args)`` runs (``ZERO1_DP_CASES``) at ``n`` ranks."""
    return [(name, dp_args(compress, n, backend) + (["--zero1"] if zero1 else []))
            for name, compress, zero1 in ZERO1_DP_CASES]


def phase_zero1_dp(tmp, n=ZERO1_RANKS, backend="gloo", jobs=None):
    """Phase 14: NetResDeep ``--zero1 --kernels`` on n ranks (three sharing
    the card over gloo), plain float32 and with the int8 ring and error
    feedback, and plain DP on n ranks beside them, all under cuDNN's
    deterministic algorithms (cuDNN's default backward sums in a
    run-dependent order), so that the first steps of zero1 and of plain DP
    are held to ``ZERO1_RTOL`` at three ranks and ``ZERO1_RTOL_OTHER`` at
    other rank counts (the ``--nccl`` mode). ``jobs``: the runs' results
    when a larger job already ran them (``launch_dp_runs``)."""
    runs = {}
    if jobs is None:
        jobs = launch_dp_runs(tmp, zero1_dp_runs(n, backend), n, phase="14",
                              deterministic=True)
    for name, compress, zero1 in ZERO1_DP_CASES:
        metrics, same = jobs[name]
        per_step = (zero1_launches(n, compress) if zero1 else {"fused_update": 1})
        check_run(name, metrics, same, 2 * DP_STEPS_PER_EPOCH, per_step)
        wire = {k: v * 2 * DP_STEPS_PER_EPOCH
                for k, v in ring_wire_calls(n, compress, zero1).items()}
        if any(x["wire_calls"] != wire for x in metrics):
            fail(f"{name}: the ring's wire calls {metrics[0]['wire_calls']}, "
                 f"expected {wire}")
        losses = metrics[0]["step_losses"]
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"  mean loss of the first 20 steps {first:.4f}, last 20 {last:.4f}",
              flush=True)
        if not last < first:
            fail(f"{name}: the losses did not fall")
        runs[name] = metrics
    first_losses_close(f"zero1 vs plain DP at {n} ranks, deterministic cuDNN",
                       runs["zero1"][0]["step_losses"][:PLAIN_STEPS_RTOL],
                       runs["plain_dp"][0]["step_losses"][:PLAIN_STEPS_RTOL],
                       ZERO1_RTOL if n == ZERO1_RANKS else ZERO1_RTOL_OTHER)
    diff = max(abs(a - b) for a, b in zip(runs["zero1_int8_ef"][0]["step_losses"][:5],
                                          runs["zero1"][0]["step_losses"][:5]))
    print(f"  zero1 int8 + error feedback vs zero1 float32, first 5 step losses: "
          f"max |diff| {diff:.4g} (limit {DP_LOSS_ATOL})", flush=True)
    if not diff <= DP_LOSS_ATOL:
        fail("zero1 with the int8 ring disagrees with float32 zero1")
    return runs


def vit_layout_args(layout, n=ZERO1_RANKS, backend="gloo"):
    """Phase 15's ViT-S/4 arguments at ``n`` ranks over ``backend``, with
    ``layout``'s flag (``"zero1"``, ``"zero3"``; None: replicated)."""
    args = ["--device", "cuda", "--dist-backend", backend, "--synthetic-data",
            "--synthetic-size", str(n * 32 * VIT_ZERO1_STEPS), "--epochs", "1",
            "--model", "vit_s4", "--attention", "flash", "--kernels",
            "--optimizer", "adamw", "--lr", "1e-3", "--weight-decay", "0.05",
            "--grad-clip-norm", "1.0", "--ema-decay", "0.999", "--batch-size", "32",
            "--eval-each-epoch", "--log-every-epochs", "1"]
    return args + ([f"--{layout}"] if layout else [])


def vit_zero1_args(zero1):
    return vit_layout_args("zero1" if zero1 else None)


VIT_ZERO1_NAMES = {True: "vit_zero1", False: "vit_replicated"}


def zero1_vit_runs():
    """Phase 15's ``(name, args)`` runs."""
    return [(VIT_ZERO1_NAMES[z], vit_zero1_args(z)) for z in (True, False)]


def phase_zero1_vit(tmp, jobs=None):
    """Phase 15: ViT-S/4 ``--zero1`` with flash attention, AdamW, decay,
    clipping and EMA on three ranks over gloo (every branch of K1 under the
    mask), against the same run without ``--zero1``; both under cuDNN's
    deterministic algorithms (the patch embed's convolution). ``jobs``: the
    runs' results when a larger job already ran them."""
    runs = {}
    if jobs is None:
        jobs = launch_dp_runs(tmp, zero1_vit_runs(), ZERO1_RANKS, phase="15",
                              deterministic=True)
    for zero1 in (True, False):
        name = VIT_ZERO1_NAMES[zero1]
        metrics, same = jobs[name]
        steps, evals = metrics[0]["steps"], metrics[0]["eval_batches"]
        check_run(name, metrics, same, VIT_ZERO1_STEPS,
                  {"fused_update": 1, "flash_attention_dq": VIT_DEPTH,
                   "flash_attention_dkv": VIT_DEPTH},
                  extra={"flash_attention_fwd": VIT_DEPTH * (steps + evals)})
        runs[name] = metrics
    first_losses_close("ViT zero1 vs without --zero1 at three ranks",
                       runs["vit_zero1"][0]["step_losses"],
                       runs["vit_replicated"][0]["step_losses"])
    return runs


# ---- phase 17: checkpoint and resume on the card -------------------------

#: steps an epoch a rank in phase 17 (the widths and the recipe are the
#: reference's)
CKPT_STEPS = 25
#: the cut run's --checkpoint-steps: two saves inside its epoch before the
#: epoch's own, so a repeat save's time on the training thread shows
CKPT_EVERY = 10
#: the one-rank run's SIGTERM: as it takes this batch, mid-epoch 2
CKPT_SIGTERM_AT = 35


def ckpt_args(nproc, backend="gloo", compress=True, zero1=True, data_ranks=None):
    """NetResDeep, the reference recipe, ``--kernels`` (and ``--zero1`` with
    the int8 ring and error feedback), CKPT_STEPS steps an epoch a rank at
    ``data_ranks`` (default ``nproc``) ranks, no evaluation."""
    args = [a for a in dp_args(compress, nproc, backend) if a != "--eval-each-epoch"]
    args[args.index("--synthetic-size") + 1] = str((data_ranks or nproc) * 32 * CKPT_STEPS)
    return args + (["--zero1"] if zero1 else [])


def with_epochs(args, epochs, *extra):
    out = list(args)
    out[out.index("--epochs") + 1] = str(epochs)
    return out + list(extra)


def rank_weights(tmp, name, nproc):
    import torch

    return [torch.load(os.path.join(tmp, name, f"rank{r}.pt")) for r in range(nproc)]


def same_weights(a, b):
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def check_manifests(ck, steps):
    """Each of ``steps`` is committed and verifies against its manifest."""
    from tpu_ddp_torch.checkpoint import manifest

    verdicts = {s: manifest.verify_step(ck, s) for s in steps}
    print(f"  checkpoint steps on disk {manifest.committed_steps(ck)}; manifests "
          f"{ {s: v[0] for s, v in verdicts.items()} }", flush=True)
    if any(v != (True, []) for v in verdicts.values()):
        fail(f"a checkpoint step does not verify against its manifest: {verdicts}")


def phase_checkpoint_dp(tmp, nproc=2, backend="gloo", then=()):
    """Phase 17: NetResDeep ``--kernels --zero1 --grad-compress int8
    --grad-compress-error-feedback`` on ``nproc`` ranks under cuDNN's
    deterministic algorithms: two epochs uninterrupted, then one epoch with
    ``--checkpoint-dir`` (and a save every CKPT_EVERY steps) and ``--resume``
    to two. The resumed run's per-step
    losses and final params must be bitwise the uninterrupted run's, the
    replicas bitwise equal, its launches exactly its steps times phase 14's
    per-step counts, and its checkpoints verify. Prints each save's time on
    the training thread of the cut and the resumed run. ``then``: more
    ``(name, args)`` runs for the same job, after these; returns their
    results."""
    args = ckpt_args(nproc, backend)
    ck = os.path.join(tmp, f"ckpt{nproc}")
    runs = {}
    cases = (("full", with_epochs(args, 2)),
             ("cut", with_epochs(args, 1, "--checkpoint-dir", ck,
                                 "--checkpoint-steps", str(CKPT_EVERY))),
             ("resumed", with_epochs(args, 2, "--checkpoint-dir", ck, "--resume")))
    jobs = launch_dp_runs(tmp, [(f"ckpt_{name}{nproc}", a) for name, a in cases]
                          + list(then), nproc, phase="17", deterministic=True)
    for name, _ in cases:
        label = f"ckpt_{name}{nproc}"
        runs[name] = (*jobs[label], rank_weights(tmp, label, nproc))
    full, resumed = runs["full"], runs["resumed"]
    per_step = zero1_launches(nproc, True)
    want = {name: 0 for name in resumed[0][0]["launches"]}
    want.update({k: v * CKPT_STEPS for k, v in per_step.items()})
    bitwise = all(m["step_losses"] == f["step_losses"][CKPT_STEPS:]
                  and same_weights(w, fw)
                  for m, f, w, fw in zip(resumed[0], full[0], resumed[2], full[2]))
    print(f"  resumed at step {CKPT_STEPS}: {len(resumed[0][0]['step_losses'])} steps; "
          f"losses and final params bitwise the uninterrupted run's on every rank "
          f"{bitwise}; replicas bitwise equal {resumed[1]}; launches on rank 0 "
          f"{resumed[0][0]['launches']} (expected {want})", flush=True)
    if resumed[0][0]["steps"] != 2 * CKPT_STEPS or not bitwise:
        fail(f"the resumed {nproc}-rank run is not bitwise the uninterrupted one")
    if not (resumed[1] and full[1]):
        fail("the ranks end with different params")
    if any(m["launches"] != want for m in resumed[0]):
        fail(f"the resumed run launched {[m['launches'] for m in resumed[0]]}, "
             f"expected {want} on every rank")
    check_manifests(ck, (CKPT_STEPS, 2 * CKPT_STEPS))
    for name in ("cut", "resumed"):
        for r, m in enumerate(runs[name][0]):
            saves = "; ".join(f"step {st}{' wait' if w else ''} {ms:.3f} ms"
                              for st, w, ms in m["checkpoint_save_ms"])
            print(f"  {name} run, rank {r}: the training thread's time in each save "
                  f"(de-sharding collectives, device-to-host copy, and the commit when "
                  f"it waits): {saves}; steady-state step {m['steady_step_ms']:.4f} ms",
                  flush=True)
    return {name: jobs[name] for name, _ in then}


def patch_train_batches(n, change):
    """Patch both host data paths of the train loader so that its ``n``-th
    batch goes through ``change``: the synchronous path's
    ``ShardedBatchLoader.epoch_batches`` (the shuffled loader or the one
    that keeps the sampler's pad: not the test loader) and the native
    ring's ``BatchPrefetcher.acquire`` (which feeds only the train loop, one
    acquire a step here). ``change(images)`` returns the batch's images: a
    new array, or the slot's view filled in place. Returns the undo."""
    from tpu_ddp_torch.data.loader import ShardedBatchLoader
    from tpu_ddp_torch.native.prefetch import BatchPrefetcher

    inner, inner_acquire = ShardedBatchLoader.epoch_batches, BatchPrefetcher.acquire
    seen = [0]

    def epoch_batches(self, *args, **kwargs):
        for batch in inner(self, *args, **kwargs):
            if not self.exclude_sampler_pad:
                if seen[0] == n:
                    batch = dict(batch, image=change(batch["image"]))
                seen[0] += 1
            yield batch

    def acquire(self):
        img, lbl, slot = inner_acquire(self)
        if seen[0] == n:
            img = change(img)
        seen[0] += 1
        return img, lbl, slot

    ShardedBatchLoader.epoch_batches, BatchPrefetcher.acquire = epoch_batches, acquire

    def undo():
        ShardedBatchLoader.epoch_batches, BatchPrefetcher.acquire = inner, inner_acquire

    return undo


def sigterm_at(n):
    """Send this process SIGTERM as the train loop takes its ``n``-th batch
    (``patch_train_batches``); returns the undo."""
    import signal

    def change(images):
        os.kill(os.getpid(), signal.SIGTERM)
        return images

    return patch_train_batches(n, change)


def phase_checkpoint_sigterm(tmp):
    """Phase 17, one rank in this process, NetResDeep ``--kernels`` under
    cuDNN's deterministic algorithms: two epochs uninterrupted; the same run
    with ``--checkpoint-dir`` SIGTERMed as it takes batch CKPT_SIGTERM_AT
    drains there and saves; ``--resume`` ends bitwise where the
    uninterrupted run ended, with K1 once a resumed step."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.checkpoint import manifest
    from tpu_ddp_torch.cli import train as cli

    args = with_epochs(ckpt_args(1, compress=False, zero1=False), 2)
    ck = os.path.join(tmp, "ckpt_sigterm")
    print(f"phase 17, deterministic cuDNN: one rank, SIGTERM at step {CKPT_SIGTERM_AT}: "
          f"tpu_ddp_torch.cli.train {' '.join(args)} --checkpoint-dir DIR", flush=True)
    torch.backends.cudnn.deterministic = True
    try:
        full, full_m = cli.run(args)
        undo = sigterm_at(CKPT_SIGTERM_AT)
        try:
            _, cut_m = cli.run(args + ["--checkpoint-dir", ck])
        finally:
            undo()
        latest = manifest.latest_verified_step(ck)
        ops.reset_launch_counts()
        resumed, res_m = cli.run(args + ["--checkpoint-dir", ck, "--resume"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    want = {name: 0 for name in counts}
    want["fused_update"] = 2 * CKPT_STEPS - CKPT_SIGTERM_AT
    bitwise = (cut_m["step_losses"] + res_m["step_losses"] == full_m["step_losses"]
               and same_weights(resumed.state.model.state_dict(),
                                full.state.model.state_dict()))
    print(f"  drained {cut_m.get('preempted', False)} at step {cut_m['steps']}; newest "
          f"verified checkpoint {latest}; resumed {len(res_m['step_losses'])} steps, "
          f"launches {counts}; losses and final params bitwise the uninterrupted "
          f"run's {bitwise}", flush=True)
    if not cut_m.get("preempted") or cut_m["steps"] != CKPT_SIGTERM_AT:
        fail("the SIGTERMed run did not drain at the step it was signalled")
    if latest != (CKPT_SIGTERM_AT, []):
        fail(f"the drained run's checkpoint is not the verified latest: {latest}")
    if not bitwise or counts != want:
        fail(f"the resumed run is not bitwise the uninterrupted one, or launched "
             f"{counts} (expected {want})")


def rank_change_runs(tmp):
    """Phase 17's rank change as two ``(name, args)`` runs: the cut at three
    ranks (phase 14's setting; it rides in the three-rank job of phases 14
    and 15) and its resume at two ranks on the same data (in the two-rank
    job of ``phase_checkpoint_dp``)."""
    n = ZERO1_RANKS
    ck = os.path.join(tmp, "ckpt_rank_change")
    return (("ckpt_cut_three", with_epochs(ckpt_args(n), 1, "--checkpoint-dir", ck)),
            ("ckpt_three_to_two", with_epochs(ckpt_args(2, data_ranks=n), 3,
                                              "--checkpoint-dir", ck, "--resume")))


def phase_checkpoint_rank_change(resumed):
    """Phase 17: the checkpoint cut at three ranks resumed at two
    (``rank_change_runs``; ``resumed``: the two-rank run's results):
    finite, falling losses, replicas bitwise equal."""
    metrics, same = resumed
    losses = metrics[0]["step_losses"]
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"  resumed at two ranks from step {CKPT_STEPS} of three: {len(losses)} steps, "
          f"mean loss of the first 20 {first:.4f}, last 20 {last:.4f}; replicas "
          f"bitwise equal {same}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not last < first or not same:
        fail("the three-rank checkpoint did not resume at two ranks with finite, "
             "falling losses and equal replicas")


def checkpoint_timing(tmp, smi):
    """Phase 17 timing: save initiation (the device-to-host copy), commit
    (write, fsync, manifest) and restore of NetResDeep's state (the phase's
    recipe at one rank, with its residual) and of ViT-B/16 at 224 with AdamW
    state, each built on the card with one step taken."""
    import shutil

    import torch

    from tpu_ddp_torch.checkpoint.manager import STATE_FILE, Checkpointer
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import checkpoint_state, create_train_state
    from tpu_ddp_torch.train.steps import make_train_step
    from tpu_ddp_torch.train.trainer import Trainer

    print(f"phase 17: checkpoint timing (host clock; {smi})", flush=True)
    trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(
        with_epochs(ckpt_args(1, zero1=False), 1))))
    batch = next(trainer.train_loader.epoch_batches(epoch=1))
    trainer.state, _ = trainer.train_step(trainer.state, trainer.to_device(batch))
    states = [("NetResDeep, SGD, int8 residual", trainer._ckpt_state)]

    def vit_state():
        gen = torch.Generator().manual_seed(0)
        model = MODEL_REGISTRY["vit_b16"](num_classes=10, generator=gen, image_size=224)
        tx = make_optimizer(lr=1e-3, optimizer="adamw")
        state = create_train_state(model, tx, torch.device("cuda"))
        images = torch.randn(8, 224, 224, 3, generator=gen).cuda()      # NHWC
        b = {"image": images, "label": torch.arange(8).cuda() % 10,
             "mask": torch.ones(8, dtype=torch.bool).cuda()}
        state, _ = make_train_step(tx)(state, b)
        return checkpoint_state(int(state.step), state.model.state_dict(), state.opt_state)

    states.append(("ViT-B/16 224, AdamW", vit_state))
    for name, build in states:
        flat = build()
        torch.cuda.synchronize()
        n_params = sum(v.numel() for k, v in flat.items() if k.startswith("model/"))
        d = os.path.join(tmp, "ckpt_timing")
        ck = Checkpointer(d)
        ck.save(1, flat, wait=True)
        first = dict(ck.timings)
        ck.save(2, flat, wait=True)
        again = dict(ck.timings)
        t0 = time.perf_counter()
        step = ck.verified_restore_step()
        verify_ms = (time.perf_counter() - t0) * 1e3
        restored = ck.restore(step)
        mb = os.path.getsize(os.path.join(d, "2", STATE_FILE)) / 1e6
        exact = all(torch.equal(restored[k], v.cpu()) if isinstance(v, torch.Tensor)
                    else restored[k] == v for k, v in flat.items())
        print(f"  {name}: {n_params} model elements, {mb:.3f} MB: save initiation "
              f"{first['initiate_ms']:.3f} ms first (pinned buffers allocated), "
              f"{again['initiate_ms']:.3f} ms again; commit {first['commit_ms']:.3f} / "
              f"{again['commit_ms']:.3f} ms; verify {verify_ms:.3f} ms; restore "
              f"{ck.timings['restore_ms']:.3f} ms; restored equal {exact}", flush=True)
        shutil.rmtree(d)
        if step != 2 or not exact:
            fail(f"{name}: the checkpoint did not restore what was saved")


def print_accounting():
    """``Zero1Partition.accounting()`` of both zero1 paths at three ranks."""
    from tpu_ddp_torch.models import MODEL_REGISTRY, NetResDeep
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

    for label, model, kw in (
            ("NetResDeep, SGD lr 1e-2 (phase 14)",
             NetResDeep(n_chans1=32, n_blocks=10, num_classes=10), dict(lr=1e-2)),
            ("ViT-S/4, AdamW + decay + clip + EMA (phase 15)",
             MODEL_REGISTRY["vit_s4"](), dict(optimizer="adamw", lr=1e-3,
                                              weight_decay=0.05, grad_clip_norm=1.0,
                                              ema_decay=0.999))):
        params = dict(model.named_parameters())
        tx = make_optimizer(zero1_axis="data", decay_mask=decay_mask(params), **kw)
        acct = Zero1Partition(tx, params, ZERO1_RANKS, rank=0).accounting()
        print(f"  accounting, {label}, {ZERO1_RANKS} ranks: {json.dumps(acct)}",
              flush=True)


def time_masked_group(variant, shapes, n, r, iters):
    """Rank r's shards of ``shapes`` over n ranks through K1 with the pad
    mask, through K1 on the same shards without it, through the plain
    version and through one PyTorch multi-tensor optimizer call, in turns
    (masked, unmasked, plain, library, plain, unmasked, masked)."""
    import torch

    from tpu_ddp_torch.ops.fused_update import LeafBatch

    gen = torch.Generator(device="cuda").manual_seed(16)
    leaves = [shard_leaf(s, n, r, leaf_config(variant, "constant", len(s) >= 2), gen)
              for s in shapes]
    scalars = scalars_for(leaves, leaves[0].cfg, "constant")
    grads = [lf.g for lf in leaves]
    masked = leaf_batch(leaves)
    bare = LeafBatch([lf.p for lf in leaves], [lf.m for lf in leaves],
                     [lf.v for lf in leaves], [lf.e for lf in leaves], leaves[0].cfg,
                     [lf.cfg.wd_apply for lf in leaves], us=[lf.u for lf in leaves])
    calls = {"kernel": lambda: masked.run(grads, scalars),
             "unmasked": lambda: bare.run(grads, scalars),
             "plain": lambda: [plain_outputs(lf, scalars) for lf in leaves],
             "library": library_call(variant, leaves)}
    ms = {k: [] for k in calls}
    for k in ("kernel", "unmasked", "plain", "library", "plain", "unmasked", "kernel"):
        ms[k].append(time_ms(calls[k], iters))
    dev = {k: device_ms(fn, 5) for k, fn in calls.items()}
    b_ms, b_by = bound([(lf.cfg, lf.n) for lf in leaves])
    masked_rows = sum(lf.valid < lf.n for lf in leaves)
    return {k: sum(v) / len(v) for k, v in ms.items()}, dev, b_ms, b_by, masked_rows


def phase_masked_timing(results, launches):
    """Phase 16: K1 with the pad mask at the zero1 paths' shards, rank 2 of
    three (the rank with the most pad)."""
    from tpu_ddp_torch import ops

    print("phase 16: K1 with the ZeRO-1 pad mask, timing (CUDA events; ms per "
          "step of the listed shards)", flush=True)
    entry = ops.KERNELS["fused_update"]
    rows = []
    n, r = ZERO1_RANKS, ZERO1_RANKS - 1
    for model, variant, shapes, iters in (
            ("netresdeep", "sgd", NETRESDEEP_LEAVES, 200),
            ("vit_s4", "adamw_wd_clip_ema", vit_leaf_shapes(), 50)):
        ms, dev, b_ms, b_by, masked_rows = time_masked_group(variant, shapes, n, r, iters)
        group = f"{model} {n} ranks rank {r}"
        err = max(results[(variant, s, group)][0] for s in ("constant", "cosine"))
        row = {
            "name": f"fused_update[zero1,{model},{n} ranks]", "route": entry["route"],
            "source": entry["source"], "replaces": entry["replaces"],
            "launches": launches[model], "max_abs_err": err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": ms["library"], "unmasked_ms": ms["unmasked"],
            "shapes": f"{group}: {len(shapes)} shards, {masked_rows} with a live mask",
            "recipe": variant, "device_ms": dev["kernel"],
            "unmasked_device_ms": dev["unmasked"], "plain_device_ms": dev["plain"],
            "library_device_ms": dev["library"],
        }
        rows.append(row)
        print(f"  {row['name']:36s} masked {ms['kernel']:.5f} ms, unmasked "
              f"{ms['unmasked']:.5f} ms, plain {ms['plain']:.5f} ms, library "
              f"{ms['library']:.5f} ms, bound {b_ms:.6f} ms ({b_by}); device only: "
              f"masked {dev['kernel']}, unmasked {dev['unmasked']}, plain "
              f"{dev['plain']}, library {dev['library']} ms", flush=True)
    return rows


def quant_bound(sizes, block, kind, rows=1):
    """(bound_ms, "bytes"): bytes one call must move over the HBM rate, for
    chunks of ``sizes`` (one a leaf), each input read once and each output
    written once. K2 reads 4 bytes an element and writes nb * block int8
    (the tail block's zero pad included: the wire message holds it) plus 4
    bytes a block ("quant"), and 4 bytes an element more with the error
    ("quant_err"); K3 reads the n int8 bytes of the elements (never the
    pad) plus 4 a block, and 4 an element more with add_to ("dequant_add"),
    and writes 4 an element, for each of ``rows`` messages. A segment table
    is 32 bytes a leaf (read once). Their few operations an element are far
    below the bytes' time."""
    total = 32 * len(sizes) if len(sizes) > 1 else 0
    for n in sizes:
        nb = -(-n // block)
        if kind.startswith("quant"):
            total += 4 * n + nb * block + 4 * nb + (4 * n if kind == "quant_err" else 0)
        else:
            total += rows * (n + 4 * nb + 4 * n
                             + (4 * n if kind == "dequant_add" else 0))
    return total / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_quant_timing(quant_err, runs):
    """Phase 13: one main-path step's K2/K3 calls on one rank at two ranks
    (the flat ring over NetResDeep's 9 leaves: K2 with the error n times,
    K3 +add_to n-1 times, K3 over the n gathered rows once) and one 2**24
    chunk (the one-segment case), each in turns with its plain version."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops.fused_quant import (
        fused_dequant,
        fused_quant,
        segment_dequant,
        segment_dequant_plain,
        segment_quant,
        segment_quant_plain,
    )
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    print("phase 13: K2/K3 timing (CUDA events, ms per step of the listed calls; "
          "no single PyTorch call quantizes block-scaled int8 or dequantizes into a "
          "ring's sums, so only the 2^24 dequantize, bare and into add_to, has a "
          "library time)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    launches = runs["int8"][0]["launches"]
    n = 2
    layout = ring_layout(NETRESDEEP_LEAVES, n)
    x = torch.randn(layout.total, generator=gen, device="cuda")
    err, acc, out = (torch.empty_like(x) for _ in range(3))
    msgs = torch.stack([segment_quant(x, layout, c) for c in range(n)])
    msg = msgs[0].clone()
    big = torch.randn(LARGE, generator=gen, device="cuda")
    big_acc = torch.randn(LARGE, generator=gen, device="cuda")
    payload = fused_quant(big, QUANT_BLOCK)
    chunks = list(layout.shard)
    # name -> (kernel, plain, calls a step, kind, sizes, rows, shapes)
    cases = {
        "fused_quant": (
            lambda: segment_quant(x, layout, 0, err=err),
            lambda: segment_quant_plain(x, layout, 0, "int8", err=err),
            n, "quant_err", chunks, 1, f"netresdeep step at {n} ranks: 9 leaves' chunks "
            f"{chunks} in one launch with the error, x {n}"),
        "fused_dequant[add_to]": (
            lambda: segment_dequant(msg, layout, acc, add=x, add_chunk=1, out_chunk=1),
            lambda: segment_dequant_plain(msg, layout, "int8", acc, add=x, add_chunk=1,
                                          out_chunk=1),
            n - 1, "dequant_add", chunks, 1, f"netresdeep step at {n} ranks: one hop's "
            f"message into 9 leaves' running sums, x {n - 1}"),
        "fused_dequant[gather]": (
            lambda: segment_dequant(msgs, layout, out),
            lambda: segment_dequant_plain(msgs, layout, "int8", out),
            1, "dequant", chunks, n, f"netresdeep step at {n} ranks: the {n} gathered "
            "rows into 9 leaves, x 1"),
        "fused_quant[2^24]": (
            lambda: fused_quant(big, QUANT_BLOCK),
            lambda: quantize_chunk(big, "int8", QUANT_BLOCK),
            1, "quant", [LARGE], 1, "one 2^24 chunk"),
        "fused_dequant[2^24]": (
            lambda: fused_dequant(payload, QUANT_BLOCK, LARGE),
            lambda: dequantize_chunk(payload, "int8", QUANT_BLOCK, LARGE),
            1, "dequant", [LARGE], 1, "one 2^24 chunk"),
        "fused_dequant[add_to][2^24]": (
            lambda: fused_dequant(payload, QUANT_BLOCK, LARGE, add_to=big_acc),
            lambda: big_acc + dequantize_chunk(payload, "int8", QUANT_BLOCK, LARGE),
            1, "dequant_add", [LARGE], 1, "one 2^24 chunk"),
    }
    # the 2^24 dequantize's one PyTorch call: int8 times float32 promotes to
    # float32, q * scale a block (its size is whole blocks); into add_to,
    # add_to + q * scale in one torch.addcmul
    nb = LARGE // QUANT_BLOCK
    library = {
        "fused_dequant[2^24]": (
            lambda: torch.mul(payload["q"].view(nb, QUANT_BLOCK), payload["scale"][:, None]),
            "torch.mul(q.view(nb, block), scale[:, None]), int8 x float32"),
        "fused_dequant[add_to][2^24]": (
            lambda: torch.addcmul(big_acc.view(nb, QUANT_BLOCK),
                                  payload["q"].view(nb, QUANT_BLOCK), payload["scale"][:, None]),
            "torch.addcmul(add_to.view(nb, block), q.view(nb, block), scale[:, None])"),
    }
    for name, (lib_fn, call) in library.items():
        want = (fused_dequant(payload, QUANT_BLOCK, LARGE, add_to=big_acc) if "add_to" in name
                else fused_dequant(payload, QUANT_BLOCK, LARGE))
        got = lib_fn().view(-1)
        print(f"  {call} against K3 ({name}): equal to the bit {bool(torch.equal(got, want))}, "
              f"max |diff| {float((got - want).abs().max()):.3g}", flush=True)
    rows = []
    for name, (kernel, plain, calls, kind, sizes, n_rows, shapes) in cases.items():
        iters = 50 if name.endswith("[2^24]") else 200
        k1, p1 = time_ms(kernel, iters), time_ms(plain, iters)
        p2, k2 = time_ms(plain, iters), time_ms(kernel, iters)
        dev_k, dev_p = device_ms(kernel, 10), device_ms(plain, 10)
        lib = library.get(name)
        l_ms = (time_ms(lib[0], iters) + time_ms(lib[0], iters)) / 2 if lib else None
        l_dev = device_ms(lib[0], 10) if lib else None
        b_ms, b_by = quant_bound(sizes, QUANT_BLOCK, kind, n_rows)
        base = name.split("[")[0]
        entry = ops.KERNELS[base]
        scale = lambda v: None if v is None else v * calls  # noqa: E731
        row = {
            "name": name, "route": entry["route"], "source": entry["source"],
            "replaces": entry["replaces"], "launches": launches[base],
            "max_abs_err": quant_err, "ms": (k1 + k2) / 2 * calls,
            "plain_ms": (p1 + p2) / 2 * calls, "bound_ms": b_ms * calls,
            "bound_by": b_by, "library_ms": scale(l_ms),
            "library": lib[1] if lib else
            "none: no single PyTorch call quantizes block-scaled int8 or dequantizes "
            "into a ring's running sums",
            "shapes": f"{shapes}, block {QUANT_BLOCK}",
            "device_ms": scale(dev_k), "plain_device_ms": scale(dev_p),
            "library_device_ms": scale(l_dev),
        }
        rows.append(row)
        print(f"  {name:28s} x{calls}: kernel {row['ms']:.5f} ms  plain "
              f"{row['plain_ms']:.5f} ms  library {row['library_ms']} ms  bound "
              f"{row['bound_ms']:.6f} ms (bytes); device only: kernel {row['device_ms']}, "
              f"plain {row['plain_device_ms']}, library {row['library_device_ms']} ms "
              f"({shapes})", flush=True)
    return rows


# ---- phase 18: the causal LM on the card (K4-K6 causal, K1; K2/K3 on ranks) ----

#: LM-32k widths: the lm_causal_32k program of ``benchmarks/aot_v5e.py:543-547``
#: (32,768 tokens sequence-sharded 8 ways, 4,096 a device) on one card, data
#: parallel: B x T = 4 x 4,096 tokens a step, float32, AdamW lr 1e-3 through K1
LM_32K = dict(vocab_size=32_000, hidden_dim=512, depth=4, num_heads=8, mlp_ratio=4)
LM_BATCH, LM_SEQ, LM_LEAVES = 4, 4096, 54
LM_STEPS, LM_STEADY_FROM, LM_PROFILE_STEPS = 30, 10, 5
#: part (b): 8 new tokens after a 4,088-token prompt fill the position table;
#: a position counts when the plain logits' top two differ by this much
LM_PROMPT, LM_NEW, DECODE_MARGIN = 4088, 8, 1e-3
#: part (c): the module's default widths (vocab 256, hidden 192, depth 6, 3
#: heads) at T = 256, 8 rows a rank, ZeRO-1 with the int8 ring
LM_RANKS, LM_RANK_ROWS, LM_RANK_SEQ, LM_RANK_STEPS = 2, 8, 256, 20
LM_DEFAULT_DEPTH, LM_DEFAULT_LEAVES = 6, 78
LM_TIMED_ITERS = 10
LM_TOP_KERNELS = 10


def lm_leaf_shapes(cfg, seq_len, leaves):
    """The parameter shapes of ``CausalTransformerLM(**cfg, seq_len=seq_len)``."""
    import torch

    from tpu_ddp_torch.models import CausalTransformerLM

    with torch.device("meta"):
        model = CausalTransformerLM(**cfg, seq_len=seq_len)
    shapes = [tuple(p.shape) for p in model.parameters()]
    if len(shapes) != leaves:
        fail(f"the LM has {len(shapes)} parameter leaves, expected {leaves}")
    return shapes


def lm_tokens(n_batches, rows, seq_len, vocab, seed=0):
    """``n_batches`` (rows, seq_len) int64 batches of the permutation task of
    ``tests/test_lm.py:64-71`` at ``vocab``: each token is a fixed
    permutation of the one before it, from a random start a row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    seq = np.empty((n_batches * rows, seq_len), np.int64)
    seq[:, 0] = rng.integers(0, vocab, n_batches * rows)
    for t in range(1, seq_len):
        seq[:, t] = perm[seq[:, t - 1]]
    return seq.reshape(n_batches, rows, seq_len)


def lm_train_run(use_flash, tokens, bf16=False, remat=False, health=None):
    """Part (a), one run: LM-32k from the seeded weights, ``LM_STEPS``
    steps on ``tokens`` with the launch counts zeroed just before and read
    just after, then ``LM_PROFILE_STEPS`` more under ``torch.profiler``;
    phase 20d's in bfloat16 compute and with ``remat``. ``health`` (a
    policy, phase 21c) adds the flight recorder to the step and, after each
    step, the trainer's host half: ``HealthFeed``'s one copy of the scalars
    to the host (read a step late, as the trainer reads it) into a
    ``HealthMonitor`` that writes nothing. Returns (model, run's numbers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.health.monitor import HealthMonitor
    from tpu_ddp_torch.health.stats import HealthConfig, HealthFeed
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.tools.profile_step import FLASH_KERNELS, _device_us
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    model = CausalTransformerLM(**LM_32K, seq_len=LM_SEQ, use_flash=use_flash,
                                generator=torch.Generator().manual_seed(0),
                                dtype=torch.bfloat16 if bf16 else torch.float32,
                                remat=remat)
    tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
    state = create_lm_train_state(model, tx, torch.device("cuda"))
    inner = make_lm_train_step(tx, health=None if health is None else HealthConfig(
        skip_nonfinite=health == "skip_step"))
    monitor = HealthMonitor(policy=health) if health is not None else None
    feed = HealthFeed(monitor, lag=health != "halt") if health is not None else None
    seen = [0]

    def step(state, batch):
        state, metrics = inner(state, batch)
        if feed is not None:
            feed.push(seen[0], metrics.pop("health"), batch)
            seen[0] += 1
        return state, metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ops.reset_launch_counts()
    for i in range(LM_STEPS):
        if i == LM_STEADY_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens[i]})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    steady_s = (time.perf_counter() - t0) / (LM_STEPS - LM_STEADY_FROM)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(LM_PROFILE_STEPS):
            state, _ = step(state, {"tokens": tokens[i]})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) / LM_PROFILE_STEPS * 1e3
    busy_us, kernels, rows = _device_us(prof)
    flash_ms = sum(us for us, _, k in rows if any(f in k for f in FLASH_KERNELS)
                   ) / LM_PROFILE_STEPS * 1e-3
    busy_ms = busy_us / LM_PROFILE_STEPS * 1e-3
    if feed is not None:
        feed.flush()
    if monitor is not None and monitor.nonfinite_steps:
        fail(f"LM-32k with health {health}: {monitor.nonfinite_steps} non-finite steps")
    return state.model, {
        "losses": [float(x) for x in losses], "launches": counts,
        "steady_step_ms": steady_s * 1e3,
        "tokens_per_sec": LM_BATCH * LM_SEQ / steady_s,
        "max_memory_allocated": peak,
        "profiled_step_ms": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "kernels_per_step": kernels / LM_PROFILE_STEPS,
        "flash_device_ms_per_step": flash_ms,
        "flash_share_of_busy": flash_ms / busy_ms if busy_ms else None,
        "top": [(us / LM_PROFILE_STEPS * 1e-3, count / LM_PROFILE_STEPS, key)
                for us, count, key in sorted(rows, reverse=True)[:LM_TOP_KERNELS]],
    }


def phase_lm_train(tokens, smi):
    """Phase 18 (a): LM-32k widths, ``LM_STEPS`` steps with ``use_flash``
    (K4-K6 causal) and with the plain causal attention, from the same
    seeded weights on the same batches. Returns (the flash model, runs)."""
    runs = {}
    for attention in ("flash", "full"):
        model, run = lm_train_run(attention == "flash", tokens)
        runs[attention] = run
        losses, counts = run["losses"], run["launches"]
        flash = attention == "flash"
        want = {name: 0 for name in counts}
        want["fused_update"] = LM_STEPS
        for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            want[name] = LM_32K["depth"] * LM_STEPS if flash else 0
        first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        print(f"phase 18a: LM-32k {attention} attention, {LM_STEPS} steps of "
              f"(B, T) = ({LM_BATCH}, {LM_SEQ}), AdamW lr 1e-3 --kernels ({smi}): "
              f"launches {counts}; mean loss of the first 10 steps {first:.5f}, "
              f"last 10 {last:.5f}; steady {run['steady_step_ms']:.3f} ms a step "
              f"(steps {LM_STEADY_FROM}-{LM_STEPS}), {run['tokens_per_sec']:.1f} "
              f"tokens/sec, max_memory_allocated {run['max_memory_allocated']} B",
              flush=True)
        print(f"  torch.profiler over {LM_PROFILE_STEPS} steps: step "
              f"{run['profiled_step_ms']:.3f} ms, device busy "
              f"{run['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{run['device_idle_share']}, {run['kernels_per_step']:.1f} kernels "
              f"a step; K4-K6 {run['flash_device_ms_per_step']:.3f} device ms a step "
              f"({run['flash_share_of_busy']} of busy); the kernels that take most "
              "device time (ms a step, calls a step):", flush=True)
        for ms, calls, key in run["top"]:
            print(f"    {ms:9.3f} ms {calls:6.1f}x  {key[:100]}", flush=True)
        if counts != want:
            fail(f"LM {attention}: launches {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            fail(f"LM {attention}: losses are not finite and falling")
        if flash:
            flash_model = model
        del model
    got = runs["full"]["losses"][:PLAIN_STEPS_RTOL]
    want = runs["flash"]["losses"][:PLAIN_STEPS_RTOL]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"  full vs flash, relative loss difference per step: "
          f"{' '.join(f'{r:.2g}' for r in rel)} (limit {FULL_STEPS_RTOL})", flush=True)
    if not max(rel) <= FULL_STEPS_RTOL:
        fail("the LM's full and flash losses disagree over the first steps")
    return flash_model, runs


def phase_lm_decode(model, tokens):
    """Phase 18 (b): ``greedy_generate`` from a (B, LM_PROMPT) prompt, with
    K4 and with the plain causal attention. Where the two decodes have seen
    the same tokens, they must pick the same one at every position where
    the plain logits' top two differ by ``DECODE_MARGIN`` or more; a
    position under the margin may differ, and that row's later positions
    are then not comparable."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.models import greedy_generate

    prompt = tokens[:, :LM_PROMPT]
    out, counts, ms = {}, {}, {}
    for attention in ("flash", "full"):
        model.use_flash = attention == "flash"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out[attention] = greedy_generate(model, prompt, LM_NEW)
        torch.cuda.synchronize()
        ms[attention] = (time.perf_counter() - t0) * 1e3 / LM_NEW
        counts[attention] = ops.launch_counts()
    with torch.no_grad():        # what each plain decode step saw, by causality
        logits = model(out["full"])[:, LM_PROMPT - 1:-1]
    model.use_flash = True
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    got, want = out["flash"][:, LM_PROMPT:].cpu(), out["full"][:, LM_PROMPT:].cpu()
    checked = under = unchecked = 0
    bad = []
    for b in range(got.shape[0]):
        for j in range(LM_NEW):
            if margin[b, j] < DECODE_MARGIN:
                under += 1
                if got[b, j] != want[b, j]:
                    unchecked += LM_NEW - j - 1
                    break
                continue
            checked += 1
            if got[b, j] != want[b, j]:
                bad.append((b, j))
                break
    task = float((got == tokens[:, LM_PROMPT:].cpu()).float().mean())
    print(f"phase 18b: greedy_generate from a {tuple(prompt.shape)} prompt, {LM_NEW} "
          f"new tokens: flash launches {counts['flash']}, plain launches "
          f"{counts['full']}; {checked} positions checked, {under} under the "
          f"margin {DECODE_MARGIN}, {unchecked} past a divergence under it; "
          f"differing checked positions {bad}; min margin {float(margin.min()):.4g}; "
          f"share of the task's next tokens {task:.4f}; ms a token (host clock) "
          f"flash {ms['flash']:.3f}, plain {ms['full']:.3f}", flush=True)
    want_counts = {name: 0 for name in counts["flash"]}
    want_counts["flash_attention_fwd"] = LM_32K["depth"] * LM_NEW
    if counts["flash"] != want_counts:
        fail(f"flash decode launched {counts['flash']}, expected {want_counts}")
    if any(counts["full"].values()):
        fail(f"plain decode launched kernels: {counts['full']}")
    if not torch.equal(out["flash"][:, :LM_PROMPT], prompt):
        fail("greedy_generate changed the prompt")
    if bad or not checked:
        fail(f"flash and plain decodes differ at checked positions {bad} "
             f"({checked} checked)")


def lm_rank_child(out_dir, backend):
    """Phase 18 (c) on one rank, started by the launcher: LM-default at
    T = 256 with flash attention, ``LM_RANK_ROWS`` rows a rank, AdamW lr
    1e-3 through K1, ZeRO-1 with the int8 ring and error feedback (K2/K3),
    ``LM_RANK_STEPS`` steps with the launch counts zeroed just before;
    writes the counts, the ring's wire calls, the losses and the weights."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import DATA_AXIS, Zero1Partition
    from tpu_ddp_torch.tools.ring_compare import wire_counter
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

    runtime.initialize_distributed("cuda", backend)
    mark_started(out_dir)
    try:
        rank, world = runtime.rank(), runtime.world_size()
        device = runtime.rank_device("cuda", backend)
        model = CausalTransformerLM(seq_len=LM_RANK_SEQ, use_flash=True,
                                    generator=torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True,
                            zero1_axis=DATA_AXIS, decay_mask=decay_mask(params))
        part = Zero1Partition(tx, params, world)
        state = create_lm_train_state(model, tx, device, zero1=part)
        comp = GradCompressor(GradCompression(mode="int8", block=QUANT_BLOCK,
                                              error_feedback=True, kernels=True),
                              state.params(), world)
        part.set_compression(comp)
        state.grad_residual = comp.init_residual(device)
        step = make_lm_train_step(tx, compress=comp, zero1=part)
        rows = slice(rank * LM_RANK_ROWS, (rank + 1) * LM_RANK_ROWS)
        tokens = torch.from_numpy(lm_tokens(LM_RANK_STEPS, world * LM_RANK_ROWS,
                                            LM_RANK_SEQ, 256)[:, rows]).to(device)
        wire = wire_counter()
        losses = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(LM_RANK_STEPS):
            state, metrics = step(state, {"tokens": tokens[i]})
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / LM_RANK_STEPS * 1e3
        out = {"launches": ops.launch_counts(), "wire_calls": wire,
               "losses": [float(x) for x in losses], "step_ms": step_ms}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        runtime.shutdown()


def phase_lm_ranks(tmp, nproc=LM_RANKS, backend="gloo"):
    """Phase 18 (c): ``lm_rank_child`` on ``nproc`` ranks through the
    launcher (two sharing the card over gloo; one card each over NCCL)."""
    import torch

    out = os.path.join(tmp, f"lm_{nproc}_{backend}")
    os.makedirs(out)
    print(f"phase 18c: LM-default (T = {LM_RANK_SEQ}, {LM_RANK_ROWS} rows a rank) "
          f"--kernels --zero1 int8 + error feedback, flash attention, on {nproc} "
          f"ranks over {backend}, {LM_RANK_STEPS} steps", flush=True)
    rc = smoke_job(["--lm-rank-child", out, backend], nproc, "18c", out)
    if rc:
        fail(f"the {nproc}-rank LM run exited with {rc}")
    metrics = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            metrics.append(json.load(f))
    weights = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(nproc)]
    same = all(torch.equal(weights[0][k], w[k]) for w in weights[1:] for k in w)
    want = {name: 0 for name in metrics[0]["launches"]}
    want.update({k: v * LM_RANK_STEPS for k, v in zero1_launches(nproc, True).items()})
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        want[name] = LM_DEFAULT_DEPTH * LM_RANK_STEPS
    wire = {k: v * LM_RANK_STEPS for k, v in ring_wire_calls(nproc, True, True).items()}
    losses = metrics[0]["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"  launches on rank 0 {metrics[0]['launches']}; wire calls "
          f"{metrics[0]['wire_calls']}; params bitwise equal on all {nproc} ranks "
          f"{same}; mean loss of the first 5 steps {first:.5f}, last 5 {last:.5f}; "
          "step time per rank (host clock) "
          + " / ".join(f"{m['step_ms']:.3f}" for m in metrics) + " ms", flush=True)
    for r, m in enumerate(metrics):
        if m["launches"] != want:
            fail(f"LM rank {r} launched {m['launches']}, expected {want}")
        if m["wire_calls"] != wire:
            fail(f"LM rank {r}'s ring made {m['wire_calls']} wire calls, "
                 f"expected {wire}")
    if not same:
        fail(f"the {nproc} LM ranks end with different params")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        fail(f"the {nproc}-rank LM losses are not finite and falling")
    return metrics


#: phase 19: fine-tuning at ResNet-50's full width (CIFAR stem), under cuDNN's
#: deterministic algorithms. (a) pretrains at 100 classes, (b) and (c)
#: fine-tune at 3 (BCE, the head alone): 2 epochs of 15 steps at batch 32
#: each; (d) ResNet-18 at 100 classes on ranks, 2 epochs of 10 steps a rank
FT_STEPS_PER_EPOCH, FT_EPOCHS = 15, 2
FT_STEPS = FT_STEPS_PER_EPOCH * FT_EPOCHS
FT_CLASSES, FT_PRETRAIN_CLASSES = 3, 100
R50_LEAVES, R50_PARAMS, R50_STATS = 161, 23_705_252, 106
R18_LEAVES, R18_PARAMS = 62, 11_220_132
FT_RANKS, FT_RANK_STEPS_PER_EPOCH = 2, 10
FT_PROFILE_STEPS = 5
#: leaves one K1 launch takes (``MAX_LEAVES`` of ops/fused_update.py)
MAX_K1_LEAVES = 128


def ft_args(*extra, classes, model="resnet50", steps_per_epoch=FT_STEPS_PER_EPOCH,
            nproc=1):
    """The train CLI's arguments of a phase-19 run: SGD with momentum 0.9,
    lr 1e-2, batch 32 a rank, ``FT_EPOCHS`` epochs of ``steps_per_epoch``
    steps on synthetic data."""
    return ["--device", "cuda", "--model", model, "--num-classes", str(classes),
            "--synthetic-data", "--synthetic-size", str(nproc * 32 * steps_per_epoch),
            "--epochs", str(FT_EPOCHS), "--batch-size", "32", "--optimizer", "sgd",
            "--momentum", "0.9", "--lr", "1e-2", "--log-every-epochs", "1", *extra]


def counted_run(args):
    """``tpu_ddp_torch.cli.train.run(args)`` with the launch counts zeroed
    just before and read just after, and the peak memory of the run.
    Returns (trainer, metrics)."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer, metrics = cli.run(args)
    torch.cuda.synchronize()
    metrics["launches"] = ops.launch_counts()
    metrics["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return trainer, metrics


def ft_run(label, args, want_k1):
    """``tpu_ddp_torch.cli.train.run(args)`` with the launch counts zeroed
    just before and read just after; checks them (K1 ``want_k1``, nothing
    else) and the losses (``FT_STEPS`` of them, finite, the last 10 below
    the first 10). Returns (trainer, metrics)."""
    print(f"phase {label}: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    trainer, metrics = counted_run(args)
    counts = metrics["launches"]
    losses = metrics["step_losses"]
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"  launches {counts}; mean loss of the first 10 steps {first:.5f}, last "
          f"10 {last:.5f}; steady {metrics['steady_step_ms']:.3f} ms a step (epoch "
          f"2, host clock), {metrics['images_per_sec_per_chip']:.1f} images/s, "
          f"max_memory_allocated {metrics['max_memory_allocated']} B", flush=True)
    want = {name: 0 for name in counts}
    want["fused_update"] = want_k1
    if counts != want:
        fail(f"phase {label}: launches {counts}, expected {want}")
    if len(losses) != FT_STEPS or not all(math.isfinite(x) for x in losses) \
            or not last < first:
        fail(f"phase {label}: losses are not {FT_STEPS} finite and falling ones")
    return trainer, metrics


def ft_profile(trainer, n=FT_PROFILE_STEPS):
    """``n`` more train steps of ``trainer`` under ``torch.profiler`` (one
    step before, unprofiled): (host ms a step, device busy ms a step, idle
    share, kernels a step, the ``LM_TOP_KERNELS`` kernels that take most
    device time as (ms a step, calls a step, name))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.tools.profile_step import _device_us

    trainer.train_loader.set_epoch(FT_EPOCHS + 1)
    batches = [trainer.to_device(b) for _, b in
               zip(range(n + 1), trainer.train_loader.epoch_batches())]
    trainer.state, _ = trainer.train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            trainer.state, _ = trainer.train_step(trainer.state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    busy_us, kernels, rows = _device_us(prof)
    busy_ms = busy_us / n * 1e-3
    top = [(us / n * 1e-3, count / n, key)
           for us, count, key in sorted(rows, reverse=True)[:LM_TOP_KERNELS]]
    return wall_ms, busy_ms, 1.0 - busy_ms / wall_ms, kernels / n, top


def export_pretrained(model, state_dict, path):
    """``export_state_dict`` of ``state_dict`` to the torchvision-layout
    ``path``, with the ``num_batches_tracked`` entry torchvision keeps
    beside each BatchNorm (the port has none: the import reports them
    unmapped)."""
    import torch

    from tpu_ddp_torch.checkpoint.import_foreign import export_state_dict

    params = {n: state_dict[n] for n, _ in model.named_parameters()}
    stats = {n: state_dict[n] for n, _ in model.named_buffers()}
    export_state_dict(params, stats, model, path)
    sd = torch.load(path, weights_only=True)
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(FT_STEPS)
    torch.save(sd, path)
    return params


def same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def phase_finetune(tmp, smi):
    """Phase 19 (a)-(c) and (e)'s launches: ResNet-50 pretrained, exported,
    fine-tuned from the file and from the checkpoint directory, and the
    fine-tune again with the plain update. Returns {run: metrics}."""
    import torch

    from tpu_ddp_torch.checkpoint.import_foreign import import_state_dict
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer, build_model

    ck = os.path.join(tmp, "ft_ckpt")
    runs = {}
    # (a) pretraining at 100 classes, two K1 launches a step (161 leaves)
    trainer, m = ft_run("19a", ft_args("--kernels", "--checkpoint-dir", ck,
                                       classes=FT_PRETRAIN_CLASSES), 2 * FT_STEPS)
    model = trainer.state.model
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves, n_stats = len(list(model.parameters())), len(list(model.buffers()))
    if (n_params, n_leaves, n_stats) != (R50_PARAMS, R50_LEAVES, R50_STATS):
        fail(f"ResNet-50 has {n_params} params in {n_leaves} leaves and {n_stats} "
             f"BatchNorm stats, expected {R50_PARAMS}, {R50_LEAVES}, {R50_STATS}")
    final = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    path = os.path.join(tmp, "resnet50_pretrained.pt")
    params = export_pretrained(model, final, path)
    wall, busy, idle, kernels, top = ft_profile(trainer)
    m.update(profiled_step_ms=wall, device_busy_ms_per_step=busy,
             device_idle_share=idle, kernels_per_step=kernels)
    runs["pretrain"] = m
    print(f"  {n_params:,} params in {n_leaves} leaves, {n_stats} BatchNorm stats; "
          f"final test accuracy {m['test_accuracy']:.4f} ({smi}); torch.profiler over "
          f"{FT_PROFILE_STEPS} steps: step {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {idle:.4f}, {kernels:.1f} kernels a step; the kernels that "
          "take most device time (ms a step, calls a step):", flush=True)
    for ms, calls, key in top:
        print(f"    {ms:9.3f} ms {calls:6.1f}x  {key[:100]}", flush=True)
    del trainer, model
    torch.cuda.empty_cache()

    # (b) the fine-tune from the exported file: BCE, the head alone trains
    fresh = build_model(cli.config_from_args(cli.build_parser().parse_args(
        ft_args(classes=FT_CLASSES))))
    _, _, report = import_state_dict(path, fresh)
    print(f"phase 19b: {path}: {report['mapped']} keys mapped, "
          f"{len(report['unmapped'])} unmapped (e.g. {report['unmapped'][:3]})",
          flush=True)
    if report["mapped"] != R50_LEAVES + R50_STATS or len(report["unmapped"]) != 53:
        fail(f"the foreign import mapped {report['mapped']} keys and left "
             f"{len(report['unmapped'])} unmapped")
    ft = ["--pretrained-dir", path, "--loss", "bce", "--freeze", "head"]
    trainer, m = ft_run("19b", ft_args("--kernels", *ft, classes=FT_CLASSES), 2 * FT_STEPS)
    got = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
    backbone = [n for n in params if not n.startswith("head.")]
    frozen_same = all(same_bits(got[n], final[n] + 0.0) for n in backbone)
    head_moved = not torch.equal(got["head.weight"], fresh.head.weight.detach())
    stats_moved = sum(not torch.equal(got[n], final[n])
                      for n in final if ".running_" in n)
    print(f"  {len(backbone)} backbone params bitwise the file's (p + 0.0): "
          f"{frozen_same}; head moved {head_moved}; BatchNorm stats moved "
          f"{stats_moved} of {R50_STATS}", flush=True)
    if not (frozen_same and head_moved and stats_moved == R50_STATS):
        fail("the fine-tune moved a frozen param, or left the head or the stats")
    runs["finetune"] = m
    kernel_losses = m["step_losses"]
    kernel_final = got
    del trainer
    torch.cuda.empty_cache()

    # the same from (a)'s checkpoint directory: the restored backbone
    tr = Trainer(cli.config_from_args(cli.build_parser().parse_args(
        ft_args("--kernels", "--pretrained-dir", ck, "--loss", "bce", "--freeze",
                "head", classes=FT_CLASSES))))
    got = tr.state.model.state_dict()
    dir_same = all(same_bits(got[n].cpu(), final[n]) for n in final
                   if not n.startswith("head."))
    print(f"phase 19b: --pretrained-dir {ck} (step {FT_STEPS}): every backbone param "
          f"and BatchNorm stat bitwise the checkpoint's: {dir_same}", flush=True)
    if not dir_same:
        fail("the restore from the checkpoint directory differs from its state")
    tr.close()
    del tr
    torch.cuda.empty_cache()

    # (c) the plain update on the same batches
    trainer, m = ft_run("19c", ft_args(*ft, classes=FT_CLASSES), 0)
    got = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
    same = (m["step_losses"] == kernel_losses
            and all(same_bits(got[n], kernel_final[n]) for n in got))
    print(f"  K1 against the plain update under deterministic cuDNN: per-step losses "
          f"and final state bitwise equal: {same}", flush=True)
    if not same:
        fail("the fine-tune with K1 and with the plain update differ")
    runs["finetune_plain"] = m
    del trainer
    torch.cuda.empty_cache()
    return runs


def ft_ranks_spec(tmp, nproc=FT_RANKS, backend="gloo"):
    """Phase 19 (d)'s run ``(name, args, options)`` for ``launch_dp_runs``,
    and the params of the file it fine-tunes from (written into ``tmp``)."""
    import torch

    from tpu_ddp_torch.models import MODEL_REGISTRY

    model = MODEL_REGISTRY["resnet18"](num_classes=FT_PRETRAIN_CLASSES,
                                       generator=torch.Generator().manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    if (n_params, len(list(model.parameters()))) != (R18_PARAMS, R18_LEAVES):
        fail(f"ResNet-18 has {n_params} params, expected {R18_PARAMS}")
    path = os.path.join(tmp, f"resnet18_pretrained_{nproc}.pt")
    params = export_pretrained(model, model.state_dict(), path)
    args = ft_args("--kernels", "--zero1", "--grad-compress", "int8",
                   "--grad-compress-error-feedback", "--freeze", "head",
                   "--pretrained-dir", path, "--dist-backend", backend,
                   classes=FT_PRETRAIN_CLASSES, model="resnet18",
                   steps_per_epoch=FT_RANK_STEPS_PER_EPOCH, nproc=nproc)
    return (f"ft_ranks{nproc}_{backend}", args, ["--deterministic"]), params


def phase_finetune_ranks(tmp, nproc=FT_RANKS, backend="gloo", runs=None):
    """Phase 19 (d): ResNet-18 at CIFAR-100 widths fine-tuned from a file
    with ``--zero1 --grad-compress int8 --grad-compress-error-feedback
    --freeze head --kernels`` on ``nproc`` ranks (two sharing the card over
    gloo; one card each over NCCL), under deterministic cuDNN: replicas
    bitwise, frozen params the file's, launches and wire calls exact.
    ``runs``: the results of a job that ran it already
    (``variant_ranks_runs``); without them it runs in a job of its own."""
    run, params = ft_ranks_spec(tmp, nproc, backend)
    label = run[0]
    if runs is None:
        runs = launch_dp_runs(tmp, [run], nproc, phase="19d")
    metrics, same = runs[label]
    weights = rank_weights(tmp, label, nproc)
    steps = FT_EPOCHS * FT_RANK_STEPS_PER_EPOCH
    want = {name: 0 for name in metrics[0]["launches"]}
    want.update({k: v * steps for k, v in zero1_launches(nproc, True).items()})
    wire = {k: v * steps for k, v in ring_wire_calls(nproc, True, True).items()}
    frozen_same = all(same_bits(w[n], p.detach() + 0.0) for w in weights
                      for n, p in params.items() if not n.startswith("head."))
    losses = metrics[0]["step_losses"]
    print(f"  launches on rank 0 {metrics[0]['launches']} (expected {want}); wire "
          f"calls {metrics[0]['wire_calls']}; replicas bitwise equal {same}; frozen "
          f"params the file's on every rank {frozen_same}; losses "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; steady step per rank "
          + " / ".join(f"{x['steady_step_ms']:.3f}" for x in metrics) + " ms",
          flush=True)
    for r, m in enumerate(metrics):
        if m["launches"] != want or m["wire_calls"] != wire:
            fail(f"fine-tune rank {r}: launches {m['launches']}, wire calls "
                 f"{m['wire_calls']}; expected {want}, {wire}")
        if m["steps"] != steps:
            fail(f"fine-tune rank {r} ran {m['steps']} steps, expected {steps}")
    if not same or not frozen_same:
        fail("the fine-tune's replicas differ, or a frozen param moved")
    if not all(math.isfinite(x) for x in losses):
        fail("the ranks' fine-tune losses are not finite")
    return metrics


def variant_ranks_runs(tmp):
    """Phases 19d, 21b and 22e's two-rank runs in one job, each with its
    own ``rank_child`` options (one process start for the three); their
    checks read the results later (``phase_finetune_ranks``,
    ``phase_health_ranks``, ``phase_scan_ranks`` with ``runs``)."""
    runs = [ft_ranks_spec(tmp)[0], health_ranks_spec(tmp)[0], scan_ranks_spec()]
    return launch_dp_runs(tmp, runs, 2, phase="19d, 21b and 22e")


def phase_finetune_timing(results, runs):
    """Phase 19 (e): K1 at ResNet-50's 161 leaves under the fine-tune's
    recipe (SGD, momentum 0.9), all trainable (phase 19a) and head-only
    (19b), each beside its plain version, ``torch._fused_sgd_`` over the
    trainable leaves and its bound."""
    print("phase 19e: K1 at ResNet-50's 161 leaves, SGD + momentum (CUDA events; "
          "ms per step)", flush=True)
    named = resnet_leaf_shapes("resnet50", FT_CLASSES, R50_LEAVES)
    shapes = [s for _, s in named]
    return [
        k1_row("fused_update[sgd_mom,resnet50]", "sgd_mom", shapes, "resnet50", 200,
               runs["pretrain"]["launches"]["fused_update"], results,
               "resnet50 161 leaves (23,506,499), all trainable"),
        k1_row("fused_update[sgd_mom,resnet50 head-only]", "sgd_mom", shapes,
               "resnet50_head", 200, runs["finetune"]["launches"]["fused_update"], results,
               "resnet50 161 leaves, 159 frozen (23,500,352), head trainable (6,147)",
               frozen=[f for _, f in head_only(named)]),
    ]


# ---- phase 20: bfloat16 compute and --remat (K4-K6's bfloat16 kernels) ----

#: phase 20c: ViT-S/4 bfloat16 through the CLI, 2 epochs of this many steps;
#: the flash and full runs' first losses within this relative band, about
#: three times the largest difference a sound run shows (1.6e-3 on an H100:
#: the two attentions round p at other places, a logit moves by a unit of
#: its last place, and AdamW's normalised update carries it on; PERF.md
#: gives the readings, a faulty kernel's included)
BF16_VIT_STEPS_PER_EPOCH = 50
BF16_LOSS_RTOL = 5e-3
#: phase 20d: LM-32k bfloat16 against phase 18a's float32 flash run: its
#: first losses within this relative band, about eight times the largest
#: difference a sound run shows (6.3e-5 on an H100)
BF16_LM_RTOL = 5e-4
#: phase 20e: NetResDeep bfloat16 through the CLI, one epoch of this many steps
BF16_NRD_STEPS = 20
#: phase 20's negative controls: K4 made wrong on purpose for one run, by a
#: patch of its wrapper (the sources stay as they are); each loss band must
#: reject each of them
BF16_FAULTS = {
    "k_v_exchanged": lambda f: lambda q, k, v, m=None, c=False: f(q, v, k, m, c),
    "scale_1_over_D": lambda f: lambda q, k, v, m=None, c=False: f(
        q * (1.0 / math.sqrt(q.shape[-1])), k, v, m, c),
}


def with_k4_fault(name, run):
    """``run()`` with ``BF16_FAULTS[name]`` patched into the wrapper
    ``FlashAttention`` calls, then the wrapper restored."""
    from tpu_ddp_torch.ops import flash_attention as fa

    sound = fa.flash_forward
    fa.flash_forward = BF16_FAULTS[name](sound)
    try:
        return run()
    finally:
        fa.flash_forward = sound


def bf16_row_control(fa, q, k, v, want_out):
    """Phase 20a's negative control at the LM's causal shape: K4 on a v
    whose last key of every 64-key tile past position 1,024 is 0, against
    the sound plain output; the per-row check must reject it. Prints what
    a single bound of 2 units of the tensor's largest value would read.
    Returns the failures."""
    import torch

    from tpu_ddp_torch.tools.variants import bf16_row_units

    v_bad = v.clone()
    v_bad[:, 1024 + 63::64] = 0
    bad, _ = fa.flash_forward(q, k, v_bad, None, True)
    diff = (bad.float() - want_out.float()).abs()
    units = bf16_row_units(bad, want_out)
    top = float(want_out.float().abs().max())
    whole = BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    flagged = int((units > BF16_ULPS).any(-1).sum())
    print(f"  control, lm_causal with the last key of every tile past 1,024 dropped: max "
          f"|diff| {float(diff.max()):.3g} (a bound of {BF16_ULPS} units of the largest "
          f"value, {whole:.3g}, would {'pass' if float(diff.max()) <= whole else 'reject'} "
          f"it); worst row {float(units.max()):.3g} units, {flagged} of "
          f"{units[..., 0].numel()} rows beyond {BF16_ULPS}", flush=True)
    del v_bad, bad, diff, units
    torch.cuda.empty_cache()
    return [] if flagged else ["the per-row check passes a K4 that drops keys"]


def bf16_dkv_control(fa, q, k, v, do, lse, di, want_dk, want_dv):
    """Phase 20a's negative control for K6 at the LM's causal shape: K6 on a
    dO whose last query row of every 64-query tile past position 1,024 is 0,
    against the plain version on the true dO; the per-row check must reject
    both dk and dv. Returns the failures."""
    import torch

    from tpu_ddp_torch.tools.variants import bf16_row_units

    do_bad = do.clone()
    do_bad[:, 1024 + 63::64] = 0
    dk, dv = fa.flash_dkv(q, k, v, do_bad, lse, di, None, True)
    flagged, worst = {}, {}
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        units = bf16_row_units(got, want)
        flagged[name] = int((units > BF16_ULPS).any(-1).sum())
        worst[name] = float(units.max())
    print(f"  control, K6 on lm_causal with the last query of every tile past 1,024 dropped "
          f"from dO: worst row dk {worst['dk']:.3g} / dv {worst['dv']:.3g} units; rows beyond "
          f"{BF16_ULPS}: dk {flagged['dk']}, dv {flagged['dv']} of {dk[..., 0].numel()}",
          flush=True)
    del do_bad, dk, dv
    torch.cuda.empty_cache()
    return ([] if all(flagged.values())
            else ["the per-row check passes a K6 whose dO drops queries"])


def phase_bf16_vs_plain():
    """Phase 20a: K4-K6's bfloat16 kernels against their plain versions in
    bfloat16 at ``BF16_CASES``: out, dq, dk and dv within ``BF16_ULPS`` of
    each row's own unit (``bf16_row_units``), lse within ``atol=2e-5``;
    rows that see no key exactly 0 with zero gradients; each kernel's
    launch. Returns {case: {output: max |diff|}}."""
    import torch

    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.tools.variants import bf16_row_units

    print(f"phase 20a: K4/K5/K6 bfloat16 kernels vs plain versions (max |diff|, and "
          f"in [] the worst row's error in bf16 units of that row's largest value; "
          f"bf16 outputs within {BF16_ULPS} such units in every row, lse atol 2e-5)",
          flush=True)
    for D in (64, 128):
        print(f"  launch at D = {D}: K4 {fa.forward_launch_info(D, torch.bfloat16)}; "
              f"K5 {fa.backward_launch_info('dq', D, torch.bfloat16)}; "
              f"K6 {fa.backward_launch_info('dkv', D, torch.bfloat16)}", flush=True)
    results, failed = {}, []
    for case in BF16_CASES:
        q, k, v, do, mask, causal = flash_inputs(case, bf16=True)
        want_out, want_lse = fa.forward_plain(q, k, v, mask, causal)
        di = fa.row_dot(do, want_out)
        want_dq = fa.dq_plain(q, k, v, do, want_lse, di, mask, causal)
        want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di, mask, causal)
        out, lse = fa.flash_forward(q, k, v, mask, causal)
        dq = fa.flash_dq(q, k, v, do, want_lse, di, mask, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal)
        torch.cuda.synchronize()
        errs, units = {}, {}
        for name, got, want in (("out", out, want_out), ("lse", lse, want_lse),
                                ("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
            diff = (got.float() - want.float()).abs()
            errs[name] = float(diff.max())
            if name == "lse":
                ok, bound = bool((diff <= 2e-5).all()), "atol 2e-5"
            else:
                units[name] = float(bf16_row_units(got, want).max())
                ok, bound = units[name] <= BF16_ULPS, f"{BF16_ULPS} units of its row"
            if (got.dtype != (torch.float32 if name == "lse" else torch.bfloat16) or not ok
                    or not bool(torch.isfinite(got.float()).all())):
                failed.append(f"{case} {name} (max |diff| {errs[name]:.3g}, worst row "
                              f"{units.get(name, 0):.3g} units; bound {bound})")
        if mask is not None:
            T = q.shape[1]
            rows = slice(None) if BF16_CASES[case][5] == "dead_batch" else slice(0, T // 4)
            hidden = mask == 0
            if not (bool((out[1, rows] == 0).all()) and bool((dq[1, rows] == 0).all())
                    and bool((lse[1, :, rows] == fa.NEG).all())
                    and bool((dk[hidden] == 0).all()) and bool((dv[hidden] == 0).all())):
                failed.append(f"{case}: rows with no visible key, or masked keys, "
                              "are not exactly 0")
        results[case] = errs
        print(f"  {case:20s} {tuple(q.shape)} causal={causal} mask={BF16_CASES[case][5]} "
              + " ".join(f"{n}={e:.3g}" + (f" [{units[n]:.3g}]" if n in units else "")
                         for n, e in errs.items()),
              flush=True)
        if case == "lm_causal":
            failed += bf16_row_control(fa, q, k, v, want_out)
            failed += bf16_dkv_control(fa, q, k, v, do, want_lse, di, want_dk, want_dv)
        del q, k, v, do, want_out, want_lse, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()
    if failed:
        fail("bf16 flash kernels disagree with their plain versions: " + "; ".join(failed))
    return results


def vit_bf16_args(attention, *extra):
    """Phase 20c's CLI arguments: phase 8's recipe in bfloat16, 2 epochs of
    ``BF16_VIT_STEPS_PER_EPOCH`` steps."""
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * BF16_VIT_STEPS_PER_EPOCH), "--epochs", "2", "--model", "vit_s4",
            "--attention", attention, "--kernels", "--optimizer", "adamw",
            "--lr", "1e-3", "--batch-size", "32", "--eval-each-epoch",
            "--log-every-epochs", "1", "--compute-dtype", "bfloat16", *extra]


def bf16_vit_run(attention, *extra):
    """One phase-20c run with the counts zeroed just before and read just
    after; checks the launches (the bfloat16 kernels alone; K4 once more a
    block a step under ``--remat``), finite and falling losses and the final
    eval. Returns (trainer, metrics)."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    args = vit_bf16_args(attention, *extra)
    print(f"phase 20c: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer, metrics = cli.run(args)
    torch.cuda.synchronize()
    counts = metrics["launches"] = ops.launch_counts()
    metrics["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    steps, evals = metrics["steps"], metrics["eval_batches"]
    losses = metrics["step_losses"]
    flash, remat = attention == "flash", "--remat" in extra
    want = {name: 0 for name in counts}
    want["fused_update"] = steps
    if flash:
        want["flash_attention_fwd_bf16"] = VIT_DEPTH * ((2 if remat else 1) * steps + evals)
        want["flash_attention_dq_bf16"] = want["flash_attention_dkv_bf16"] = VIT_DEPTH * steps
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"  steps {steps}, eval batches {evals}, launches {counts}; mean loss of the "
          f"first 20 steps {first:.4f}, last 20 {last:.4f}; steady-state "
          f"images/sec/chip {metrics['images_per_sec_per_chip']:.1f} "
          f"({metrics['steady_step_ms']:.3f} ms a step, host clock), max_memory_allocated "
          f"{metrics['max_memory_allocated']} B, final test accuracy "
          f"{metrics['test_accuracy']:.4f}", flush=True)
    if steps != 2 * BF16_VIT_STEPS_PER_EPOCH or counts != want:
        fail(f"ViT bf16 {attention} {extra}: {steps} steps, launches {counts}; "
             f"expected {2 * BF16_VIT_STEPS_PER_EPOCH}, {want}")
    if not all(math.isfinite(x) for x in losses) or not last < first:
        fail(f"ViT bf16 {attention} {extra}: losses are not finite and falling")
    if not math.isfinite(metrics["test_loss"]) or metrics["test_accuracy"] < 0.2:
        fail(f"ViT bf16 final eval out of range: {metrics['test_accuracy']}")
    return trainer, metrics


def rel_diffs(got, want, n=PLAIN_STEPS_RTOL):
    return [abs(g - w) / abs(w) for g, w in zip(got[:n], want[:n])]


def worst_rel(got, want):
    """The largest of ``rel_diffs``, a NaN counting as infinitely far."""
    return max(math.inf if math.isnan(r) else r for r in rel_diffs(got, want))


def phase_bf16_vit():
    """Phase 20c: ViT-S/4 in bfloat16 through the trainer, flash and full,
    and the band's controls (``BF16_FAULTS``, one epoch each); then flash
    without and with ``--remat`` under deterministic cuDNN: losses and
    final weights bitwise equal. Returns {run: metrics}."""
    import torch

    from tpu_ddp_torch.cli import train as cli

    runs = {}
    for attention in ("flash", "full"):
        _, runs[attention] = bf16_vit_run(attention)
    rel = rel_diffs(runs["full"]["step_losses"], runs["flash"]["step_losses"])
    print(f"  bf16 --attention full vs flash, relative loss difference per step: "
          f"{' '.join(f'{r:.2g}' for r in rel)} (band {BF16_LOSS_RTOL})", flush=True)
    if not max(rel) <= BF16_LOSS_RTOL:
        fail("ViT bf16 full and flash losses disagree over the first steps")
    for name in BF16_FAULTS:
        _, m = with_k4_fault(name, lambda: cli.run(vit_bf16_args("flash", "--epochs", "1")))
        bad = worst_rel(runs["full"]["step_losses"], m["step_losses"])
        print(f"  control, flash with K4 {name}: largest relative loss difference {bad:.3g} "
              f"(band {BF16_LOSS_RTOL})", flush=True)
        if not bad > BF16_LOSS_RTOL:
            fail(f"ViT bf16 loss band passes a K4 with {name}")
    torch.backends.cudnn.deterministic = True
    try:
        pair = {}
        for extra in ((), ("--remat",)):
            trainer, m = bf16_vit_run("flash", *extra)
            pair[extra] = (m, {k: v.detach().cpu() for k, v in
                               trainer.state.model.state_dict().items()})
            del trainer
    finally:
        torch.backends.cudnn.deterministic = False
    (m0, w0), (m1, w1) = pair[()], pair[("--remat",)]
    same_losses = m0["step_losses"] == m1["step_losses"]
    same_weights = all(torch.equal(w0[k], w1[k]) for k in w0)
    worst = max(abs(a - b) for a, b in zip(m0["step_losses"], m1["step_losses"]))
    print(f"  deterministic cuDNN, --remat against without: per-step losses bitwise "
          f"{same_losses} (largest difference {worst:.3g}), final weights bitwise "
          f"{same_weights}; steady {m0['steady_step_ms']:.3f} -> {m1['steady_step_ms']:.3f} "
          f"ms a step, max_memory_allocated {m0['max_memory_allocated']} -> "
          f"{m1['max_memory_allocated']} B", flush=True)
    if not (same_losses and same_weights):
        fail("ViT bf16 --remat differs from the run without")
    runs["remat"] = m1
    torch.cuda.empty_cache()
    return runs


def phase_bf16_lm(tokens, f32_run):
    """Phase 20d: LM-32k in bfloat16 with flash, 30 steps as phase 18a
    (host clock and profiler), its first losses within ``BF16_LM_RTOL`` of
    18a's float32 flash run, and the band's controls (``BF16_FAULTS``);
    then ``remat=True``: launches (K4 twice a block a step), peak memory,
    step time, and losses against the run without. Returns {run: numbers}."""
    import torch

    runs = {}
    for remat in (False, True):
        model, run = lm_train_run(True, tokens, bf16=True, remat=remat)
        del model
        torch.cuda.empty_cache()
        label = "bf16_remat" if remat else "bf16"
        runs[label] = run
        losses, counts = run["losses"], run["launches"]
        want = {name: 0 for name in counts}
        want["fused_update"] = LM_STEPS
        want["flash_attention_fwd_bf16"] = (2 if remat else 1) * LM_32K["depth"] * LM_STEPS
        want["flash_attention_dq_bf16"] = LM_32K["depth"] * LM_STEPS
        want["flash_attention_dkv_bf16"] = LM_32K["depth"] * LM_STEPS
        first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        print(f"phase 20d: LM-32k bfloat16 flash{' remat=True' if remat else ''}, "
              f"{LM_STEPS} steps: launches {counts}; mean loss of the first 10 steps "
              f"{first:.5f}, last 10 {last:.5f}; steady {run['steady_step_ms']:.3f} ms a "
              f"step, {run['tokens_per_sec']:.1f} tokens/sec, max_memory_allocated "
              f"{run['max_memory_allocated']} B", flush=True)
        print(f"  torch.profiler over {LM_PROFILE_STEPS} steps: step "
              f"{run['profiled_step_ms']:.3f} ms, device busy "
              f"{run['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{run['device_idle_share']}, {run['kernels_per_step']:.1f} kernels a step; "
              f"K4-K6 {run['flash_device_ms_per_step']:.3f} device ms a step "
              f"({run['flash_share_of_busy']} of busy); the kernels that take most "
              "device time (ms a step, calls a step):", flush=True)
        for ms, calls, key in run["top"]:
            print(f"    {ms:9.3f} ms {calls:6.1f}x  {key[:100]}", flush=True)
        if counts != want:
            fail(f"LM bf16 remat={remat}: launches {counts}, expected {want}")
        if not all(math.isfinite(x) for x in losses) or not last < first:
            fail(f"LM bf16 remat={remat}: losses are not finite and falling")
    rel = rel_diffs(runs["bf16"]["losses"], f32_run["losses"])
    print(f"  bf16 against phase 18a's float32 flash run, relative loss difference per "
          f"step: {' '.join(f'{r:.2g}' for r in rel)} (band {BF16_LM_RTOL})", flush=True)
    if not max(rel) <= BF16_LM_RTOL:
        fail("LM-32k bf16 losses leave the band around the float32 run's")
    for name in BF16_FAULTS:
        model, run = with_k4_fault(name, lambda: lm_train_run(True, tokens, bf16=True))
        del model
        torch.cuda.empty_cache()
        bad = worst_rel(run["losses"], f32_run["losses"])
        print(f"  control, bf16 with K4 {name}: largest relative loss difference {bad:.3g} "
              f"(band {BF16_LM_RTOL})", flush=True)
        if not bad > BF16_LM_RTOL:
            fail(f"LM-32k bf16 loss band passes a K4 with {name}")
    a, b = runs["bf16"]["losses"], runs["bf16_remat"]["losses"]
    worst = max(abs(x - y) for x, y in zip(a, b))
    print(f"  remat=True against without: losses bitwise {a == b} (largest difference "
          f"{worst:.3g}); steady {runs['bf16']['steady_step_ms']:.3f} -> "
          f"{runs['bf16_remat']['steady_step_ms']:.3f} ms a step; max_memory_allocated "
          f"{runs['bf16']['max_memory_allocated']} -> "
          f"{runs['bf16_remat']['max_memory_allocated']} B", flush=True)
    if a != b:
        fail("LM-32k bf16 remat=True losses differ from the run without")
    return runs


def phase_bf16_netresdeep():
    """Phase 20e: NetResDeep ``--compute-dtype bfloat16 --kernels`` through
    the CLI under deterministic cuDNN, ``BF16_NRD_STEPS`` steps: finite
    losses, K1 once a step (float32 params); then ``--remat``: losses,
    params and the BatchNorm running buffers bitwise the run without."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    base = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * BF16_NRD_STEPS), "--epochs", "1", "--batch-size", "32",
            "--kernels", "--compute-dtype", "bfloat16", "--log-every-epochs", "1"]
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for extra in ((), ("--remat",)):
            args = base + list(extra)
            print(f"phase 20e: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
            ops.reset_launch_counts()
            trainer, m = cli.run(args)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = {name: 0 for name in counts}
            want["fused_update"] = BF16_NRD_STEPS
            losses = m["step_losses"]
            print(f"  launches {counts}; losses {losses[0]:.5f} -> {losses[-1]:.5f}; "
                  f"steady {m['steady_step_ms']:.3f} ms a step", flush=True)
            if counts != want or len(losses) != BF16_NRD_STEPS \
                    or not all(math.isfinite(x) for x in losses):
                fail(f"NetResDeep bf16 {extra}: launches {counts} (expected {want}) "
                     "or losses not finite")
            out[extra] = (losses, {k: v.detach().cpu() for k, v in
                                   trainer.state.model.state_dict().items()})
            del trainer
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, w0), (l1, w1) = out[()], out[("--remat",)]
    buffers = [k for k in w0 if "running_" in k]
    same_buffers = all(torch.equal(w0[k], w1[k]) for k in buffers)
    same_all = l0 == l1 and all(torch.equal(w0[k], w1[k]) for k in w0)
    print(f"  --remat against without: BatchNorm running buffers ({len(buffers)}) bitwise "
          f"{same_buffers}; losses and params bitwise {same_all}", flush=True)
    if not (same_buffers and same_all):
        fail("NetResDeep bf16 --remat differs from the run without")


def phase_bf16_timing(errors, counts):
    """Phase 20b: K4-K6's bfloat16 kernels at ``BF16_TIMED``'s shapes, with
    phase 20a's errors and the launches of the path each shape belongs to
    (``counts``: 20c's ViT flash run, 20d's LM run)."""
    print("phase 20b: bfloat16 K4-K6 timing (CUDA events and device time; ms per call)",
          flush=True)
    rows = []
    for case, (iters, path) in BF16_TIMED.items():
        rows += flash_timing_rows(case, iters, errors, counts[path], bf16=True)
    return rows


#: phase 20f: case -> timed iterations, for K4-K6 against the parent's
BF16_PARENT_TIMED = {"lm_causal": 20, "vit_s4": 200}
PARENT_DIR = os.path.join(ROOT, "build", "parent_csrc")
#: the parent's sources phase 20f builds: the two libraries and their headers
PARENT_FILES = ("flash_forward.cu", "flash_attention.cu", "bf16_tiles.cuh", "flash_wg.cuh",
                "hopper.cuh")


def tma_encode_us(t, rows, n=2000):
    """Host microseconds of one ``cuTensorMapEncodeTiled`` (the driver's,
    through ctypes) of the bf16 (B, T, H, D) tensor ``t`` as K4-K6
    encode each operand on each call (``csrc/hopper.cuh``): 4-D, boxes of
    64 columns by ``rows`` tokens, 128-byte swizzle. None if the driver
    refuses it."""
    import ctypes

    B, T, H, D = t.shape
    cuda = ctypes.CDLL("libcuda.so.1")
    buf = (ctypes.c_uint8 * 192)()          # a tensor map: 128 bytes, 64-aligned
    addr = ctypes.addressof(buf)
    tmap = ctypes.c_void_p(addr + (-addr) % 64)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    dims = (u64 * 4)(D, H, T, B)
    strides = (u64 * 3)(*(2 * s for s in reversed(t.stride()[:3])))
    box, unit = (u32 * 4)(64, 1, rows, 1), (u32 * 4)(1, 1, 1, 1)
    # bfloat16 (9), no interleave (0), 128-byte swizzle (3), 128-byte L2
    # promotion (2), zero fill (0): the arguments hopper.cuh passes
    args = (tmap, 9, 4, ctypes.c_void_p(t.data_ptr()), dims, strides, box, unit, 0, 3, 2, 0)
    if cuda.cuTensorMapEncodeTiled(*args) != 0:
        return None
    t0 = time.perf_counter()
    for _ in range(n):
        cuda.cuTensorMapEncodeTiled(*args)
    return (time.perf_counter() - t0) / n * 1e6


def phase_bf16_against_parent():
    """Phase 20f: K4's, K5's and K6's bfloat16 kernels against the parent
    commit's (``build/parent_csrc/``), in turns: {case: {kernel:
    {"this"|"parent": {"ms": [...], "device_ms": [...]}}}}, or None without
    the copy. K4's and K5's outputs must equal the parent's to the bit;
    K6's are reported in bf16 units of each row from the parent's."""
    import torch

    from tpu_ddp_torch.ops import _build
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.tools import k4_variants, k56_variants, variants
    from tpu_ddp_torch.tools.variants import bf16_row_units

    if not all(os.path.isfile(os.path.join(PARENT_DIR, f)) for f in PARENT_FILES):
        print(f"phase 20f: no copy of the parent's sources under {PARENT_DIR} (git show "
              "<parent>:tpu_ddp_torch/ops/csrc/<file> for "
              f"{', '.join(PARENT_FILES)}); skipped", flush=True)
        return None
    print("phase 20f: K4/K5/K6 bfloat16 against the parent's (in turns parent, this, this, "
          "parent; ms a call by CUDA events and device time)", flush=True)
    libs = {
        "flash_forward": {
            "this": _build.load("flash_forward"),
            **variants.build("flash_forward", {}, {
                "parent": (os.path.join(PARENT_DIR, "flash_forward.cu"), ())})},
        "flash_attention": {
            "this": _build.load("flash_attention"),
            **variants.build("flash_attention", {}, {
                "parent": (os.path.join(PARENT_DIR, "flash_attention.cu"), ())})},
    }
    results, failed = {}, []
    for case, iters in BF16_PARENT_TIMED.items():
        q, k, v, do, _, causal = flash_inputs(case, seed=2, bf16=True)
        out, lse = fa.forward_plain(q, k, v, causal=causal)
        di = fa.row_dot(do, out)
        calls = {
            "K4": {n: (lambda lib=lib: k4_variants.forward(lib, q, k, v, causal))
                   for n, lib in libs["flash_forward"].items()},
            "K5": {n: (lambda lib=lib: k56_variants.dq(lib, q, k, v, do, lse, di, causal))
                   for n, lib in libs["flash_attention"].items()},
            "K6": {n: (lambda lib=lib: k56_variants.dkv(lib, q, k, v, do, lse, di, causal))
                   for n, lib in libs["flash_attention"].items()},
        }
        results[case] = {}
        for kernel, fns in calls.items():
            got = {n: fn() for n, fn in fns.items()}
            pairs = list(zip(*(x if isinstance(x, tuple) else (x,) for x in
                               (got["this"], got["parent"]))))
            # each is held to the plain version elsewhere (phase 20a, the
            # parent in its own run): here how far apart the two are
            same = all(bool(torch.equal(a, b)) for a, b in pairs)
            units = max(float(bf16_row_units(a, b).max()) for a, b in pairs)
            if kernel != "K6" and not same:
                failed.append(f"{kernel}[{case}] differs from the parent's ({units:.3g} units)")
            row = {n: {"ms": [], "device_ms": []} for n in fns}
            for n in ("parent", "this", "this", "parent"):
                row[n]["ms"].append(time_ms(fns[n], iters))
                row[n]["device_ms"].append(device_ms(fns[n], iters))
            results[case][kernel] = row
            mean = {n: sum(r["ms"]) / 2 for n, r in row.items()}
            if kernel == "K4":
                print(f"  one tensor map's encode on the host (K4 makes 3 a call, K5 4, K6 6): "
                      f"{tma_encode_us(q, 128)} us", flush=True)
            print(f"  {kernel}[bf16,{case}] {tuple(q.shape)} causal={causal}: this "
                  f"{row['this']['ms']} ms (device {row['this']['device_ms']}); parent "
                  f"{row['parent']['ms']} ms (device {row['parent']['device_ms']}); "
                  f"parent / this {mean['parent'] / mean['this']:.3f} by events; equal to "
                  f"the bit {same}, within {units:.3g} bf16 units of each row", flush=True)
        del q, k, v, do, out, lse, di
    torch.cuda.empty_cache()
    if failed:
        fail("phase 20f: " + "; ".join(failed))
    return results


# ---- phase 21: the numerics flight recorder (K1 under the guard, K2's error for health) ----

#: 21a: one epoch of NetResDeep steps at full width, the fifth batch all NaN
HEALTH_STEPS, HEALTH_POISON = 40, 4
#: 21b: steps a rank on two ranks, rank 0's fifth batch all NaN
HEALTH_RANK_STEPS = 20
#: 21c: NetResDeep's cost runs, steps an epoch (epoch 2 is timed), and the
#: turns of health off and on (its host-bound step time moves run to run)
HEALTH_NRD_STEPS = 50
HEALTH_NRD_TURNS = (False, True, True, False)


def poison_batch(n, rank=None):
    """Fill the train loop's ``n``-th batch with NaN (``patch_train_batches``:
    on the native ring, the slot itself before its copy to the card), on
    ``rank`` only (the ``RANK`` of the launcher) or on every process;
    returns the undo."""
    import numpy as np

    if rank is not None and int(os.environ.get("RANK", "0")) != rank:
        return lambda: None

    def change(images):
        if isinstance(images, np.ndarray):
            return np.full_like(images, np.nan)
        return images.fill_(float("nan"))

    return patch_train_batches(n, change)


def state_bits(state):
    """Clones of what a step moves: the model (params and BatchNorm
    buffers), ZeRO-3's param shards, every optimizer slot and count, the
    error-feedback residual."""
    from tpu_ddp_torch.train.state import COUNTS, SLOTS

    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for n, t in (state.param_shards or {}).items():
        out[f"shard/{n}"] = t.clone()
    for n, t in (state.grad_residual or {}).items():
        out[f"residual/{n}"] = t.clone()
    for slot in SLOTS:
        for n, t in (getattr(state.opt_state, slot) or {}).items():
            out[f"opt/{slot}/{n}"] = t.clone()
    for c in COUNTS:
        if getattr(state.opt_state, c) is not None:
            out[f"opt/{c}"] = getattr(state.opt_state, c).clone()
    return out


def same_state(a, b):
    """Two ``state_bits`` equal to the bit (``same_bits`` for the float
    tensors: NaN payloads and signed zeros too)."""
    import torch

    return set(a) == set(b) and all(
        same_bits(a[k], b[k]) if a[k].is_floating_point() else torch.equal(a[k], b[k])
        for k in a)


def health_records(run_dir, rank=0):
    """The step records of ``health-p<rank>.jsonl`` under ``run_dir``,
    without the rank."""
    with open(os.path.join(run_dir, f"health-p{rank}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k != "pid"} for r in recs if r["type"] == "health"]


def same_records(a, b):
    """Two runs' health records equal to the bit: their JSON texts (a float
    prints as the shortest text that reads back to it; NaN equals NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def health_args(health_dir, kernels=True):
    """Phase 21a's CLI arguments: NetResDeep at full width, one unshuffled
    epoch of ``HEALTH_STEPS`` steps, SGD with momentum, the recorder on
    with ``skip_step`` and per-layer norms every step."""
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * HEALTH_STEPS),
            "--epochs", "1", "--no-shuffle", "--n-chans1", "32", "--n-blocks", "10",
            "--batch-size", "32", "--lr", "1e-2", "--momentum", "0.9", "--log-every-epochs",
            "1", "--health", "on", "--health-policy", "skip_step",
            "--health-per-layer-stride", "1", "--health-dir", health_dir,
            *(["--kernels"] if kernels else [])]


def health_run(args):
    """A trainer built from the train CLI's ``args``, trained by its ``run``
    with the fifth batch all NaN and the launch counts zeroed just before;
    the state's bits just before and after the poisoned step. Returns
    (trainer, metrics, launch counts, bits before, bits after)."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
    inner, calls, bits = trainer.train_step, [0], {}

    def watched(state, batch):
        if calls[0] == HEALTH_POISON:
            bits["before"] = state_bits(state)
        out = inner(state, batch)
        if calls[0] == HEALTH_POISON:
            bits["after"] = state_bits(state)
        calls[0] += 1
        return out

    trainer.train_step = watched
    undo = poison_batch(HEALTH_POISON)
    ops.reset_launch_counts()
    try:
        metrics = trainer.run()
    finally:
        undo()
        trainer.close()
    torch.cuda.synchronize()
    return trainer, metrics, ops.launch_counts(), bits["before"], bits["after"]


def phase_health_skip(tmp):
    """Phase 21a: the flight recorder's ``skip_step`` on the main path at
    full width, under deterministic cuDNN: exactly one non-finite step, the
    params, momentum and BatchNorm buffers after it bitwise as before it,
    K1 once every step (the skipped one too), the dump written and rendered,
    the final params finite; then the same steps without ``--kernels``:
    health records equal to the bit."""
    import torch

    from tpu_ddp_torch.health.summarize import summarize_health

    records = {}
    torch.backends.cudnn.deterministic = True
    try:
        for kernels in (True, False):
            run_dir = os.path.join(tmp, f"health_{'k1' if kernels else 'plain'}")
            args = health_args(run_dir, kernels)
            print(f"phase 21a: tpu_ddp_torch.cli.train {' '.join(args)} (deterministic "
                  f"cuDNN, batch {HEALTH_POISON} all NaN)", flush=True)
            trainer, m, counts, before, after = health_run(args)
            mon = trainer.health_monitor
            recs = records[kernels] = health_records(run_dir)
            bad = [r["step"] for r in recs if not r["all_finite"]]
            finite = all(bool(torch.isfinite(p).all()) for p in trainer.state.params().values())
            skipped = same_state(before, after)
            want = {name: 0 for name in counts}
            want["fused_update"] = HEALTH_STEPS if kernels else 0
            dump = os.path.join(run_dir, "anomalies", f"step_{HEALTH_POISON:08d}")
            dumped = sorted(os.listdir(dump)) if os.path.isdir(dump) else []
            summary = summarize_health(run_dir)
            print(f"  steps {m['steps']}, non-finite steps {bad} (monitor "
                  f"{mon.nonfinite_steps}); state after the poisoned step bitwise as "
                  f"before it ({len(before)} tensors: params, momentum, BatchNorm buffers) "
                  f"{skipped}; launches {counts}; final params finite {finite}; dump "
                  f"{dumped}; steady {m['steady_step_ms']:.3f} ms a step", flush=True)
            if m["steps"] != HEALTH_STEPS or bad != [HEALTH_POISON] or mon.nonfinite_steps != 1:
                fail(f"21a: non-finite steps {bad} in {m['steps']}, expected "
                     f"[{HEALTH_POISON}] in {HEALTH_STEPS}")
            if not skipped:
                fail("21a: the skipped step moved the params, momentum or BatchNorm buffers")
            if counts != want:
                fail(f"21a: launches {counts}, expected {want}")
            if not finite:
                fail("21a: the final params are not finite")
            if dumped != ["batch.npz", "health.json", "meta.json"] \
                    or "non-finite: 1" not in summary:
                fail(f"21a: dump {dumped}, or the summary does not show the step")
            if kernels:
                print("  " + summary.replace("\n", "\n  "), flush=True)
            del trainer
    finally:
        torch.backends.cudnn.deterministic = False
    same = same_records(records[True], records[False])
    print(f"  K1 against the plain update: {len(records[True])} health records (per-layer "
          f"norms included) equal to the bit {same}", flush=True)
    for a, b in zip(records[True], records[False]):
        keys = [k for k in a if not same_records(a[k], b.get(k))]
        if keys:
            print(f"  first difference, step {a['step']}: "
                  + "; ".join(f"{k} {a[k]} against {b.get(k)}" for k in keys)[:2000], flush=True)
            break
    if not same:
        fail("21a: the health records of the K1 and plain runs differ")


def health_ranks_spec(tmp, nproc=2, backend="gloo"):
    """Phase 21b's run ``(name, args, options)`` for ``launch_dp_runs``
    (rank 0's ``HEALTH_POISON``-th batch all NaN), and its health dir."""
    run_dir = os.path.join(tmp, "health_ranks")
    args = ["--device", "cuda", "--dist-backend", backend, "--synthetic-data",
            "--synthetic-size", str(nproc * 32 * HEALTH_RANK_STEPS), "--epochs", "1",
            "--no-shuffle", "--kernels", "--zero1", "--grad-compress", "int8",
            "--n-chans1", "32", "--n-blocks", "10", "--batch-size", "32", "--lr", "1e-2",
            "--momentum", "0.9", "--log-every-epochs", "1", "--health", "on",
            "--health-policy", "skip_step", "--health-per-layer-stride", "5",
            "--health-dir", run_dir]
    return ("health_ranks_out", args, ["--poison-batch", str(HEALTH_POISON)]), run_dir


def phase_health_ranks(tmp, nproc=2, backend="gloo", runs=None):
    """Phase 21b: two ranks through the launcher, ``--kernels --zero1
    --grad-compress int8`` without error feedback (K2's error pass runs for
    health alone), ``skip_step``, rank 0's fifth batch all NaN: both ranks'
    health files equal, the same step skipped on both, replicas bitwise,
    ``compress_error_norm`` finite and above 0 on the healthy steps,
    launches and the ring's wire calls exact. ``runs``: as
    ``phase_finetune_ranks``'."""
    run, run_dir = health_ranks_spec(tmp, nproc, backend)
    if runs is None:
        runs = launch_dp_runs(tmp, [run], nproc, phase="21b")
    metrics, same = runs[run[0]]
    recs = [health_records(run_dir, r) for r in range(nproc)]
    bad = [[r["step"] for r in rec if not r["all_finite"]] for rec in recs]
    errs = [r["compress_error_norm"] for r in recs[0] if r["all_finite"]]
    steps = metrics[0]["steps"]
    want = {name: 0 for name in metrics[0]["launches"]}
    want.update({k: v * steps for k, v in zero1_launches(nproc, True).items()})
    wire = {k: v * steps for k, v in ring_wire_calls(nproc, True, True).items()}
    print(f"  steps {steps}; non-finite steps by rank {bad}; health files equal on the "
          f"{nproc} ranks {all(same_records(rec, recs[0]) for rec in recs)}; replicas "
          f"bitwise {same}; "
          f"compress_error_norm on the healthy steps {min(errs):.6g}..{max(errs):.6g}; "
          f"launches on rank 0 {metrics[0]['launches']}; wire calls "
          f"{metrics[0]['wire_calls']}", flush=True)
    if steps != HEALTH_RANK_STEPS or bad != [[HEALTH_POISON]] * nproc:
        fail(f"21b: non-finite steps {bad} in {steps}, expected [{HEALTH_POISON}] a rank")
    if not all(same_records(rec, recs[0]) for rec in recs):
        fail("21b: the ranks' health records differ")
    if not same:
        fail("21b: the replicas end with different params")
    if not all(math.isfinite(e) and e > 0 for e in errs):
        fail("21b: compress_error_norm is not finite and above 0 on a healthy step")
    for r in range(nproc):
        if metrics[r]["launches"] != want or metrics[r]["wire_calls"] != wire:
            fail(f"21b: rank {r} launched {metrics[r]['launches']} (expected {want}) or "
                 f"made {metrics[r]['wire_calls']} wire calls (expected {wire})")


def nrd_cost_run(health):
    """Phase 21c, NetResDeep: the main path's recipe through the trainer, 2
    epochs of ``HEALTH_NRD_STEPS`` steps (epoch 2 timed), health off or on
    (``warn``, nothing written); then 5 more steps of the step and its host
    read under ``torch.profiler``. Returns the run's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.tools.profile_step import _device_us
    from tpu_ddp_torch.train.trainer import Trainer

    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * HEALTH_NRD_STEPS), "--epochs", "2", "--kernels", "--n-chans1", "32",
            "--n-blocks", "10", "--batch-size", "32", "--lr", "1e-2", "--log-every-epochs", "1",
            *(["--health", "on"] if health else [])]
    trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
    torch.cuda.reset_peak_memory_stats()
    m = trainer.run()
    batches = [trainer.to_device(b) for b in trainer.train_loader.epoch_batches(epoch=3)][:5]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, b in enumerate(batches):
            trainer.state, metrics = trainer.train_step(trainer.state, b)
            if health:
                trainer.health_feed.push(i, metrics.pop("health"), b)
        if health:
            trainer.health_feed.flush()
        torch.cuda.synchronize()
    busy_us, kernels, _ = _device_us(prof)
    trainer.close()
    return {"steady_step_ms": m["steady_step_ms"], "losses": m["step_losses"],
            "kernels_per_step": kernels / len(batches),
            "device_busy_ms_per_step": busy_us / len(batches) * 1e-3,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_health_cost(tokens, smi):
    """Phase 21c: what the recorder costs. LM-32k in bfloat16 (phase 20d's
    run: K4-K6 and K1) with health off, ``warn`` and ``skip_step``, one run
    each, over the same steps: ms a step, tokens/s, launches and kernels a
    step, peak memory; losses equal to the bit. Then NetResDeep's step with
    health off and on, in turns (two runs each)."""
    import torch

    runs = {}
    for label in ("off", "warn", "skip_step"):
        model, run = lm_train_run(True, tokens, bf16=True,
                                  health=None if label == "off" else label)
        del model
        torch.cuda.empty_cache()
        runs.setdefault(label, []).append(run)
        print(f"phase 21c: LM-32k bf16 flash, health {label} ({smi}): steady "
              f"{run['steady_step_ms']:.3f} ms a step, {run['tokens_per_sec']:.1f} tokens/sec, "
              f"{run['kernels_per_step']:.1f} kernels a step (profiled step "
              f"{run['profiled_step_ms']:.3f} ms, device busy "
              f"{run['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{run['device_idle_share']}), max_memory_allocated "
              f"{run['max_memory_allocated']} B, launches {run['launches']}", flush=True)
    losses = [r["losses"] for rs in runs.values() for r in rs]
    if any(x != losses[0] for x in losses):
        fail("21c: the LM's losses with health on differ from health off")
    want = {name: 0 for name in runs["off"][0]["launches"]}
    want["fused_update"] = LM_STEPS
    for name in ("fwd", "dq", "dkv"):
        want[f"flash_attention_{name}_bf16"] = LM_32K["depth"] * LM_STEPS
    if any(r["launches"] != want for rs in runs.values() for r in rs):
        fail(f"21c: the LM's launches differ from {want}")
    mean = lambda label, key: sum(r[key] for r in runs[label]) / len(runs[label])  # noqa: E731
    for label in ("warn", "skip_step"):
        more = lambda key: mean(label, key) - mean("off", key)  # noqa: E731
        ms, off_ms = mean(label, "steady_step_ms"), mean("off", "steady_step_ms")
        print(f"  LM-32k bf16, health {label} against off (one run each): "
              f"{ms:.3f} against {off_ms:.3f} ms a step ({ms / off_ms - 1:+.4f}); "
              f"{more('kernels_per_step'):+.1f} kernels a step; device busy "
              f"{more('device_busy_ms_per_step'):+.3f} ms a step; peak "
              f"{more('max_memory_allocated'):+.0f} B; losses equal to the bit", flush=True)
    nrd = {}
    for health in HEALTH_NRD_TURNS:
        run = nrd_cost_run(health)
        nrd.setdefault(health, []).append(run)
        print(f"phase 21c: NetResDeep --kernels, health {'on' if health else 'off'}: steady "
              f"{run['steady_step_ms']:.3f} ms a step, {run['kernels_per_step']:.1f} kernels a "
              f"step, device busy {run['device_busy_ms_per_step']:.3f} ms a step, "
              f"max_memory_allocated {run['max_memory_allocated']} B", flush=True)
    if any(not all(math.isfinite(x) for x in r["losses"]) for rs in nrd.values() for r in rs):
        fail("21c: NetResDeep produced a non-finite loss")
    on = sorted(r["steady_step_ms"] for r in nrd[True])
    off = sorted(r["steady_step_ms"] for r in nrd[False])
    print(f"  NetResDeep, health on against off, ms a step sorted: {on} against {off}",
          flush=True)
    return {"lm": runs, "netresdeep": nrd}


#: phase 22: (a) steps an epoch, the fused calls' K and the turns; (b) ViT
#: steps and the accumulation's K; (c) steps an epoch and the SIGTERM's batch;
#: (e) steps a rank
P22_STEPS = 48
P22_K = 8
P22_TURNS = (P22_K, 1, 1, P22_K)
P22_PROFILE_STEPS = 16
P22_VIT_STEPS = 20
P22_ACCUM = 4
P22_AUG_STEPS = 30
P22_AUG_SIGTERM_AT = 35
P22_RANK_STEPS = 20


def variant_profile(trainer, n=P22_PROFILE_STEPS):
    """``n`` more steps of ``trainer`` under ``torch.profiler``, as fused
    calls when it has them (``multi_step``) or single steps, one call
    before, unprofiled: (host ms a step, device busy ms a step, idle share,
    kernels a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.data.loader import step_groups
    from tpu_ddp_torch.tools.profile_step import _device_us

    k = trainer.steps_per_call if trainer.multi_step is not None else 1
    step = trainer.multi_step or trainer.train_step
    host = list(trainer.train_loader.epoch_batches(epoch=1000))[:n + k]
    calls = [trainer.to_device(b) for _, b in step_groups(host, k)]
    trainer.state, _ = step(trainer.state, calls[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in calls[1:]:
            trainer.state, _ = step(trainer.state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    busy_us, kernels, _ = _device_us(prof)
    busy_ms = busy_us / n * 1e-3
    return wall_ms, busy_ms, 1.0 - busy_ms / wall_ms, kernels / n


def nrd_args(steps, epochs, *extra):
    """NetResDeep at full width through the train CLI: ``--kernels``, batch
    32, SGD lr 1e-2, ``epochs`` epochs of ``steps`` steps."""
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * steps),
            "--epochs", str(epochs), "--kernels", "--n-chans1", "32", "--n-blocks", "10",
            "--batch-size", "32", "--lr", "1e-2", "--log-every-epochs", "1", *extra]


def phase_scan(smi):
    """Phase 22a: ``--steps-per-call 8`` against 1 (module docstring)."""
    import torch

    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for k in P22_TURNS:
            args = nrd_args(P22_STEPS, 2, "--steps-per-call", str(k))
            print(f"phase 22a, deterministic cuDNN: tpu_ddp_torch.cli.train {' '.join(args)}",
                  flush=True)
            trainer, m = counted_run(args)
            print(f"  launches {m['launches']}; steady {m['steady_step_ms']:.4f} ms a step "
                  f"(epoch 2)", flush=True)
            if k in runs:            # the second turn of each K is profiled
                m["profile"] = variant_profile(trainer)
                wall, busy, idle, kernels = m["profile"]
                print(f"  profiled {P22_PROFILE_STEPS} more steps: {wall:.4f} ms a step, busy "
                      f"{busy:.4f} ms, idle {idle:.4f}, {kernels:.1f} kernels a step",
                      flush=True)
            del trainer
            want = {name: 0 for name in m["launches"]}
            want["fused_update"] = 2 * P22_STEPS
            if m["launches"] != want or m["steps"] != 2 * P22_STEPS:
                fail(f"22a: {m['steps']} steps and launches {m['launches']}, expected "
                     f"{2 * P22_STEPS} and {want}")
            runs.setdefault(k, []).append(m)
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(r["step_losses"] == runs[1][0]["step_losses"] for rs in runs.values() for r in rs)
    print(f"  --steps-per-call {P22_K} against 1: {2 * P22_STEPS} step losses equal to the "
          f"bit {same}; steady ms a step {[r['steady_step_ms'] for r in runs[P22_K]]} against "
          f"{[r['steady_step_ms'] for r in runs[1]]}; kernels a step "
          f"{runs[P22_K][1]['profile'][3]} against {runs[1][1]['profile'][3]} ({smi})",
          flush=True)
    if not same:
        fail("22a: the fused calls' losses differ from the single steps'")
    return runs


def vit_accum_args(accum):
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(128 * P22_VIT_STEPS), "--epochs", "1", "--model", "vit_s4", "--attention",
            "flash", "--kernels", "--optimizer", "adamw", "--lr", "1e-3", "--batch-size",
            "128", "--grad-accum-steps", str(accum), "--log-every-epochs", "1"]


def phase_grad_accum(smi):
    """Phase 22b: ViT-S/4 flash with ``--grad-accum-steps 4`` against 1
    (module docstring)."""
    runs = {}
    for accum in (P22_ACCUM, 1):
        args = vit_accum_args(accum)
        print(f"phase 22b: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
        trainer, m = counted_run(args)
        steps, evals = m["steps"], trainer.eval_batches
        del trainer
        per = VIT_DEPTH * accum * steps
        want = {name: 0 for name in m["launches"]}
        want.update(fused_update=steps, flash_attention_fwd=per + VIT_DEPTH * evals,
                    flash_attention_dq=per, flash_attention_dkv=per)
        print(f"  steps {steps}, eval batches {evals}; launches {m['launches']}; steady "
              f"{m['steady_step_ms']:.4f} ms a step; max_memory_allocated "
              f"{m['max_memory_allocated']} B ({smi})", flush=True)
        if m["launches"] != want or steps != P22_VIT_STEPS:
            fail(f"22b: {steps} steps and launches {m['launches']}, expected "
                 f"{P22_VIT_STEPS} and {want}")
        if not all(math.isfinite(x) for x in m["step_losses"]):
            fail("22b: a loss is not finite")
        runs[accum] = m
    rel = rel_diffs(runs[P22_ACCUM]["step_losses"], runs[1]["step_losses"])
    print(f"  accumulated against the full batch, first {PLAIN_STEPS_RTOL} losses: relative "
          f"differences {' '.join(f'{r:.3g}' for r in rel)} (limit 1e-4)", flush=True)
    if not max(rel) <= 1e-4:
        fail("22b: the accumulated step's first losses differ from the full batch's")
    return runs


def card_draws():
    """22c's draw check: 20,000 crop offsets and flips at one step on the
    card cover 0..8 and flip about half, and equal the CPU's to the bit."""
    import torch

    from tpu_ddp_torch.data import augment

    n = 20_000
    offsets, flip = augment.crop_flip_draws(0, torch.tensor(7, device="cuda"), 0, n)
    perm, lam = augment.mixup_draws(0, torch.tensor(7, device="cuda"), 0, 32, alpha=0.2)
    cpu = augment.crop_flip_draws(0, torch.tensor(7), 0, n)
    cpu_mix = augment.mixup_draws(0, torch.tensor(7), 0, 32, alpha=0.2)
    counts = torch.bincount(offsets.reshape(-1), minlength=9).tolist()
    rate = float(flip.float().mean())
    same = (torch.equal(offsets.cpu(), cpu[0]) and torch.equal(flip.cpu(), cpu[1])
            and torch.equal(perm.cpu(), cpu_mix[0]))
    lam_diff = abs(float(lam) - float(cpu_mix[1]))
    print(f"  draws on the card: offsets by value {counts}, flip rate {rate:.4f}, the CPU's "
          f"offsets, flips and partners to the bit {same}, lambda {float(lam):.6f} "
          f"(CPU {float(cpu_mix[1]):.6f})", flush=True)
    if len(counts) != 9 or min(counts) == 0 or abs(rate - 0.5) > 4 * (0.25 / n) ** 0.5:
        fail("22c: the card's crop offsets do not cover 0..8 or its flips are not about half")
    if not same or lam_diff > 1e-6:
        fail("22c: the card's draws differ from the CPU's")


def phase_augment_resume(tmp):
    """Phase 22c: ``--augment --mixup-alpha 0.2`` cut by SIGTERM and resumed,
    bitwise the uninterrupted run (module docstring)."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    args = nrd_args(P22_AUG_STEPS, 2, "--augment", "--mixup-alpha", "0.2")
    ck = os.path.join(tmp, "augment_ckpt")
    print(f"phase 22c, deterministic cuDNN, SIGTERM at batch {P22_AUG_SIGTERM_AT}: "
          f"tpu_ddp_torch.cli.train {' '.join(args)} --checkpoint-dir DIR", flush=True)
    torch.backends.cudnn.deterministic = True
    try:
        full, full_m = cli.run(args)
        undo = sigterm_at(P22_AUG_SIGTERM_AT)
        try:
            _, cut_m = cli.run(args + ["--checkpoint-dir", ck])
        finally:
            undo()
        resumed, res_m = counted_run(args + ["--checkpoint-dir", ck, "--resume"])
    finally:
        torch.backends.cudnn.deterministic = False
    counts = res_m["launches"]
    want = {name: 0 for name in counts}
    want["fused_update"] = 2 * P22_AUG_STEPS - P22_AUG_SIGTERM_AT
    losses = full_m["step_losses"]
    bitwise = (cut_m["step_losses"] + res_m["step_losses"] == losses
               and same_weights(resumed.state.model.state_dict(),
                                full.state.model.state_dict()))
    print(f"  drained {cut_m.get('preempted', False)} at step {cut_m['steps']}; resumed "
          f"{len(res_m['step_losses'])} steps, launches {counts}; losses and final params "
          f"bitwise the uninterrupted run's {bitwise}; losses finite "
          f"{all(math.isfinite(x) for x in losses)}", flush=True)
    if not cut_m.get("preempted") or cut_m["steps"] != P22_AUG_SIGTERM_AT:
        fail("22c: the SIGTERMed run did not drain at the step it was signalled")
    if not bitwise or counts != want or not all(math.isfinite(x) for x in losses):
        fail(f"22c: the resumed run is not bitwise the uninterrupted one, its losses are "
             f"not finite, or it launched {counts} (expected {want})")
    card_draws()


def phase_dump_predictions(tmp):
    """Phase 22d: ``--dump-predictions`` after a short NetResDeep run
    (module docstring)."""
    import numpy as np
    import torch

    path = os.path.join(tmp, "predictions.json")
    args = nrd_args(20, 1, "--dump-predictions", path)
    print(f"phase 22d, deterministic cuDNN: tpu_ddp_torch.cli.train {' '.join(args)}",
          flush=True)
    torch.backends.cudnn.deterministic = True
    try:
        trainer, m = counted_run(args)
        images = torch.as_tensor(trainer.test_loader.images).to("cuda")
        with torch.no_grad():
            trainer.state.model.eval()
            # the predict step's batches: the test set is a whole number of them
            want = torch.cat([trainer.state.model(x) for x in images.split(32)])
    finally:
        torch.backends.cudnn.deterministic = False
    with open(path) as f:
        dump = json.load(f)
    preds, labels = np.asarray(dump["predictions"]), np.asarray(dump["labels"])
    argmax = want.argmax(-1).cpu().numpy()
    acc = float(np.mean(preds == labels))
    print(f"  {len(preds)} rows for {len(trainer.test_loader.images)} test images; "
          f"predictions equal the eval forward's argmax {np.array_equal(preds, argmax)}; "
          f"labels the test set's {np.array_equal(labels, trainer.test_loader.labels)}; "
          f"accuracy {acc} against the trainer's {m['test_accuracy']}", flush=True)
    if len(preds) != len(trainer.test_loader.images) or not np.array_equal(preds, argmax) \
            or not np.array_equal(labels, trainer.test_loader.labels) \
            or acc != m["test_accuracy"]:
        fail("22d: the dump does not hold the test set's predictions and accuracy")


def scan_ranks_spec(nproc=2, backend="gloo"):
    """Phase 22e's run ``(name, args)`` for ``launch_dp_runs``."""
    args = short_args(dp_args(True, nproc, backend), nproc, P22_RANK_STEPS)
    return "scan_ranks", args + ["--steps-per-call", "4"]


def phase_scan_ranks(tmp, nproc=2, backend="gloo", runs=None):
    """Phase 22e: two ranks through the launcher, ``--steps-per-call 4``
    over the int8 ring with error feedback (module docstring). ``runs``: as
    ``phase_finetune_ranks``'."""
    run = scan_ranks_spec(nproc, backend)
    if runs is None:
        runs = launch_dp_runs(tmp, [run], nproc, phase="22e")
    metrics, same = runs[run[0]]
    check_run("22e", metrics, same, P22_RANK_STEPS, dp_launches(nproc))
    wire = {k: v * P22_RANK_STEPS for k, v in ring_wire_calls(nproc, True, False).items()}
    for r, m in enumerate(metrics):
        if m["wire_calls"] != wire:
            fail(f"22e: rank {r} made {m['wire_calls']} wire calls, expected {wire}")
    return metrics


# ---- phase 23: the trainer, CLI and optimizer remainder; the host data path

#: 23a: steps an epoch (two epochs, and a profiled third on the paths of
#: P23_PROFILED), and its four paths
P23_STEPS = 16
P23_K = 8
P23_PATHS = (("--prefetch-depth 0", ["--prefetch-depth", "0"]),
             ("--prefetch-depth 2", []),
             ("--prefetch-batches 2", ["--prefetch-batches", "2"]),
             (f"--prefetch-depth 2 --steps-per-call {P23_K}", ["--steps-per-call", str(P23_K)]))
P23_PROFILED = ("--prefetch-depth 0", "--prefetch-depth 2")
#: 23a: batches the gathers alone are timed over
P23_GATHERS = 200
#: 23b: steps an epoch (two epochs) at two ranks of 32 rows and at one of 64
P23_BN_STEPS = 5
P23_BN_RTOL = 1e-5

#: 23b: BatchNorm calls a NetResDeep forward (one tied BatchNorm, 10 blocks)
P23_BN_CALLS = 10
P23_LAMB_STEPS = 20
P23_LAMB_ATOL = 1e-6
P23_CV_ROWS = 256


def data_path_profile(trainer):
    """One more epoch of ``trainer`` through its ``run`` (its own data path)
    under ``torch.profiler``: (ms a step, device busy ms a step, idle
    share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_ddp_torch.tools.profile_step import _device_us

    trainer.config.epochs += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / P23_STEPS * 1e3
    busy = _device_us(prof)[0] / P23_STEPS * 1e-3
    return wall, busy, 1.0 - busy / wall


def gather_alone(loader):
    """Host ms a 32-row batch of the main path's two gathers alone:
    ``loader.gather`` (numpy's fancy indexing below 1 MiB, the synchronous
    path's) and one native ring round trip (submit, acquire, release; the
    ring's C++ worker gathers)."""
    from tpu_ddp_torch.native.prefetch import BatchPrefetcher

    index = [idx for idx, _ in loader.epoch_index_batches(epoch=1)]
    index = (index * (P23_GATHERS // len(index) + 1))[:P23_GATHERS]
    t0 = time.perf_counter()
    for idx in index:
        loader.gather(idx)
    numpy_ms = (time.perf_counter() - t0) / P23_GATHERS * 1e3
    with BatchPrefetcher(loader.images, loader.labels, max_batch=loader.local_batch,
                         depth=3, pin_memory=True) as pf:
        t0 = time.perf_counter()
        for idx in index:
            pf.submit(idx)
            pf.release(pf.acquire()[2])
        ring_ms = (time.perf_counter() - t0) / P23_GATHERS * 1e3
    return numpy_ms, ring_ms


def phase_data_path(smi):
    """Phase 23a: NetResDeep at full width through the train CLI's config
    (``--kernels``, batch 32, SGD lr 1e-2, deterministic cuDNN) on each host
    data path; losses bitwise equal across the four, K1 once a step, and the
    host ms a step of the gather, the copy and the wait for a batch."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, extra in P23_PATHS:
            args = nrd_args(P23_STEPS, 2, *extra)
            print(f"phase 23a, deterministic cuDNN, {label}: tpu_ddp_torch.cli.train "
                  f"{' '.join(args)}", flush=True)
            trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
            try:
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                m = trainer.run()
                torch.cuda.synchronize()
                m["launches"] = ops.launch_counts()
                gathered = trainer.train_loader.gather_seconds
                m["gather_ms"] = gathered / (2 * P23_STEPS) * 1e3 if gathered else None
                if label in P23_PROFILED:
                    m["profile"] = data_path_profile(trainer)
                if label == P23_PATHS[0][0]:
                    m["gather_alone"] = gather_alone(trainer.train_loader)
            finally:
                trainer.close()
            want = {name: 0 for name in m["launches"]}
            want["fused_update"] = 2 * P23_STEPS
            if m["launches"] != want or m["steps"] != 2 * P23_STEPS:
                fail(f"23a {label}: {m['steps']} steps and launches {m['launches']}, "
                     f"expected {2 * P23_STEPS} and {want}")
            profiled = ("" if "profile" not in m else "; profiled epoch {:.4f} ms a step, "
                        "device busy {:.4f} ms, idle share {:.4f}".format(*m["profile"]))
            gather = ("in the ring's C++ worker" if m["gather_ms"] is None else
                      f"{m['gather_ms']:.4f} ms a step on the "
                      + ("training thread" if label == P23_PATHS[0][0] else "loader thread"))
            print(f"  K1 {m['launches']['fused_update']} launches in {m['steps']} steps; host "
                  f"ms a step: data wait {m['data_ms']['data_wait']:.4f}, H2D "
                  f"{m['data_ms']['h2d']:.4f}, gather {gather}; steady "
                  f"{m['steady_step_ms']:.4f} ms a step, "
                  f"{m['images_per_sec_per_chip']:.1f} images/sec{profiled}", flush=True)
            runs[label] = m
    finally:
        torch.backends.cudnn.deterministic = False
    first = runs[P23_PATHS[0][0]]
    same = all(m["step_losses"] == first["step_losses"] for m in runs.values())
    numpy_ms, ring_ms = first["gather_alone"]
    print(f"  23a: {2 * P23_STEPS} step losses equal to the bit on the four paths {same}; "
          f"a 32-row batch of float32 images is {32 * 32 * 32 * 3 * 4} B; gathered alone "
          f"(host ms a batch, {P23_GATHERS} batches): numpy {numpy_ms:.4f}, native ring round "
          f"trip {ring_ms:.4f} ({smi})", flush=True)
    if not same:
        fail("23a: the host data paths' losses differ")
    return runs


def sync_bn_child(out_dir, args):
    """One rank of phase 23b, started by the launcher: the train CLI's
    config of ``args`` trained twice on the one process group, with and
    without ``--sync-bn``, under deterministic cuDNN, the launch and sync-BN
    counts zeroed just before each; writes the metrics and each run's
    final weights to ``out_dir``."""
    import dataclasses

    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.models.resnet import SYNC_BN_COLLECTIVES
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.train.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    rank = int(os.environ["RANK"])
    base = cli.config_from_args(cli.build_parser().parse_args(args))
    runtime.initialize_distributed(base.device, base.dist_backend)
    mark_started(out_dir)
    out = {}
    try:
        for label, sync in (("sync", True), ("local", False)):
            trainer = Trainer(dataclasses.replace(base, sync_bn=sync))
            states, inner = [], trainer.train_step

            def watched(state, batch, inner=inner, states=states):
                states.append({k: v.to("cpu", copy=True)
                               for k, v in state.model.state_dict().items()})
                return inner(state, batch)

            trainer.train_step = watched      # the state each step starts from
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            SYNC_BN_COLLECTIVES.clear()
            m = trainer.run()
            torch.cuda.synchronize()
            m["launches"] = ops.launch_counts()
            m["sync_bn"] = dict(SYNC_BN_COLLECTIVES)
            states.append({k: v.to("cpu", copy=True)
                           for k, v in trainer.state.model.state_dict().items()})
            torch.save(states, os.path.join(out_dir, f"{label}_rank{rank}.pt"))
            trainer.close()
            out[label] = m
    finally:
        runtime.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_sync_bn(tmp, smi, nproc=2):
    """Phase 23b: ``--sync-bn --kernels`` on two gloo ranks sharing the card
    against one rank at batch 64 on the same data order, and the same two
    ranks without ``--sync-bn`` (module docstring)."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    def bn_args(batch, *extra):
        return ["--device", "cuda", *extra, "--synthetic-data", "--synthetic-size",
                str(nproc * 32 * P23_BN_STEPS), "--epochs", "2", "--kernels", "--n-chans1",
                "32", "--n-blocks", "10", "--batch-size", str(batch), "--lr", "1e-2",
                "--log-every-epochs", "1"]

    args, one = bn_args(32, "--dist-backend", "gloo"), bn_args(32 * nproc)
    out = os.path.join(tmp, "sync_bn")
    os.makedirs(out)
    print(f"phase 23b, deterministic cuDNN: python -m tpu_ddp_torch.cli.launch "
          f"--nproc-per-node {nproc} -- python -m tpu_ddp_torch.cli.train {' '.join(args)} "
          "with and without --sync-bn", flush=True)
    rc = smoke_job(["--sync-bn-child", out, *args], nproc, "23b", out)
    if rc:
        fail(f"23b: the {nproc}-rank run exited with {rc}")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    states = {label: [torch.load(os.path.join(out, f"{label}_rank{r}.pt"))
                      for r in range(nproc)] for label in ("sync", "local")}
    print(f"phase 23b, deterministic cuDNN, the oracle: one rank at batch {32 * nproc} "
          f"(tpu_ddp_torch.cli.train {' '.join(one)}), each step from the state the two "
          "ranks started it from", flush=True)
    steps = 2 * P23_BN_STEPS
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(one)))
        oracle, state_diff = {}, {}
        ops.reset_launch_counts()
        for label in ("sync", "local"):
            oracle[label], state_diff[label] = [], []
            s = 0
            for epoch in (1, 2):
                trainer.train_loader.set_epoch(epoch)
                for batch in trainer.train_loader.epoch_batches():
                    trainer.state.model.load_state_dict(states[label][0][s])
                    trainer.state, m = trainer.train_step(trainer.state,
                                                          trainer.to_device(batch))
                    oracle[label].append(float(m["loss"]))
                    after = trainer.state.model.state_dict()
                    state_diff[label].append(max(
                        float((after[k].cpu() - v).abs().max())
                        for k, v in states[label][0][s + 1].items()))
                    s += 1
        torch.cuda.synchronize()
        oracle_k1 = ops.launch_counts()["fused_update"]
        trainer.close()
    finally:
        torch.backends.cudnn.deterministic = False

    def rels(label):
        return [abs(g - w) / abs(w) for g, w in zip(ranks[0][label]["step_losses"],
                                                   oracle[label])]

    sync, local = ranks[0]["sync"], ranks[0]["local"]
    replicas = {label: all(torch.equal(states[label][0][-1][k], w[-1][k])
                           for w in states[label][1:] for k in w[-1]) for label in states}
    calls = {k: v / steps for k, v in sync["sync_bn"].items()}
    print(f"  from the same state each step, the two ranks' loss against one rank at the "
          f"whole batch, relative: synced {' '.join(f'{x:.3g}' for x in rels('sync'))} "
          f"(limit {P23_BN_RTOL}); without --sync-bn "
          f"{' '.join(f'{x:.3g}' for x in rels('local'))} (must exceed it); largest "
          f"|difference| of the state after a step: synced {max(state_diff['sync']):.3g}, "
          f"without {max(state_diff['local']):.3g}", flush=True)
    print(f"  replicas bitwise: sync {replicas['sync']}, without {replicas['local']}; K1 a "
          f"rank {[r['sync']['launches']['fused_update'] for r in ranks]} (sync), "
          f"{[r['local']['launches']['fused_update'] for r in ranks]} (without), "
          f"{oracle_k1} (the oracle's two trajectories) in {steps} steps each", flush=True)
    print(f"  BN collectives a step a rank: {calls} ({sum(calls.values()):.0f}; "
          f"{2 * P23_BN_CALLS} expected); steady ms a step at two ranks: sync "
          f"{sync['steady_step_ms']:.4f}, without {local['steady_step_ms']:.4f}, the sync adds "
          f"{sync['steady_step_ms'] - local['steady_step_ms']:.4f} ms ({smi})", flush=True)
    if not max(rels("sync")) <= P23_BN_RTOL:
        fail("23b: the synced ranks' losses disagree with one rank at the whole batch")
    if not max(rels("local")) > P23_BN_RTOL:
        fail("23b: the unsynced ranks agree with the whole batch: the sync did not show")
    if not (replicas["sync"] and replicas["local"]):
        fail("23b: replicas differ")
    if calls != {"forward": P23_BN_CALLS, "backward": P23_BN_CALLS} or local["sync_bn"]:
        fail(f"23b: sync-BN collectives {sync['sync_bn']} / {local['sync_bn']}, expected "
             f"{P23_BN_CALLS} each way a step and none without --sync-bn")
    for r in ranks:
        for label in ("sync", "local"):
            if r[label]["launches"]["fused_update"] != steps or r[label]["steps"] != steps:
                fail(f"23b: {label}: K1 {r[label]['launches']} in {r[label]['steps']} steps")
    if oracle_k1 != 2 * steps:
        fail(f"23b: the oracle launched K1 {oracle_k1} times in 2 x {steps} steps")


def phase_lamb(smi):
    """Phase 23c: one NetResDeep lamb update on the card against the plain
    chain on the CPU on the same gradients, 20 steps through the CLI with a
    falling loss, and ``--kernels --optimizer lamb`` refused."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.train.optim import make_optimizer

    gen = torch.Generator().manual_seed(23)
    named = dict(NetResDeep(generator=torch.Generator().manual_seed(0)).named_parameters())
    params = {n: p.detach().clone() for n, p in named.items()}
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
    grads["fc2.bias"].zero_()               # a leaf whose trust ratio is 1
    out = {}
    for device in ("cuda", "cpu"):
        tx = make_optimizer(lr=1e-2, optimizer="lamb", weight_decay=0.01, grad_clip_norm=1.0)
        p = {n: t.to(device) for n, t in params.items()}
        state = tx.init(p)
        for _ in range(2):
            tx.apply({n: g.to(device) for n, g in grads.items()}, state, p)
        out[device] = p
    err = max(float((out["cuda"][n].cpu() - out["cpu"][n]).abs().max()) for n in params)
    print(f"phase 23c: lamb on NetResDeep's {len(params)} leaves, two updates on the card "
          f"against the plain chain on the CPU: max |diff| {err:.3g} (limit "
          f"{P23_LAMB_ATOL})", flush=True)
    if not err <= P23_LAMB_ATOL:
        fail("23c: lamb on the card disagrees with the CPU")
    args = [a for a in nrd_args(P23_LAMB_STEPS, 1) if a != "--kernels"]
    args += ["--optimizer", "lamb", "--weight-decay", "0.01"]
    print(f"phase 23c: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    trainer, m = counted_run(args)
    del trainer
    losses = m["step_losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"  {m['steps']} steps, mean loss of the first 5 {first:.4f}, last 5 {last:.4f}; "
          f"launches {m['launches']}; steady {m['steady_step_ms']:.4f} ms a step ({smi})",
          flush=True)
    if m["steps"] != P23_LAMB_STEPS or not last < first or any(m["launches"].values()):
        fail("23c: the lamb run did not take its steps, its loss did not fall, or it "
             "launched a kernel")
    try:
        cli.run(nrd_args(P23_LAMB_STEPS, 1, "--optimizer", "lamb"))
    except ValueError as e:
        refused = "no lamb branch" in str(e)
        print(f"  --kernels --optimizer lamb refused: {e}", flush=True)
    else:
        refused = False
    ops.reset_launch_counts()
    if not refused:
        fail("23c: --kernels --optimizer lamb was not refused")


def phase_cv(smi):
    """Phase 23d: ``--cv-mode 2`` through the train CLI, NetResDeep at full
    width, one epoch a fold: both folds train and validate, their validation
    sets are disjoint and cover the data, K1 once a step."""
    import numpy as np

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    args = nrd_args(P23_CV_ROWS // 32, 1, "--cv-mode", "2")
    print(f"phase 23d: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
    seen = []
    inner = cli.Trainer

    class Recording(inner):
        def __init__(self, config, *, train_data=None, test_data=None):
            seen.append((train_data, test_data))
            super().__init__(config, train_data=train_data, test_data=test_data)

    cli.Trainer = Recording
    try:
        ops.reset_launch_counts()
        _, out = cli.run(args)
        counts = ops.launch_counts()
    finally:
        cli.Trainer = inner
    rows = [set(map(bytes, np.ascontiguousarray(test[0]).reshape(len(test[0]), -1)))
            for _, test in seen]
    disjoint = not rows[0] & rows[1]
    covers = sum(len(test[0]) for _, test in seen) == P23_CV_ROWS and all(
        len(train[0]) + len(test[0]) == P23_CV_ROWS for train, test in seen)
    steps = sum(r["steps"] for r in out["cv_results"])
    print(f"  folds {out['completed_folds']}, val accuracy "
          f"{[round(r['val_accuracy'], 4) for r in out['cv_results']]}; validation sets "
          f"disjoint {disjoint}, covering the {P23_CV_ROWS} rows {covers}; K1 "
          f"{counts['fused_update']} launches in {steps} steps", flush=True)
    if out["completed_folds"] != 2 or not (disjoint and covers):
        fail("23d: the folds did not complete or their validation sets are wrong")
    if counts["fused_update"] != steps or steps != 2 * (P23_CV_ROWS // 2 // 32):
        fail(f"23d: K1 {counts['fused_update']} launches in {steps} steps")


# ---- phase 24: --zero3 (parameter streaming) on three ranks -------------

#: ZeRO-3's blocks (top-level modules) of NetResDeep and ViT-S/4
ZERO3_BLOCKS = {"netresdeep": 4, "vit_s4": 10}


def vit_zero3_accounting(n):
    """``Zero3Partition.accounting()`` of phase 15's ViT-S/4 recipe at ``n``
    ranks (built on the CPU: the layout needs shapes only)."""
    from tpu_ddp_torch.parallel.zero import Zero3Partition
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
    from tpu_ddp_torch.train.trainer import TrainConfig, build_model

    params = dict(build_model(TrainConfig(device="cpu", model="vit_s4")).named_parameters())
    tx = make_optimizer(optimizer="adamw", lr=1e-3, weight_decay=0.05, grad_clip_norm=1.0,
                        ema_decay=0.999, zero1_axis="data", decay_mask=decay_mask(params))
    return Zero3Partition(tx, params, n, rank=0).accounting()


#: 24b's ViT-S/4 runs take two epochs of phase 15's, the second one timed
P24_VIT_EPOCHS = 2


def zero3_runs(n, backend, serial):
    """Phase 24's runs on ``n`` ranks in one job: (a) NetResDeep
    ``--zero3`` float32 and int8 with error feedback (phase 14's arguments);
    (b) ViT-S/4 replicated, ``--zero1`` and ``--zero3`` (phase 15's, over
    ``P24_VIT_EPOCHS`` epochs), and with ``serial`` the ``--zero3`` run in
    turns with the gathers serialized (prefetch, serial, serial,
    prefetch)."""
    runs = [("zero3", dp_args(False, n, backend) + ["--zero3"]),
            ("zero3_int8_ef", dp_args(True, n, backend) + ["--zero3"])]
    vit = lambda layout: with_epochs(vit_layout_args(layout, n, backend),  # noqa: E731
                                     P24_VIT_EPOCHS)
    runs += [(f"p24_vit_{layout or 'replicated'}", vit(layout))
             for layout in (None, "zero1", "zero3")]
    if serial:
        runs += [("p24_vit_zero3" + SERIAL, vit("zero3")),
                 ("p24_vit_zero3_2" + SERIAL, vit("zero3")), ("p24_vit_zero3_2", vit("zero3"))]
    return runs


def print_memory(label, metrics):
    """Each rank's device memory allocated between steps (the last sample,
    and the spread of the samples) and its peak, in bytes."""
    for r, m in enumerate(metrics):
        between = m["memory_between_steps"]
        print(f"  {label}, rank {r}: memory allocated between steps {between[-1]} B "
              f"(samples {min(between)}..{max(between)}), peak {m['peak_memory']} B; "
              f"steady-state step {m['steady_step_ms']:.4f} ms", flush=True)


def phase_zero3(tmp, zero1_runs, n=ZERO1_RANKS, backend="gloo", serial=False):
    """Phase 24 (a)-(c) on ``n`` ranks (three sharing the card over gloo, or
    one card each over NCCL), all under cuDNN's deterministic algorithms, in
    one job (``zero3_runs``): the launches (K1 once a step, K2/K3 at
    ZeRO-1's counts, K4-K6 at the ViT's), the ring's wire calls and one
    block gather a block a step, the first losses against phase 14's and
    15's ``--zero1`` runs (``zero1_runs``) within ``ZERO1_RTOL``, replicas
    bitwise, memory between steps and peak against ``accounting()`` for
    the three ViT layouts, and (c) the resumed run bitwise the uncut one.
    Returns the runs' metrics."""
    ck = os.path.join(tmp, f"zero3_ckpt{n}")
    runs = zero3_runs(n, backend, serial)
    int8 = dict(runs)["zero3_int8_ef"]
    runs += [("p24_cut", with_epochs(int8, 1, "--checkpoint-dir", ck)),
             ("p24_resumed", with_epochs(int8, 2, "--checkpoint-dir", ck, "--resume"))]
    jobs = launch_dp_runs(tmp, runs, n, phase="24", deterministic=True)
    steps = 2 * DP_STEPS_PER_EPOCH
    out = {}
    # (a) NetResDeep
    for name, compress in (("zero3", False), ("zero3_int8_ef", True)):
        metrics, same = jobs[name]
        check_run(f"24a {name}", metrics, same, steps, zero1_launches(n, compress))
        wire = {k: v * steps for k, v in ring_wire_calls(n, compress, True).items()}
        gathers = ZERO3_BLOCKS["netresdeep"] * steps
        print(f"  24a {name}: the ring's wire calls on rank 0 {metrics[0]['wire_calls']} "
              f"(expected {wire}); block gathers {metrics[0]['block_gathers']} "
              f"(expected {gathers}: one a block a step)", flush=True)
        for r, m in enumerate(metrics):
            if m["wire_calls"] != wire or m["block_gathers"] != gathers:
                fail(f"24a {name}: rank {r} made {m['wire_calls']} wire calls and "
                     f"{m['block_gathers']} block gathers")
        zero1 = zero1_runs[name.replace("zero3", "zero1")][0]["step_losses"]
        got = metrics[0]["step_losses"]
        first_losses_close(f"24a {name} vs phase 14's --zero1", got, zero1)
        print(f"  24a {name}: all {len(got)} step losses equal to phase 14's --zero1 "
              f"to the bit: {got == zero1}", flush=True)
        out[name] = metrics
    # (b) ViT-S/4
    acct = vit_zero3_accounting(n)
    print(f"  24b ViT-S/4 Zero3Partition.accounting() at {n} ranks: {acct}", flush=True)
    want_per_step = {"fused_update": 1, "flash_attention_dq": VIT_DEPTH,
                     "flash_attention_dkv": VIT_DEPTH}
    vit = {}
    vit_steps = P24_VIT_EPOCHS * VIT_ZERO1_STEPS
    for name in [r for r, _ in runs if r.startswith("p24_vit_")]:
        metrics, same = jobs[name]
        evals = metrics[0]["eval_batches"]
        check_run(f"24b {name}", metrics, same, vit_steps, want_per_step,
                  extra={"flash_attention_fwd": VIT_DEPTH * (vit_steps + evals)})
        print_memory(f"24b {name}", metrics)
        vit[name] = metrics
        out[name] = metrics
    z3 = vit["p24_vit_zero3"]
    gathers = ZERO3_BLOCKS["vit_s4"] * vit_steps
    if any(m["block_gathers"] != gathers for name, ms in vit.items() if "zero3" in name
           for m in ms):
        fail(f"24b: {[m['block_gathers'] for m in z3]} block gathers, expected {gathers}")
    first_losses_close("24b ViT --zero3 vs --zero1 (this job)",
                       z3[0]["step_losses"], vit["p24_vit_zero1"][0]["step_losses"])
    print(f"  24b: all {vit_steps} step losses of --zero3 equal to --zero1's to the bit: "
          f"{z3[0]['step_losses'] == vit['p24_vit_zero1'][0]['step_losses']}", flush=True)
    if "vit_zero1" in zero1_runs:
        first_losses_close("24b ViT --zero3 vs phase 15's --zero1",
                           z3[0]["step_losses"], zero1_runs["vit_zero1"][0]["step_losses"])
    saved = acct["params_bytes_replicated"] - acct["params_bytes_per_device_sharded"]
    for r in range(n):
        drop = (vit["p24_vit_zero1"][r]["memory_between_steps"][-1]
                - z3[r]["memory_between_steps"][-1])
        print(f"  24b rank {r}: memory between steps, --zero1 minus --zero3: {drop} B "
              f"({drop / saved:.3f} of params_bytes_replicated - "
              f"params_bytes_per_device_sharded = {saved} B)", flush=True)
        if drop < 0.9 * saved:
            fail(f"24b: rank {r} holds {drop} B less under --zero3 than --zero1, "
                 f"less than 0.9 of {saved} B")
    for name, metrics in vit.items():
        print(f"  24b {name}: steady-state step time per rank "
              + " / ".join(f"{m['steady_step_ms']:.4f}" for m in metrics) + " ms",
              flush=True)
    if serial:
        turns = ("p24_vit_zero3", "p24_vit_zero3" + SERIAL, "p24_vit_zero3_2" + SERIAL,
                 "p24_vit_zero3_2")
        mean = lambda name: sum(m["steady_step_ms"] for m in vit[name]) / n  # noqa: E731
        print("  24b ViT-S/4 --zero3 in turns, prefetch / serialized / serialized / "
              "prefetch, mean over the ranks: "
              + " / ".join(f"{mean(t):.4f}" for t in turns) + " ms a step", flush=True)
    # (c) cut and resumed
    full, resumed = jobs["zero3_int8_ef"], jobs["p24_resumed"]
    weights = {name: rank_weights(tmp, name, n) for name in ("zero3_int8_ef", "p24_resumed")}
    cut_steps = DP_STEPS_PER_EPOCH
    bitwise = all(m["step_losses"] == f["step_losses"][cut_steps:] and same_weights(w, fw)
                  for m, f, w, fw in zip(resumed[0], full[0], weights["p24_resumed"],
                                         weights["zero3_int8_ef"]))
    want = {k: 0 for k in resumed[0][0]["launches"]}
    want.update({k: v * cut_steps for k, v in zero1_launches(n, True).items()})
    print(f"  24c: --zero3 int8 cut at step {cut_steps} and resumed: losses and final "
          f"params bitwise the uncut run's on every rank {bitwise}; replicas bitwise "
          f"{resumed[1]}; launches on rank 0 {resumed[0][0]['launches']}", flush=True)
    if not bitwise or not resumed[1] or any(m["launches"] != want for m in resumed[0]):
        fail("24c: the resumed --zero3 run is not bitwise the uncut one")
    check_manifests(ck, (cut_steps, 2 * cut_steps))
    return out


def phase_zero3_two(tmp, n=ZERO1_RANKS):
    """Phase 24 (c) and (d) at two ranks over gloo, in one job: ``skip_step``
    under ``--zero3`` with rank 0's fifth batch all NaN (the job's first run,
    so the process's fifth batch is its): that step skipped on both ranks,
    every rank's state (param shards, optimizer slots and counts, BatchNorm
    buffers, residual) bitwise as before it, replicas bitwise; then 24c's
    ``--zero3`` int8 checkpoint (``phase_zero3``'s at ``n`` ranks; its latest,
    the resumed run's last step) resumed under ``--zero1`` (from that step,
    finite losses, replicas bitwise, the data that of ``n`` ranks)."""
    ck = os.path.join(tmp, f"zero3_ckpt{n}")
    resume = dp_args(True, 2) + ["--zero1"]
    resume[resume.index("--synthetic-size") + 1] = str(n * 32 * DP_STEPS_PER_EPOCH)
    resume = [a for a in resume if a != "--eval-each-epoch"]
    run_dir = os.path.join(tmp, "zero3_health")
    skip = ["--device", "cuda", "--dist-backend", "gloo", "--synthetic-data",
            "--synthetic-size", str(2 * 32 * HEALTH_RANK_STEPS), "--epochs", "1",
            "--no-shuffle", "--kernels", "--zero3", "--grad-compress", "int8",
            "--grad-compress-error-feedback", "--n-chans1", "32", "--n-blocks", "10",
            "--batch-size", "32", "--lr", "1e-2", "--momentum", "0.9",
            "--log-every-epochs", "1", "--health", "on", "--health-policy", "skip_step",
            "--health-per-layer-stride", "5", "--health-dir", run_dir]
    jobs = launch_dp_runs(
        tmp, [("zero3_skip", skip),
              ("zero3_to_zero1_two", with_epochs(resume, 3, "--checkpoint-dir", ck,
                                                 "--resume"))],
        2, phase="24c-d", deterministic=True, poison=HEALTH_POISON)
    metrics, same = jobs["zero3_skip"]
    recs = [health_records(run_dir, r) for r in range(2)]
    bad = [[r["step"] for r in rec if not r["all_finite"]] for rec in recs]
    bits = [m["poisoned_step_bitwise"] for m in metrics]
    print(f"  24d: non-finite steps by rank {bad}; the state bitwise across the skipped "
          f"step on each rank {bits}; replicas bitwise {same}; launches on rank 0 "
          f"{metrics[0]['launches']}", flush=True)
    if bad != [[HEALTH_POISON]] * 2 or not all(bits) or not same:
        fail("24d: skip_step under --zero3 did not leave the state bitwise")
    metrics, same = jobs["zero3_to_zero1_two"]
    losses = metrics[0]["step_losses"]
    # the n ranks' rows at two ranks: a padded last batch an epoch when odd
    want = 3 * math.ceil(n * DP_STEPS_PER_EPOCH / 2) - 2 * DP_STEPS_PER_EPOCH
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    print(f"  24c: the {n}-rank --zero3 checkpoint (step {2 * DP_STEPS_PER_EPOCH}) resumed "
          f"under --zero1 at two ranks: {len(losses)} steps (expected {want}), mean loss "
          f"of the first 20 {first:.4f}, last 20 {last:.4f}; replicas bitwise equal "
          f"{same}", flush=True)
    if not all(math.isfinite(x) for x in losses) or len(losses) != want or not same:
        fail("24c: the --zero3 checkpoint did not resume under --zero1 at two ranks")


#: phase 25: sequence parallelism. (a) the ring at 2 and 4 gloo ranks sharing
#: the card: global (B, T, H, D) shapes cut into n chunks of T, cases (shape,
#: dtype, causal, key mask); (b) ViT-S/4 through the CLI at data=1,
#: sequence=2, batch 32, SP_VIT_STEPS steps an epoch for two epochs, and
#: SP_VIT_HEALTH_STEPS under --health warn; (c) in the same job, LM-32k
#: through make_sp_lm_train_step, SP_LM_STEPS steps in float32 and in
#: bfloat16, the ring timed alone first
SP_RINGS = (2, 4)
SP_SHAPES = {"vit_s4": (32, 64, 3, 64), "lm_32k": (LM_BATCH, LM_SEQ, LM_32K["num_heads"], 64)}
SP_CASES = [("vit_s4", "float32", False, False), ("vit_s4", "float32", True, False),
            ("vit_s4", "float32", False, True), ("vit_s4", "bfloat16", False, False),
            ("lm_32k", "float32", True, False), ("lm_32k", "bfloat16", True, False)]
SP_BF16_UNITS = 2                 # bf16 units of a row's largest value
SP_RING_ITERS = 5                 # timed forward + backward passes of the ring
SP_VIT_STEPS, SP_VIT_HEALTH_STEPS = 12, 10
SP_LM_STEPS, SP_LM_STEADY_FROM = 6, 3
SP_LM_BF16_RTOL = 5e-3


def sp_case_label(case):
    shape, dtype, causal, masked = case
    return (f"{shape} {dtype}" + (" causal" if causal else "")
            + (" kv_mask" if masked else ""))


def bf16_row_units(got, want, scale=None, floor=2.0 ** -12):
    """The largest distance of ``got`` from ``want`` in bfloat16 units of
    each row's scale (the last axis): the row's largest ``|want|``, or
    ``scale`` (one value a row) where given; a row's scale at least
    ``floor`` of the tensor's largest (phase 20a's check)."""
    import torch

    diff = (got.float() - want.float()).abs()
    top = want.float().abs().amax(-1, keepdim=True) if scale is None else scale[..., None]
    top = top.clamp(min=float(top.max()) * floor)
    unit = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(torch.where(diff == 0, 0.0, diff / unit).max())


def tile_close(got, want, grad):
    """(ok, measure) of one K4-K6 output against its plain version: within
    2 bf16 units of each row's largest value, or phase 7's float32
    tolerances (``grad``: the gradients')."""
    import torch

    if got.dtype == torch.bfloat16:
        units = bf16_row_units(got, want)
        return units <= SP_BF16_UNITS, units
    tol = GRAD_TOL if grad else FWD_TOL
    err = (got.float() - want.float()).abs()
    return bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()), float(err.max())


def checked_tiles(fa, records):
    """Wrap the K4-K6 wrappers the flash ring calls: each call's outputs
    against their plain versions on the same inputs (``tile_close``; lse
    ``atol=2e-5``), appended to ``records[kind]`` with each output row's
    largest ``|value|``. Returns the function that unwraps them."""
    orig = fa.flash_forward, fa.flash_dq, fa.flash_dkv

    def rowmax(t):
        return t.detach().float().abs().amax(-1)

    def fwd(q, k, v, kv_mask=None, causal=False):
        out, lse = orig[0](q, k, v, kv_mask, causal)
        want_out, want_lse = fa.forward_plain(q, k, v, kv_mask, causal)
        ok, m = tile_close(out, want_out, False)
        lse_err = float((lse - want_lse).abs().max())
        records["fwd"].append((ok and lse_err <= 2e-5, m, lse_err, rowmax(out)))
        return out, lse

    def dq(q, k, v, do, lse, di, kv_mask=None, causal=False):
        got = orig[1](q, k, v, do, lse, di, kv_mask, causal)
        ok, m = tile_close(got, fa.dq_plain(q, k, v, do, lse, di, kv_mask, causal), True)
        records["dq"].append((ok, m, rowmax(got)))
        return got

    def dkv(q, k, v, do, lse, di, kv_mask=None, causal=False):
        dk, dv = orig[2](q, k, v, do, lse, di, kv_mask, causal)
        want_dk, want_dv = fa.dkv_plain(q, k, v, do, lse, di, kv_mask, causal)
        (ok_k, mk), (ok_v, mv) = tile_close(dk, want_dk, True), tile_close(dv, want_dv, True)
        records["dkv"].append((ok_k and ok_v, max(mk, mv), rowmax(dk), rowmax(dv)))
        return dk, dv

    fa.flash_forward, fa.flash_dq, fa.flash_dkv = fwd, dq, dkv

    def restore():
        fa.flash_forward, fa.flash_dq, fa.flash_dkv = orig
    return restore


def sp_ring_child(out_dir):
    """Phase 25 (a) on one rank, started by the launcher over gloo (the
    ranks share ``cuda:0``), for each ring size n of ``SP_RINGS`` on the
    grid ``data = world / n, sequence = n`` (two rings of 2, then one of 4,
    at four ranks): every case of ``SP_CASES`` on this rank's
    chunk, through ``ring_flash_attention`` (K4-K6 a hop; its launches
    counted alone; each tile's outputs held to their plain versions on the
    same inputs, ``checked_tiles``), through the same ring with the plain
    tiles, and against one-rank ``flash_attention`` on the whole sequence
    (this rank's rows of it); out, lse, dq, dk and dv compared. Writes
    ``rank<r>.json``.

    The ring's float32 results are held to phase 7's tolerances. In
    bfloat16 each tile's output is rounded to bfloat16 before the ring sums
    it in float32 (as the JAX ring does), so the ring's error is the sum of
    its tiles' (each within 2 units of its own rows' largest value) and the
    final rounding: a row is held within ``2 m + 1`` units of its scale (m
    tiles summed into it; the row's largest value among its tiles' and the
    result's), ``2 m + 3`` against one-rank flash (whose own kernel adds 2),
    and the units against the result's own largest value are reported
    beside them."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.ops import flash_attention as fa
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
        ring_forward,
    )

    runtime.initialize_distributed("cuda", "gloo")
    mark_started(out_dir)
    try:
        world = runtime.world_size()
        # every rank builds every layout's groups, in the same order
        meshes = [create_mesh({"data": world // n, "sequence": n}) for n in SP_RINGS]
        out = {}
        for mesh in meshes:
            n, s, group = mesh.sequence_size, mesh.sequence_index, mesh.sequence_group()
            res_n = out[str(n)] = {"cases": {}}
            for case in SP_CASES:
                shape, dtype_name, causal, masked = case
                dtype = getattr(torch, dtype_name)
                B, T, H, D = SP_SHAPES[shape]
                rows = slice(s * T // n, (s + 1) * T // n)
                gen = torch.Generator(device="cuda").manual_seed(T + D + len(res_n["cases"]))
                full = [torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                        for _ in range(4)]
                km_full = None
                if masked:
                    km_full = (torch.rand((B, T), generator=gen, device="cuda") > 0.3).float()
                    km_full[0] = 0.0                                 # a dead batch row
                q, k, v, g = (t[:, rows] for t in full)
                km = None if km_full is None else km_full[:, rows].contiguous()
                res, records = {}, {"fwd": [], "dq": [], "dkv": []}
                for tile, ring in (("flash", ring_flash_attention), ("plain", ring_attention),
                                   ("one_rank", None)):
                    a, b, c = (t.clone().requires_grad_() for t in (full[:3] if ring is None
                                                                    else (q, k, v)))
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    if ring is None:
                        o = fa.flash_attention(a, b, c, causal=causal, kv_mask=km_full)
                        o.backward(full[3])
                        lse = fa.flash_forward(*(t.detach() for t in (a, b, c)), km_full,
                                               causal)[1][:, :, rows]
                        grads = [t.grad[:, rows] for t in (a, b, c)]
                        o = o[:, rows]
                    else:
                        restore = checked_tiles(fa, records) if tile == "flash" else None
                        try:
                            o = ring(a, b, c, group=group, causal=causal, kv_mask=km)
                            o.backward(g)
                            torch.cuda.synchronize()
                        finally:
                            if restore is not None:
                                restore()
                        res[tile + "_launches"] = ops.launch_counts()
                        lse = ring_forward(q, k, v, km, group, causal, tile == "flash")[1]
                        grads = [t.grad for t in (a, b, c)]
                    res[tile] = [o.detach(), lse] + grads
                errs = {"tiles": {kind: [max((r[1] for r in recs), default=0.0),
                                         all(r[0] for r in recs)]
                                  for kind, recs in records.items()}}
                failed = [f"{kind} tile" for kind, (_, ok) in errs["tiles"].items() if not ok]
                # each row's scale: its largest value among the tiles summed into it
                # (dk and dv: the tiles of every rank whose queries saw this chunk)
                held = [((s - i) % n, r[2].cpu(), r[3].cpu()) for i, r in enumerate(records["dkv"])]
                every = [None] * n
                dist.all_gather_object(every, held, group=group)
                mine = [x for rank_held in every for x in rank_held if x[0] == s]
                scales = {"out": torch.stack([r[3] for r in records["fwd"]]).amax(0),
                          "dq": torch.stack([r[2] for r in records["dq"]]).amax(0),
                          "dk": torch.stack([x[1] for x in mine]).amax(0).cuda(),
                          "dv": torch.stack([x[2] for x in mine]).amax(0).cuda()}
                terms = {"out": len(records["fwd"]), "dq": len(records["dq"]),
                         "dk": len(mine), "dv": len(mine)}
                for other in ("plain", "one_rank"):
                    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
                        got, want = res["flash"][i], res[other][i]
                        key = f"{name} vs {other}"
                        err = float((got.float() - want.float()).abs().max())
                        errs[key] = err
                        if name == "lse":
                            ok = err <= 2e-5
                        elif dtype == torch.bfloat16:
                            scale = torch.maximum(scales[name], want.float().abs().amax(-1))
                            units = bf16_row_units(got, want, scale)
                            bound = 2 * terms[name] + (1 if other == "plain" else 3)
                            errs[key + " bf16 units"] = [units, bound,
                                                         bf16_row_units(got, want)]
                            ok = units <= bound
                        else:
                            tol = FWD_TOL if name == "out" else GRAD_TOL
                            ok = bool(((got - want).abs()
                                       <= tol["atol"] + tol["rtol"] * want.abs()).all())
                        if not ok:
                            failed.append(key)
                errs["failed"] = failed
                suffix = "_bf16" if dtype == torch.bfloat16 else ""
                tiles = s + 1 if causal else n
                want = {name: 0 for name in res["flash_launches"]}
                for kind in ("fwd", "dq", "dkv"):
                    want[f"flash_attention_{kind}{suffix}"] = tiles
                res_n["cases"][sp_case_label(case)] = {
                    "launches": res["flash_launches"], "want_launches": want,
                    "plain_launches": res["plain_launches"], "errors": errs}
                del full, q, k, v, g, res, records, scales
                torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{runtime.rank()}.json"), "w") as f:
            json.dump(out, f)
    finally:
        runtime.shutdown()


def phase_sp_ring(tmp, smi):
    """Phase 25 (a): ``sp_ring_child`` on ``max(SP_RINGS)`` ranks sharing
    the card: its rings of each size in turn, in one job."""

    world = max(SP_RINGS)
    out = os.path.join(tmp, "sp_ring")
    os.makedirs(out)
    rc = smoke_job(["--sp-ring-child", out], world, "25a", out)
    if rc:
        fail(f"phase 25a: the {world}-rank ring job exited with {rc}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    failed = []
    for n in SP_RINGS:
        for r, res in enumerate(ranks):
            res = res[str(n)]
            for label, c in res["cases"].items():
                errs = c["errors"]
                if c["launches"] != c["want_launches"]:
                    failed.append(f"n={n} rank {r} {label}: launches {c['launches']}, "
                                  f"expected {c['want_launches']}")
                if any(c["plain_launches"].values()):
                    failed.append(f"n={n} rank {r} {label}: the plain ring launched "
                                  f"{c['plain_launches']}")
                if errs.get("failed"):
                    failed.append(f"n={n} rank {r} {label}: {errs['failed']}")
                if r >= n:              # the other rings of n repeat the first's cases
                    continue
                launched = {k: v for k, v in c["launches"].items() if v}
                tiles = ", ".join(f"{k} {m:.3g}" for k, (m, _) in errs["tiles"].items())
                ends = ", ".join(
                    f"{k} {v:.3g}" if isinstance(v, float) else
                    f"{k} {v[0]:.3g} (bound {v[1]}; {v[2]:.3g} of the result's own largest)"
                    for k, v in errs.items() if k not in ("tiles", "failed"))
                print(f"phase 25a: ring of {n} over gloo on one card ({smi}), rank {r}, "
                      f"{label}: flash ring launches {launched}; each tile against its "
                      f"plain version, largest {tiles}; the ring: {ends}", flush=True)
    if failed:
        fail("phase 25a: " + "; ".join(failed))


def sp_vit_args(nproc, backend, data, *extra, steps=SP_VIT_STEPS, epochs=2):
    seq = nproc // data
    return ["--device", "cuda", "--dist-backend", backend, "--synthetic-data",
            "--synthetic-size", str(data * 32 * steps), "--epochs", str(epochs),
            "--model", "vit_s4", "--parallelism", "sp", "--mesh",
            f"data={data},sequence={seq}", "--sp-flash", "--kernels", "--optimizer",
            "adamw", "--lr", "1e-3", "--batch-size", "32", "--log-every-epochs", "1",
            *extra]


def sp_vit_one_rank():
    """Phase 25b's baseline: the one-rank ``--attention flash`` run in this
    process on the SP run's first epoch (the same data, order and init);
    its metrics with its peak memory above what the process held."""
    import torch

    from tpu_ddp_torch.cli import train as cli

    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(32 * SP_VIT_STEPS), "--epochs", "1", "--model", "vit_s4", "--attention",
            "flash", "--kernels", "--optimizer", "adamw", "--lr", "1e-3", "--batch-size",
            "32", "--log-every-epochs", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    metrics = cli.main(args)
    torch.cuda.synchronize()
    metrics["peak_memory"] = torch.cuda.max_memory_allocated() - held
    return metrics


def sp_lm_runs(out_dir, data):
    """Phase 25 (c) on one rank, in ``rank_child``'s process group: LM-32k
    through ``make_sp_lm_train_step`` with ``sp_flash`` on this rank's rows
    and chunk of phase 18a's batches, AdamW lr 1e-3 through K1, float32 then
    bfloat16: the flash ring's forward + backward at a layer's shape timed
    first, then ``SP_LM_STEPS`` steps with the launch counts zeroed just
    before; writes the losses, counts, ms a step, tokens/sec and peak memory
    of this rank, and a digest of its params."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.ring_attention import ring_flash_attention
    from tpu_ddp_torch.train import create_lm_train_state, make_sp_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    device = runtime.rank_device("cuda", dist.get_backend())
    mesh = create_mesh({"data": data, "sequence": runtime.world_size() // data})
    n, s, d = mesh.sequence_size, mesh.sequence_index, mesh.data_index
    rows = slice(d * LM_BATCH // data, (d + 1) * LM_BATCH // data)
    cols = slice(s * LM_SEQ // n, (s + 1) * LM_SEQ // n)
    tokens = torch.from_numpy(lm_tokens(LM_STEPS, LM_BATCH, LM_SEQ, LM_32K["vocab_size"])
                              [:SP_LM_STEPS, rows, cols].copy()).to(device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        B, T = tokens.shape[1:]
        H, D = LM_32K["num_heads"], LM_32K["hidden_dim"] // LM_32K["num_heads"]
        gen = torch.Generator(device=device).manual_seed(1)
        q, k, v, g = (torch.randn((B, T, H, D), generator=gen, device=device).to(dtype)
                      for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()
        ring_ms = []
        for i in range(SP_RING_ITERS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring_flash_attention(q, k, v, group=mesh.sequence_group(),
                                 causal=True).backward(g)
            torch.cuda.synchronize()
            ring_ms.append((time.perf_counter() - t0) * 1e3)
        del q, k, v, g
        model = CausalTransformerLM(**LM_32K, seq_len=LM_SEQ,
                                    generator=torch.Generator().manual_seed(0), dtype=dtype)
        tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
        state = create_lm_train_state(model, tx, device)
        step = make_sp_lm_train_step(tx, mesh, sp_flash=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses = []
        for i in range(SP_LM_STEPS):
            if i == SP_LM_STEADY_FROM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, {"tokens": tokens[i]})
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (SP_LM_STEPS - SP_LM_STEADY_FROM)
        digest = hashlib.sha256()
        for name, p in sorted(state.model.state_dict().items()):
            digest.update(p.detach().cpu().numpy().tobytes())
        out[str(dtype).split(".")[-1]] = {
            "losses": [float(x) for x in losses], "launches": ops.launch_counts(),
            "step_ms": step_s * 1e3, "tokens_per_sec": B * T / step_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "ring_ms": sorted(ring_ms[1:])[SP_RING_ITERS // 2],
            "digest": digest.hexdigest()}
        del model, state, step
        torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{runtime.rank()}.json"), "w") as f:
        json.dump(out, f)


def phase_sp_train(tmp, smi, one_rank=None, nproc=2, backend="gloo", data=1):
    """Phase 25 (b) and (c) in one launcher job on ``nproc`` ranks
    (``rank_child --then-sp-lm``): ViT-S/4 ``--parallelism sp --sp-flash
    --kernels`` through the CLI, a short run under ``--health warn``, then
    the LM-32k steps. ``one_rank``: ``{"vit": sp_vit_one_rank()'s metrics,
    "float32": phase 18a's run, "bfloat16": phase 20d's}``, or None."""
    seq = nproc // data
    runs = launch_dp_runs(tmp, [
        ("sp_vit", sp_vit_args(nproc, backend, data)),
        ("sp_vit_health", sp_vit_args(nproc, backend, data, "--health", "on",
                                      "--health-policy", "warn",
                                      steps=SP_VIT_HEALTH_STEPS, epochs=1))],
        nproc, phase="25b", extra=["--then-sp-lm", str(data)])
    for name, (metrics, same) in runs.items():
        steps = metrics[0]["steps"]
        want = {k: 0 for k in metrics[0]["launches"]}
        want["fused_update"] = steps
        for kind in ("fwd", "dq", "dkv"):
            want[f"flash_attention_{kind}"] = VIT_DEPTH * seq * steps
        losses = metrics[0]["step_losses"]
        print(f"phase 25b {name} ({smi}): {steps} steps on {nproc} ranks over {backend} "
              f"(data={data}, sequence={seq}); launches on rank 0 {metrics[0]['launches']}; "
              f"replicas bitwise {same}; steady step ms a rank "
              + " / ".join(f"{m['steady_step_ms']:.3f}" for m in metrics)
              + "; peak memory a rank " + " / ".join(str(m["peak_memory"]) for m in metrics)
              + f" B; final test accuracy {metrics[0].get('test_accuracy')}", flush=True)
        for r, m in enumerate(metrics):
            if m["launches"] != want:
                fail(f"25b {name} rank {r}: launches {m['launches']}, expected {want}")
        if not same or not all(math.isfinite(x) for x in losses):
            fail(f"25b {name}: replicas differ or a loss is not finite")
    losses = runs["sp_vit"][0][0]["step_losses"]
    if not sum(losses[-10:]) < sum(losses[:10]):
        fail("25b: the SP ViT losses did not fall")
    if one_rank is not None:
        base = one_rank["vit"]
        rel = rel_diffs(losses, base["step_losses"])
        peak = runs["sp_vit"][0][0]["peak_memory"]
        print(f"  against the one-rank --attention flash run, relative loss difference "
              f"per step: {' '.join(f'{x:.2g}' for x in rel)} (limit {FULL_STEPS_RTOL}); "
              f"peak memory a rank {peak} B against one rank's {base['peak_memory']} B "
              f"({peak / base['peak_memory']:.3f}x)", flush=True)
        if not max(rel) <= FULL_STEPS_RTOL:
            fail("25b: the SP ViT losses leave the one-rank run's")
    ranks = []
    for r in range(nproc):
        with open(os.path.join(tmp, "sp_lm", f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"phase 25c: LM-32k make_sp_lm_train_step(sp_flash=True) on {nproc} ranks over "
          f"{backend} (data={data}, sequence={seq}), {SP_LM_STEPS} steps a dtype", flush=True)
    for dtype, rtol in (("float32", FULL_STEPS_RTOL), ("bfloat16", SP_LM_BF16_RTOL)):
        suffix = "_bf16" if dtype == "bfloat16" else ""
        for r, res in enumerate(ranks):
            run = res[dtype]
            want = {k: 0 for k in run["launches"]}
            want["fused_update"] = SP_LM_STEPS
            for kind in ("fwd", "dq", "dkv"):
                want[f"flash_attention_{kind}{suffix}"] = (
                    LM_32K["depth"] * (r % seq + 1) * SP_LM_STEPS)
            print(f"  {dtype} rank {r} ({smi}): launches {run['launches']}; "
                  f"{run['step_ms']:.3f} ms a step (steps {SP_LM_STEADY_FROM}-"
                  f"{SP_LM_STEPS}, host clock), {run['tokens_per_sec']:.1f} tokens/sec a "
                  f"rank, max_memory_allocated {run['max_memory_allocated']} B; the flash "
                  f"ring's forward + backward at a layer {run['ring_ms']:.3f} ms", flush=True)
            if run["launches"] != want:
                fail(f"25c {dtype} rank {r}: launches {run['launches']}, expected {want}")
        losses = ranks[0][dtype]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"25c {dtype}: a loss is not finite")
        if len({res[dtype]["digest"] for res in ranks}) != 1:
            fail(f"25c {dtype}: the ranks end with different params")
        if one_rank is not None:
            base = one_rank[dtype]
            rel = rel_diffs(losses, base["losses"])
            print(f"  {dtype} against the one-rank run: relative loss difference per step "
                  f"{' '.join(f'{x:.2g}' for x in rel)} (limit {rtol}); one rank "
                  f"{base['steady_step_ms']:.3f} ms a step, {base['tokens_per_sec']:.1f} "
                  f"tokens/sec, max_memory_allocated {base['max_memory_allocated']} B",
                  flush=True)
            if not max(rel) <= rtol:
                fail(f"25c {dtype}: the SP LM losses leave the one-rank run's")


# ---- phase 26: the SP overlays and the GSPMD families --------------------------------

#: steps an epoch of each phase-26 run (two epochs, the second timed), at a
#: global batch of GSPMD_BATCH
GSPMD_STEPS, GSPMD_BATCH = 5, 64
#: phase 26a's LM-32k, cut in depth
SP_LM_ZERO1_DEPTH, SP_LM_ZERO1_STEPS = 2, 6
#: the shapes K4-K6 take on a tensor-parallel rank in phase 26 (each rank's
#: data shard's rows of GSPMD_BATCH, ViT-S/4's 64 tokens, its own heads of 64
#: columns: model=2 holds 2 heads and 1, model=3 one; q, k and v views of
#: the rank's qkv columns), held against the plain versions as in phase 7
TP_FLASH_CASES = {
    "tp_data2_2heads": (GSPMD_BATCH // 2, 64, 2, 64, False, None, True),
    "tp_data2_1head": (GSPMD_BATCH // 2, 64, 1, 64, False, None, True),
    "tp_data1_1head": (GSPMD_BATCH, 64, 1, 64, False, None, True),
}


def sp_lm_zero1_runs(out_dir, data):
    """Phase 26a's LM on one rank, in ``rank_child``'s process group: LM-32k
    at depth ``SP_LM_ZERO1_DEPTH`` through ``make_sp_lm_train_step`` with
    ``sp_flash`` on this rank's rows and chunk of phase 18a's batches, AdamW
    lr 1e-3 through K1, replicated and then under ``--zero1`` over the
    data group (``Zero1Partition(group=mesh.data_group())``), the launch
    counts zeroed before each; writes each run's losses, counts and a
    digest of its params."""
    import hashlib

    import torch
    import torch.distributed as dist

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train import create_lm_train_state, make_sp_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    device = runtime.rank_device("cuda", dist.get_backend())
    mesh = create_mesh({"data": data, "sequence": runtime.world_size() // data})
    n, s, d = mesh.sequence_size, mesh.sequence_index, mesh.data_index
    rows = slice(d * LM_BATCH // data, (d + 1) * LM_BATCH // data)
    cols = slice(s * LM_SEQ // n, (s + 1) * LM_SEQ // n)
    tokens = torch.from_numpy(lm_tokens(LM_STEPS, LM_BATCH, LM_SEQ, LM_32K["vocab_size"])
                              [:SP_LM_ZERO1_STEPS, rows, cols].copy()).to(device)
    out = {}
    for name in ("replicated", "zero1"):
        model = CausalTransformerLM(**dict(LM_32K, depth=SP_LM_ZERO1_DEPTH), seq_len=LM_SEQ,
                                    generator=torch.Generator().manual_seed(0))
        zero1 = name == "zero1"
        tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True,
                            zero1_axis="data" if zero1 else None)
        part = (Zero1Partition(tx, dict(model.named_parameters()), mesh.data_size,
                               rank=d, group=mesh.data_group()) if zero1 else None)
        state = create_lm_train_state(model, tx, device, zero1=part)
        step = make_sp_lm_train_step(tx, mesh, sp_flash=True, zero1=part)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        losses = []
        for i in range(SP_LM_ZERO1_STEPS):
            state, metrics = step(state, {"tokens": tokens[i]})
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for _, p in sorted(state.model.state_dict().items()):
            digest.update(p.detach().cpu().numpy().tobytes())
        out[name] = {"losses": [float(x) for x in losses], "launches": ops.launch_counts(),
                     "digest": digest.hexdigest()}
        del model, state, step
        torch.cuda.empty_cache()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{runtime.rank()}.json"), "w") as f:
        json.dump(out, f)


def gspmd_args(backend, model, parallelism=None, mesh=None, *extra):
    """A phase-26 run of ``model`` (``"vit"``: ViT-S/4 with ``--attention
    flash`` and AdamW; ``"cnn"``: NetResDeep at its full width, the
    reference's SGD, whose state is the model's alone), ``--kernels``, two
    epochs of GSPMD_STEPS steps at a global batch of GSPMD_BATCH; one rank
    without ``parallelism``."""
    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(GSPMD_BATCH * GSPMD_STEPS), "--epochs", "2", "--kernels",
            "--global-batch-size", str(GSPMD_BATCH), "--log-every-epochs", "1"]
    if model == "vit":
        args += ["--model", "vit_s4", "--attention", "flash", "--optimizer", "adamw",
                 "--lr", "1e-3"]
    if parallelism is not None:
        args += ["--dist-backend", backend, "--parallelism", parallelism, "--mesh", mesh]
    return args + list(extra)


def gspmd_one_rank(model):
    """Phase 26's baseline: the one-rank run of ``gspmd_args(model)`` in this
    process on the same global batches; its metrics, launch counts, held
    bytes and peak memory above what the process held."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    trainer, metrics = cli.run(gspmd_args(None, model))
    torch.cuda.synchronize()
    metrics["launches"] = ops.launch_counts()
    metrics["peak_memory"] = torch.cuda.max_memory_allocated() - held
    metrics.update(held_bytes(trainer))
    del trainer
    torch.cuda.empty_cache()
    return metrics


def gspmd_launches(m, steps, flash):
    """The launches a step of a phase-26 GSPMD run makes on every rank: K1
    once a step; with ``flash`` K4 once a block a step and a test batch, K5
    and K6 once a block a step (each rank's own heads)."""
    want = {k: 0 for k in m["launches"]}
    want["fused_update"] = steps
    if flash:
        want["flash_attention_fwd"] = VIT_DEPTH * (steps + m.get("eval_batches", 0))
        want["flash_attention_dq"] = want["flash_attention_dkv"] = VIT_DEPTH * steps
    return want


def same_state_losses(states_path, args, steps=PLAIN_STEPS_RTOL):
    """One rank's loss of each of the first ``steps`` steps of the run of
    ``args`` (the one-rank form of the sharded run's), each step taken from
    the state the sharded run started it from (its ``--save-states`` file:
    phase 23b's oracle), under deterministic cuDNN."""
    import torch

    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    states = torch.load(states_path)
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cli.config_from_args(cli.build_parser().parse_args(args)))
        trainer.train_loader.set_epoch(1)
        out = []
        for s, batch in zip(range(steps), trainer.train_loader.epoch_batches()):
            trainer.state.model.load_state_dict(states[s])
            trainer.state, m = trainer.train_step(trainer.state, trainer.to_device(batch))
            out.append(float(m["loss"]))
        trainer.close()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def check_gspmd_run(label, metrics, same, base, flash, smi, same_state=None):
    """One phase-26 GSPMD run against its one-rank baseline ``base``: the
    first losses within ``FULL_STEPS_RTOL`` (with ``same_state``, the
    ``--save-states`` file of a run whose trajectory leaves one rank's by
    more in a few steps, each step taken from the same state:
    ``same_state_losses``), the launches, replicas (the gathered model
    state) bitwise; prints ms a step, the bytes held and the peak memory a
    rank against the baseline's."""
    m = metrics[0]
    if same_state:
        rel = rel_diffs(m["step_losses"], base["step_losses"])
        print(f"  26 {label}: along the two trajectories, relative loss differences "
              f"{' '.join(f'{x:.3g}' for x in rel)}", flush=True)
        first_losses_close(f"26 {label} vs one rank's whole model from the same state each "
                           "step", m["step_losses"], same_state_losses(same_state, gspmd_args(None, "cnn")),
                           FULL_STEPS_RTOL)
    else:
        first_losses_close(f"26 {label} vs one rank's whole model", m["step_losses"],
                           base["step_losses"], FULL_STEPS_RTOL)
    print(f"  26 {label} ({smi}): {m['steps']} steps; launches on rank 0 {m['launches']}; "
          f"replicas bitwise {same}; steady ms a step a rank "
          + " / ".join(f"{x['steady_step_ms']:.3f}" for x in metrics)
          + f" (one rank {base['steady_step_ms']:.3f}); param bytes a rank "
          + " / ".join(str(x["param_bytes"]) for x in metrics)
          + f" (one rank {base['param_bytes']}); optimizer bytes a rank "
          + " / ".join(str(x["opt_bytes"]) for x in metrics)
          + f" (one rank {base['opt_bytes']}); peak memory a rank "
          + " / ".join(str(x["peak_memory"]) for x in metrics)
          + f" B (one rank {base['peak_memory']} B); final test accuracy "
          f"{m.get('test_accuracy')}", flush=True)
    for r, x in enumerate(metrics):
        want = gspmd_launches(x, x["steps"], flash)
        if x["launches"] != want:
            fail(f"26 {label} rank {r}: launches {x['launches']}, expected {want}")
    if not same or not all(math.isfinite(v) for v in m["step_losses"]):
        fail(f"26 {label}: replicas differ or a loss is not finite")


def phase_gspmd(tmp, smi, base=None, nproc=4, backend="gloo", shared=None):
    """Phase 26: (a) ViT-S/4 ``--parallelism sp --mesh data=2,sequence=2
    --sp-flash --kernels`` replicated, with ``--zero1`` and with
    ``--grad-compress int8 --grad-compress-error-feedback``, then the
    LM-32k SP step with and without ``--zero1`` (``sp_lm_zero1_runs``); (b)
    ViT-S/4 at full width under ``--parallelism tp --attention flash
    --kernels`` at model=2 (data=2; 2 heads and 1 a rank) and model=3
    (data=1; 1 head a rank); (c) NetResDeep at full width under ``tp --mesh
    data=2,model=2``, ViT-S/4 under ``fsdp`` (data=2) and ``fsdp_tp``
    (data=2, model=2). The ranks share the card over gloo (or have a card
    each under ``--nccl``: the 4-rank job alone); ``base``: the one-rank
    baselines ``{"vit", "cnn"}`` (``gspmd_one_rank``), None under
    ``--nccl``. ``shared``: the results of ``tp_vit_m3`` and ``fsdp_vit``
    from the jobs of other phases they rode (``gspmd_shared_runs``: the
    whole smoke runs them in phase 14's three-rank job and phase 27's
    two-rank job); without them, and with ``base``, they run in a three-
    and a two-rank job of their own."""
    phase_flash_vs_plain(TP_FLASH_CASES, "phase 26 (tensor-parallel ranks' heads)")
    sp = lambda *extra: sp_vit_args(nproc, backend, 2, *extra, steps=GSPMD_STEPS)  # noqa: E731
    jobs = {nproc: [("sp_replicated", sp()), ("sp_zero1", sp("--zero1")),
                    ("sp_int8", sp("--grad-compress", "int8",
                                   "--grad-compress-error-feedback")),
                    ("tp_vit_m2", gspmd_args(backend, "vit", "tp", "data=2,model=2")),
                    ("fsdp_tp_vit", gspmd_args(backend, "vit", "fsdp_tp", "data=2,model=2")),
                    ("tp_cnn", gspmd_args(backend, "cnn", "tp", "data=2,model=2"))]}
    if base is not None and shared is None:
        jobs.update({n: [run] for n, run in gspmd_shared_runs(backend).items()})
    runs = dict(shared or {})
    for n, job in jobs.items():
        extra = (["--then-sp-lm-zero1", "2", "--save-states", "tp_cnn"] if n == nproc
                 else [])
        runs.update(launch_dp_runs(os.path.join(tmp, f"gspmd{n}"), job, n, phase="26",
                                   deterministic=True, extra=extra))
    # (a) the overlays
    for name in ("sp_replicated", "sp_zero1", "sp_int8"):
        metrics, same = runs[name]
        steps = metrics[0]["steps"]
        want = {k: 0 for k in metrics[0]["launches"]}
        want["fused_update"] = steps
        for kind in ("fwd", "dq", "dkv"):
            want[f"flash_attention_{kind}"] = VIT_DEPTH * (nproc // 2) * steps
        if name == "sp_int8":
            want.update({k: v * steps for k, v in dp_launches(2).items() if k != "fused_update"})
        print(f"phase 26a {name} ({smi}): {steps} steps on {nproc} ranks over {backend} "
              f"(data=2, sequence={nproc // 2}); launches on rank 0 {metrics[0]['launches']}; "
              f"replicas bitwise {same}; steady ms a step a rank "
              + " / ".join(f"{m['steady_step_ms']:.3f}" for m in metrics)
              + "; optimizer bytes a rank " + " / ".join(str(m["opt_bytes"]) for m in metrics)
              + "; peak memory a rank " + " / ".join(str(m["peak_memory"]) for m in metrics)
              + " B", flush=True)
        for r, m in enumerate(metrics):
            if m["launches"] != want:
                fail(f"26a {name} rank {r}: launches {m['launches']}, expected {want}")
        if not same or not all(math.isfinite(x) for x in metrics[0]["step_losses"]):
            fail(f"26a {name}: replicas differ or a loss is not finite")
    replicated = runs["sp_replicated"][0][0]["step_losses"]
    first_losses_close("26a sp --zero1 vs replicated sp", runs["sp_zero1"][0][0]["step_losses"],
                       replicated, FULL_STEPS_RTOL)
    diff = max(abs(a - b) for a, b in zip(runs["sp_int8"][0][0]["step_losses"], replicated))
    print(f"  26a sp int8 + error feedback vs replicated sp: max |loss diff| {diff:.4g} "
          f"(limit {DP_LOSS_ATOL})", flush=True)
    if not diff <= DP_LOSS_ATOL:
        fail("26a: sp with the int8 ring leaves the float32 run's band")
    lm = []
    for r in range(nproc):
        with open(os.path.join(tmp, f"gspmd{nproc}", "sp_lm_zero1", f"rank{r}.json")) as f:
            lm.append(json.load(f))
    for name in ("replicated", "zero1"):
        for r, res in enumerate(lm):
            want = {k: 0 for k in res[name]["launches"]}
            want["fused_update"] = SP_LM_ZERO1_STEPS
            for kind in ("fwd", "dq", "dkv"):
                want[f"flash_attention_{kind}"] = (SP_LM_ZERO1_DEPTH * (r % (nproc // 2) + 1)
                                                   * SP_LM_ZERO1_STEPS)
            if res[name]["launches"] != want:
                fail(f"26a LM {name} rank {r}: launches {res[name]['launches']}, "
                     f"expected {want}")
        if len({res[name]["digest"] for res in lm}) != 1:
            fail(f"26a LM {name}: the ranks end with different params")
        print(f"  26a LM-32k at depth {SP_LM_ZERO1_DEPTH} {name}: launches on rank 0 "
              f"{lm[0][name]['launches']}; losses {lm[0][name]['losses']}", flush=True)
    first_losses_close("26a LM --zero1 vs replicated", lm[0]["zero1"]["losses"],
                       lm[0]["replicated"]["losses"], FULL_STEPS_RTOL)
    # (b), (c) the GSPMD families
    if base is None:
        for name in ("tp_vit_m2", "fsdp_tp_vit", "tp_cnn"):
            metrics, same = runs[name]
            for r, x in enumerate(metrics):
                want = gspmd_launches(x, x["steps"], name != "tp_cnn")
                if x["launches"] != want:
                    fail(f"26 {name} rank {r}: launches {x['launches']}, expected {want}")
            print(f"  26 {name} over {backend}: launches on rank 0 {metrics[0]['launches']}; "
                  f"replicas bitwise {same}; steady ms a step a rank "
                  + " / ".join(f"{x['steady_step_ms']:.3f}" for x in metrics), flush=True)
            if not same:
                fail(f"26 {name}: replicas differ")
        return runs
    for name, label in (("tp_vit_m2", "b ViT-S/4 tp data=2 model=2 (heads 2 + 1)"),
                        ("tp_vit_m3", "b ViT-S/4 tp data=1 model=3 (1 head a rank)"),
                        ("tp_cnn", "c NetResDeep tp data=2 model=2"),
                        ("fsdp_vit", "c ViT-S/4 fsdp data=2"),
                        ("fsdp_tp_vit", "c ViT-S/4 fsdp_tp data=2 model=2")):
        check_gspmd_run(label, *runs[name], base["cnn" if name == "tp_cnn" else "vit"],
                        name != "tp_cnn", smi, same_state=name == "tp_cnn" and os.path.join(
                            tmp, f"gspmd{nproc}", name, "states.pt"))
    return runs


def gspmd_shared_runs(backend="gloo"):
    """``{ranks: (name, args)}``: phase 26's runs at three and two ranks
    (``phase_gspmd``'s ``shared``)."""
    return {3: ("tp_vit_m3", gspmd_args(backend, "vit", "tp", "data=1,model=3")),
            2: ("fsdp_vit", gspmd_args(backend, "vit", "fsdp", "data=2"))}


def run_phase26(smi, shared=None):
    """Phase 26 on one card: the one-rank baselines, then ``phase_gspmd``
    (``shared``: its runs that rode other phases' jobs)."""
    import shutil
    import tempfile

    import torch

    t26 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        base26 = {"vit": gspmd_one_rank("vit"), "cnn": gspmd_one_rank("cnn")}
    finally:
        torch.backends.cudnn.deterministic = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_gspmd(tmp, smi, base26, shared=shared)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 26 took {time.perf_counter() - t26:.1f} s", flush=True)


def phase26_main(nproc=None):
    """``python3 chip_smoke.py --phase 26``: phase 26 alone on one card (the
    kernels built, then ``run_phase26``), or with ``nproc`` (``--nccl N
    --phase 26``) its N-rank job alone on N cards over NCCL; for phase 26's
    readings, which the whole smoke prints too."""
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if nproc is not None and torch.cuda.device_count() < nproc:
        fail(f"--nccl {nproc} needs {nproc} cards, {torch.cuda.device_count()} visible")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    if nproc is None:
        run_phase26(smi)
    else:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
        try:
            phase_gspmd(tmp, smi, None, nproc, "nccl")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke --phase 26: ok ({smi})", flush=True)

#: phase 27: the pp runs' steps an epoch (two epochs at batch PP_BATCH: the
#: second is the steady one), microbatches and the microbatch attention
#: shape; the MoE runs' steps an epoch; the experts of vit_moe_s4 (3 MoE
#: layers of 8 experts, hidden 192, MLP 768)
PP_STEPS, PP_BATCH, PP_MICRO = 6, 32, 4
PP_FLASH_CASES = {"pp_micro": (PP_BATCH // PP_MICRO, 64, 3, 64, False, None, True)}
PP_BLOCKS = VIT_DEPTH // 2                # a stage's blocks at pipeline=2
#: the schedule line's bubble and in-flight count at 2 stages and 4 micros
PP_LINES = {"gpipe": "bubble=20.0% in-flight=4", "1f1b": "bubble=33.3% in-flight=3"}
MOE_STEPS = 16
EP_STEPS = 6
MOE_LEAVES = 85
MOE_EXPERT_PARAMS = 3 * 8 * (2 * 192 * 768 + 768 + 192)


def pp_args(schedule, backend="gloo", one_rank=False, nproc=2):
    """A phase-27a run: ViT-S/4 ``--attention flash --kernels`` AdamW, two
    epochs of ``PP_STEPS`` steps at the global batch ``PP_BATCH``, under pp
    ``schedule`` on ``data=nproc/2,pipeline=2`` (``one_rank``: the whole
    model on one rank, the same batches)."""
    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size",
            str(PP_BATCH * PP_STEPS), "--epochs", "2", "--model", "vit_s4",
            "--attention", "flash", "--kernels", "--optimizer", "adamw", "--lr", "1e-3",
            "--global-batch-size", str(PP_BATCH), "--log-every-epochs", "1"]
    if one_rank:
        return args
    return args + ["--dist-backend", backend, "--parallelism", "pp", "--mesh",
                   f"data={nproc // 2},pipeline=2", "--microbatches", str(PP_MICRO),
                   "--pp-schedule", schedule]


def moe_args(model, steps, parallelism=None, backend="gloo", nproc=2):
    """A phase-27 MoE run: ``model`` at full width, ``--kernels`` AdamW, two
    epochs of ``steps`` steps at batch 32, on one rank or under
    ``parallelism`` ep on ``data=1,expert=nproc``."""
    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * steps),
            "--epochs", "2", "--model", model, "--kernels", "--optimizer", "adamw",
            "--lr", "1e-3", "--global-batch-size", "32", "--log-every-epochs", "1"]
    if parallelism:
        args += ["--dist-backend", backend, "--parallelism", parallelism, "--mesh",
                 f"data=1,expert={nproc}"]
    return args


def pp_launches(schedule, m):
    """K1 and K4-K6 launches a pp rank makes in a phase-27a run: a step K1
    once, K4, K5 and K6 once a stage block and microbatch (K4 twice under
    1f1b: forward and recompute); the final evaluation K4 once a block of
    the plain module and a test batch."""
    steps, evals = m["steps"], m["eval_batches"]
    per = PP_BLOCKS * PP_MICRO * steps
    want = {k: 0 for k in m["launches"]}
    want.update({"fused_update": steps,
                 "flash_attention_fwd": (2 if schedule == "1f1b" else 1) * per
                 + VIT_DEPTH * evals,
                 "flash_attention_dq": per, "flash_attention_dkv": per})
    return want


def moe_one_rank(model, smi):
    """Phase 27b's run of ``model`` on one rank in this process: losses
    finite and falling, ``aux_loss`` at least 1 - 1e-5 every step, K1 once a
    step; returns its metrics and held bytes."""
    import torch

    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.train.trainer import Trainer

    ns = cli.build_parser().parse_args(moe_args(model, MOE_STEPS))
    config = cli.config_from_args(ns)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    trainer = Trainer(config)
    aux, inner = [], trainer.train_step

    def step(state, batch):
        state, metrics = inner(state, batch)
        aux.append(metrics["aux_loss"])
        return state, metrics

    trainer.train_step = step
    try:
        metrics = cli._run_and_report(ns, config, trainer)
    finally:
        trainer.close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    aux = [float(a) for a in aux]
    losses = metrics["step_losses"]
    first, last = sum(losses[:8]) / 8, sum(losses[-8:]) / 8
    print(f"  27b {model} ({smi}): {metrics['steps']} steps; launches {counts}; mean loss "
          f"of the first 8 steps {first:.4f}, last 8 {last:.4f}; aux_loss min "
          f"{min(aux):.6f} max {max(aux):.6f}; steady ms a step "
          f"{metrics['steady_step_ms']:.3f}; final test accuracy "
          f"{metrics['test_accuracy']:.4f}", flush=True)
    want = {k: 0 for k in counts}
    want["fused_update"] = metrics["steps"]
    if counts != want:
        fail(f"27b {model}: launches {counts}, expected {want}")
    if metrics["steps"] != 2 * MOE_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"27b {model}: {metrics['steps']} steps or a non-finite loss")
    if not last < first:
        fail(f"27b {model}: the losses did not fall")
    if len(aux) != 2 * MOE_STEPS or not min(aux) >= 1.0 - 1e-5:
        fail(f"27b {model}: aux_loss below 1 - 1e-5 or missing: {aux}")
    metrics.update(held_bytes(trainer))
    return metrics


def pp_ep_job(tmp, backend="gloo", nproc=2, more=()):
    """Phase 27a's and 27c's runs (and the ``more`` runs of other phases)
    in one job into ``tmp/pp`` (one process start); returns
    ``launch_dp_runs``' results."""
    return launch_dp_runs(
        os.path.join(tmp, "pp"), [(f"pp_{sched}", pp_args(sched, backend, nproc=nproc))
                                  for sched in ("gpipe", "1f1b")]
        + [("ep", moe_args("vit_moe_s4", EP_STEPS, "ep", backend, nproc))] + list(more),
        nproc, phase="27a, 27c" + (" and 26" if more else ""), deterministic=True,
        extra=["--save-states", "pp_gpipe,pp_1f1b,ep"])


def phase_pp_ep(tmp, smi, backend="gloo", nproc=2, runs=None):
    """Phase 27 (module docstring): (a) pp, (b) the MoE ViT on one rank,
    (c) ep. At ``nproc`` ranks other than two (``--nccl N --phase 27``) the
    job alone: pp on ``data=N/2,pipeline=2`` and ep on ``data=1,expert=N``,
    without (b) and the kernel checks. ``runs``: ``pp_ep_job``'s results
    when the job ran already (into ``tmp``)."""
    import torch

    if nproc == 2:
        phase_flash_vs_plain(PP_FLASH_CASES, "phase 27a (pp microbatch)")
    if runs is None:
        runs = pp_ep_job(tmp, backend, nproc)
    one = {}
    for sched in ("gpipe", "1f1b"):
        metrics, same = runs[f"pp_{sched}"]
        m = metrics[0]
        line = m["strategy_line"]
        print(f"  27a pp {sched} ({smi}, {nproc} ranks over {backend}): {m['steps']} steps; "
              f"launches on rank 0 {m['launches']}, rank 1 {metrics[1]['launches']}; "
              f"eval batches "
              f"{m['eval_batches']}; gathered params bitwise on every rank {same}; steady "
              f"ms a step a rank " + " / ".join(f"{x['steady_step_ms']:.3f}" for x in metrics)
              + f"; peak memory a rank " + " / ".join(str(x["peak_memory"]) for x in metrics)
              + f" B; final test accuracy {m['test_accuracy']:.4f}; printed: {line}",
              flush=True)
        want_line = PP_LINES[sched]
        if want_line not in (line or ""):
            fail(f"27a pp {sched}: printed {line!r}, expected {want_line!r}")
        for r, x in enumerate(metrics):
            want = pp_launches(sched, x)
            if x["launches"] != want:
                fail(f"27a pp {sched} rank {r}: launches {x['launches']}, expected {want}")
        if (not same or m["steps"] != 2 * PP_STEPS
                or not all(math.isfinite(v) for v in m["step_losses"])):
            fail(f"27a pp {sched}: ranks differ, wrong step count or a non-finite loss")
        one[sched] = same_state_losses(os.path.join(tmp, "pp", f"pp_{sched}", "states.pt"),
                                       pp_args(sched, one_rank=True), PP_STEPS)
        first_losses_close(f"27a pp {sched} vs one rank's whole model from the same state "
                           "each step", m["step_losses"], one[sched], FULL_STEPS_RTOL)
    gp, ob = runs["pp_gpipe"][0][0]["step_losses"], runs["pp_1f1b"][0][0]["step_losses"]
    diff = max(abs(a - b) for a, b in zip(gp, ob))
    print(f"  27a gpipe vs 1f1b: max |loss diff| over {len(gp)} steps {diff:.3g} "
          "(limit 1e-5)", flush=True)
    if not diff <= 1e-5:
        fail("27a: the two schedules' losses differ by more than 1e-5")
    stamp("phase 27a")
    # (b) K1 at the MoE ViT's leaves, then the two MoE models on one rank
    from tpu_ddp_torch.models import MODEL_REGISTRY

    shapes = [tuple(p.shape) for p in MODEL_REGISTRY["vit_moe_s4"]().parameters()]
    if len(shapes) != MOE_LEAVES:
        fail(f"vit_moe_s4 has {len(shapes)} parameter leaves, expected {MOE_LEAVES}")
    if nproc != 2:
        base = {"vit_moe_s4": {"param_bytes": 4 * sum(math.prod(sh) for sh in shapes)}}
        return runs, base, ep_check(runs, base, smi, nproc, backend, tmp)
    gen = torch.Generator(device="cuda").manual_seed(27)
    for variant in ("adamw", "adamw_wd_clip_ema"):
        leaves = [Leaf(sh, leaf_config(variant, "constant", len(sh) >= 2), gen)
                  for sh in shapes]
        err, ulp, launches = compare(leaves, scalars_for(leaves, leaves[0].cfg, "constant"))
        print(f"  27b K1 {variant} at vit_moe_s4's {len(shapes)} leaves: max|diff|={err:.3g} "
              f"max_ulp={ulp} launches={launches}", flush=True)
        if ulp or launches != 1:
            fail(f"27b K1 {variant}: {ulp} ulp from the plain version, {launches} launches")
        del leaves
    base = {m: moe_one_rank(m, smi) for m in ("vit_moe_s4", "vit_moe_s4_top2")}
    stamp("phase 27b")
    # (c) ep on two ranks, run in 27a's job
    return runs, base, ep_check(runs, base, smi, nproc, backend, tmp)


def ep_check(runs, base, smi, nproc, backend, tmp):
    """Phase 27c's checks of the ep run of ``runs`` (the job in ``tmp``) at
    ``nproc`` ranks: launches, each rank's experts' bytes, replicas and
    losses held to one rank's from the same states. Returns every rank's
    metrics."""
    metrics, same = runs["ep"]
    m = metrics[0]
    whole = base["vit_moe_s4"]["param_bytes"]
    held = [x["param_bytes"] for x in metrics]
    less = 4 * MOE_EXPERT_PARAMS * (nproc - 1) // nproc
    print(f"  27c ep ({smi}, {nproc} ranks over {backend}): {m['steps']} steps; launches "
          f"on rank 0 {m['launches']}; gathered params bitwise on every rank {same}; steady "
          f"ms a step a rank " + " / ".join(f"{x['steady_step_ms']:.3f}" for x in metrics)
          + (f" (one rank {base['vit_moe_s4']['steady_step_ms']:.3f})" if nproc == 2 else "")
          + "; param bytes a rank "
          + " / ".join(str(h) for h in held) + f" (one rank {whole}: {MOE_EXPERT_PARAMS} "
          f"expert parameters, {MOE_EXPERT_PARAMS // nproc} a rank, {less} B less); peak "
          "memory a rank " + " / ".join(str(x["peak_memory"]) for x in metrics) + " B",
          flush=True)
    for r, x in enumerate(metrics):
        want = {k: 0 for k in x["launches"]}
        want["fused_update"] = x["steps"]
        if x["launches"] != want:
            fail(f"27c ep rank {r}: launches {x['launches']}, expected {want}")
    if any(h != whole - less for h in held):
        fail(f"27c ep: a rank holds {held} param bytes, expected {whole - less}")
    if not same or not all(math.isfinite(v) for v in m["step_losses"]):
        fail("27c ep: the ranks differ or a loss is not finite")
    first_losses_close("27c ep vs one rank's whole model from the same state each step",
                       m["step_losses"], same_state_losses(
                           os.path.join(tmp, "pp", "ep", "states.pt"),
                           moe_args("vit_moe_s4", EP_STEPS), EP_STEPS), FULL_STEPS_RTOL)
    return metrics


def run_phase27(smi, tmp=None, runs=None):
    """Phase 27 on one card (``phase_pp_ep``), in a scratch directory, or
    on ``pp_ep_job``'s ``runs`` already in ``tmp``."""
    import shutil
    import tempfile

    t27 = time.perf_counter()
    if tmp is not None:
        phase_pp_ep(tmp, smi, runs=runs)
    else:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
        try:
            phase_pp_ep(tmp, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 27 took {time.perf_counter() - t27:.1f} s", flush=True)


def phase27_main():
    """``python3 chip_smoke.py --phase 27``: the kernels built, then phase 27
    alone on one card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    run_phase27(smi)
    print(f"chip_smoke --phase 27: ok ({smi})", flush=True)


#: phase 28: NetResDeep's steps an epoch (two epochs at batch 32), ViT-S/4's,
#: and the two-rank job's
TEL_STEPS, TEL_VIT_STEPS, TEL_RANK_STEPS = 20, 8, 4
STEP_PHASES = ("data_wait", "compiled_step", "device_sync")


def tel_args(model, steps, run_dir=None, *extra):
    """A phase-28 run: NetResDeep at full width or ViT-S/4 ``--attention
    flash`` (AdamW), ``--kernels``, two epochs of ``steps`` steps at batch
    32; with ``run_dir`` under ``--telemetry-dir`` (the default sinks) and
    ``--watchdog-deadline 300``."""
    args = ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * steps),
            "--epochs", "2", "--kernels", "--batch-size", "32", "--log-every-epochs", "1",
            *extra]
    if model == "vit_s4":
        args += ["--model", "vit_s4", "--attention", "flash", "--optimizer", "adamw",
                 "--lr", "1e-3"]
    if run_dir:
        args += ["--telemetry-dir", run_dir, "--watchdog-deadline", "300"]
    return args


def traced_run(args):
    """``counted_run`` with the process-wide telemetry registry reset first
    and ``torch.cuda.max_memory_allocated()`` read just after each epoch's
    telemetry (``metrics["peaks"]``: what the memory gauges saw)."""
    import torch

    from tpu_ddp_torch.telemetry import reset_default_registry
    from tpu_ddp_torch.train.trainer import Trainer

    reset_default_registry()
    peaks, traced = [], Trainer._traced_epoch

    def traced_epoch(self, *a):
        traced(self, *a)
        peaks.append(torch.cuda.max_memory_allocated())

    Trainer._traced_epoch = traced_epoch
    try:
        trainer, metrics = counted_run(args)
    finally:
        Trainer._traced_epoch = traced
    metrics["peaks"] = peaks
    return trainer, metrics


def trace_records(run_dir, rank=0):
    with open(os.path.join(run_dir, f"trace-p{rank}.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_traced(label, run_dir, metrics, plain, smi):
    """Phase 28a's checks of a traced run against the same run without
    telemetry (``plain``)."""
    records = trace_records(run_dir)
    steps = metrics["steps"]
    by_step = {}
    for r in records:
        if r["type"] == "span" and r["name"] in STEP_PHASES:
            by_step.setdefault(r["step"], set()).add(r["name"])
    full = sorted(s for s, names in by_step.items() if names == set(STEP_PHASES))
    final = records[-1]["attrs"]
    counters, gauges = final["counters"], final["gauges"]
    with open(os.path.join(run_dir, "trace-p0.trace.json")) as f:
        chrome = json.load(f)["traceEvents"]
    with open(os.path.join(run_dir, "heartbeat-p0.json")) as f:
        beat = json.load(f)["step"]
    with open(os.path.join(run_dir, "data-p0.jsonl")) as f:
        digests = [json.loads(line) for line in f][1:]
    print(f"  28a {label} ({smi}): {steps} steps, {len(full)} with all of {STEP_PHASES}; "
          f"train/steps {counters.get('train/steps')}; launches {metrics['launches']} "
          f"(without telemetry {plain['launches']}); losses bitwise the run's without "
          f"telemetry {metrics['step_losses'] == plain['step_losses']}; chrome events "
          f"{len(chrome)}; heartbeat step {beat}; memory/high_water_bytes "
          f"{gauges.get('memory/high_water_bytes')} (max_memory_allocated at the gauge "
          f"{metrics['peaks'][-1] if metrics['peaks'] else None}); train/mfu "
          f"{gauges.get('train/mfu')}; digests {len(digests)}", flush=True)
    if full != list(range(steps)) or counters.get("train/steps") != steps:
        fail(f"28a {label}: steps without the three phases, or train/steps "
             f"{counters.get('train/steps')} != {steps}")
    if metrics["launches"] != plain["launches"] or metrics["launches"]["fused_update"] != steps:
        fail(f"28a {label}: launches {metrics['launches']}, without telemetry "
             f"{plain['launches']}")
    if metrics["step_losses"] != plain["step_losses"]:
        fail(f"28a {label}: the losses differ from the run's without telemetry")
    if not {e["name"] for e in chrome if e.get("ph") == "X"} >= set(STEP_PHASES):
        fail(f"28a {label}: the Chrome trace lacks the step phases")
    if beat != steps:
        fail(f"28a {label}: the heartbeat's step is {beat}, expected {steps}")
    if not metrics["peaks"] or gauges.get("memory/high_water_bytes") != metrics["peaks"][-1]:
        fail(f"28a {label}: memory/high_water_bytes {gauges.get('memory/high_water_bytes')} "
             f"!= max_memory_allocated {metrics['peaks']}")
    mfu = gauges.get("train/mfu")
    if mfu is None or not 0 < mfu < 1 or mfu != metrics["mfu"]:
        fail(f"28a {label}: train/mfu {mfu} (metrics {metrics['mfu']}) outside (0, 1)")
    if [d["step"] for d in digests] != list(range(steps)):
        fail(f"28a {label}: digest steps {[d['step'] for d in digests]}")


#: phase 28's arms, in turns: no telemetry, telemetry, telemetry without digests
TEL_ARMS = ("off", "on", "nodig")


def tel_arm_args(model, steps, tmp, i, arm):
    """Run ``i`` of phase 28's turns in ``arm`` (``TEL_ARMS``)."""
    if arm == "off":
        return tel_args(model, steps)
    extra = ["--no-data-digests"] if arm == "nodig" else []
    return tel_args(model, steps, os.path.join(tmp, f"{model}{i}"), *extra)


def check_arms(label, runs, losses=True):
    """Every run's launches and (with ``losses``) losses, to the bit, are
    the first untraced run's, and a digest-free run writes no digest
    file."""
    plain = runs[0][1]
    for arm, m, run_dir in runs:
        if m["launches"] != plain["launches"] or (
                losses and m["step_losses"] != plain["step_losses"]):
            fail(f"28 {label} {arm}: launches {m['launches']} or losses differ from the "
                 f"run's without telemetry ({plain['launches']})")
        if arm == "nodig" and os.path.exists(os.path.join(run_dir, "data-p0.jsonl")):
            fail(f"28 {label}: --no-data-digests wrote data-p0.jsonl")


def fence_cost(label, runs, smi):
    """The steady ms a step of ``runs`` (``TEL_ARMS`` in turns) and the
    differences of the arms' means: all of telemetry, the part the digests
    add, and the rest (spans, counters, the ``device_sync`` fence)."""
    ms = {arm: [m["steady_step_ms"] for k, m, *_ in runs if k == arm] for arm in TEL_ARMS}
    mean = {arm: sum(v) / len(v) for arm, v in ms.items()}
    print(f"  28 telemetry cost, {label} ({smi}): steady ms a step "
          + "; ".join(f"{arm} " + " / ".join(f"{x:.4f}" for x in v) for arm, v in ms.items())
          + f": telemetry {mean['on'] - mean['off']:+.4f} ms a step, of which digests "
          f"{mean['on'] - mean['nodig']:+.4f} and spans, counters and fence "
          f"{mean['nodig'] - mean['off']:+.4f}", flush=True)


def digest_cost(smi, reps=50):
    """Host ms of a NetResDeep batch's digest (32 rows of 32x32x3 float32),
    medians of ``reps``: ``batch_digest`` in Python (what the training
    thread pays on the synchronous and staged paths); the native ring's
    submit to acquire without and with the rows' digests (the gather
    thread's C++ hash between them); and ``xor_row_digests`` of the row
    digests (what the training thread pays on the native ring)."""
    import statistics

    import numpy as np

    from tpu_ddp_torch.datapath.audit import batch_digest, xor_row_digests
    from tpu_ddp_torch.native.prefetch import BatchPrefetcher

    rng = np.random.default_rng(28)
    images = rng.standard_normal((4096, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4096).astype(np.int32)
    mask = np.ones(32, bool)

    def median_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    idx = rng.integers(0, 4096, 32)
    py = median_ms(lambda: batch_digest(images[idx], labels[idx], mask))
    ring = {}
    for seed in (None, 0):
        with BatchPrefetcher(images, labels, max_batch=32, depth=2, digest_seed=seed) as pf:
            def one():
                pf.submit(rng.integers(0, 4096, 32))
                slot = pf.acquire()[2]
                if seed is not None:
                    ring["rows"] = pf.row_digests(slot, 32).copy()
                pf.release(slot)
            ring[seed] = median_ms(one)
    fold = median_ms(lambda: xor_row_digests(ring["rows"], mask))
    print(f"  28 digest cost ({smi}): one batch's digest in Python {py:.4f} ms; the native "
          f"ring's gather {ring[None]:.4f} ms, with the rows' digests {ring[0]:.4f} ms; the "
          f"training thread's fold of the row digests {fold:.4f} ms (medians of {reps})",
          flush=True)


def phase_telemetry(tmp, smi):
    """Phase 28 (module docstring): (a) NetResDeep traced against untraced,
    in turns, under deterministic cuDNN; (b) ViT-S/4 flash; (c) two gloo
    ranks with the int8 ring and a counting hop hook."""
    import torch

    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for i, arm in enumerate(TEL_ARMS * 2):
            args = tel_arm_args("netresdeep", TEL_STEPS, tmp, i, arm)
            if i == 1:
                print(f"phase 28a: tpu_ddp_torch.cli.train {' '.join(args)}", flush=True)
            runs.append((arm, traced_run(args)[1], args[args.index("--telemetry-dir") + 1]
                         if arm != "off" else None))
    finally:
        torch.backends.cudnn.deterministic = False
    check_arms("NetResDeep", runs)
    for arm, traced, run_dir in runs:
        if arm == "on":
            check_traced("NetResDeep", run_dir, traced, runs[0][1], smi)
    print(f"  28a NetResDeep MFU ({smi}): " + " / ".join(
        f"{m['mfu']:.6f}" for k, m, _ in runs if k != "off"), flush=True)
    fence_cost("NetResDeep batch 32", runs, smi)
    digest_cost(smi)
    stamp("phase 28a")
    vit = []
    for i, arm in enumerate(TEL_ARMS * 2):
        args = tel_arm_args("vit_s4", TEL_VIT_STEPS, tmp, i, arm)
        vit.append((arm, traced_run(args)[1], args[args.index("--telemetry-dir") + 1]
                    if arm != "off" else None))
    # K5's dQ accumulates with atomics: the ViT's losses are not bitwise
    check_arms("ViT-S/4", vit, losses=False)
    for arm, traced, _ in vit:
        if not traced["launches"]["flash_attention_fwd"]:
            fail(f"28b ViT-S/4 {arm}: launches {traced['launches']}")
        if arm != "off" and (traced["mfu"] is None or not 0 < traced["mfu"] < 1):
            fail(f"28b ViT-S/4: mfu {traced['mfu']}")
    print(f"  28b ViT-S/4 flash ({smi}): launches {vit[1][1]['launches']} in every arm; MFU "
          + " / ".join(f"{m['mfu']:.6f}" for k, m, _ in vit if k != "off"), flush=True)
    fence_cost("ViT-S/4 flash batch 32", vit, smi)
    stamp("phase 28b")
    tel_ranks(tmp, smi, with31=True)
    return runs, vit


def tel_rank_args(run_dir):
    """Phase 28c's run: two gloo ranks, NetResDeep at full width, the int8
    ring, ``TEL_RANK_STEPS`` steps an epoch, traced into ``run_dir``."""
    return ["--device", "cuda", "--dist-backend", "gloo", "--synthetic-data",
            "--synthetic-size", str(2 * 32 * TEL_RANK_STEPS), "--epochs", "2", "--kernels",
            "--batch-size", "32", "--grad-compress", "int8", "--log-every-epochs", "1",
            "--telemetry-dir", run_dir]


def tel_ranks(tmp, smi, with31=False):
    """Phase 28c (module docstring) and its observatory checks, 30c: each
    rank's ``exporter-p<rank>.json`` on its own port, and ``watch --once
    --json`` over the run dir with both ranks. With ``with31``, phase 31's
    (a) and (b) ride the same job (``phase31_runs``) and are checked after
    28c (``phase31_checks``)."""
    from tpu_ddp_torch.parallel.compression import chunk_wire_bytes

    # (c) two gloo ranks, the int8 ring with a counting hop hook in each,
    # under deterministic cuDNN (phase 31a's losses are held to this run's)
    run_dir = os.path.join(tmp, "ranks")
    args = tel_rank_args(run_dir) + ["--monitor-port", "-1", "--monitor-bind", "127.0.0.1"]
    more = phase31_runs(tmp) if with31 else []
    t0 = time.perf_counter()
    jobs = launch_dp_runs(tmp, [("tel_ranks", args, ["--deterministic", "--hop-hook"])]
                          + more, 2, phase="28c" + (" and 31" if with31 else ""))
    job_s = time.perf_counter() - t0
    metrics, same = jobs["tel_ranks"]
    n = 2
    msg = sum(chunk_wire_bytes((math.prod(sh) + (-math.prod(sh)) % n) // n, "int8", 256)
              for sh in NETRESDEEP_LEAVES)
    for r, m in enumerate(metrics):
        steps, calls = m["steps"], m["hop_calls"]
        want = [("ring-all-reduce", "s8", hop, n, msg if hop < n else (n - 1) * msg)
                for _ in range(steps) for hop in range(1, n + 1)]
        print(f"  28c rank {r} ({smi}): {steps} steps, {len(calls)} hop calls ({n} a step), "
              f"wire bytes {sorted({c[4] for c in calls})} (a hop's message {msg} B); "
              f"launches {m['launches']}; summary sink {m['summary_sink']}", flush=True)
        if [tuple(c) for c in calls] != want:
            fail(f"28c rank {r}: hop calls {calls[:4]}..., expected {want[:4]}...")
        if m["launches"] != {**{k: 0 for k in m["launches"]}, "fused_update": steps,
                             "fused_quant": n * steps, "fused_dequant": n * steps}:
            fail(f"28c rank {r}: launches {m['launches']}")
        if m["summary_sink"] != (r == 0):
            fail(f"28c rank {r}: summary sink {m['summary_sink']}")
        if not os.path.isfile(os.path.join(run_dir, f"trace-p{r}.jsonl")):
            fail(f"28c: no trace-p{r}.jsonl")
    if not same:
        fail("28c: the ranks' weights differ")
    ports = []
    for r in range(n):
        with open(os.path.join(run_dir, f"exporter-p{r}.json")) as f:
            ports.append(json.load(f)["port"])
    rc, text, _ = read_back(["watch", run_dir, "--once", "--json"])
    hosts = [h["host"] for h in json.loads(text)["snapshot"]["hosts"]] if rc in (0, 1) else None
    print(f"  30c ({smi}): exporter ports {ports}; watch --once exit {rc}, hosts {hosts}",
          flush=True)
    if len(set(ports)) != n or rc or hosts != list(range(n)):
        fail(f"30c: exporter ports {ports}, watch exit {rc} over hosts {hosts}")
    if with31:
        phase31_checks(tmp, smi, jobs, job_s)


# ---- phase 31: the comms and data-path observatories and chaos injection

#: 31a: the monitored run's watchdog deadline; the comm_stall on rank 0 at
#: P31_STALL_STEP (its delay past the deadline); the stage-targeted
#: data_stall on the gather at P31_DATA_STEP (shorter than the deadline)
P31_DEADLINE, P31_STALL_S, P31_STALL_STEP = 4.0, 6.0, 3
P31_DATA_S, P31_DATA_STEP = 1.5, 5
#: 31b: comms bench's kinds, payload sizes (elements a rank) and reps
P31_KINDS = ("all-reduce", "ring-all-reduce", "ring-reduce-scatter")
P31_SIZES, P31_REPS = (65536, 1048576), 5
#: 31b: K2 (= K3) launches a ring call at two ranks in int8: the
#: all-reduce's hop and gather phase, the reduce-scatter's hop
P31_RING_QUANTS = {"ring-all-reduce": 2, "ring-reduce-scatter": 1}


#: 31d: the monitors' cost end to end: NetResDeep's two-rank int8 run on
#: the synchronous loader (``--prefetch-depth 0``: the stage monitor's
#: writes on the training thread), no faults, P31_COST_STEPS steps in one
#: epoch, its arms switched step by step (``MonitorCycle``); two such
#: runs; the first P31_COST_WARM steps left out
P31_COST_STEPS, P31_COST_WARM, P31_COST_RUNS = 72, 8, 2


def phase31_cost_runs(tmp):
    """31d's runs for 28c's job, each traced into its own run dir."""
    return [(f"cost_{i}", [
        "--device", "cuda", "--dist-backend", "gloo", "--synthetic-data",
        "--synthetic-size", str(2 * 32 * P31_COST_STEPS), "--epochs", "1", "--kernels",
        "--batch-size", "32", "--grad-compress", "int8", "--log-every-epochs", "1",
        "--prefetch-depth", "0", "--comms-monitor", "--telemetry-dir",
        os.path.join(tmp, "cost", f"cost_{i}")], ["--cycle-monitors"])
        for i in range(1, P31_COST_RUNS + 1)]


def phase31_cost(smi, jobs):
    """31d's checks and lines: each run's launches exact (K1 1, K2 2, K3 2
    a step a rank) and two hook calls in each ``hops`` step; each arm's
    step period (rank 0's host clock from a step's call to the next's),
    run by run and pooled; the differences that price the stage monitor,
    the hop monitor and the probe's read; the hook's own ms inside the
    live step with and without the probe (both ranks)."""
    import statistics

    periods = {arm: [] for arm in P31_ARMS}
    hop_ms = {arm: [] for arm in P31_ARMS[2:]}
    seconds = 0.0
    for i in range(1, P31_COST_RUNS + 1):
        name = f"cost_{i}"
        metrics, same = jobs[name]
        for r, m in enumerate(metrics):
            steps = m["steps"]
            want = {**{k: 0 for k in m["launches"]}, "fused_update": steps,
                    "fused_quant": 2 * steps, "fused_dequant": 2 * steps}
            calls = {arm: len(v) for arm, v in m["hop_ms_by_arm"].items()}
            if (m["launches"] != want or not same or steps != P31_COST_STEPS
                    or calls != {arm: 2 * m["cycle_arms"].count(arm) for arm in hop_ms}):
                fail(f"31d {name} rank {r}: {steps} steps, launches {m['launches']}, hook "
                     f"calls {calls}, replicas {same}")
            for arm in hop_ms:
                hop_ms[arm] += [ms for k, ms in m["hop_ms_by_arm"][arm] if k >= P31_COST_WARM]
        t, arms = metrics[0]["step_starts"], metrics[0]["cycle_arms"]
        for arm in P31_ARMS:
            periods[arm].append([(t[k + 1] - t[k]) * 1e3 for k in range(
                P31_COST_WARM, len(t) - 1) if arms[k] == arm])
        seconds += metrics[0]["run_seconds"]
    med = {arm: statistics.median([p for run in runs for p in run])
           for arm, runs in periods.items()}
    print(f"  31d monitors' cost ({smi}; two gloo ranks, int8 ring, --prefetch-depth 0, "
          f"{P31_COST_RUNS} runs of {P31_COST_STEPS} steps, the arms switched step by step, "
          f"from step {P31_COST_WARM + 1}; step periods on rank 0's host clock, ms, each "
          "run's median / the pooled median over n): "
          + "; ".join(f"{arm} " + " / ".join(f"{statistics.median(run):.3f}" for run in runs)
                      + f" / {med[arm]:.3f} over {sum(map(len, runs))}"
                      for arm, runs in periods.items()), flush=True)
    print(f"  31d: the stage monitor {med['stages'] - med['bare']:+.3f} ms a step "
          f"(stages - bare), the hop monitor {med['hops'] - med['stages']:+.3f} ms (hops - "
          f"stages), the probe's read {med['hops'] - med['hops_no_probe']:+.3f} ms (hops - "
          f"hops_no_probe); the hook in the live step, p50: "
          f"{statistics.median(hop_ms['hops']):.4f} ms reading the probe "
          f"({len(hop_ms['hops'])} calls), {statistics.median(hop_ms['hops_no_probe']):.4f} "
          f"ms without ({len(hop_ms['hops_no_probe'])}); the runs {seconds:.1f} s",
          flush=True)
    return seconds


def phase31_paths(tmp):
    """Phase 31's run dir, chaos spec and comms bench artifact under ``tmp``."""
    return (os.path.join(tmp, "chaos_run"), os.path.join(tmp, "chaos.json"),
            os.path.join(tmp, "comms-bench.json"))


def phase31_runs(tmp):
    """Phase 31 (a) and (b)'s runs for 28c's job: (a) 28c's run with
    ``--comms-monitor --prefetch-batches 2`` (the staged path, whose stages
    the observer hears), a short ``--watchdog-deadline`` and ``--chaos``: a
    ``comm_stall`` on rank 0 past the deadline (no abort) and a
    stage-targeted ``data_stall`` on the gather; (b) ``comms bench`` over
    the job's two ranks."""
    run_dir, spec, bench = phase31_paths(tmp)
    with open(spec, "w") as f:
        json.dump({"chaos_schema_version": 1, "seed": 0, "faults": [
            {"kind": "comm_stall", "step": P31_STALL_STEP, "delay_s": P31_STALL_S,
             "hops": 1, "process_index": 0},
            {"kind": "data_stall", "step": P31_DATA_STEP, "stage": "gather",
             "stall_s": P31_DATA_S, "process_index": 0}]}, f)
    monitored = tel_rank_args(run_dir) + [
        "--comms-monitor", "--prefetch-batches", "2", "--watchdog-deadline",
        str(P31_DEADLINE), "--chaos", spec]
    bench_args = ["--device", "cuda", "--dist-backend", "gloo", "--mesh", "data=2",
                  "--kinds", ",".join(P31_KINDS), "--dtypes", "f32", "--ring-modes",
                  "f32,int8", "--sizes", ",".join(map(str, P31_SIZES)), "--reps",
                  str(P31_REPS), "--out", bench]
    return [("chaos_monitored", monitored, ["--deterministic"]),
            ("comms_bench", bench_args, ["--comms-bench"]), *phase31_cost_runs(tmp)]


def phase31_checks(tmp, smi, jobs, job_s):
    """Phase 31 (a) and (b)'s checks on 28c's job (module docstring), then
    (c) in this process."""
    import torch

    t31 = time.perf_counter()
    run_dir, _, bench = phase31_paths(tmp)
    twin_dir = os.path.join(tmp, "ranks")
    n = 2
    # (a) the monitored, faulted run against 28c's
    metrics, same = jobs["chaos_monitored"]
    twin, _ = jobs["tel_ranks"]
    for r, m in enumerate(metrics):
        steps = m["steps"]
        want = {**{k: 0 for k in m["launches"]}, "fused_update": steps,
                "fused_quant": n * steps, "fused_dequant": n * steps}
        if m["launches"] != want:
            fail(f"31a rank {r}: launches {m['launches']}, expected {want}")
        if m["step_losses"] != twin[r]["step_losses"]:
            fail(f"31a rank {r}: losses {m['step_losses']} differ from 28c's "
                 f"{twin[r]['step_losses']}")
        for name in (f"comms-health-p{r}.json", f"data-health-p{r}.json",
                     f"hang-forensics-p{r}.json", f"hang-p{r}.log"):
            if not os.path.isfile(os.path.join(run_dir, name)):
                fail(f"31a: no {name} in the monitored run's dir")
        with open(os.path.join(run_dir, f"hang-forensics-p{r}.json")) as f:
            bundle = json.load(f)
        suspect = bundle.get("suspect_collective") or {}
        got = (suspect.get("key"), suspect.get("kind"), suspect.get("dtype"),
               suspect.get("axis"))
        print(f"  31a rank {r} ({smi}): {steps} steps; launches {m['launches']}; hang "
              f"bundle: suspect collective {got} from {suspect.get('source')} (hop "
              f"{suspect.get('hop')}/{suspect.get('n_hops')}), suspect stage "
              f"{bundle.get('suspect_stage')}, last step {bundle.get('last_step')}", flush=True)
        if got != ("ring-all-reduce/s8/data", "ring-all-reduce", "s8", "data"):
            fail(f"31a rank {r}: the hang bundle names {got}")
    weights = [torch.load(os.path.join(d, f"rank{r}.pt")) for d in
               (os.path.join(tmp, "chaos_monitored"), os.path.join(tmp, "tel_ranks"))
               for r in range(n)]
    bitwise = all(torch.equal(weights[0][k], w[k]) for w in weights[1:] for k in w)
    with open(os.path.join(run_dir, "chaos-state.json")) as f:
        fired = json.load(f)["fired"]
    with open(os.path.join(run_dir, "data-health-p0.json")) as f:
        stages = sorted(json.load(f)["stages"])
    p50 = {}
    for label, d in (("28c", twin_dir), ("31a", run_dir)):
        # the second epoch's steps: past the first steps' set-up and the stall
        ms = sorted(v for k, v in step_ms(d).items() if k > TEL_RANK_STEPS)
        p50[label] = ms[len(ms) // 2]
    print(f"  31a ({smi}): weights bitwise 28c's on both ranks {bitwise}; losses bitwise "
          f"28c's; chaos faults fired {fired}; data-health stages {stages}; step p50 over "
          f"the second epoch's {TEL_RANK_STEPS} steps (compiled_step + device_sync, rank 0) "
          f"monitored {p50['31a']:.3f} ms against 28c's {p50['28c']:.3f} ms "
          f"({p50['31a'] / p50['28c']:.3f}x; too few steps to price the monitors: 31d "
          "does)", flush=True)
    if not (same and bitwise) or sorted(fired) != [0, 1] or "gather" not in stages:
        fail(f"31a: replicas {same}, bitwise 28c's {bitwise}, fired {fired}, stages {stages}")
    # (b) comms bench in the same job
    bm, _ = jobs["comms_bench"]
    k23 = (P31_REPS + 1) * len(P31_SIZES) * sum(P31_RING_QUANTS.values())
    for r, m in enumerate(bm):
        want = {**{k: 0 for k in m["launches"]}, "fused_quant": k23, "fused_dequant": k23}
        if m["rc"] or m["launches"] != want:
            fail(f"31b rank {r}: exit {m['rc']}, launches {m['launches']}, expected {want}")
    with open(bench) as f:
        art = json.load(f)["comms"]
    print(f"  31b comms bench ({smi}; two gloo ranks sharing the card, the wire through "
          f"host memory): {bm[0]['seconds']:.2f} s, launches a rank {bm[0]['launches']}; "
          f"chip {art['chip']}, mesh {art['mesh']}", flush=True)
    for key, link in sorted(art["links"].items()):
        print(f"    {key}: alpha {link['alpha_s'] * 1e6:.1f} us, beta "
              f"{link['beta_bytes_per_s'] / 1e6:.1f} MB/s, achieved "
              f"{link['achieved_bw_bytes_per_s'] / 1e6:.1f} MB/s", flush=True)
    reg = os.path.join(tmp, "registry31")
    rc, text, _ = read_back(["registry", "--registry", reg, "record", bench])
    rc2, listed, _ = read_back(["registry", "--registry", reg, "list", "--json"])
    kinds = [e["artifact_kind"] for e in json.loads(listed)["entries"]] if not rc2 else None
    rc3, text3, _ = read_back(["watch", run_dir, "--once", "--json", "--no-alerts-file",
                               "--comms-baseline", bench])
    watched = json.loads(text3) if rc3 in (0, 1) else {}
    views = [h.get("comms") for h in watched.get("snapshot", {}).get("hosts", [])]
    alerts = sorted({a["rule"] for a in watched.get("alerts", [])})
    print(f"  31b registry record exit {rc}, kinds {kinds}; watch --once --comms-baseline "
          f"exit {rc3}, hosts' comms views on axes "
          f"{[sorted((v or {}).get('axis_bw', {})) for v in views]}, alerts {alerts}",
          flush=True)
    if rc or kinds != ["comms"] or rc3 not in (0, 1) or len(views) != n or not all(
            v and "data" in v.get("axis_bw", {}) for v in views):
        fail("31b: the registry or watch did not read the comms bench artifact")
    cost_s = phase31_cost(smi, jobs)
    stamp("phase 31 (a), (b), (d)")
    phase31_in_process(tmp, smi, run_dir)
    own = (time.perf_counter() - t31 + metrics[0]["run_seconds"] + bm[0]["seconds"]
           + cost_s)
    print(f"phase 31 took {own:.1f} s beyond 28c's run (31a's run "
          f"{metrics[0]['run_seconds']:.1f} s, 31b's {bm[0]['seconds']:.1f} s, 31d's "
          f"{cost_s:.1f} s, the checks and (c) {time.perf_counter() - t31:.1f} s; 28c's run "
          f"{twin[0]['run_seconds']:.1f} s; the shared job {job_s:.1f} s in all)", flush=True)


def monitor_cost(tmp, smi, batches=200):
    """Phase 31c: the stage monitor's host cost alone, on this host's
    clock: a batch's five stage entries and exits through a
    ``StageMonitor`` (each entry a forced atomic write); the median. 31d
    prices both monitors inside live steps."""
    import statistics

    from tpu_ddp_torch.datapath.stages import HOST_STAGES, StageMonitor

    d = os.path.join(tmp, "monitor_cost")
    os.makedirs(d)
    stages = StageMonitor(d)
    per_batch = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for stage in HOST_STAGES:
            stages.stage_enter(stage)
            stages.stage_exit(stage, 1e-4, 4096)
        per_batch.append((time.perf_counter() - t0) * 1e3)
    print(f"  31c stage monitor alone ({smi}, host clock, median of {batches}): "
          f"{statistics.median(per_batch):.4f} ms a batch (five stages)", flush=True)


def phase31_in_process(tmp, smi, run_dir):
    """Phase 31 (c) in the smoke's process: ``data bench --device cuda``
    with the real h2d copy, and ``data report`` on (a)'s run dir, whose
    stalled gather must be the dominant stage."""
    art_path = os.path.join(tmp, "data-bench.json")
    rc, _, secs = read_back(["data", "bench", "--device", "cuda", "--reps", "5", "--out",
                             art_path])
    if rc:
        fail(f"31c: data bench exited {rc}")
    with open(art_path) as f:
        data = json.load(f)["data"]
    print(f"  31c data bench ({smi}, {secs:.2f} s; batch {data['per_shard_batch']}, "
          f"device {data['device_kind']}): "
          + ", ".join(f"{k} {v['seconds_per_batch'] * 1e3:.4f} ms"
                      for k, v in data["stages"].items())
          + f"; {data['per_image_s'] * 1e6:.3f} us an image; skipped {data['skipped']}",
          flush=True)
    if "h2d" not in data["stages"] or data["skipped"]:
        fail(f"31c: data bench's stages {sorted(data['stages'])}, skipped {data['skipped']}")
    monitor_cost(tmp, smi)
    rc, text, _ = read_back(["data", "report", run_dir, "--json"])
    rec = json.loads(text) if rc == 0 else {}
    print(f"  31c data report on 31a's run dir: exit {rc}, dominant stage "
          f"{rec.get('dominant_stage')}, per-stage p50 ms "
          + ", ".join(f"{k} {v['p50_s'] * 1e3:.4f}" for k, v in rec.get("stages", {}).items())
          + f"; verdict {rec.get('verdict')}", flush=True)
    if rc or rec.get("dominant_stage") != "gather":
        fail(f"31c: data report exit {rc}, dominant stage {rec.get('dominant_stage')}")


def run_phase28(smi):
    """Phase 28 on one card (``phase_telemetry``), in a scratch directory,
    phase 31 riding 28c's job."""
    import shutil
    import tempfile

    t28 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_telemetry(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 28 took {time.perf_counter() - t28:.1f} s", flush=True)


#: phase 29: NetResDeep's steps an epoch (two epochs at batch 32), the
#: checkpoint cadence (--checkpoint-steps) and the batch the first life is
#: SIGKILLed at: after the step-RD_CKPT save, before the step-2 RD_CKPT one
RD_STEPS, RD_CKPT, RD_KILL = 10, 5, 8


def rd_args(run_dir, kernels=True):
    """A phase-29 run: NetResDeep at full width, two epochs of ``RD_STEPS``
    steps at batch 32, ``--telemetry-dir run_dir --health on``, a checkpoint
    every ``RD_CKPT`` steps under ``run_dir/ckpt``."""
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * RD_STEPS),
            "--epochs", "2", "--batch-size", "32", "--log-every-epochs", "1",
            *(["--kernels"] if kernels else []), "--telemetry-dir", run_dir,
            "--health", "on", "--checkpoint-dir", os.path.join(run_dir, "ckpt"),
            "--checkpoint-steps", str(RD_CKPT)]


def life_child(out_path, kill_at, args):
    """``chip_smoke.py --life-child OUT N ARGS...``: the train CLI's ``run``
    under cuDNN's deterministic algorithms; as the train loop takes batch N
    (``patch_train_batches``) and once the step-``RD_CKPT`` checkpoint has
    committed, writes the launch counts so far and the steps trained to
    OUT, then waits to be SIGKILLed."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.checkpoint.manifest import latest_verified_step
    from tpu_ddp_torch.cli import train as cli

    torch.backends.cudnn.deterministic = True
    ck = args[args.index("--checkpoint-dir") + 1]

    def change(images):
        deadline = time.monotonic() + 120
        while latest_verified_step(ck)[0] != RD_CKPT:
            if time.monotonic() > deadline:
                fail(f"29a: the step-{RD_CKPT} checkpoint never committed")
            time.sleep(0.005)
        torch.cuda.synchronize()
        with open(out_path + ".tmp", "w") as f:
            json.dump({"launches": ops.launch_counts(), "steps": kill_at}, f)
        os.replace(out_path + ".tmp", out_path)
        while True:
            time.sleep(60)

    patch_train_batches(kill_at, change)
    ops.reset_launch_counts()
    cli.run(args)
    fail("29a: the first life ran to its end")


def read_back(argv):
    """``tpu_ddp_torch.cli.main.main(argv)`` in this process: (exit code,
    standard output, host seconds)."""
    import contextlib
    import io

    from tpu_ddp_torch.cli.main import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def phase_run_dir_readers(tmp, smi):
    """Phase 29: the run-dir readers on what the card wrote. (a) NetResDeep
    ``--kernels`` (``rd_args``) in a child process, SIGKILLed as it takes
    batch ``RD_KILL`` after its step-``RD_CKPT`` checkpoint committed, then
    ``--resume``d to the end in this process, both under deterministic
    cuDNN: ``goodput --json`` gives two lives, killed then clean,
    ``RD_KILL - RD_CKPT`` replayed steps, categories that sum to the
    elapsed seconds within 1e-6 s and a checkpoint; K1's launches in each
    life are the steps it trained. (b) ``curves --json``: each of the
    ``2 RD_STEPS`` steps once. (c) The same recipe and seed without
    ``--kernels``, uninterrupted: ``curves diff`` passes with a drift of
    0.0. (d) The ledger, curve and ``trace summarize --json`` of both runs
    recorded into a registry; ``registry list`` and ``trend`` exit 0;
    ``bench compare --against`` the registry (``--allow-dirty``: the copy
    has no git identity) of the incident's ledger exits 0 (its own entry),
    and the plain run's ledger against the incident's exits 1
    (``tests/test_torch_cli_main.py::test_registry_and_compare_flow``)."""
    import signal

    import torch

    from tpu_ddp_torch.telemetry import reset_default_registry

    run_dir, plain_dir = os.path.join(tmp, "incident"), os.path.join(tmp, "plain")
    marker = os.path.join(tmp, "life0.json")
    args = rd_args(run_dir)
    print(f"phase 29 ({smi}): tpu_ddp_torch.cli.train {' '.join(args)}, SIGKILLed at "
          f"batch {RD_KILL}, then --resume; the same without --kernels", flush=True)
    OTHER_CHILDREN[0] += 1
    child = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                              "--life-child", marker, str(RD_KILL), *args], cwd=ROOT)
    try:
        deadline = time.monotonic() + 300
        while not os.path.isfile(marker):
            if child.poll() is not None:
                fail(f"29a: the first life exited with {child.returncode} before its kill")
            if time.monotonic() > deadline:
                fail("29a: the first life never reached its kill point")
            time.sleep(0.01)
        os.kill(child.pid, signal.SIGKILL)
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(marker) as f:
        life0 = json.load(f)
    torch.backends.cudnn.deterministic = True
    try:
        reset_default_registry()
        _, resumed = counted_run(args + ["--resume"])
        reset_default_registry()
        _, plain = counted_run(rd_args(plain_dir, kernels=False))
    finally:
        torch.backends.cudnn.deterministic = False
    lives = [life0["launches"], resumed["launches"]]
    for i, launches in enumerate(lives):
        print(f"  life {i}: launches {launches}", flush=True)
    if {k: v for k, v in plain["launches"].items() if v}:
        fail(f"29c: the plain run launched {plain['launches']}")

    times = {}

    def cli(label, argv, want):
        rc, out, seconds = read_back(argv)
        times.setdefault(label, []).append(seconds)
        if rc != want:
            fail(f"29: tpu-ddp-torch {' '.join(argv)} exited {rc}, expected {want}:\n{out}")
        return out

    art = json.loads(cli("goodput", ["goodput", run_dir, "--json"], 0))
    led = art["ledger"]
    incs = led["incarnations"]
    print(f"  goodput {led['goodput_fraction']:.6f} of {led['elapsed_s']:.6f} s; checkpoints "
          f"{led['checkpoint']}; category seconds {json.dumps(led['category_seconds'])}",
          flush=True)
    print(f"  lives: {[(e['exit'], e['steps'], e['first_step'], e['executed_through'], e['replayed_steps']) for e in incs]}",
          flush=True)
    if [e["exit"] for e in incs] != ["killed", "clean"]:
        fail(f"29a: lives {[e['exit'] for e in incs]}, expected killed then clean")
    if led["replayed_steps"] != RD_KILL - RD_CKPT:
        fail(f"29a: {led['replayed_steps']} replayed steps, expected {RD_KILL - RD_CKPT}")
    if abs(sum(led["category_seconds"].values()) - led["elapsed_s"]) > 1e-6:
        fail("29a: the categories do not sum to the elapsed seconds")
    if led["checkpoint"]["count"] < 1 or led["category_seconds"]["compile"] != 0.0:
        fail(f"29a: checkpoints {led['checkpoint']}, compile "
             f"{led['category_seconds']['compile']}")
    if [e["steps"] for e in incs] != [RD_KILL, 2 * RD_STEPS - RD_CKPT]:
        fail(f"29a: the lives trained {[e['steps'] for e in incs]} steps")
    for i, (e, launches) in enumerate(zip(incs, lives)):
        if {k: v for k, v in launches.items() if v} != {"fused_update": e["steps"]}:
            fail(f"29a: life {i} trained {e['steps']} steps, launches {launches}")
    cli("goodput_text", ["goodput", run_dir], 0)

    curve = json.loads(cli("curves", ["curves", run_dir, "--json"], 0))["curve"]
    print(f"  curve: {json.dumps(list(zip(curve['steps'], curve['loss'])))}", flush=True)
    if curve["steps"] != list(range(2 * RD_STEPS)) or curve["incarnations"] != 2:
        fail(f"29b: curve steps {curve['steps']}, lives {curve['incarnations']}")
    if not all(math.isfinite(v) for v in curve["loss"]):
        fail("29b: a non-finite loss in the curve")

    diff = json.loads(cli("curves_diff", ["curves", "diff", run_dir, plain_dir, "--json"], 0))
    print(f"  curves diff: {diff['verdict']}, drift {diff['max_loss_drift']}, raw "
          f"{diff['raw_max_loss_drift']}, final eval loss delta "
          f"{diff['final_eval_loss_delta']}, steps {diff['steps_compared']}", flush=True)
    if diff["verdict"] != "pass" or diff["max_loss_drift"] != 0.0 \
            or diff["raw_max_loss_drift"] != 0.0:
        fail(f"29c: curves diff {diff}")

    reg = os.path.join(tmp, "registry")
    ledgers = {}
    for name, d in (("incident", run_dir), ("plain", plain_dir)):
        for kind, argv in (("goodput", ["goodput", d, "--json"]),
                           ("curves", ["curves", d, "--json"]),
                           ("trace", ["trace", "summarize", d, "--json"])):
            path = os.path.join(tmp, f"{name}_{kind}.json")
            with open(path, "w") as f:
                f.write(cli(f"{kind}_json", argv, 0))
            if kind == "goodput":
                ledgers[name] = path
            cli("registry_record", ["registry", "--registry", reg, "record", path], 0)
    cli("registry_list", ["registry", "--registry", reg, "list"], 0)
    cli("registry_trend", ["registry", "--registry", reg, "trend"], 0)
    cli("bench_compare_against", ["bench", "compare", "--against", reg, "--allow-dirty",
                                  ledgers["incident"]], 0)
    out = cli("bench_compare", ["bench", "compare", ledgers["plain"], ledgers["incident"]], 1)
    if not all(k in out for k in ("badput/restart_gap", "badput/replayed", "exits/killed")):
        fail(f"29d: bench compare did not name the kill's badput:\n{out}")
    print("  reader host seconds: " + "; ".join(
        f"{k} {' '.join(f'{x:.4f}' for x in v)}" for k, v in times.items()), flush=True)


def run_phase29(smi):
    """Phase 29 on one card (``phase_run_dir_readers``), in a scratch
    directory under ``build/``."""
    import shutil
    import tempfile

    t29 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_run_dir_readers(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 29 took {time.perf_counter() - t29:.1f} s", flush=True)


#: phase 30: three epochs of OBS_STEPS steps at batch 32; the config
#: capture window (--profile-steps A:B), the step at which the child holds
#: for the parent's requests, the live window's steps (POST /profile) and
#: the number of timed /metrics scrapes
OBS_STEPS, OBS_WINDOW, OBS_GATE, OBS_LIVE, OBS_SCRAPES = 12, (4, 8), 27, 3, 5
#: phase 30b: the child's memory cap (a fraction of the card) and its batch,
#: whose first step's activations (about 1.6 MB a row) cannot fit
OOM_FRACTION, OOM_BATCH = 0.02, 4096
#: phase 30a: a memory sample and the parts of it its child times apart
MEMTRACK_PARTS = (("MemorySampler", "sample"), ("sampler", "sample_devices"),
                  ("sampler", "host_rss_bytes"), ("MemorySampler", "_write"),
                  ("sampler", "publish_memory_gauges"))
K1_KERNEL = "fused_update_kernel"


def obs_args(run_dir, profile_dir):
    """Phase 30a's run: NetResDeep at full width ``--kernels``, three
    epochs of ``OBS_STEPS`` steps at batch 32, every observatory on."""
    return ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(32 * OBS_STEPS),
            "--epochs", "3", "--batch-size", "32", "--log-every-epochs", "1", "--kernels",
            "--telemetry-dir", run_dir, "--monitor-port", "-1", "--monitor-bind",
            "127.0.0.1", "--watchdog-deadline", "60", "--profile-steps",
            f"{OBS_WINDOW[0]}:{OBS_WINDOW[1]}", "--profile-dir", profile_dir]


def obs_child(out_path, args):
    """``chip_smoke.py --obs-child OUT ARGS...``: the train CLI's ``run``,
    held in the capture manager's ``on_step`` at step ``OBS_GATE`` (after
    the step's heartbeat, outside every span) from writing ``OUT.ready``
    until the parent writes ``OUT.go``; every memory sample timed, and its
    parts apart (``MEMTRACK_PARTS``). Writes the launch counts, the metrics
    and the seconds to OUT."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.cli import train as cli
    from tpu_ddp_torch.memtrack import sampler as memtrack
    from tpu_ddp_torch.profiler.capture import CaptureManager

    on_step = CaptureManager.on_step
    seconds = {name: [] for _, name in MEMTRACK_PARTS}

    def timing(owner, name):
        inner = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                seconds[name].append(time.perf_counter() - t0)

        setattr(owner, name, timed)

    def held(self, step):
        if step == OBS_GATE:
            open(out_path + ".ready", "w").close()
            deadline = time.monotonic() + 120
            while not os.path.exists(out_path + ".go"):
                if time.monotonic() > deadline:
                    fail("30a: the parent never released the child")
                time.sleep(0.005)
        return on_step(self, step)

    CaptureManager.on_step = held
    for owner, name in MEMTRACK_PARTS:
        timing(memtrack.MemorySampler if owner == "MemorySampler" else memtrack, name)
    ops.reset_launch_counts()
    _, metrics = cli.run(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    metrics["launches"] = ops.launch_counts()
    metrics["memtrack_s"] = seconds
    with open(out_path + ".tmp", "w") as f:
        json.dump(metrics, f)
    os.replace(out_path + ".tmp", out_path)


def oom_child(args):
    """``chip_smoke.py --oom-child ARGS...``: this process capped at
    ``OOM_FRACTION`` of the card, then the train CLI on ``args`` (a batch
    that cannot fit). Returns only if the run ends without the allocator
    failing."""
    import torch

    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.cli import train as cli

    torch.cuda.set_per_process_memory_fraction(OOM_FRACTION, 0)
    cli.run(args)
    fail("30b: the capped run did not run out of memory")


def http_call(method, url, timeout=10):
    """(status, body, seconds) of one HTTP request; an error status is a
    result, not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=b"" if method == "POST" else None, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    return code, body, time.perf_counter() - t0


def k1_kernels(trace_path):
    """K1's kernel events in a ``torch.profiler`` Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and K1_KERNEL in e.get("name", ""))


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(path) for n in names)


def step_ms(run_dir):
    """{span step: ms of its ``compiled_step`` + ``device_sync``} from
    ``trace-p0.jsonl``."""
    out = {}
    for r in trace_records(run_dir):
        if r["type"] == "span" and r["name"] in ("compiled_step", "device_sync"):
            out[r["step"]] = out.get(r["step"], 0.0) + r["dur_s"] * 1e3
    return out


def phase_observatories(tmp, smi):
    """Phase 30 (a) and (b) (module docstring). (b)'s capped child starts
    first and runs beside (a)'s: it fails its first step while (a)'s child
    is still starting, so the two share only their start-up, which is most
    of the phase's time."""
    oom_dir = os.path.join(tmp, "oom")
    oom_args = ["--device", "cuda", "--synthetic-data", "--synthetic-size", str(OOM_BATCH),
                "--epochs", "1", "--batch-size", str(OOM_BATCH), "--kernels",
                "--telemetry-dir", oom_dir, "--telemetry-sinks", "jsonl"]
    print(f"phase 30b: tpu_ddp_torch.cli.train {' '.join(oom_args)} capped at {OOM_FRACTION} "
          "of the card, in a child beside 30a's", flush=True)
    oom_log = os.path.join(tmp, "oom.log")
    with open(oom_log, "w") as log:
        OTHER_CHILDREN[0] += 1
        oom = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--oom-child", *oom_args],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log)
    try:
        phase_observed_child(tmp, smi)
        rc = oom.wait(timeout=300)
    finally:
        if oom.poll() is None:
            oom.kill()
            oom.wait()
    check_oom_child(oom_dir, oom_log, rc)


def phase_observed_child(tmp, smi):
    """Phase 30a (module docstring)."""
    import statistics

    import torch

    from tpu_ddp_torch.profiler.capture import list_bundles, read_bundle_meta

    run_dir, prof_dir = os.path.join(tmp, "obs"), os.path.join(tmp, "obs_profile")
    out = os.path.join(tmp, "obs.json")
    args = obs_args(run_dir, prof_dir)
    print(f"phase 30a ({smi}): tpu_ddp_torch.cli.train {' '.join(args)} in a child; "
          f"held at step {OBS_GATE} for /metrics, /healthz and POST "
          f"/profile?steps={OBS_LIVE}", flush=True)
    OTHER_CHILDREN[0] += 1
    child = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                              "--obs-child", out, *args], cwd=ROOT)
    try:
        deadline = time.monotonic() + 300
        while not os.path.isfile(out + ".ready"):
            if child.poll() is not None:
                fail(f"30a: the child exited with {child.returncode} before step {OBS_GATE}")
            if time.monotonic() > deadline:
                fail(f"30a: the child never reached step {OBS_GATE}")
            time.sleep(0.01)
        with open(os.path.join(run_dir, "exporter-p0.json")) as f:
            base = f"http://127.0.0.1:{json.load(f)['port']}"
        scrapes = [http_call("GET", base + "/metrics") for _ in range(OBS_SCRAPES)]
        health = http_call("GET", base + "/healthz")
        armed = http_call("POST", f"{base}/profile?steps={OBS_LIVE}")
        again = http_call("POST", f"{base}/profile?steps={OBS_LIVE}")
        open(out + ".go", "w").close()
        rc = child.wait(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if rc:
        fail(f"30a: the child exited with {rc}")
    text = scrapes[-1][1]
    steps_line = re.search(r"^tpu_ddp_train_steps_total\{[^}]*\} (\S+)$", text, re.M)
    gauges = [float(v) for v in re.findall(
        r"^tpu_ddp_memory_d\d+_bytes_in_use\{[^}]*\} (\S+)$", text, re.M)]
    print(f"  30a /metrics: {[c for c, *_ in scrapes]}, train_steps_total "
          f"{steps_line.group(1) if steps_line else None}, memory_d<i>_bytes_in_use {gauges}; "
          f"/healthz {health[0]} {health[1]}; POST /profile {armed[0]} {armed[1]}, again "
          f"{again[0]}", flush=True)
    if any(c != 200 for c, *_ in scrapes) or not steps_line \
            or float(steps_line.group(1)) != OBS_GATE or not gauges or min(gauges) <= 0:
        fail("30a: /metrics lacks train_steps_total at the held step or a memory gauge > 0")
    if health[0] != 200 or json.loads(health[1])["status"] != "ok":
        fail(f"30a: /healthz {health[0]} {health[1]}")
    if armed[0] != 200 or again[0] != 429:
        fail(f"30a: POST /profile {armed[0]}, a second {again[0]} (expected 200, 429)")
    with open(out) as f:
        metrics = json.load(f)
    steps = 3 * OBS_STEPS
    if metrics["steps"] != steps or metrics["launches"]["fused_update"] != steps:
        fail(f"30a: {metrics['steps']} steps, launches {metrics['launches']}")

    bundles = list_bundles(run_dir)
    want = [("config", OBS_WINDOW[0], OBS_WINDOW[1]), ("http", OBS_GATE, OBS_GATE + OBS_LIVE)]
    got = [(b["trigger"], b["start_step"], b["end_step"]) for b in bundles]
    if got != want:
        fail(f"30a: bundles {got}, expected {want}")
    windows = []
    for b in bundles:
        meta = read_bundle_meta(b["path"])
        device = meta["sources"]["device"]
        folded = os.path.getsize(os.path.join(b["path"], "host_stacks.folded"))
        if "trace_dir" not in device:
            fail(f"30a: bundle {b['path']} has no device trace: {device}")
        n_k1 = k1_kernels(os.path.join(b["path"], "device", "trace.json"))
        print(f"  30a bundle {os.path.basename(b['path'])} ({b['trigger']}): window "
              f"{meta['window']}, host samples {meta['sources']['host']['samples']}, "
              f"folded {folded} B, K1 kernels in the device trace {n_k1}, bundle "
              f"{dir_bytes(b['path'])} B", flush=True)
        if not folded or n_k1 != meta["window"]["steps"]:
            fail(f"30a: {b['path']}: folded stacks {folded} B, {n_k1} K1 kernels for "
                 f"{meta['window']['steps']} steps")
        windows.append(range(meta["window"]["start_step"], meta["window"]["end_step"]))
    written = [r for r in trace_records(run_dir)
               if r["type"] == "instant" and r["name"] == "profiler_trace_written"]
    epoch_trace = os.path.join(prof_dir, "trace.json")
    n_epoch = k1_kernels(epoch_trace) if os.path.isfile(epoch_trace) else None
    print(f"  30a --profile-dir: {[r['attrs'] for r in written]}, K1 kernels {n_epoch}, "
          f"{dir_bytes(prof_dir)} B", flush=True)
    if len(written) != 1 or written[0]["attrs"]["epoch"] != 2 or n_epoch != OBS_STEPS:
        fail(f"30a: the epoch trace: {written}, K1 kernels {n_epoch}")

    total = torch.cuda.get_device_properties(0).total_memory
    with open(os.path.join(run_dir, "mem-p0.jsonl")) as f:
        mem = [json.loads(line) for line in f][1:]
    devs = [d for r in mem for d in r["devices"]]
    print(f"  30a mem-p0.jsonl: {len(mem)} records over {steps} steps, bytes_in_use "
          f"{min(d['bytes_in_use'] for d in devs)}..{max(d['bytes_in_use'] for d in devs)}, "
          f"peak {max(d['peak_bytes_in_use'] for d in devs)}, limit {total}", flush=True)
    if not mem or any(d["source"] != "memory_stats" or d["bytes_limit"] != total
                      or not 0 < d["bytes_in_use"] <= d["peak_bytes_in_use"] <= total
                      for d in devs):
        fail("30a: mem-p0.jsonl lacks memory_stats records within the card's memory")
    for argv in (["watch", run_dir, "--once", "--json"], ["mem", run_dir, "--json"],
                 ["profile", run_dir]):
        rc, text, seconds = read_back(argv)
        print(f"  30a tpu-ddp-torch {argv[0]}: exit {rc}, {seconds:.4f} s", flush=True)
        if rc:
            fail(f"30a: tpu-ddp-torch {' '.join(argv)} exited {rc}:\n{text[-2000:]}")
        if argv[0] == "watch":
            report = json.loads(text)
            if [h["host"] for h in report["snapshot"]["hosts"]] != [0] \
                    or len(report["profiles"]) != 2:
                fail(f"30a: watch saw hosts {report['snapshot']['hosts']}, "
                     f"{len(report['profiles'])} bundles")

    per_step = step_ms(run_dir)
    in_window = [v for s, v in per_step.items() if any(s in w for w in windows)]
    first_window = [v for s, v in per_step.items() if s in windows[0]]
    epoch2 = [v for s, v in per_step.items() if OBS_STEPS <= s < 2 * OBS_STEPS]
    outside = [v for s, v in per_step.items() if s > 0 and not any(s in w for w in windows)
               and not OBS_STEPS <= s < 2 * OBS_STEPS]
    parts = metrics["memtrack_s"]
    samples = parts["sample"]
    print(f"  30a ({smi}): /metrics scrape ms "
          + " / ".join(f"{x[2] * 1e3:.3f}" for x in scrapes)
          + f"; step ms (compiled_step + device_sync) p50 in the capture windows "
          f"{statistics.median(in_window):.4f} (the first, with the process's first "
          f"torch.profiler session, {statistics.median(first_window):.4f}), in the "
          f"--profile-dir epoch {statistics.median(epoch2):.4f}, outside both "
          f"{statistics.median(outside):.4f}; memory sample ms median "
          f"{statistics.median(samples) * 1e3:.4f} ("
          + ", ".join(f"{name} {statistics.median(v) * 1e3:.4f}" for name, v in parts.items()
                      if name != "sample" and v)
          + f") over {len(samples)} samples in {steps} steps "
          f"({sum(samples) / steps * 1e3:.4f} ms a step)", flush=True)
    stamp("phase 30a")



def check_oom_child(oom_dir, oom_log, rc):
    """Phase 30b's checks of the capped child that exited with ``rc``
    (module docstring)."""
    with open(oom_log) as f:
        stderr = f.read()
    tail = stderr.strip().splitlines()[-1:] or [""]
    print(f"  30b: exit {rc}, {tail[0][:300]}", flush=True)
    bundles = sorted(os.listdir(os.path.join(oom_dir, "oom"))) \
        if os.path.isdir(os.path.join(oom_dir, "oom")) else []
    # 1: the re-raised exception's own exit, not a signal in the teardown
    if rc != 1 or "OutOfMemoryError" not in stderr or bundles != ["step_0-p0"]:
        fail(f"30b: exit {rc}, postmortems {bundles}:\n{stderr[-3000:]}")
    with open(os.path.join(oom_dir, "oom", "step_0-p0", "meta.json")) as f:
        meta = json.load(f)
    rc, text, _ = read_back(["goodput", oom_dir, "--json"])
    exits = [e["exit"] for e in json.loads(text)["ledger"]["incarnations"]] if not rc else None
    rc_mem, mem_text, _ = read_back(["mem", oom_dir, "--json"])
    samples = json.loads(mem_text)["oom"][0]["n_samples"] if rc_mem == 1 else None
    print(f"  30b postmortem: {meta['error_type']}, {meta['n_samples']} memory samples; "
          f"goodput exit {rc}, lives {exits}; mem exit {rc_mem}", flush=True)
    if meta["error_type"] != "OutOfMemoryError" or rc or exits != ["oom"] \
            or rc_mem != 1 or samples != meta["n_samples"]:
        fail("30b: the OOM was not classified oom")
    stamp("phase 30b")


def run_phase30(smi, ranks=False):
    """Phase 30 (a) and (b) on one card, in a scratch directory; with
    ``ranks``, phase 28c's two-rank job too (``tel_ranks``), whose checks
    hold 30c (in the whole smoke it runs in phase 28)."""
    import shutil
    import tempfile

    t30 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_observatories(tmp, smi)
        if ranks:
            tel_ranks(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 30 took {time.perf_counter() - t30:.1f} s", flush=True)


def phase30_main():
    """``python3 chip_smoke.py --phase 30``: the kernels built, then phase 30
    alone on one card, 28c's two-rank job included."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    run_phase30(smi, ranks=True)
    print(f"chip_smoke --phase 30: ok ({smi})", flush=True)


def phase31_main():
    """``python3 chip_smoke.py --phase 31``: the kernels built, then phase
    31 alone on one card, with 28c's two-rank job it rides."""
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        tel_ranks(tmp, smi, with31=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print_jobs()
    print(f"chip_smoke --phase 31: ok ({smi})", flush=True)


def phase27_nccl_main(nproc):
    """``python3 chip_smoke.py --nccl N --phase 27`` on a machine with N
    cards: phase 27's job alone at N ranks, one card each, over NCCL (pp
    gpipe and 1f1b on ``data=N/2,pipeline=2``, ep on ``data=1,expert=N``),
    losses held to one rank's from the same states."""
    import shutil
    import tempfile

    import torch

    if torch.cuda.device_count() < nproc:
        fail(f"--nccl {nproc} needs {nproc} cards, {torch.cuda.device_count()} visible")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_pp_ep(tmp, smi, "nccl", nproc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke --nccl {nproc} --phase 27: ok ({smi})", flush=True)


def phase28_main():
    """``python3 chip_smoke.py --phase 28``: the kernels built, then phase 28
    alone on one card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    run_phase28(smi)
    print(f"chip_smoke --phase 28: ok ({smi})", flush=True)


def phase29_main():
    """``python3 chip_smoke.py --phase 29``: the kernels built, then phase 29
    alone on one card."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch import native
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    native.build()
    run_phase29(smi)
    print(f"chip_smoke --phase 29: ok ({smi})", flush=True)


def nccl_main(nproc):
    """``python3 chip_smoke.py --nccl N`` on a machine with N cards: phase
    10 with NetResDeep's chunks at N ranks, then phases 12, 14, 24 (a)-(c),
    17's resume (``phase_checkpoint_dp``) and 18c at N ranks, one card each, over
    NCCL (the default backend on cuda), 19d's fine-tune and 21b's flight
    recorder and 22e's fused calls at N ranks, 25 (b) and (c) and 26's N-rank
    job."""
    import shutil
    import tempfile

    import torch

    if torch.cuda.device_count() < nproc:
        fail(f"--nccl {nproc} needs {nproc} cards, {torch.cuda.device_count()} visible")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    _build.build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    phase_quant_vs_plain((nproc,))
    try:
        phase_dp_main_path(tmp, nproc, "nccl")
        zero1_runs = phase_zero1_dp(tmp, nproc, "nccl")
        phase_zero3(tmp, zero1_runs, nproc, "nccl", serial=True)
        phase_checkpoint_dp(tmp, nproc, "nccl")
        phase_lm_ranks(tmp, nproc, "nccl")
        phase_finetune_ranks(tmp, nproc, "nccl")
        phase_health_ranks(tmp, nproc, "nccl")
        phase_scan_ranks(tmp, nproc, "nccl")
        phase_sp_train(tmp, smi, None, nproc, "nccl", data=nproc // 2)
        phase_gspmd(tmp, smi, None, nproc, "nccl")
        phase_pp_ep(tmp, smi, "nccl", nproc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke --nccl {nproc}: ok", flush=True)


def main():
    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--sync-bn-child"]:
        return sync_bn_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--lm-rank-child"]:
        return lm_rank_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--sp-ring-child"]:
        return sp_ring_child(sys.argv[2])
    if sys.argv[1:2] == ["--life-child"]:
        return life_child(sys.argv[2], int(sys.argv[3]), sys.argv[4:])
    if sys.argv[1:2] == ["--obs-child"]:
        return obs_child(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--oom-child"]:
        return oom_child(sys.argv[2:])
    if sys.argv[1:2] == ["--nccl"]:
        if sys.argv[3:5] == ["--phase", "26"]:
            return phase26_main(int(sys.argv[2]))
        if sys.argv[3:5] == ["--phase", "27"]:
            return phase27_nccl_main(int(sys.argv[2]))
        return nccl_main(int(sys.argv[2]))
    if sys.argv[1:3] == ["--phase", "26"]:
        return phase26_main()
    if sys.argv[1:3] == ["--phase", "27"]:
        return phase27_main()
    if sys.argv[1:3] == ["--phase", "28"]:
        return phase28_main()
    if sys.argv[1:3] == ["--phase", "29"]:
        return phase29_main()
    if sys.argv[1:3] == ["--phase", "30"]:
        return phase30_main()
    if sys.argv[1:3] == ["--phase", "31"]:
        return phase31_main()
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "tpu_ddp_torch", "ops", "csrc")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    from tpu_ddp_torch.ops import _build

    smi = nvidia_smi()
    print(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)

    from tpu_ddp_torch import native

    t0 = time.perf_counter()
    built = _build.build()
    print(f"phase 2: built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})", flush=True)
    print(f"  native data-path library (g++): {native.build():.2f} s, "
          f"{native.library_path().name}", flush=True)
    for name in _build.LIBRARIES:
        log = _build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers/thread, {spills} bytes of spill stores", flush=True)

    results = phase_kernel_vs_plain()
    masked_results = phase_masked_vs_plain()
    stamp("phases 1-3b")
    args, metrics, launches = phase_main_path()
    phase_plain_same_steps(args, metrics)
    rows = phase_timing(results, launches)
    stamp("phases 4-6")
    flash_results = phase_flash_vs_plain()
    vit_runs = phase_vit_main_path()
    rows += phase_flash_timing({"k1": results, "flash": flash_results},
                               vit_runs["flash"][1])
    stamp("phases 7-9")
    for attention, (m, _) in vit_runs.items():
        print(f"ViT-S/4 --attention {attention}: steady-state images/sec/chip "
              f"{m['images_per_sec_per_chip']:.1f}", flush=True)
    quant_err = phase_quant_vs_plain((2, ZERO1_RANKS))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_ring_on_card(tmp)
        stamp("phases 10-11")
        dp_runs = phase_dp_main_path(tmp)
        stamp("phase 12")
        # phases 14, 15, 17's cut and 26's model=3 run at three ranks in one
        # three-rank job
        cut_three, three_to_two = rank_change_runs(tmp)
        jobs = launch_dp_runs(tmp, zero1_dp_runs() + zero1_vit_runs() + [cut_three]
                              + [gspmd_shared_runs()[ZERO1_RANKS]], ZERO1_RANKS,
                              phase="14, 15, 17 and 26", deterministic=True)
        zero1_runs = phase_zero1_dp(tmp, jobs=jobs)
        zero1_runs.update(phase_zero1_vit(tmp, jobs=jobs))
        stamp("phases 14-15")
        t17 = time.perf_counter()
        resumed = phase_checkpoint_dp(tmp, then=[three_to_two])
        phase_checkpoint_sigterm(tmp)
        phase_checkpoint_rank_change(resumed[three_to_two[0]])
        checkpoint_timing(tmp, smi)
        print(f"phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)
        t18 = time.perf_counter()
        lm_tokens_32k = torch.from_numpy(
            lm_tokens(LM_STEPS, LM_BATCH, LM_SEQ, LM_32K["vocab_size"])).to("cuda")
        lm_model, lm_runs = phase_lm_train(lm_tokens_32k, smi)
        phase_lm_decode(lm_model, lm_tokens_32k[-1])
        del lm_model, lm_tokens_32k
        torch.cuda.empty_cache()
        phase_lm_ranks(tmp)
        print(f"phase 18 (a)-(c) took {time.perf_counter() - t18:.1f} s", flush=True)
        t19 = time.perf_counter()
        torch.backends.cudnn.deterministic = True
        try:
            ft_runs = phase_finetune(tmp, smi)
        finally:
            torch.backends.cudnn.deterministic = False
        # 19d, 21b and 22e in one two-rank job, checked in their phases
        variant_tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
        variants = variant_ranks_runs(variant_tmp)
        phase_finetune_ranks(variant_tmp, runs=variants)
        print(f"phase 19 (a)-(d) took {time.perf_counter() - t19:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phases 17-19 (a)-(d)")
    t20 = time.perf_counter()
    bf16_errors = phase_bf16_vs_plain()
    bf16_vit = phase_bf16_vit()
    lm_tokens_32k = torch.from_numpy(
        lm_tokens(LM_STEPS, LM_BATCH, LM_SEQ, LM_32K["vocab_size"])).to("cuda")
    bf16_lm = phase_bf16_lm(lm_tokens_32k, lm_runs["flash"])
    torch.cuda.empty_cache()
    phase_bf16_netresdeep()
    print(f"phase 20 (a), (c)-(e) took {time.perf_counter() - t20:.1f} s", flush=True)
    t21 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_health_skip(tmp)
        phase_health_ranks(variant_tmp, runs=variants)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_health_cost(lm_tokens_32k, smi)
    del lm_tokens_32k
    torch.cuda.empty_cache()
    print(f"phase 21 took {time.perf_counter() - t21:.1f} s", flush=True)
    t22 = time.perf_counter()
    phase_scan(smi)
    phase_grad_accum(smi)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_augment_resume(tmp)
        phase_dump_predictions(tmp)
        phase_scan_ranks(variant_tmp, runs=variants)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(variant_tmp, ignore_errors=True)
    print(f"phase 22 took {time.perf_counter() - t22:.1f} s", flush=True)
    t23 = time.perf_counter()
    phase_data_path(smi)
    stamp("phase 23a")
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_sync_bn(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 23b")
    phase_lamb(smi)
    phase_cv(smi)
    print(f"phase 23 took {time.perf_counter() - t23:.1f} s", flush=True)
    t24 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_zero3(tmp, zero1_runs)
        phase_zero3_two(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 24 took {time.perf_counter() - t24:.1f} s", flush=True)
    t25 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        phase_sp_ring(tmp, smi)
        stamp("phase 25a")
        phase_sp_train(tmp, smi, {"vit": sp_vit_one_rank(), "float32": lm_runs["flash"],
                                  "bfloat16": bf16_lm["bf16"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 25 took {time.perf_counter() - t25:.1f} s", flush=True)
    # 27's two-rank job carries 26's fsdp run; 26's model=3 run rode 14's job
    tmp27 = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        pp_runs = pp_ep_job(tmp27, more=[gspmd_shared_runs()[2]])
        run_phase26(smi, shared={"tp_vit_m3": jobs["tp_vit_m3"],
                                 "fsdp_vit": pp_runs["fsdp_vit"]})
        run_phase27(smi, tmp27, pp_runs)
    finally:
        shutil.rmtree(tmp27, ignore_errors=True)
    run_phase28(smi)
    run_phase29(smi)
    run_phase30(smi)
    print_jobs()
    print_accounting()
    rows += phase_lm_timing(results, flash_results, lm_runs["flash"]["launches"])
    stamp("phase 18d")
    rows += phase_finetune_timing(results, ft_runs)
    stamp("phase 19e")
    rows += phase_bf16_timing(bf16_errors, {"vit": bf16_vit["flash"]["launches"],
                                            "lm": bf16_lm["bf16"]["launches"]})
    stamp("phase 20b")
    phase_bf16_against_parent()
    stamp("phases 18d, 19e, 20b and 20f")
    rows += phase_quant_timing(quant_err, dp_runs)
    stamp("phase 13")
    rows += phase_masked_timing(masked_results, {
        "netresdeep": zero1_runs["zero1"][0]["launches"]["fused_update"],
        "vit_s4": zero1_runs["vit_zero1"][0]["launches"]["fused_update"]})
    stamp("phases 13 and 16")
    for name, ms in (("int8 ring", dp_runs["int8"]), ("plain DP", dp_runs["plain"])):
        print(f"NetResDeep on two ranks, {name}: steady-state step time per rank "
              f"{ms[0]['steady_step_ms']:.4f} / {ms[1]['steady_step_ms']:.4f} ms",
              flush=True)
    for name, ms in zero1_runs.items():
        print(f"three ranks, {name}: steady-state step time per rank "
              + " / ".join(f"{x['steady_step_ms']:.4f}" for x in ms) + " ms", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
