"""ZeRO-3 on three gloo CPU ranks: the flight recorder, the skip guard, the
real asynchronous block gather and the trainer.

The model is NetResDeep with 6 channels, 2 tied blocks and 7 classes (seven
of its nine leaves pad at three ranks), SGD with momentum and a cosine
schedule, ``kernels=True`` (K1, K2 and K3 take their plain versions on the
CPU), ``skip_nonfinite`` and the per-layer norms on, the second batch all
NaN in rank 0's rows.

* The zero3 step's stats against the zero1 step's on the same arguments,
  float32 and int8 with error feedback: every norm ``rtol=1e-5`` (the param
  norms are shard sums over the ranks under zero3), per-layer norms too,
  the sentinels equal; both ranks' stats equal to the bit.
* ``skip_step`` on the NaN batch leaves every rank's param shards,
  optimizer slots, counts, BatchNorm buffers and residual bitwise as they
  were; the params after the three steps equal zero1's to the bit.
* The block gather over gloo (async collectives): issued in block order, at
  most two outstanding, each block waited for once a step, the tied block
  entered twice.
* The small ViT (2 blocks) with flash attention and ``remat`` under AdamW:
  zero3 equal to zero1 to the bit, at 3 ranks.
* The trainer under ``--zero3``: between steps no module parameter holds
  storage, each shard holds ``padded / 3`` elements.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

from test_torch_health_steps import FLAGS, NORMS, assert_bitwise, snapshot

N = 3
PER_RANK = 8
MODEL = dict(n_chans1=6, n_blocks=2, num_classes=7)
VIT = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=7)
OPT = dict(lr=1e-2, momentum=0.9, schedule="cosine", total_steps=6, warmup_steps=1)
#: case -> (partition, error feedback with the int8 ring)
CASES = {"zero1": ("zero1", False), "zero3": ("zero3", False),
         "zero1_int8_ef": ("zero1", True), "zero3_int8_ef": ("zero3", True)}
NAN_STEP = 1


def _batches(nan=True):
    from tpu_ddp.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(3 * N * PER_RANK, num_classes=7, seed=5)
    out = []
    for i in range(3):
        sl = slice(i * N * PER_RANK, (i + 1) * N * PER_RANK)
        img = images[sl].astype(np.float32)
        if nan and i == NAN_STEP:
            img[:PER_RANK] = np.nan                  # rank 0's rows
        out.append({"image": img, "label": labels[sl], "mask": np.ones(N * PER_RANK, bool)})
    return out


def _host(stats):
    out = {k: float(v) for k, v in stats.items() if k != "per_layer"}
    out["per_layer"] = {g: {n: float(v) for n, v in layers.items()}
                        for g, layers in stats.get("per_layer", {}).items()}
    return out


def _snapshot(state):
    out = snapshot(state)
    for n, t in (state.param_shards or {}).items():
        out[f"shard/{n}"] = t.clone()
    return out


def _partition(kind, tx, params):
    from tpu_ddp_torch.parallel.zero import Zero1Partition, Zero3Partition

    return (Zero3Partition if kind == "zero3" else Zero1Partition)(tx, params, N)


def _worker(rank, n, path):
    from tpu_ddp_torch.health.stats import HealthConfig
    from tpu_ddp_torch.models import NetResDeep, ViT
    from tpu_ddp_torch.ops.flash_attention import flash_attention
    from tpu_ddp_torch.parallel import collectives
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
    from tpu_ddp_torch.train.state import create_train_state, full_model_state
    from tpu_ddp_torch.train.steps import make_train_step
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    torch.manual_seed(0)
    init = NetResDeep(**MODEL).state_dict()
    rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
    result = {}

    log = []                            # the block gather's events, this rank
    issue, finish = collectives.BlockGather._issue, collectives.BlockGather._finish

    def _issue(gather, k):
        issue(gather, k)
        log.append(("issue", k, gather.outstanding()))

    def _finish(gather, k):
        log.append(("wait", k, gather.outstanding()))
        return finish(gather, k)

    collectives.BlockGather._issue, collectives.BlockGather._finish = _issue, _finish

    for case, (kind, ef) in CASES.items():
        model = NetResDeep(**MODEL)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        tx = make_optimizer(kernels=True, decay_mask=decay_mask(params), zero1_axis="data",
                            **OPT)
        part = _partition(kind, tx, params)
        state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
        comp = None
        if ef:
            comp = GradCompressor(GradCompression(mode="int8", block=64, error_feedback=True,
                                                  kernels=True), part.param_slots, n)
            part.set_compression(comp)
            state.grad_residual = comp.init_residual(torch.device("cpu"))
        entries = []
        hook = model.resblock.register_forward_pre_hook(lambda m, a: entries.append(1))
        step = make_train_step(tx, compress=comp, zero1=part,
                               health=HealthConfig(per_layer=True, skip_nonfinite=True))
        out = {"stats": []}
        del log[:]
        for i, batch in enumerate(_batches()):
            if i == NAN_STEP:
                out["before"] = _snapshot(state)
            state, metrics = step(state, {k: torch.as_tensor(v[rows]) for k, v in batch.items()})
            out["stats"].append(_host(metrics["health"]))
            if i == NAN_STEP:
                out["after"] = _snapshot(state)
        hook.remove()
        out["gather_log"] = list(log)
        out["entries"] = len(entries)
        out["step"] = int(state.step)
        out["model"] = {k: v.clone() for k, v in full_model_state(state, part).items()}
        result[case] = out

    # the small ViT with flash attention and remat, AdamW
    for kind in ("zero1", "zero3"):
        torch.manual_seed(0)
        model = ViT(**VIT, generator=torch.Generator().manual_seed(1), remat=True)
        model.attention_impl = flash_attention
        params = dict(model.named_parameters())
        tx = make_optimizer(optimizer="adamw", lr=1e-3, weight_decay=0.05, grad_clip_norm=1.0,
                            ema_decay=0.9, zero1_axis="data", decay_mask=decay_mask(params))
        part = _partition(kind, tx, params)
        state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
        step = make_train_step(tx, zero1=part, remat=True)
        losses = []
        for batch in _batches(nan=False):
            state, metrics = step(state, {k: torch.as_tensor(v[rows]) for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
        result[f"vit_{kind}"] = {
            "losses": losses,
            "model": {k: v.clone() for k, v in full_model_state(state, part).items()},
            "ema": {k: v.clone() for k, v in part.gather_params(state.opt_state.ema).items()}}

    # the trainer
    trainer = Trainer(TrainConfig(device="cpu", synthetic_data=True, synthetic_size=96,
                                  per_shard_batch=4, n_chans1=6, n_blocks=2, num_classes=7,
                                  epochs=1, momentum=0.9, zero3=True, kernels=True,
                                  log_every_epochs=1))
    trainer.run()
    result["trainer"] = {
        "placeholders": all(p.untyped_storage().nbytes() == 0
                            for p in trainer.state.model.parameters()),
        "shards": {k: (v.numel(), trainer.zero1.param_slots[k].padded)
                   for k, v in trainer.state.param_shards.items()},
        "model": {k: v.clone() for k, v in trainer.model_state().items()}}
    trainer.close()
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    path = tmp_path_factory.mktemp("zero3_ranks")
    spawn(_worker, N, str(path), init_file=str(path / "rdzv"), timeout=300)
    return [torch.load(path / f"rank{r}.pt") for r in range(N)]


def _same_floats(a, b):
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64), equal_nan=True)


@pytest.mark.parametrize("ef", ["", "_int8_ef"], ids=["float32", "int8_ef"])
def test_zero3_stats_match_zero1(runs, ef):
    for res in runs:
        for z3, z1 in zip(res["zero3" + ef]["stats"], res["zero1" + ef]["stats"]):
            for k in FLAGS:
                assert z3[k] == z1[k], k
            if not z1["all_finite"]:
                continue
            keys = NORMS + (("compress_error_norm",) if ef else ())
            for k in keys:
                np.testing.assert_allclose(z3[k], z1[k], rtol=1e-5, err_msg=k)
            for group, layers in z1["per_layer"].items():
                for name, w in layers.items():
                    np.testing.assert_allclose(z3["per_layer"][group][name], w, rtol=1e-5,
                                               err_msg=f"{group}/{name}")


@pytest.mark.parametrize("case", ["zero3", "zero3_int8_ef"])
def test_zero3_ranks_report_the_same_stats(runs, case):
    for other in runs[1:]:
        for x, y in zip(runs[0][case]["stats"], other[case]["stats"]):
            assert set(x) == set(y)
            for k in x:
                if k == "per_layer":
                    for g in x[k]:
                        assert _same_floats(list(x[k][g].values()),
                                            list(y[k][g].values())), g
                else:
                    assert _same_floats(x[k], y[k]), k


@pytest.mark.parametrize("ef", ["", "_int8_ef"], ids=["float32", "int8_ef"])
def test_zero3_skip_step_leaves_the_state_bitwise(runs, ef):
    for res in runs:
        got = res["zero3" + ef]
        h = got["stats"][NAN_STEP]
        assert not h["all_finite"] and not h["grads_finite"]
        assert any(k.startswith("shard/") for k in got["before"])
        assert_bitwise(got["before"], got["after"])
        assert all(s["all_finite"] for i, s in enumerate(got["stats"]) if i != NAN_STEP)
        assert got["step"] == 3
        z1 = res["zero1" + ef]["model"]
        assert all(torch.equal(got["model"][k], v) for k, v in z1.items())
    for res in runs[1:]:
        assert all(torch.equal(res["zero3" + ef]["model"][k], v)
                   for k, v in runs[0]["zero3" + ef]["model"].items())


def test_block_gather_over_gloo(runs):
    for res in runs:
        log = res["zero3"]["gather_log"]
        n_blocks = 4
        issues = [k for what, k, _ in log if what == "issue"]
        waits = [k for what, k, _ in log if what == "wait"]
        assert issues == waits == list(range(n_blocks)) * 3        # three steps
        assert max(out for what, _, out in log if what == "issue") == 2
        for s in range(3):
            step = log[s * 2 * n_blocks:(s + 1) * 2 * n_blocks]
            at = {e[:2]: i for i, e in enumerate(step)}
            for k in range(n_blocks - 1):
                assert at[("issue", k + 1)] < at[("wait", k)]
        assert res["zero3"]["entries"] == 2 * 3                    # tied: twice a forward
        assert res["zero1"]["gather_log"] == []


def test_vit_remat_zero3_equals_zero1(runs):
    for res in runs:
        z3, z1 = res["vit_zero3"], res["vit_zero1"]
        assert z3["losses"] == z1["losses"] == runs[0]["vit_zero3"]["losses"]
        for tree in ("model", "ema"):
            assert all(torch.equal(z3[tree][k], v) for k, v in z1[tree].items()), tree


def test_trainer_keeps_no_full_param_between_steps(runs):
    for res in runs:
        t = res["trainer"]
        assert t["placeholders"]
        assert all(size * N == padded for size, padded in t["shards"].values())
        assert all(torch.equal(t["model"][k], v)
                   for k, v in runs[0]["trainer"]["model"].items())
