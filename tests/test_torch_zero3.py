"""ZeRO-3 in the port (``tpu_ddp_torch/parallel/zero.py::Zero3Partition``,
``parallel/collectives.py::BlockGather``, the zero3 branch of
``train/steps.py``) against the JAX package's ZeRO-3 step, on gloo CPU ranks.

Unlike the JAX zero1 step, the JAX zero3 step runs under this box's jax 0.9,
so it is the direct oracle. The models are NetResDeep with 6 channels, 2
tied blocks and 7 classes, and a ViT with 2 blocks (patch 4, hidden 32, 2
heads, 7 classes): the 7-element head bias pads at every rank count, the
32-element leaves at N = 3, the 6-element and 162-element ones at N = 4.

(a) The partition's layout and ``accounting()`` equal JAX
    ``Zero3Partition(tx, params, N)``'s for N in {2, 3, 4}, every key but
    ``prefetch_buffer_bytes``, which is held to its own definition in the
    port's block order (the forward's, where JAX sorts the names); each
    block's bytes equal JAX's; ``param_blocks`` puts every leaf in exactly
    one block.
(b) Three steps at N = 2 and 3, SGD with momentum 0.9, and AdamW with decay
    0.05, clip 1.0, EMA 0.9 and a cosine schedule, the plain chain and K1's
    CPU path, against the JAX zero3 step (``make_train_step(...,
    zero1=Zero3Partition(...))``): losses ``rtol=1e-5``, the de-sharded
    params, BatchNorm stats and optimizer state ``atol=1e-5`` through
    ``from_jax``.
(c) The port's zero3 against its own zero1 on the same arguments: losses and
    gathered params equal to the bit (float32, int8 with error feedback);
    the ranks' params equal to the bit; the shards land in the layout and
    come out of it exactly; between steps every module parameter holds an
    empty placeholder and every shard ``padded / N`` elements.
(d) Scan (3 steps a call), grad-accum (2 microbatches) against the JAX
    zero3 scan and accumulating steps ``atol=1e-5``; int8 with error feedback
    within 0.05 of float32 zero3 with a non-zero residual
    (``tests/test_zero3.py:186``, ``:219``, ``:238``).
(e) The prefetch schedule, with a recording gather: block k+1's gather is
    issued before block k's first use, at most two are outstanding, a tied
    block and a recompute under remat wait once, ``prefetch=False``
    serializes.
(f) Through the launcher: ``--zero3 --ema-decay 0.9`` against the
    replicated run (EMA evaluation accuracy ``atol=1e-6``, loss
    ``atol=1e-4``), one rank against the replicated trainer, and the CLI
    guards with the JAX messages.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models import NetResDeep as FlaxNetResDeep
from tpu_ddp.models.vit import ViT as FlaxViT
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.zero import Zero3Partition as JaxZero3Partition
from tpu_ddp.parallel.zero import param_blocks as jax_param_blocks
from tpu_ddp.train import create_train_state as jax_create_train_state
from tpu_ddp.train import make_optimizer as jax_make_optimizer
from tpu_ddp.train.steps import make_grad_accum_train_step as jax_accum_step
from tpu_ddp.train.steps import make_scan_train_step as jax_scan_step
from tpu_ddp.train.steps import make_train_step as jax_make_train_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.cli.train import main
from tpu_ddp_torch.models import NetResDeep, ViT
from tpu_ddp_torch.parallel import collectives
from tpu_ddp_torch.parallel.zero import Zero3Partition, param_blocks
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
from tpu_ddp_torch.train.state import create_train_state
from tpu_ddp_torch.train.steps import make_train_step
from test_torch_zero1 import (
    COUNTS,
    MODEL,
    N_STEPS,
    RECIPES,
    SLOTS,
    _batches,
    _close_states,
    _close_trees,
    _launch_evals,
    _port_name,
    _rows,
    _state_dict,
    SMALL,
)

VIT = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=2, num_classes=7)
ATOL = 1e-5
ACCUM = 2


def _flax(kind):
    model = FlaxNetResDeep(**MODEL) if kind == "netresdeep" else FlaxViT(**VIT)
    return model, model.init(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32),
                             train=False)["params"]


def _port(kind):
    return NetResDeep(**MODEL) if kind == "netresdeep" else ViT(**VIT)


def _jax_tx(kw, params, zero=True):
    extra = dict(zero1_axis="data", decay_mask=jax.tree.map(lambda p: p.ndim >= 2, params)) \
        if zero else {}
    return jax_make_optimizer(**extra, **kw)


# ---- (a) layout and accounting ----------------------------------------------


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("kind", ["netresdeep", "vit"])
def test_partition_layout_and_accounting_match_jax(kind, n, recipe):
    kw = RECIPES[recipe]
    _, params = _flax(kind)
    jax_part = JaxZero3Partition(_jax_tx(kw, params), params, n)
    port_params = dict(_port(kind).named_parameters())
    tx = make_optimizer(zero1_axis="data", decay_mask=decay_mask(port_params), **kw)
    part = Zero3Partition(tx, port_params, n, rank=0)

    flat = jax.tree_util.tree_flatten_with_path(
        jax_part.param_slots, is_leaf=lambda x: hasattr(x, "padded"))[0]
    jax_names = [_port_name(path) for path, _ in flat]
    jax_slots = dict(zip(jax_names, (slot for _, slot in flat)))
    assert set(jax_slots) == set(part.param_slots)
    for name, want in jax_slots.items():
        got = part.param_slots[name]
        assert (got.size, got.padded) == (want.size, want.padded), name

    got, want = part.accounting(), jax_part.accounting()
    high = got.pop("prefetch_buffer_bytes")
    want.pop("prefetch_buffer_bytes")
    assert got == want
    assert got["block_names"] == jax_part.block_names == sorted(part.block_names)

    # each block's gathered bytes, JAX's and the port's, and the high-water
    # as its definition gives it in the port's order
    jax_bytes = {jax_part.block_names[k]: sum(jax_slots[jax_names[i]].padded * 4 for i in blk)
                 for k, blk in enumerate(jax_part.blocks)}
    port_bytes = [sum(part.param_slots[part.names[i]].padded * 4 for i in blk)
                  for blk in part.blocks]
    assert dict(zip(part.block_names, port_bytes)) == jax_bytes
    assert high == max(a + b for a, b in zip(port_bytes, port_bytes[1:]))
    assert got["n_blocks"] == (4 if kind == "netresdeep" else 6)

    # a block's row holds its leaves' chunks; its width is the layout's
    for blk, lay in zip(part.blocks, part.block_layouts):
        assert list(lay.shard) == [part.shard_size(part.names[i]) for i in blk]
    assert part.row_width == sum(lay.width for lay in part.block_layouts)


@pytest.mark.parametrize("kind", ["netresdeep", "vit"])
def test_param_blocks_partition_every_leaf_once(kind):
    params = dict(_port(kind).named_parameters())
    names, blocks = param_blocks(params)
    assert sorted(i for blk in blocks for i in blk) == list(range(len(params)))
    assert len(set(names)) == len(names)
    leaves = list(params)
    for name, blk in zip(names, blocks):
        assert all(leaves[i].split(".", 1)[0] == name for i in blk)
    _, flax_params = _flax(kind)
    jax_names, jax_blocks = jax_param_blocks(flax_params)
    assert sorted(names) == jax_names
    assert sorted(len(b) for b in blocks) == sorted(len(b) for b in jax_blocks)
    # the port's order is the forward's: the root's params, then the children
    want = (["conv1", "resblock", "fc1", "fc2"] if kind == "netresdeep" else
            ["pos_embed", "patch_embed", "block_0", "block_1", "ln_f", "head"])
    assert names == want


# ---- (b)-(d): the step on ranks ----------------------------------------------

#: port case -> (partition, kernels, compression)
CASES = {"zero3": ("zero3", False, None), "zero3_k1": ("zero3", True, None),
         "zero1": ("zero1", False, None), "zero1_k1": ("zero1", True, None),
         "zero3_int8_ef": ("zero3", True, "int8"), "zero1_int8_ef": ("zero1", True, "int8")}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _worker(rank, n, path):
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train.optim import OptState
    from tpu_ddp_torch.train.state import full_model_state
    from tpu_ddp_torch.train.steps import make_grad_accum_train_step, scan

    init = torch.load(f"{path}/init.pt")
    result = {}
    batches = _batches(n)
    for recipe, kw in RECIPES.items():
        names = list(CASES)[:4] + (list(CASES)[4:] + ["zero3_scan", "zero3_accum"]
                                   if recipe == "sgd_mom" else [])
        for case in names:
            layout, kernels, mode = CASES.get(case, ("zero3", False, None))
            model = NetResDeep(**MODEL)
            model.load_state_dict(init)
            params = dict(model.named_parameters())
            tx = make_optimizer(kernels=kernels, zero1_axis="data",
                                decay_mask=decay_mask(params), **kw)
            part = (Zero3Partition if layout == "zero3" else Zero1Partition)(tx, params, n)
            state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
            comp = None
            if mode is not None:
                comp = GradCompressor(GradCompression(mode=mode, block=64,
                                                      error_feedback=True),
                                      part.param_slots, n)
                part.set_compression(comp)
                state.grad_residual = comp.init_residual(torch.device("cpu"))
            out = {}
            if case == "zero3_scan":
                step = scan(make_train_step(tx, zero1=part), N_STEPS)
                stacked = {k: torch.as_tensor(v) for k, v in _stack(
                    [{k: v.numpy() for k, v in _rows(b, rank).items()} for b in batches]).items()}
                state, metrics = step(state, stacked)
                losses = [float(x) for x in metrics["loss"]]
            else:
                step = (make_grad_accum_train_step(tx, accum_steps=ACCUM, zero1=part)
                        if case == "zero3_accum" else
                        make_train_step(tx, compress=comp, zero1=part))
                losses = []
                for batch in batches:
                    state, metrics = step(state, _rows(batch, rank))
                    losses.append(float(metrics["loss"]))
                    if layout == "zero3":       # between steps: the shards alone
                        out.setdefault("placeholders", []).append(
                            all(p.untyped_storage().nbytes() == 0
                                for p in state.model.parameters()))
            out.update(losses=losses,
                       model={k: v.clone() for k, v in full_model_state(state, part).items()},
                       desharded=_state_dict(part.deshard_opt_state(state.opt_state)))
            if layout == "zero3":
                out["shard_sizes"] = {k: v.numel() for k, v in state.param_shards.items()}
                out["padded"] = {k: s.padded for k, s in part.param_slots.items()}
                out["round_trip"] = part.deshard_params(part.shard_params(out["model"]))
                if case == "zero3":
                    jax_state = torch.load(f"{path}/jax_{recipe}.pt")
                    landed = part.shard_params(jax_state["params"])
                    out["landed"] = {k: v.clone() for k, v in landed.items()}
                    out["shards"] = {k: v.clone() for k, v in
                                     part.shard_params(out["model"]).items()}
                    out["landed_opt"] = _state_dict(
                        part.shard_opt_state(OptState(**jax_state["opt"])))
                    out["opt_shards"] = _state_dict(state.opt_state)
            if state.grad_residual is not None:
                out["residual_norm"] = float(sum(x.square().sum() for x in
                                                 state.grad_residual.values()))
            result[(recipe, case)] = out
    torch.save(result, f"{path}/rank{rank}.pt")


def _jax_state(final, part):
    params = jax.device_get(part.deshard_params(final.params))
    opt = jax.device_get(part.deshard_opt_state(final.opt_state))
    return from_jax(params, jax.device_get(final.batch_stats), opt)


def _jax_runs(devices, n, recipe):
    """The JAX zero3 step (and for SGD its scan and accumulating steps) from
    the same init on the same batches: ``{name: (converted state, losses)}``,
    and the init."""
    kw = RECIPES[recipe]
    model, _ = _flax("netresdeep")
    state = jax_create_train_state(model, jax_make_optimizer(**kw), jax.random.key(0))
    mesh = create_mesh(MeshSpec(data=n), devices[:n])
    tx = _jax_tx(kw, state.params)
    part = JaxZero3Partition(tx, state.params, n)
    start = part.shard_state(state.replace(opt_state=tx.init(state.params)), mesh)
    batches = [jax.device_put(b, batch_sharding(mesh)) for b in _batches(n)]
    out = {}
    s, losses = start, []
    step = jax_make_train_step(model, tx, mesh, donate=False, zero1=part)
    for b in batches:
        s, m = step(s, b)
        losses.append(float(m["loss"]))
    out["zero3"] = (_jax_state(s, part), losses)
    if recipe == "sgd_mom":
        scan_step = jax_scan_step(model, tx, mesh, steps_per_call=N_STEPS, donate=False,
                                  zero1=part)
        s, m = scan_step(start, {k: jax.numpy.stack([b[k] for b in batches])
                                 for k in batches[0]})
        out["zero3_scan"] = (_jax_state(s, part), [float(x) for x in m["loss"]])
        accum = jax_accum_step(model, tx, mesh, accum_steps=ACCUM, donate=False, zero1=part)
        s, losses = start, []
        for b in batches:
            s, m = accum(s, b)
            losses.append(float(m["loss"]))
        out["zero3_accum"] = (_jax_state(s, part), losses)
    return state, out


@pytest.fixture(scope="module", params=[2, 3], ids=["n2", "n3"])
def runs(request, devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    n = request.param
    path = tmp_path_factory.mktemp(f"zero3_n{n}")
    jax_runs = {}
    for recipe in RECIPES:
        init, jax_runs[recipe] = _jax_runs(devices, n, recipe)
        converted, _ = jax_runs[recipe]["zero3"]
        torch.save({"params": {k: v for k, v in converted["model"].items()
                               if not k.endswith(("running_mean", "running_var"))},
                    "opt": _state_dict(converted["opt_state"])},
                   path / f"jax_{recipe}.pt")
    torch.save(from_jax(*jax.device_get((init.params, init.batch_stats)))["model"],
               path / "init.pt")
    spawn(_worker, n, str(path), init_file=str(path / "rdzv"), timeout=300)
    return {"n": n, "jax": jax_runs,
            "port": [torch.load(path / f"rank{r}.pt") for r in range(n)]}


JAX_CASES = ([(recipe, case) for recipe in RECIPES for case in ("zero3", "zero3_k1")]
             + [("sgd_mom", "zero3_scan"), ("sgd_mom", "zero3_accum")])


@pytest.mark.parametrize("recipe,case", JAX_CASES)
def test_zero3_matches_jax_zero3_step(runs, recipe, case):
    want, losses = runs["jax"][recipe][case.replace("_k1", "")]
    for rank, res in enumerate(runs["port"]):
        got = res[(recipe, case)]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_trees({k: v.numpy() for k, v in got["model"].items()},
                     {k: v.numpy() for k, v in want["model"].items()}, ATOL,
                     f"rank {rank} model")
        _close_states(got["desharded"], _state_dict(want["opt_state"]), ATOL,
                      f"rank {rank}")


@pytest.mark.parametrize("recipe,kernels", [(r, k) for r in RECIPES for k in ("", "_k1")]
                         + [("sgd_mom", "_int8_ef")])
def test_zero3_equals_zero1_to_the_bit(runs, recipe, kernels):
    for res in runs["port"]:
        z3, z1 = res[(recipe, "zero3" + kernels)], res[(recipe, "zero1" + kernels)]
        assert z3["losses"] == z1["losses"]
        assert all(torch.equal(z3["model"][k], v) for k, v in z1["model"].items())
        for slot in SLOTS + COUNTS:
            a, b = z3["desharded"][slot], z1["desharded"][slot]
            assert (a is None) == (b is None), slot
            if slot in COUNTS and a is not None:
                assert torch.equal(a, b)
            elif a is not None:
                assert all(torch.equal(a[k], b[k]) for k in b), slot


@pytest.mark.parametrize("recipe,case", [(r, c) for r in RECIPES
                                         for c in ("zero3", "zero3_k1")]
                         + [("sgd_mom", c) for c in ("zero3_int8_ef", "zero3_scan",
                                                     "zero3_accum")])
def test_zero3_replicas_and_layout(runs, recipe, case):
    n = runs["n"]
    first = runs["port"][0][(recipe, case)]
    for res in runs["port"]:
        got = res[(recipe, case)]
        assert got["losses"] == first["losses"]
        assert all(torch.equal(got["model"][k], v) for k, v in first["model"].items())
        assert all(got.get("placeholders", [True]))
        for name, size in got["shard_sizes"].items():
            assert size * n == got["padded"][name]
        assert all(torch.equal(got["round_trip"][k], got["model"][k])
                   for k in got["round_trip"])


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_jax_zero3_state_lands_in_shard_layout(runs, recipe):
    """The JAX zero3 state after three steps, de-sharded and converted, laid
    into the port's shards, against the port's own shards (``atol=1e-5``)."""
    for rank, res in enumerate(runs["port"]):
        out = res[(recipe, "zero3")]
        _close_trees({k: v.numpy() for k, v in out["landed"].items()},
                     {k: v.numpy() for k, v in out["shards"].items()}, ATOL,
                     f"rank {rank} params")
        _close_states(out["landed_opt"], out["opt_shards"], ATOL, f"rank {rank}")


def test_zero3_int8_error_feedback_close_to_float32(runs):
    for res in runs["port"]:
        got, plain = res[("sgd_mom", "zero3_int8_ef")], res[("sgd_mom", "zero3_k1")]
        for k, v in plain["model"].items():
            assert float((got["model"][k] - v).abs().max()) <= 0.05, k
        assert got["residual_norm"] > 0


# ---- (e) the prefetch schedule -------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_chunk_major_leaves_equal_unpack(n):
    """``ChunkMajor.leaves`` (the gathered block's unpack: one buffer, one
    multi-tensor copy) gives ``unpack_``'s values, each leaf starting 512
    bytes into an aligned run."""
    sizes = [1, 7, 162, 1003, 32, 224]
    lay = collectives.ChunkMajor(sizes, n)
    rows = torch.randn(n, lay.width)
    want = [torch.empty(size) for size in sizes]
    lay.unpack_(rows, want)
    got = lay.leaves(rows)
    base = got[0].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert (g.data_ptr() - base) % 512 == 0


class Recorder:
    """Wraps ``BlockGather`` to log its issues and waits, with the number
    of gathers outstanding at each issue, and the blocks' entries."""

    def __init__(self, monkeypatch):
        self.log = []
        issue, finish = collectives.BlockGather._issue, collectives.BlockGather._finish

        def _issue(gather, k):
            issue(gather, k)
            self.log.append(("issue", k, gather.outstanding()))

        def _finish(gather, k):
            self.log.append(("wait", k, gather.outstanding()))
            return finish(gather, k)

        monkeypatch.setattr(collectives.BlockGather, "_issue", _issue)
        monkeypatch.setattr(collectives.BlockGather, "_finish", _finish)

    def of(self, kind):
        return [k for what, k, _ in self.log if what == kind]


def _record_step(monkeypatch, model, prefetch, remat=False):
    rec = Recorder(monkeypatch)
    params = dict(model.named_parameters())
    tx = make_optimizer(zero1_axis="data", lr=1e-2)
    part = Zero3Partition(tx, params, 1, rank=0, prefetch=prefetch)
    state = create_train_state(model, tx, torch.device("cpu"), zero1=part)
    entries = []
    hooks = [getattr(model, name).register_forward_pre_hook(
        lambda m, a, k=k: entries.append(k))
        for k, name in enumerate(part.block_names) if hasattr(model, name)
        and isinstance(getattr(model, name), torch.nn.Module)]
    step = make_train_step(tx, zero1=part, remat=remat)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    step(state, {"image": images, "label": torch.arange(4) % 7})
    for h in hooks:
        h.remove()
    return part, rec, entries


@pytest.mark.parametrize("kind,remat", [("netresdeep", False), ("vit", True)],
                         ids=["tied_block", "vit_remat"])
def test_prefetch_schedule(monkeypatch, kind, remat):
    model = _port(kind)
    part, rec, entries = _record_step(monkeypatch, model, prefetch=True, remat=remat)
    n_blocks = len(part.blocks)
    assert rec.of("issue") == list(range(n_blocks))
    assert rec.of("wait") == list(range(n_blocks))           # each block once
    # a block entered twice: the tied resblock (twice a forward), the ViT's
    # blocks recomputed under remat
    assert len(entries) > len(set(entries))
    assert max(out for what, _, out in rec.log if what == "issue") <= 2
    at = {e[:2]: i for i, e in enumerate(rec.log)}
    for k in range(n_blocks - 1):             # k+1 issued before k is waited for
        assert at[("issue", k + 1)] < at[("wait", k)]
    # nothing stays gathered after the step
    assert all(p.untyped_storage().nbytes() == 0 for p in model.parameters())


def test_serialized_schedule(monkeypatch):
    model = _port("vit")
    part, rec, _ = _record_step(monkeypatch, model, prefetch=False)
    want = [e for k in range(len(part.blocks)) for e in (("issue", k), ("wait", k))]
    assert [e[:2] for e in rec.log] == want
    assert all(out <= 1 for _, _, out in rec.log)


# ---- (f) the trainer and the CLI ---------------------------------------------


def test_trainer_zero3_ema_eval_matches_replicated():
    """Two CPU ranks through the launcher; evaluation reads the EMA weights,
    which ``--zero3`` gathers from the ranks' shards."""
    want = _launch_evals([])
    for extra in (["--zero3"], ["--zero3", "--kernels"]):
        got = _launch_evals(extra)
        for (acc, loss), (w_acc, w_loss) in zip(got, want):
            assert abs(acc - w_acc) <= 1e-6 and abs(loss - w_loss) <= 1e-4


def test_zero3_on_one_rank_matches_replicated():
    """One rank, no EMA: evaluation gathers the params themselves."""
    i = SMALL.index("--ema-decay")
    args = SMALL[:i] + SMALL[i + 2:] + [
        "--optimizer", "adamw", "--lr", "1e-3", "--momentum", "0",
        "--weight-decay", "0.05", "--grad-clip-norm", "1.0", "--kernels"]
    want = main(args)
    got = main(args + ["--zero3"])
    np.testing.assert_allclose(got["step_losses"], want["step_losses"], rtol=0, atol=1e-6)
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 1e-6
    assert abs(got["test_loss"] - want["test_loss"]) <= 1e-4


def test_zero3_finetune_matches_zero1(tmp_path):
    """``--pretrained-dir`` under ``--zero3``: the merge runs against the
    gathered fresh params and lands in the shards; the run equals
    ``--zero1``'s on the same arguments to the bit."""
    base = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "64",
            "--n-chans1", "6", "--n-blocks", "2", "--epochs", "1"]
    main(base + ["--checkpoint-dir", str(tmp_path / "pre")])
    tune = base + ["--num-classes", "5", "--pretrained-dir", str(tmp_path / "pre"),
                   "--momentum", "0.9", "--ema-decay", "0.9", "--kernels"]
    want = main(tune + ["--zero1"])
    got = main(tune + ["--zero3"])
    assert got["step_losses"] == want["step_losses"]
    assert (got["test_accuracy"], got["test_loss"]) == (want["test_accuracy"],
                                                        want["test_loss"])


@pytest.mark.parametrize("kw", [dict(zero1=True), dict(optimizer="lamb")],
                         ids=["zero1", "lamb"])
def test_zero3_guards_raise_the_jax_messages(kw):
    from tpu_ddp.train.trainer import TrainConfig as JaxTrainConfig
    from tpu_ddp_torch.train.trainer import TrainConfig

    with pytest.raises(ValueError) as want:
        JaxTrainConfig(zero3=True, **kw).validate()
    with pytest.raises(ValueError) as got:
        TrainConfig(zero3=True, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as cli:
        main(["--device", "cpu", "--synthetic-data", "--zero3",
              *(["--zero1"] if "zero1" in kw else ["--optimizer", "lamb"])])
    assert str(cli.value) == str(want.value)
