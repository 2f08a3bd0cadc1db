"""Resume across gloo CPU ranks (``parallel/runtime.py::spawn``).

(a) two ranks under ``--kernels --zero1 --grad-compress int8
    --grad-compress-error-feedback`` (and the same under ``--zero3``), cut
    at epoch 1 of 2 and resumed: the per-step losses and final params are
    BITWISE the uninterrupted run's (each rank gets its own residual row
    back from the checkpoint), and the replicas are bitwise equal;
(b) across layouts at two ranks: a ``--zero1`` checkpoint resumes into a
    replicated run and a replicated one into ``--zero1``, and ``--zero3``
    is both source and target against replicated and ``--zero1`` runs;
    after the restore each run's optimizer state (de-sharded under
    ``--zero1`` and ``--zero3``) and params (gathered under ``--zero3``)
    equal the other run's bitwise;
(c) a checkpoint cut at three ranks (``--zero1``, int8 ring with error
    feedback) resumes at two: the restored de-sharded state equals the
    checkpoint's, with the residual's sum all on rank 0, the losses are
    finite and the replicas bitwise equal; a ``--zero3`` checkpoint cut at
    three ranks resumes under ``--zero3`` at two, its params and optimizer
    state restored exactly.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import os

import pytest
import torch

from tpu_ddp_torch.checkpoint.manager import Checkpointer
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.parallel import runtime as dist_runtime
from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
from tpu_ddp_torch.train.state import split_checkpoint
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=200, per_shard_batch=4,
            n_chans1=8, n_blocks=2, seed=0, log_every_epochs=1)
ZERO1_INT8 = dict(kernels=True, zero1=True, grad_compress="int8",
                  grad_compress_error_feedback=True, momentum=0.9)
ZERO3_INT8 = {**ZERO1_INT8, "zero1": False, "zero3": True}
#: the layouts as TrainConfig fields
LAYOUTS = {"replicated": {}, "zero1": dict(zero1=True), "zero3": dict(zero3=True)}
#: (source, target) checkpoint layouts, by test id
ACROSS = {f"{a}_into_{b}": (a, b) for a, b in (
    ("zero1", "replicated"), ("replicated", "zero1"), ("zero3", "replicated"),
    ("replicated", "zero3"), ("zero3", "zero1"), ("zero1", "zero3"))}
SLOTS = ("trace", "ema")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the host's cores, and at
    these sizes more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    t = Trainer(TrainConfig(**{**BASE, **kw}))
    t.run()
    t.close()
    return t


def _resumed(**kw):
    return Trainer(TrainConfig(**{**BASE, **kw, "resume": True}))


def _opt(t):
    """The run's optimizer state in the replicated layout (a collective
    under ``--zero1`` and ``--zero3``), as plain CPU tensors."""
    state = t.state if t.zero1 is None else t.zero1.deshard_state(t.state)
    out = {f"{slot}/{n}": v.clone() for slot in SLOTS
           for n, v in (getattr(state.opt_state, slot) or {}).items()}
    return out


def _model(t):
    """The model state, params whole (a collective under ``--zero3``)."""
    return {k: v.clone() for k, v in t.model_state().items()}


def _two_rank_worker(rank, world, tmp):
    out = {}
    full = _run(epochs=2, **ZERO1_INT8)
    out["full"] = (full.history["step_loss"], _model(full))
    ck = os.path.join(tmp, "cut")
    _run(epochs=1, checkpoint_dir=ck, **ZERO1_INT8)
    resumed = _run(epochs=2, checkpoint_dir=ck, resume=True, **ZERO1_INT8)
    out["resumed"] = (resumed.history["step_loss"], _model(resumed), resumed.resumed_step)
    full = _run(epochs=2, **ZERO3_INT8)
    out["zero3_full"] = (full.history["step_loss"], _model(full))
    ck = os.path.join(tmp, "cut3")
    _run(epochs=1, checkpoint_dir=ck, **ZERO3_INT8)
    resumed = _run(epochs=2, checkpoint_dir=ck, resume=True, **ZERO3_INT8)
    out["zero3_resumed"] = (resumed.history["step_loss"], _model(resumed),
                            resumed.resumed_step)

    layout = dict(momentum=0.9, ema_decay=0.9, kernels=True)
    for name, (src, dst) in ACROSS.items():
        ck = os.path.join(tmp, name)
        cut = _run(epochs=1, checkpoint_dir=ck, **LAYOUTS[src], **layout)
        back = _resumed(epochs=2, checkpoint_dir=ck, **LAYOUTS[dst], **layout)
        out[name] = (_opt(cut), _opt(back), _model(cut), _model(back))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _cut_three_worker(rank, world, tmp):
    _run(epochs=1, checkpoint_dir=os.path.join(tmp, "three"), **ZERO1_INT8)


def _cut_three_zero3_worker(rank, world, tmp):
    _run(epochs=1, checkpoint_dir=os.path.join(tmp, "three3"), **ZERO3_INT8)


def _resume_two_zero3_worker(rank, world, tmp):
    t = _resumed(epochs=2, checkpoint_dir=os.path.join(tmp, "three3"), **ZERO3_INT8)
    restored = {"opt": _opt(t), "model": _model(t), "step": t.resumed_step}
    t.run()
    t.close()
    torch.save({**restored, "losses": t.history["step_loss"], "final": _model(t)},
               os.path.join(tmp, f"two3_{rank}.pt"))


def _resume_two_worker(rank, world, tmp):
    t = _resumed(epochs=2, checkpoint_dir=os.path.join(tmp, "three"), **ZERO1_INT8)
    restored = {"opt": _opt(t), "residual": {n: v.clone() for n, v in
                                             t.state.grad_residual.items()},
                "step": t.resumed_step}
    t.run()
    t.close()
    torch.save({**restored, "losses": t.history["step_loss"], "model": _model(t)},
               os.path.join(tmp, f"two{rank}.pt"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("two"))
    dist_runtime.spawn(_two_rank_worker, 2, tmp, init_file=os.path.join(tmp, "init"),
                       timeout=240)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_two_rank_zero1_int8_resume_is_bitwise(two):
    for r, res in enumerate(two):
        full_losses, full_model = res["full"]
        losses, model, step = res["resumed"]
        assert step == 25
        assert losses == full_losses[25:], r
        assert _equal(model, full_model), r
    assert _equal(two[0]["resumed"][1], two[1]["resumed"][1])


def test_two_rank_zero3_int8_resume_is_bitwise(two):
    for r, res in enumerate(two):
        full_losses, full_model = res["zero3_full"]
        losses, model, step = res["zero3_resumed"]
        assert step == 25
        assert losses == full_losses[25:], r
        assert _equal(model, full_model), r
        # zero3 trains the zero1 run's bits
        assert full_losses == res["full"][0] and _equal(full_model, res["full"][1])
    assert _equal(two[0]["zero3_resumed"][1], two[1]["zero3_resumed"][1])


@pytest.mark.parametrize("case", list(ACROSS))
def test_checkpoints_resume_across_layouts(two, case):
    for res in two:
        cut_opt, back_opt, cut_model, back_model = res[case]
        assert cut_opt and _equal(back_opt, cut_opt)
        assert _equal(back_model, cut_model)


def test_three_rank_checkpoint_resumes_at_two(tmp_path):
    tmp = str(tmp_path)
    dist_runtime.spawn(_cut_three_worker, 3, tmp, init_file=os.path.join(tmp, "i3"),
                       timeout=180)
    ck = split_checkpoint(Checkpointer(os.path.join(tmp, "three")).restore())
    assert ck["grad_residual_rows"].shape[0] == 3
    dist_runtime.spawn(_resume_two_worker, 2, tmp, init_file=os.path.join(tmp, "i2"),
                       timeout=180)
    runs = [torch.load(os.path.join(tmp, f"two{r}.pt")) for r in range(2)]
    steps = ck["step"]
    want = {f"{slot}/{n}": v for slot in SLOTS
            for n, v in (getattr(ck["opt_state"], slot) or {}).items()}
    assert ck["grad_residual"] is None       # the rows alone, summed at restore
    params = dict(NetResDeep(n_chans1=BASE["n_chans1"], n_blocks=BASE["n_blocks"])
                  .named_parameters())
    three = GradCompressor(GradCompression(mode="int8", error_feedback=True), params, 3)
    totals = three.deshard_residual(None, ck["grad_residual_rows"])
    for r, run in enumerate(runs):
        assert run["step"] == steps
        assert _equal(run["opt"], want), r
        for name, total in totals.items():
            got = run["residual"][name][:total.numel()].reshape(total.shape)
            assert torch.equal(got, total if r == 0 else torch.zeros_like(total))
        assert len(run["losses"]) == 2 * 25 - steps      # 17 steps an epoch at three ranks
        assert all(math.isfinite(x) for x in run["losses"])
    assert runs[0]["losses"] == runs[1]["losses"]
    assert _equal(runs[0]["model"], runs[1]["model"])


def test_three_rank_zero3_checkpoint_resumes_at_two(tmp_path):
    tmp = str(tmp_path)
    dist_runtime.spawn(_cut_three_zero3_worker, 3, tmp, init_file=os.path.join(tmp, "i3"),
                       timeout=180)
    ck = split_checkpoint(Checkpointer(os.path.join(tmp, "three3")).restore())
    dist_runtime.spawn(_resume_two_zero3_worker, 2, tmp, init_file=os.path.join(tmp, "i2"),
                       timeout=180)
    runs = [torch.load(os.path.join(tmp, f"two3_{r}.pt")) for r in range(2)]
    want = {f"{slot}/{n}": v for slot in SLOTS
            for n, v in (getattr(ck["opt_state"], slot) or {}).items()}
    for r, run in enumerate(runs):
        assert run["step"] == ck["step"]
        assert _equal(run["opt"], want), r
        assert _equal(run["model"], ck["model"]), r
        assert len(run["losses"]) == 2 * 25 - ck["step"]
        assert all(math.isfinite(x) for x in run["losses"])
    assert runs[0]["losses"] == runs[1]["losses"]
    assert _equal(runs[0]["final"], runs[1]["final"])
