"""The LM's next-token DP step in the port
(``tpu_ddp_torch/train/lm_steps.py``) against the JAX package's
``make_lm_train_step``, and its multi-rank forms against the port's own
replicated step.

A tiny LM (vocab 17, hidden 32, depth 2, 2 heads, T = 32) with flash
attention on both sides starts from the same weights (carried across by
``from_jax``) and takes three steps on the same numpy token batches. Inside
the JAX step, which runs under shard_map, the JAX flash attention takes its
jnp reference on the CPU; the port's flash path on the CPU runs the plain
versions of K4-K6. The optimizers are SGD lr 1e-2 and AdamW lr 1e-3 with
weight decay 0.05 under the ``ndim >= 2`` mask (so both embeddings decay),
both with ``kernels=True`` (K1's plain version on the CPU). Tolerances are
``tests/test_torch_dp_step.py``'s:

* one rank against a 1-device mesh, and two gloo ranks against a 2-device
  CPU mesh: per-step loss ``rtol=1e-5``, params after step 3 ``atol=1e-5``.
  Against JAX under AdamW one slice is held to a bound instead, as in
  ``tests/test_torch_vit.py``: the key third of each ``qkv`` bias, whose
  gradient is rounding noise (the softmax ignores a constant added to a
  query's scores) that Adam divides by its own size into steps of up to
  ``lr``; both sides must stay within 3 such steps of the start;
* ZeRO-1 and the rings, held to the port's replicated two-rank step (the
  JAX ZeRO-1 and compressed steps fail shard_map's replication check under
  jax 0.9, so they are no oracle): ZeRO-1 within ``1e-5``; the f32 ring
  ``atol=1e-5``; int8 with error feedback, replicated and under ZeRO-1,
  within ``0.05`` of the uncompressed losses with a non-zero residual;
* every case's replicas end bitwise equal.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models.lm import CausalTransformerLM as FlaxLM
from tpu_ddp.parallel import MeshSpec, batch_sharding, create_mesh
from tpu_ddp.parallel.mesh import replicated_sharding
from tpu_ddp.train import make_optimizer as jax_make_optimizer
from tpu_ddp.train.lm_steps import create_lm_train_state as jax_create_state
from tpu_ddp.train.lm_steps import make_lm_train_step as jax_make_step
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax, load_into

TINY = dict(vocab_size=17, hidden_dim=32, depth=2, num_heads=2)
T = 32
PER_RANK = 4
N = 2
N_STEPS = 3
RECIPES = {
    "sgd": dict(lr=1e-2),
    "adamw": dict(optimizer="adamw", lr=1e-3, weight_decay=0.05),
}
#: two-rank cases: (recipe, zero1, compression)
RANK_CASES = {
    "sgd": ("sgd", False, None),
    "adamw": ("adamw", False, None),
    "zero1": ("adamw", True, None),
    "f32": ("adamw", False, "f32"),
    "int8_ef": ("adamw", False, "int8"),
    "zero1_int8_ef": ("adamw", True, "int8"),
}


def _batches(rows):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 17, (rows, T)).astype(np.int32) for _ in range(N_STEPS)]


def _jax_run(recipe, devices, n):
    model = FlaxLM(**TINY, use_flash=True)
    tx = jax_make_optimizer(**RECIPES[recipe])
    state = jax_create_state(model, tx, jax.random.key(0), seq_len=T)
    mesh = create_mesh(MeshSpec(data=n), devices[:n])
    step = jax_make_step(model, tx, mesh, donate=False)
    s = jax.device_put(state, replicated_sharding(mesh))
    losses = []
    for toks in _batches(n * PER_RANK):
        s, m = step(s, jax.device_put({"tokens": toks}, batch_sharding(mesh)))
        losses.append(float(m["loss"]))
    return state, convert_tree(jax.device_get(s.params)), losses


def _close_params(got, want, start, recipe):
    """The port's params ``got`` and JAX's ``want`` (name -> tensor) within
    ``atol=1e-5``; under AdamW the key third of each qkv bias within 3
    steps of lr of ``start`` instead (module docstring)."""
    assert set(got) == set(want)
    C, lr = TINY["hidden_dim"], RECIPES[recipe]["lr"]
    for name, w in want.items():
        g, w = np.array(got[name]), np.array(w)
        if recipe == "adamw" and name.endswith("attn.qkv.bias"):
            s0 = np.asarray(start[name])[C:2 * C]
            for side in (g, w):
                assert np.all(np.abs(side[C:2 * C] - s0) <= 3 * lr), name
            g[C:2 * C] = w[C:2 * C] = 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_one_rank_matches_jax(devices, recipe):
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    init, want, j_losses = _jax_run(recipe, devices, 1)
    tx = make_optimizer(kernels=True, **RECIPES[recipe])
    state = create_lm_train_state(
        CausalTransformerLM(**TINY, seq_len=T, use_flash=True), tx, torch.device("cpu"))
    load_into(state, from_jax(*jax.device_get((init.params, {}, init.opt_state))))
    start = {n: t.clone() for n, t in state.model.state_dict().items()}
    step = make_lm_train_step(tx)
    losses = []
    for toks in _batches(PER_RANK):
        state, metrics = step(state, {"tokens": torch.from_numpy(toks).long()})
        assert set(metrics) == {"loss"}
        losses.append(float(metrics["loss"]))
    assert int(state.step) == N_STEPS
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _close_params(state.model.state_dict(), want, start, recipe)


def _rank_worker(rank, n, path):
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

    init = torch.load(f"{path}/init.pt")
    cpu = torch.device("cpu")
    result = {}
    for case, (recipe, zero1, mode) in RANK_CASES.items():
        model = CausalTransformerLM(**TINY, seq_len=T, use_flash=True)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        tx = make_optimizer(kernels=True, zero1_axis="data" if zero1 else None,
                            decay_mask=decay_mask(params) if zero1 else None,
                            **RECIPES[recipe])
        part = Zero1Partition(tx, params, n) if zero1 else None
        comp = None
        if mode is not None:
            comp = GradCompressor(GradCompression(
                mode=mode, block=64, error_feedback=mode == "int8", kernels=True),
                params, n)
            if part is not None:
                part.set_compression(comp)
        state = create_lm_train_state(model, tx, cpu, zero1=part)
        if comp is not None and comp.config.error_feedback:
            state.grad_residual = comp.init_residual(cpu)
        step = make_lm_train_step(tx, compress=comp, zero1=part)
        losses = []
        for toks in _batches(n * PER_RANK):
            rows = torch.from_numpy(toks[rank * PER_RANK:(rank + 1) * PER_RANK]).long()
            state, metrics = step(state, {"tokens": rows})
            losses.append(float(metrics["loss"]))
        result[case] = {
            "losses": losses,
            "model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "residual_norm": (None if state.grad_residual is None else float(
                sum(r.square().sum() for r in state.grad_residual.values()))),
        }
    torch.save(result, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    jax_runs = {r: _jax_run(r, devices, N) for r in RECIPES}
    init = jax_runs["sgd"][0]
    path = tmp_path_factory.mktemp("lm_dp")
    torch.save(from_jax(jax.device_get(init.params), {})["model"], path / "init.pt")
    spawn(_rank_worker, N, str(path), init_file=str(path / "rdzv"), timeout=180)
    port = [torch.load(path / f"rank{r}.pt") for r in range(N)]
    start = convert_tree(jax.device_get(init.params))
    return {"jax": jax_runs, "port": port, "start": start}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_ranks_end_bitwise_equal(runs, case):
    a, b = (r[case] for r in runs["port"])
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_two_ranks_match_jax(runs, recipe):
    init, want, j_losses = runs["jax"][recipe]
    got = runs["port"][0][recipe]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    _close_params(got["model"], want, runs["start"], recipe)


@pytest.mark.parametrize("case,atol", [("zero1", 1e-5), ("f32", 1e-5)])
def test_zero1_and_f32_ring_match_replicated(runs, case, atol):
    got, want = runs["port"][0][case], runs["port"][0]["adamw"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=atol)
    assert set(got["model"]) == set(want["model"])
    for name, w in want["model"].items():
        np.testing.assert_allclose(got["model"][name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["int8_ef", "zero1_int8_ef"])
def test_int8_error_feedback_close_to_uncompressed(runs, case):
    for rank in range(N):
        got = runs["port"][rank][case]
        plain = runs["port"][rank]["adamw"]["losses"]
        assert max(abs(a - b) for a, b in zip(got["losses"], plain)) < 0.05
        assert got["residual_norm"] > 0
