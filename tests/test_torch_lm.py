"""The causal LM in the PyTorch port (``tpu_ddp_torch/models/lm.py``)
against the Flax model (``tpu_ddp/models/lm.py``).

* Param names and shapes equal the Flax tree's through ``convert_tree`` at
  tiny widths (vocab 17, hidden 32, depth 2, 2 heads), and the counts equal
  Flax's (``jax.eval_shape``) at the module's default widths at T = 256
  (2,817,280 in 78 leaves) and at the 32k program's widths at T = 4,096
  (47,507,712 in 54 leaves; the port's model on the meta device).
* The initialisers follow Flax's, by statistics: the embedding an
  untruncated normal of std ``1/sqrt(hidden)``, ``pos_embed`` normal(0.02),
  the dense kernels lecun-normal, zero biases.
* Forward logits on weights carried across by ``from_jax``, full and flash
  attention on both sides, within ``atol=2e-5`` (``tests/test_lm.py:56``'s
  bound). The JAX flash model runs the Pallas kernel in interpret mode at
  T = 128, as ``tests/test_lm.py`` runs it; the port's flash path on the CPU
  runs the plain versions of K4-K6.
* Causality: changing token 10 leaves logits ``[:, :10]`` bitwise unchanged.
* Learning and decode, the port alone (``tests/test_lm.py``'s permutation
  task: B = 8, T = 32, AdamW lr 0.01, 60 steps): the loss falls below 0.2,
  and ``greedy_generate`` from an 8-token prompt reproduces the rollout.
* The converter carries AdamW's ``mu``/``nu`` of an LM, and the decay mask
  equals JAX ``_decay_mask``: both embeddings are decayed (``ndim >= 2``).
* ``chip_smoke.attention_work`` counts a causal call's visible (query, key)
  pairs: the ``True`` entries of the port's causal visibility matrix.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_ddp.models.lm import CausalTransformerLM as FlaxLM
from tpu_ddp.train.optim import _decay_mask
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.models import CausalTransformerLM, greedy_generate
from tpu_ddp_torch.models.lm import causal_flash_attention, causal_full_attention
from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
from tpu_ddp_torch.train.optim import decay_mask, make_optimizer

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=17, hidden_dim=32, depth=2, num_heads=2)
WIDTHS = {
    "tiny": (TINY, 16, None),
    "lm_default": ({}, 256, (2_817_280, 78)),
    "lm_32k": (dict(vocab_size=32_000, hidden_dim=512, depth=4, num_heads=8), 4096,
               (47_507_712, 54)),
}


def _tokens(B, T, seed=0, vocab=17):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _flax_init(model, T, seed=0, B=1):
    return model.init(jax.random.key(seed), np.zeros((B, T), np.int32),
                      train=False)["params"]


def _port_from_flax(params, T, use_flash=False, **cfg):
    port = CausalTransformerLM(**{**TINY, **cfg}, seq_len=T, use_flash=use_flash)
    port.load_state_dict(from_jax(jax.device_get(params), {})["model"])
    return port


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_params_match_flax(widths):
    cfg, T, expected = WIDTHS[widths]
    shapes = jax.eval_shape(lambda: _flax_init(FlaxLM(**cfg), T))
    leaves = jax.tree.leaves(shapes)
    want = sum(math.prod(x.shape) for x in leaves)
    with torch.device("meta"):
        port = CausalTransformerLM(**cfg, seq_len=T)
    got = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert sum(math.prod(s) for s in got.values()) == want
    assert len(got) == len(leaves)
    if expected is not None:
        assert (want, len(leaves)) == expected
    converted = convert_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert {n: tuple(t.shape) for n, t in converted.items()} == got


def test_initializers_follow_flax():
    """The embedding: std within 2% of 1/sqrt(512) and draws past three of
    its stddevs (a normal truncated at two has none); ``pos_embed`` std
    0.02; a dense kernel lecun-normal (std within 2% of Flax's, nothing past
    two of its stddevs); zero biases; a seed fixes the weights."""
    cfg = dict(vocab_size=4000, hidden_dim=512, depth=1, num_heads=8)
    port = CausalTransformerLM(**cfg, seq_len=64,
                               generator=torch.Generator().manual_seed(3))
    emb = port.tok_embed.weight.detach()
    std = 1 / math.sqrt(512)
    assert emb.std().item() == pytest.approx(std, rel=0.02)
    assert emb.mean().abs().item() < 0.01 * std
    assert (emb.abs() > 3 * std).sum().item() > 0
    flax_emb = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0)(
        jax.random.key(3), (4000, 512))
    assert float(np.std(flax_emb)) == pytest.approx(std, rel=0.02)
    assert port.pos_embed.std().item() == pytest.approx(0.02, rel=0.05)
    w = port.head.weight.detach()                        # (vocab, hidden)
    flax_w = jax.nn.initializers.lecun_normal()(jax.random.key(3), (512, 4000))
    assert w.std().item() == pytest.approx(float(np.std(flax_w)), rel=0.02)
    assert w.abs().max().item() <= 2 * math.sqrt(1 / 512) / 0.87962566103423978
    assert torch.count_nonzero(port.head.bias) == 0
    assert torch.all(port.ln_f.weight == 1) and torch.all(port.ln_f.bias == 0)
    fresh = CausalTransformerLM(**cfg, seq_len=64,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(fresh.tok_embed.weight, port.tok_embed.weight)


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_forward_matches_flax(attention):
    """T = 128: the JAX flash model takes the Pallas kernel in interpret
    mode (outside any shard_map), as ``tests/test_lm.py`` runs it."""
    T = 128
    toks = _tokens(2, T)
    flax_model = FlaxLM(**TINY, use_flash=attention == "flash")
    params = _flax_init(FlaxLM(**TINY), T, seed=1)
    want = np.asarray(flax_model.apply({"params": params}, toks, train=False))
    port = _port_from_flax(params, T, use_flash=attention == "flash")
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (2, T, 17) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_use_flash_binds_every_block():
    port = CausalTransformerLM(**TINY, seq_len=16)
    assert all(b.attn.attention_impl is causal_full_attention for b in port.blocks)
    port.use_flash = True
    assert all(b.attn.attention_impl is causal_flash_attention for b in port.blocks)
    with pytest.raises(ValueError, match="seq_len"):
        port(torch.zeros((1, 8), dtype=torch.long))


@pytest.mark.parametrize("use_flash", [False, True])
def test_lm_is_causal(use_flash):
    port = CausalTransformerLM(**TINY, seq_len=16, use_flash=use_flash)
    toks = torch.from_numpy(_tokens(2, 16)).long()
    poked = toks.clone()
    poked[:, 10] = (poked[:, 10] + 1) % 17
    with torch.no_grad():
        base, out = port(toks), port(poked)
    assert torch.equal(base[:, :10], out[:, :10])
    assert (base[:, 10:] - out[:, 10:]).abs().max() > 0


def _permutation_task(vocab=17, B=8, T=32):
    """``tests/test_lm.py``'s task: the next token is a fixed permutation of
    the current one."""
    perm = np.random.default_rng(3).permutation(vocab)
    seq = np.zeros((B, T), np.int64)
    seq[:, 0] = np.random.default_rng(4).integers(0, vocab, B)
    for t in range(1, T):
        seq[:, t] = perm[seq[:, t - 1]]
    return seq


def test_learns_permutation_and_greedy_decode_reproduces_it():
    T = 32
    seq = _permutation_task(T=T)
    tx = make_optimizer(lr=0.01, optimizer="adamw", kernels=True)
    state = create_lm_train_state(CausalTransformerLM(**TINY, seq_len=T), tx,
                                  torch.device("cpu"))
    step = make_lm_train_step(tx)
    batch = {"tokens": torch.from_numpy(seq)}
    losses = []
    for _ in range(60):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] > 2.0                       # ~log(17) at init
    assert losses[-1] < 0.2, losses[-5:]
    model = state.model
    prompt = torch.from_numpy(seq[:4, :8])
    out = greedy_generate(model, prompt, T - 8)
    assert model.training                        # the mode is restored
    np.testing.assert_array_equal(out.numpy(), seq[:4])
    with pytest.raises(ValueError, match="seq_len"):
        greedy_generate(model, prompt, T - 9)


def test_from_jax_carries_adamw_state_and_decay_mask_matches():
    params = _flax_init(FlaxLM(**TINY), 16)
    tx = jax_make_optimizer(lr=1e-3, optimizer="adamw", weight_decay=0.05)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    opt_state = tx.init(params)
    _, opt_state = tx.update(grads, opt_state, params)
    conv = from_jax(*jax.device_get((params, {}, opt_state)))
    port = CausalTransformerLM(**TINY, seq_len=16)
    port.load_state_dict(conv["model"])
    (adam,) = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    want_mu = convert_tree(jax.device_get(adam.mu))
    names = {n for n, _ in port.named_parameters()}
    assert set(conv["opt_state"].mu) == set(conv["opt_state"].nu) == names
    for name in names:
        np.testing.assert_array_equal(conv["opt_state"].mu[name].numpy(),
                                      want_mu[name].numpy())
    assert int(conv["opt_state"].count) == 1
    np.testing.assert_array_equal(
        conv["model"]["tok_embed.weight"].numpy(),
        np.asarray(params["tok_embed"]["embedding"]))
    np.testing.assert_array_equal(conv["opt_state"].nu["tok_embed.weight"].numpy(),
                                  np.asarray(adam.nu["tok_embed"]["embedding"]))

    want = {n: bool(t) for n, t in convert_tree(_decay_mask(params)).items()}
    assert decay_mask(dict(port.named_parameters())) == want
    assert want["tok_embed.weight"] and want["pos_embed"]
    assert not want["head.bias"] and not want["ln_f.weight"]


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_attention_work_counts_causal_visible_pairs(T):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    B, H, D = 2, 3, 16
    vis = fa._bhqk_visibility(T, T, True, None, torch.device("cpu"))
    pairs = B * H * int(vis.sum())
    assert pairs == B * H * T * (T + 1) // 2
    for kind, per_product, per_other in (("fwd", 4, 5), ("dq", 6, 6), ("dkv", 8, 6)):
        nbytes, products, other = chip_smoke.attention_work(kind, B, T, H, D, causal=True)
        full = chip_smoke.attention_work(kind, B, T, H, D)
        assert (products, other) == (per_product * pairs * D, per_other * pairs)
        assert full[1:] == (per_product * B * H * T * T * D, per_other * B * H * T * T)
        assert nbytes == full[0]                       # the same tensors move
