"""Ring attention in the port (``tpu_ddp_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention`` and ``ring_flash_attention``
under ``shard_map``, at 2, 3 and 4 gloo CPU ranks.

The same numpy q, k, v ``(2, 8n, 2, 8)`` and key mask go through both: each
port rank takes its chunk of the sequence (rank r, rows ``[8r, 8r + 8)``),
the JAX rings run on a ``data=1, sequence=n`` mesh of the conftest's CPU
devices. On the CPU the JAX flash ring takes its jnp tile (interpret mode
under ``shard_map``) and the port's flash ring the plain versions of
K4-K6; both are exact attention. Cases: causal and not, without and with a
key mask; the mask hides batch row 1's keys but the first, and in the
non-causal case all of batch row 0's keys on the last rank's chunk, so the
mask travels the ring with its chunk, and batch row 1's queries past key 0
see one key at most. One more case hides every key of batch row 1: its
rows are dead (output exactly 0, finite, zero gradients). The loss is
``sum(out * cos(arange(D)))``, as in ``tests/test_ring_attention.py``,
whose tolerances hold: output ``atol=2e-5, rtol=2e-5`` against JAX and
against plain full attention; gradients of q, k and v ``atol=5e-5``.

Also ``ring_shift`` by +1 and -1 against the JAX ``ring_shift``, and
``sequence_sharded_attention``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

RINGS = (2, 3, 4)
B, T_LOCAL, H, D = 2, 8, 2, 8
#: case -> (causal, mask kind)
CASES = {"plain": (False, None), "masked": (False, "partial"),
         "causal": (True, None), "causal_masked": (True, "partial"),
         "dead_row": (False, "dead")}
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=0)


def _inputs(n):
    rng = np.random.default_rng(10 + n)
    q, k, v = (rng.standard_normal((B, n * T_LOCAL, H, D)).astype(np.float32)
               for _ in range(3))
    masks = {None: np.ones((B, n * T_LOCAL), np.float32)}
    partial = (rng.random((B, n * T_LOCAL)) > 0.3).astype(np.float32)
    partial[1, :] = 0.0
    partial[1, 0] = 1.0
    masks["partial"] = partial
    dead = partial.copy()
    dead[0, -T_LOCAL:] = 0.0            # the last chunk's keys of row 0
    dead[1, :] = 0.0                    # no key of row 1
    masks["dead"] = dead
    return q, k, v, masks


def _weight():
    return np.cos(np.arange(D)).astype(np.float32)


def _worker(rank, n, path):
    from tpu_ddp_torch.parallel.collectives import ring_shift
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
        sequence_sharded_attention,
    )

    mesh = create_mesh({"sequence": n})
    group = mesh.sequence_group()
    q, k, v, masks = _inputs(n)
    rows = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
    w = torch.from_numpy(_weight())
    out = {}
    for name, (causal, kind) in CASES.items():
        for flash, ring in (("flash", ring_flash_attention), ("plain", ring_attention)):
            ql, kl, vl = (torch.from_numpy(t[:, rows].copy()).requires_grad_()
                          for t in (q, k, v))
            km = None if kind is None else torch.from_numpy(masks[kind][:, rows].copy())
            o = ring(ql, kl, vl, group=group, causal=causal, kv_mask=km)
            (o * w).sum().backward()
            out[(name, flash)] = [t.detach().clone() for t in (o, ql.grad, kl.grad, vl.grad)]
    x = torch.full((2, 3), float(rank))
    out["shift"] = {s: ring_shift(x, group, shift=s) for s in (1, -1)}
    g = [torch.from_numpy(t) for t in (q, k, v)]
    out["sharded"] = sequence_sharded_attention(*g, group=group, causal=True)
    torch.save(out, f"{path}/rank{rank}.pt")


@pytest.fixture(scope="module", params=RINGS, ids=lambda n: f"n{n}")
def ranks(request, tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    n = request.param
    path = tmp_path_factory.mktemp(f"ring{n}")
    spawn(_worker, n, str(path), init_file=str(path / "rdzv"), timeout=240)
    return n, [torch.load(path / f"rank{r}.pt") for r in range(n)]


def _jax_ring(n, causal, mask, flash):
    """(out, dq, dk, dv) of the JAX ring on the global inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel.ring_attention import ring_attention, ring_flash_attention

    q, k, v, masks = _inputs(n)
    km = masks[mask]
    mesh = create_mesh(MeshSpec(data=1, sequence=n), jax.devices()[:n])
    spec = P(None, "sequence")
    fn = ring_flash_attention if flash else ring_attention

    def local(a, b, c, m):
        return fn(a, b, c, axis_name="sequence", causal=causal,
                  kv_mask=None if mask is None else m)

    ring = jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)
    w = jnp.asarray(_weight())
    out = jax.jit(ring)(q, k, v, km)
    grads = jax.jit(jax.grad(lambda a, b, c: (ring(a, b, c, km) * w).sum(),
                             (0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


def _full(n, causal, mask):
    """(out, dq, dk, dv) of the port's plain full attention on the global
    inputs (``ops/flash_attention.py::reference``)."""
    from tpu_ddp_torch.ops.flash_attention import reference

    q, k, v, masks = _inputs(n)
    a, b, c = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    km = None if mask is None else torch.from_numpy(masks[mask])
    o = reference(a, b, c, causal=causal, kv_mask=km)
    (o * torch.from_numpy(_weight())).sum().backward()
    return [t.detach().numpy() for t in (o, a.grad, b.grad, c.grad)]


def _gathered(runs, key):
    return [torch.cat([r[key][i] for r in runs], dim=1).numpy() for i in range(4)]


def _close(got, want, label):
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        tol = FWD_TOL if i == 0 else GRAD_TOL
        np.testing.assert_allclose(got[i], want[i], err_msg=f"{label} {name}", **tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tile", ["flash", "plain"])
def test_ring_matches_jax_and_full(ranks, case, tile):
    n, runs = ranks
    causal, mask = CASES[case]
    got = _gathered(runs, (case, tile))
    _close(got, _jax_ring(n, causal, mask, flash=tile == "flash"), f"n={n} {case} vs JAX")
    _close(got, _full(n, causal, mask), f"n={n} {case} vs full attention")
    for t in got:
        assert np.isfinite(t).all()


def test_dead_rows_are_zero(ranks):
    n, runs = ranks
    _, dq, dk, dv = _gathered(runs, ("dead_row", "flash"))
    out = _gathered(runs, ("dead_row", "flash"))[0]
    _, _, _, masks = _inputs(n)
    assert np.all(out[1] == 0.0) and np.all(dq[1] == 0.0)
    hidden = masks["dead"] == 0.0
    assert np.all(dk[hidden] == 0.0) and np.all(dv[hidden] == 0.0)


def test_flash_and_plain_tiles_agree(ranks):
    """On the CPU the flash ring's wrappers take the plain tiles: the two
    rings give the same bits."""
    _, runs = ranks
    for case in CASES:
        for r in runs:
            for a, b in zip(r[(case, "flash")], r[(case, "plain")]):
                assert torch.equal(a, b), case


def test_ring_shift_matches_jax(ranks):
    import jax
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel.collectives import ring_shift

    n, runs = ranks
    mesh = create_mesh(MeshSpec(data=1, sequence=n), jax.devices()[:n])
    x = np.repeat(np.arange(n, dtype=np.float32), 2 * 3).reshape(n * 2, 3)
    for shift in (1, -1):
        want = np.asarray(jax.jit(jax.shard_map(
            lambda a, s=shift: ring_shift(a, "sequence", s), mesh=mesh,
            in_specs=P("sequence"), out_specs=P("sequence")))(x))
        got = np.concatenate([r["shift"][shift].numpy() for r in runs])
        np.testing.assert_array_equal(got, want)


def test_sequence_sharded_attention(ranks):
    n, runs = ranks
    got = torch.cat([r["sharded"] for r in runs], dim=1).numpy()
    np.testing.assert_allclose(got, _full(n, True, None)[0], **FWD_TOL)
