"""The flat ring (``parallel/collectives.py::FlatLayout``): one ring over all
leaves of a step, one wire message and one K2 / K3 pass a hop, held to the
JAX package's per-leaf ring on the same numpy inputs.

``GradCompressor.all_reduce_mean`` (its output and its residual
``err_state``) and ``reduce_scatter_mean_flat`` run on gloo CPU ranks at
n = 2, 3 and 4, over a tree of six leaves in an order that is not sorted:
chunks that are not block multiples, a block-multiple chunk, and leaves of
one and three elements, smaller than n. Two steps each: the first from a
given residual, the second from the residual the first returned. The JAX
``tpu_ddp.parallel.compression.GradCompressor`` runs the same under
an eager ``jax.vmap`` over the named axis (op by op, as
``tests/test_torch_collectives.py`` runs the JAX ring under an eager
``jax.shard_map``: under ``jit`` XLA:CPU contracts a hop's ``add_to + q *
scale`` into one FMA), and once under an eager ``jax.shard_map`` too, which
the vmap oracle matches bitwise. Every leaf is held bitwise, in f32, bf16 and int8,
int8 at block 16 and at block 7 (a message of an odd number of bytes, so the
all-gather's rows start unaligned), with the kernel switch on and off (on
CPU tensors the kernel wrappers take their plain versions).

The plan tests hold the layout itself: scale blocks restart at every leaf's
chunk, a hop's message has the bytes ``accounting()`` counts, the segment
table serves more than 128 leaves, the segment plain versions equal
``quantize_chunk`` / ``dequantize_chunk`` run leaf by leaf (the JAX
package's too), and a step's ring makes n wire calls (n - 1 under the
reduce-scatter alone).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.parallel import compression as jc
from tpu_ddp_torch import ops
from tpu_ddp_torch.ops.fused_quant import (
    segment_dequant,
    segment_dequant_plain,
    segment_quant,
    segment_quant_plain,
)
from tpu_ddp_torch.parallel import compression as tc
from tpu_ddp_torch.parallel.collectives import FlatLayout

#: leaf name -> shape, insertion order unsorted (JAX's trees sort their keys)
TREE = {"conv": (4, 3, 3), "bias": (5,), "one": (1,), "fc": (7, 9),
        "tiny": (3,), "big": (2, 50)}
RANKS = (2, 3, 4)
#: (mode, block): block 7 makes a message of an odd number of bytes
CONFIGS = (("f32", 16), ("bf16", 16), ("int8", 16), ("int8", 7))
STEPS = 2


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _inputs(n: int):
    """Per-rank grads ``(n, *shape)`` for each step, and the first step's
    residual ``(n, padded)``."""
    rng = np.random.default_rng(700 + n)
    grads = [{k: (rng.standard_normal((n,) + s) * 2).astype(np.float32)
              for k, s in TREE.items()} for _ in range(STEPS)]
    residual = {}
    for k, s in TREE.items():
        size = int(np.prod(s))
        r = np.zeros((n, size + (-size) % n), np.float32)
        r[:, :size] = rng.standard_normal((n, size)) * 0.01
        residual[k] = r
    return grads, residual


def _port_worker(rank, n, out_dir):
    from tpu_ddp_torch.parallel import collectives
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    calls = {"wire": 0}
    for name in ("exchange", "all_gather_bytes"):
        fn = getattr(collectives, name)

        def counted(*a, _fn=fn, **kw):
            calls["wire"] += 1
            return _fn(*a, **kw)

        setattr(collectives, name, counted)
    grads, residual = _inputs(n)
    template = {k: np.empty(s) for k, s in TREE.items()}
    res = {}
    for mode, block in CONFIGS:
        for kernels in (False, True):
            tag = f"{mode}/{block}/{kernels}"
            comp = GradCompressor(GradCompression(mode=mode, block=block,
                                                  kernels=kernels), template, n)
            ar_res = rs_res = {k: torch.from_numpy(v[rank]) for k, v in residual.items()}
            for step, g in enumerate(grads):
                tree = {k: torch.from_numpy(v[rank]) for k, v in g.items()}
                before = calls["wire"]
                mean, ar_res = comp.all_reduce_mean(tree, ar_res, with_error=True)
                res[f"{tag}/wire_ar"] = calls["wire"] - before
                before = calls["wire"]
                shards, rs_res = comp.reduce_scatter_mean_flat(
                    comp.flatten(tree), rs_res, with_error=True)
                res[f"{tag}/wire_rs"] = calls["wire"] - before
                for k in TREE:
                    res[f"{tag}/{step}/mean/{k}"] = mean[k].numpy()
                    res[f"{tag}/{step}/err/{k}"] = ar_res[k].numpy()
                    res[f"{tag}/{step}/shard/{k}"] = shards[k].numpy()
                    res[f"{tag}/{step}/rs_err/{k}"] = rs_res[k].numpy()
    res["launches"] = np.array(sum(ops.launch_counts().values()))
    np.savez(f"{out_dir}/rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    runs = {}
    for n in RANKS:
        out = tmp_path_factory.mktemp(f"flat{n}")
        spawn(_port_worker, n, str(out), init_file=str(out / "rdzv"), timeout=180)
        runs[n] = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return runs


def _jax_body(n, mode, block):
    """One step of the JAX compressor on one rank: ``(mean, err, shards,
    rs_err)`` from ``(grads, all-reduce residual, reduce-scatter
    residual)``, the residuals one ``(padded,)`` row a leaf."""
    template = {k: np.empty(s) for k, s in TREE.items()}
    comp = jc.GradCompressor(jc.GradCompression(mode=mode, block=block),
                             template, n)

    def body(g, ar_res, rs_res):
        mean, err = comp.all_reduce_mean(
            g, {k: v[None] for k, v in ar_res.items()}, with_error=True)
        shards, rs_err = comp.reduce_scatter_mean_flat(
            comp.flatten(g), {k: v[None] for k, v in rs_res.items()},
            with_error=True)
        return (mean, {k: v[0] for k, v in err.items()}, shards,
                {k: v[0] for k, v in rs_err.items()})

    return body


@pytest.fixture(autouse=True, scope="module")
def _drop_cached_jax_results():
    """Clear this module's caches when its tests end: their results can be
    numpy views of JAX buffers, which would otherwise stay alive in the
    worker process and count in a later file's ``jax.live_arrays()``
    (``tests/test_memtrack.py``)."""
    yield
    for fn in (_jax_runs,):
        fn.cache_clear()


@functools.lru_cache(maxsize=None)
def _jax_runs(n, mode, block):
    """The JAX compressor's two steps on n ranks, each leaf ``(n, ...)`` in
    rank order. The ranks are the named axis ``data`` of an eager
    ``jax.vmap``: op by op, as eager ``shard_map`` runs them (no fusion, so
    no FMA), without ``shard_map``'s compile of every op (about 0.1 s an op
    under jax 0.9). ``test_vmap_oracle_is_the_shard_map_ring`` holds the
    two bitwise."""
    f = jax.vmap(_jax_body(n, mode, block), axis_name="data")
    grads, residual = _inputs(n)
    ar_res = rs_res = {k: jnp.asarray(v) for k, v in residual.items()}
    steps = []
    for g in grads:
        mean, ar_res, shards, rs_res = f({k: jnp.asarray(v) for k, v in g.items()},
                                         ar_res, rs_res)
        steps.append(jax.tree.map(np.asarray, (mean, ar_res, shards, rs_res)))
    return steps


def test_vmap_oracle_is_the_shard_map_ring(devices):
    """The first step at two ranks in int8 (the main path's mode), under
    ``jax.shard_map`` on two CPU devices run eagerly, is bitwise the vmap
    oracle's."""
    n, mode, block = 2, "int8", 16
    mesh = create_mesh(MeshSpec(data=n), devices[:n])
    body = _jax_body(n, mode, block)

    def per_device(g, ar_res, rs_res):
        out = body({k: v[0] for k, v in g.items()},
                   {k: v[0] for k, v in ar_res.items()},
                   {k: v[0] for k, v in rs_res.items()})
        return jax.tree.map(lambda v: v[None], out)

    f = jax.shard_map(per_device, mesh=mesh, in_specs=(P("data"),) * 3,
                      out_specs=P("data"))
    grads, residual = _inputs(n)
    res = {k: jnp.asarray(v) for k, v in residual.items()}
    got = f({k: jnp.asarray(v) for k, v in grads[0].items()}, res, res)
    want = _jax_runs(n, mode, block)[0]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(_bits(g), _bits(w))


def _check(port_runs, n, mode, block, kernels, keys):
    want = _jax_runs(n, mode, block)
    for rank, got in enumerate(port_runs[n]):
        for step in range(STEPS):
            for key, idx in keys:
                for k in TREE:
                    g = got[f"{mode}/{block}/{kernels}/{step}/{key}/{k}"]
                    w = want[step][idx][k][rank]
                    assert g.dtype == np.float32 and g.shape == w.shape, (key, k)
                    assert np.array_equal(_bits(g), _bits(w)), (
                        f"rank {rank} step {step} {key} leaf {k}")


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("mode,block", CONFIGS)
@pytest.mark.parametrize("n", RANKS)
def test_all_reduce_mean_bitwise_equal_jax(devices, port_runs, n, mode, block, kernels):
    """Every leaf of the mean and of the residual, on every rank, two steps."""
    _check(port_runs, n, mode, block, kernels, (("mean", 0), ("err", 1)))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("mode,block", CONFIGS)
@pytest.mark.parametrize("n", RANKS)
def test_reduce_scatter_mean_flat_bitwise_equal_jax(devices, port_runs, n, mode,
                                                     block, kernels):
    """Every leaf's shard and residual (zero at the rank's own chunk), on
    every rank, two steps."""
    _check(port_runs, n, mode, block, kernels, (("shard", 2), ("rs_err", 3)))


@pytest.mark.parametrize("n", RANKS)
def test_one_wire_message_a_hop(port_runs, n):
    """n - 1 exchanges and one all-gather a step (n - 1 exchanges under the
    reduce-scatter), whatever the number of leaves; CPU tensors launch no
    kernel."""
    for got in port_runs[n]:
        for mode, block in CONFIGS:
            for kernels in (False, True):
                assert got[f"{mode}/{block}/{kernels}/wire_ar"] == n
                assert got[f"{mode}/{block}/{kernels}/wire_rs"] == n - 1
        assert got["launches"] == 0


# ---- the plan -------------------------------------------------------------


def _padded(n):
    return [int(np.prod(s)) + (-int(np.prod(s))) % n for s in TREE.values()]


@pytest.mark.parametrize("block", [16, 7])
@pytest.mark.parametrize("n", RANKS)
def test_scale_blocks_restart_at_every_leaf(n, block):
    layout = FlatLayout(_padded(n), n, block)
    nb = [-(-p // n // block) for p in _padded(n)]
    assert layout.first_block == tuple(np.cumsum([0] + nb[:-1]))
    assert layout.n_blocks == sum(nb)
    assert layout.offsets == tuple(np.cumsum([0] + _padded(n)[:-1]))
    table = layout.table(torch.device("cpu"))
    assert table.dtype == torch.int64 and table.shape == (len(TREE), 4)
    assert table[:, 0].tolist() == list(layout.offsets)
    assert table[:, 1].tolist() == [p // n for p in _padded(n)]
    assert table[:, 2].tolist() == list(layout.first_block)
    assert table[:, 3].tolist() == list(layout.rows.offsets)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", RANKS)
def test_message_bytes_equal_accounting(n, mode):
    """(n - 1) hops and one gathered message a rank: the port's messages
    carry exactly the bytes the JAX package's accounting counts."""
    template = {k: np.empty(s) for k, s in TREE.items()}
    comp = tc.GradCompressor(tc.GradCompression(mode=mode, block=16), template, n)
    want = jc.GradCompressor(jc.GradCompression(mode=mode, block=16),
                             template, n).accounting()
    assert comp.accounting() == want
    msg = comp.layout.msg_bytes(mode)
    assert msg == sum(tc.chunk_wire_bytes(p // n, mode, 16) for p in _padded(n))
    assert (n - 1) * msg == want["reduce_scatter_bytes_on_wire_per_device"]
    assert 2 * (n - 1) * msg == want["all_reduce_bytes_on_wire_per_device"]
    x = torch.randn(comp.layout.total)
    assert segment_quant_plain(x, comp.layout, 0, mode).numel() == msg


def _segment_case(padded, n, block, seed):
    rng = np.random.default_rng(seed)
    layout = FlatLayout(padded, n, block)
    x = torch.from_numpy((rng.standard_normal(layout.total) * 3).astype(np.float32))
    add = torch.from_numpy(rng.standard_normal(layout.total).astype(np.float32))
    return layout, x, add


@pytest.mark.parametrize("case", ["tree3", "tree4_block7", "vit_b16_151"])
def test_segment_plain_versions_equal_per_leaf(case):
    """K2's and K3's segment plain versions (and the CPU route of their
    wrappers) give, for every leaf, the bits of ``quantize_chunk`` /
    ``dequantize_chunk`` of that leaf's chunk alone, the JAX package's
    too: the message, the error, the accumulate, the shard row and the
    n-row gather. ``vit_b16_151``: ViT-B/16's 151 leaves, more than K1's
    table of 128 (its sizes cut by 4096, rounded up)."""
    if case == "tree3":
        n, block, padded = 3, 16, _padded(3)
    elif case == "tree4_block7":
        n, block, padded = 4, 7, _padded(4)
    else:
        from tpu_ddp_torch.models import MODEL_REGISTRY

        with torch.device("meta"):
            model = MODEL_REGISTRY["vit_b16"](image_size=224)
        n, block = 2, 16
        sizes = [-(-p.numel() // 4096) for p in model.parameters()]
        padded = [s + s % n for s in sizes]
        assert len(padded) == 151
    layout, x, add = _segment_case(padded, n, block, seed=len(padded))
    assert layout.table(torch.device("cpu")).shape == (len(padded), 4)
    ops.reset_launch_counts()
    for c in range(n):
        err = torch.zeros(layout.total)
        msg = segment_quant(x, layout, c, err=err)
        assert torch.equal(msg, segment_quant_plain(x, layout, c, "int8"))
        acc = torch.zeros(layout.total)
        segment_dequant(msg, layout, acc, add=add, add_chunk=(c + 1) % n,
                        out_chunk=(c + 1) % n)
        row = torch.zeros(layout.rows.width)
        segment_dequant(msg, layout, row, add=add, add_chunk=c, to_rows=True)
        views = layout.payload(msg, "int8")
        for i in range(len(padded)):
            p = layout.chunk(x, i, c)
            want = tc.quantize_chunk(p, "int8", block)
            jwant = jc.quantize_chunk(jnp.asarray(p.numpy()), "int8", block)
            assert torch.equal(views[i]["q"], want["q"])
            assert np.array_equal(views[i]["q"].numpy(), np.asarray(jwant["q"]))
            assert np.array_equal(_bits(views[i]["scale"]), _bits(jwant["scale"]))
            d = tc.dequantize_chunk(want, "int8", block, p.numel())
            jd = jc.dequantize_chunk(jwant, "int8", block, p.numel())
            assert np.array_equal(_bits(d), _bits(jd))
            assert np.array_equal(_bits(layout.chunk(err, i, c)), _bits(p - d))
            c1 = (c + 1) % n
            assert np.array_equal(_bits(layout.chunk(acc, i, c1)),
                                  _bits(layout.chunk(add, i, c1) + d))
            r0 = layout.rows.offsets[i]
            assert np.array_equal(_bits(row[r0:r0 + layout.shard[i]]),
                                  _bits(layout.chunk(add, i, c) + d))
    # the all-gather's n rows in one pass: row r into chunk r of every leaf
    msgs = torch.stack([segment_quant(x, layout, c) for c in range(n)])
    out = torch.zeros(layout.total)
    segment_dequant(msgs, layout, out)
    for c in range(n):
        for i, views in enumerate(layout.payload(msgs[c].clone(), "int8")):
            d = tc.dequantize_chunk(views, "int8", block, layout.shard[i])
            assert np.array_equal(_bits(layout.chunk(out, i, c)), _bits(d))
    assert torch.equal(out, segment_dequant_plain(msgs, layout, "int8",
                                                  torch.zeros(layout.total)))
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("n", RANKS)
def test_cast_hops_equal_segment_plain_versions(n, mode):
    """The f32 and bf16 hops (one cat and one cast a message, one cast and
    multi-tensor ops back) give the bits of the segment plain versions
    (``quantize_chunk`` / ``dequantize_chunk`` leaf by leaf): the message,
    the error, the accumulate, the shard row and the n-row gather."""
    from tpu_ddp_torch.parallel.collectives import _cast_hop, _uncast_hop

    layout, x, add = _segment_case(_padded(n), n, 16, seed=40 + n)
    for c in range(n):
        err, want_err = torch.zeros(layout.total), torch.zeros(layout.total)
        msg = _cast_hop(x, layout, c, mode, err)
        assert torch.equal(msg, segment_quant_plain(x, layout, c, mode, err=want_err))
        assert np.array_equal(_bits(err), _bits(want_err))
        c1 = (c + 1) % n
        for where in (dict(add=add, add_chunk=c1, out_chunk=c1),
                      dict(add=add, add_chunk=c, to_rows=True)):
            width = layout.rows.width if where.get("to_rows") else layout.total
            got = _uncast_hop(msg, layout, mode, torch.zeros(width), **where)
            want = segment_dequant_plain(msg, layout, mode, torch.zeros(width), **where)
            assert np.array_equal(_bits(got), _bits(want))
    msgs = torch.stack([_cast_hop(x, layout, c, mode, None) for c in range(n)])
    got = _uncast_hop(msgs, layout, mode, torch.zeros(layout.total))
    want = segment_dequant_plain(msgs, layout, mode, torch.zeros(layout.total))
    assert np.array_equal(_bits(got), _bits(want))


def test_flattened_leaves_join_without_a_copy():
    """``flatten``'s leaves, a residual and an ``err_state`` are views of one
    leaf-major buffer, which the ring reads as it is; other per-leaf
    tensors are joined by one cat into the same values."""
    template = {k: np.empty(s) for k, s in TREE.items()}
    comp = tc.GradCompressor(tc.GradCompression(error_feedback=True), template, 3)
    tree = {k: torch.randn(s) for k, s in TREE.items()}
    flat = comp.flatten(tree)
    joined = comp._joined(flat)
    assert joined is flat["conv"]._base
    res = comp.init_residual(torch.device("cpu"))
    assert comp._joined(res) is res["conv"]._base
    copies = {k: v.clone() for k, v in flat.items()}
    again = comp._joined(copies)
    assert again.data_ptr() != joined.data_ptr() and torch.equal(again, joined)
    assert comp._joined(dict(reversed(list(flat.items())))) is joined


def test_residual_is_views_of_one_buffer():
    template = {k: np.empty(s) for k, s in TREE.items()}
    comp = tc.GradCompressor(tc.GradCompression(error_feedback=True), template, 3)
    res = comp.init_residual(torch.device("cpu"))
    base = res["conv"]._base
    assert base is not None and base.numel() == comp.layout.total
    for (k, r), off, p in zip(res.items(), comp.layout.offsets, comp.layout.padded):
        assert r._base is base and r.is_contiguous()
        assert r.storage_offset() == off and r.shape == (p,) and not r.any()
    flat = comp.flatten({k: torch.ones(s) for k, s in TREE.items()})
    assert all(v._base is flat["conv"]._base for v in flat.values())
    assert [int(v.sum()) for v in flat.values()] == [int(np.prod(s)) for s in TREE.values()]


def test_segment_wrappers_refuse_bad_operands():
    layout = FlatLayout(_padded(2), 2, 16)
    with pytest.raises(ValueError, match="no kernel for device"):
        segment_quant(torch.zeros(layout.total, device="meta"), layout, 0)
    with pytest.raises(ValueError, match="chunk 2 outside"):
        segment_quant(torch.zeros(layout.total), layout, 2)
    with pytest.raises(ValueError, match="contiguous float32"):
        segment_quant(torch.zeros(layout.total + 1), layout, 0)
    msg = segment_quant(torch.ones(layout.total), layout, 0)
    with pytest.raises(ValueError, match="uint8 rows"):
        segment_dequant(msg[1:], layout, torch.zeros(layout.total))
    shifted = torch.empty(msg.numel() + 1, dtype=torch.uint8)[1:]
    shifted.copy_(msg)
    with pytest.raises(ValueError, match="4-byte aligned"):
        segment_dequant(shifted, layout, torch.zeros(layout.total))
    with pytest.raises(ValueError, match="to_rows takes one"):
        segment_dequant(torch.stack([msg, msg]), layout,
                        torch.zeros(layout.rows.width), to_rows=True)
    with pytest.raises(ValueError, match="not all multiples"):
        FlatLayout([3, 4], 2, 16)
