"""The port's compressed gradient ring (``parallel/collectives.py``) on CPU
ranks over gloo, against the JAX ring under ``jax.shard_map`` on as many
CPU devices, on the same numpy inputs.

The JAX ring runs eagerly (``shard_map`` outside ``jit`` executes op by op),
as the port does: under ``jit`` XLA:CPU contracts a hop's ``add_to + q *
scale`` into one FMA. Outputs and errors are then bitwise equal rank by
rank in f32, bf16 and int8 (block 16 over chunks of 40: two full blocks and
a tail), with and without the kernel route (on CPU tensors the kernel
wrappers take their plain versions). Error-feedback telescoping is held to
``atol 1e-4`` over 6 rounds, as in ``tests/test_compression.py``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpu_ddp.parallel import MeshSpec, create_mesh
from tpu_ddp.parallel.collectives import ring_all_reduce as jax_ring_all_reduce
from tpu_ddp.parallel.collectives import ring_reduce_scatter as jax_ring_reduce_scatter

CHUNK = 40
BLOCK = 16
MODES = ("f32", "bf16", "int8")
ROUNDS = 6


def _inputs(n: int) -> np.ndarray:
    return np.random.default_rng(n).standard_normal((n, n * CHUNK)).astype(np.float32)


#: leaf name -> shape, for the compressor's entry points
TREE = {"w": np.empty((3, 7)), "b": np.empty((5,))}


def _tree_inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    return {k: rng.standard_normal((n,) + v.shape).astype(np.float32)
            for k, v in TREE.items()}


def _ring_worker(rank, n, out_dir):
    import torch

    from tpu_ddp_torch.parallel.collectives import ring_all_reduce, ring_reduce_scatter
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    x = torch.from_numpy(_inputs(n)[rank])
    res = {}
    for mode in MODES:
        for kernels in (False, True):
            rs, rs_err = ring_reduce_scatter(x, mode=mode, block=BLOCK,
                                             with_error=True, kernels=kernels)
            ar, ar_err = ring_all_reduce(x, mode=mode, block=BLOCK,
                                         with_error=True, kernels=kernels)
            for key, t in (("rs", rs), ("rs_err", rs_err), ("ar", ar),
                           ("ar_err", ar_err)):
                res[f"{mode}/{kernels}/{key}"] = t.numpy()
    r = torch.zeros_like(x)
    outs = []
    for _ in range(ROUNDS):
        out, r = ring_all_reduce(x + r, mode="int8", block=BLOCK, with_error=True)
        outs.append(out)
    res["tele/outs"] = torch.stack(outs).numpy()
    res["tele/res"] = r.numpy()
    # the compressor's entry points over a two-leaf tree (sizes not divisible
    # by n: the padding path)
    comp = GradCompressor(GradCompression(mode="int8", block=BLOCK), TREE, n)
    tree = {k: torch.from_numpy(v[rank]) for k, v in _tree_inputs(n).items()}
    mean, err = comp.all_reduce_mean(tree, with_error=True)
    shards, _ = comp.reduce_scatter_mean_flat(comp.flatten(tree))
    for k in TREE:
        res[f"comp/mean/{k}"] = mean[k].numpy()
        res[f"comp/err/{k}"] = err[k].numpy()
        res[f"comp/shard/{k}"] = shards[k].numpy()
    res["comp/error_sq"] = comp.error_sq(err).numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    runs = {}
    for n in (2, 4):
        out = tmp_path_factory.mktemp(f"ring{n}")
        spawn(_ring_worker, n, str(out), init_file=str(out / "rdzv"), timeout=120)
        runs[n] = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return runs


@pytest.fixture(autouse=True, scope="module")
def _drop_cached_jax_results():
    """Clear this module's caches when its tests end: their results can be
    numpy views of JAX buffers, which would otherwise stay alive in the
    worker process and count in a later file's ``jax.live_arrays()``
    (``tests/test_memtrack.py``)."""
    yield
    for fn in (_jax_ring,):
        fn.cache_clear()


@functools.lru_cache(maxsize=None)
def _jax_ring(n, mode):
    devices = jax.devices()
    mesh = create_mesh(MeshSpec(data=n), devices[:n])

    def body(x):
        rs, rs_err = jax_ring_reduce_scatter(x, "data", mode=mode, block=BLOCK,
                                             with_error=True)
        ar, ar_err = jax_ring_all_reduce(x, "data", mode=mode, block=BLOCK,
                                         with_error=True)
        return rs, rs_err, ar, ar_err

    f = jax.shard_map(body, mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    outs = f(jnp.asarray(_inputs(n)).reshape(-1))
    keys = ("rs", "rs_err", "ar", "ar_err")
    sizes = (CHUNK, n * CHUNK, n * CHUNK, n * CHUNK)
    return {k: np.asarray(o).reshape(n, s) for k, o, s in zip(keys, outs, sizes)}


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [2, 4])
def test_ring_bitwise_equal_jax_ring(devices, port_runs, n, mode, kernels):
    want = _jax_ring(n, mode)
    for rank, got in enumerate(port_runs[n]):
        for key, w in want.items():
            g = got[f"{mode}/{kernels}/{key}"]
            assert g.dtype == np.float32 and g.shape == w[rank].shape
            assert np.array_equal(g.view(np.int32), w[rank].view(np.int32)), (
                f"rank {rank} {key}")


@pytest.mark.parametrize("n", [2, 4])
def test_int8_all_reduce_identical_on_every_rank(port_runs, n):
    outs = [run["int8/True/ar"] for run in port_runs[n]]
    assert all(o.tobytes() == outs[0].tobytes() for o in outs)
    np.testing.assert_allclose(outs[0], _inputs(n).sum(0), atol=0.2)


@pytest.mark.parametrize("n", [2, 4])
def test_error_feedback_telescopes(port_runs, n):
    """sum of the k outputs + the ranks' final residuals == k * true sum."""
    runs = port_runs[n]
    outs = runs[0]["tele/outs"]
    assert all(np.array_equal(r["tele/outs"], outs) for r in runs)
    res_sum = sum(r["tele/res"] for r in runs)
    true = _inputs(n).sum(0)
    np.testing.assert_allclose(outs.sum(0) + res_sum, ROUNDS * true, rtol=0,
                               atol=1e-4)
    assert np.abs(outs.mean(0) - true).max() < np.abs(outs[0] - true).max()


@pytest.mark.parametrize("n", [2, 4])
def test_compressor_entry_points(port_runs, n):
    """``all_reduce_mean`` is the ring's sum over n (identical on every
    rank, close to the true mean), ``reduce_scatter_mean_flat`` gives each
    rank its 1/n of the padded flat mean, and ``error_sq`` is the sum over
    the ranks of the squared residuals."""
    runs, inputs = port_runs[n], _tree_inputs(n)
    err_sq = sum(float(np.sum(np.square(r[f"comp/err/{k}"])))
                 for r in runs for k in TREE)
    for rank, got in enumerate(runs):
        np.testing.assert_allclose(got["comp/error_sq"], err_sq, rtol=1e-6)
        for k, shape in TREE.items():
            mean = got[f"comp/mean/{k}"]
            assert mean.shape == shape.shape
            assert mean.tobytes() == runs[0][f"comp/mean/{k}"].tobytes()
            np.testing.assert_allclose(mean, inputs[k].mean(0), atol=0.05)
            size = int(np.prod(shape.shape))
            flat_mean = np.zeros(size + (-size) % n, np.float32)
            flat_mean[:size] = inputs[k].mean(0).reshape(-1)
            s = flat_mean.size // n
            np.testing.assert_allclose(got[f"comp/shard/{k}"],
                                       flat_mean[rank * s:(rank + 1) * s], atol=0.05)
