"""The ring hop hook and the per-rank telemetry files at two gloo ranks.

The port's ``set_ring_hop_hook`` against the JAX one: the same flat vector
through the int8 reduce-scatter and all-reduce rings, the port on two gloo
ranks (kernel switch on and off: the plain versions on the CPU), JAX under
``shard_map`` on two CPU devices; the hooks' keywords (``kind``, ``dtype``,
``hop``, ``n_hops``, ``wire_bytes``) are equal and the probes within 1e-6,
and the rings' results are bitwise those without a hook. Then a two-rank
train run through the launcher with ``--telemetry-dir`` on both: each rank
writes ``trace-p<rank>``, the JAX summarizer's skew line reads both, rank 0
alone prints the phase table, and the launcher's ``launch-n0.jsonl`` holds
a spawn and an exit a rank."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

CHUNK, BLOCK, N = 40, 16, 2
KEYS = ("kind", "dtype", "hop", "n_hops", "wire_bytes")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs() -> np.ndarray:
    return np.random.default_rng(21).standard_normal((N, N * CHUNK)).astype(np.float32)


def _hop_worker(rank, n, out_dir):
    import torch

    from tpu_ddp_torch.parallel import collectives as c

    x = torch.from_numpy(_inputs()[rank])
    res = {}
    for kernels in (False, True):
        plain_rs, _ = c.ring_reduce_scatter(x, mode="int8", block=BLOCK, kernels=kernels)
        plain_ar, _ = c.ring_all_reduce(x, mode="int8", block=BLOCK, kernels=kernels)
        calls = []
        prev = c.set_ring_hop_hook(lambda probe, **kw: calls.append(
            {"probe": float(probe), **kw}))
        try:
            rs, _ = c.ring_reduce_scatter(x, mode="int8", block=BLOCK, kernels=kernels)
            ar, _ = c.ring_all_reduce(x, mode="int8", block=BLOCK, kernels=kernels)
        finally:
            assert c.set_ring_hop_hook(prev) is not None
        res[str(kernels)] = {"calls": calls, "same": bool(torch.equal(rs, plain_rs)
                                                          and torch.equal(ar, plain_ar))}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def port_hops(tmp_path_factory):
    from tpu_ddp_torch.parallel.runtime import spawn

    out = tmp_path_factory.mktemp("hops")
    spawn(_hop_worker, N, str(out), init_file=str(out / "rdzv"), timeout=120)
    return [json.load(open(out / f"rank{r}.json")) for r in range(N)]


@functools.lru_cache(maxsize=None)
def _jax_hops():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.parallel import collectives as jc

    mesh = create_mesh(MeshSpec(data=N), jax.devices()[:N])
    calls = []
    prev = jc.set_ring_hop_hook(lambda probe, **kw: calls.append(
        {"probe": float(np.asarray(probe)), **kw}))
    try:
        for fn in (jc.ring_reduce_scatter, jc.ring_all_reduce):
            f = jax.shard_map(lambda x, fn=fn: fn(x, "data", mode="int8", block=BLOCK)[0],
                              mesh=mesh, in_specs=P("data"), out_specs=P("data"))
            jax.block_until_ready(f(jnp.asarray(_inputs()).reshape(-1)))
            jax.effects_barrier()
    finally:
        jc.set_ring_hop_hook(prev)
    return tuple(calls)


def _by_hop(calls):
    """{(kind, hop): (keywords, sorted probes)} over the ranks' calls."""
    out = {}
    for call in calls:
        kw = tuple(call[k] for k in KEYS)
        key = (call["kind"], call["hop"])
        want, probes = out.setdefault(key, (kw, []))
        assert kw == want
        probes.append(call["probe"])
    return {k: (kw, sorted(p)) for k, (kw, p) in out.items()}


@pytest.mark.parametrize("kernels", ["False", "True"])
def test_hop_hook_keywords_equal_jax(devices, port_hops, kernels):
    from tpu_ddp.parallel.compression import chunk_wire_bytes

    port = _by_hop([c for rank in port_hops for c in rank[kernels]["calls"]])
    jax_ = _by_hop(_jax_hops())
    assert set(port) == set(jax_) == {("ring-reduce-scatter", 1), ("ring-all-reduce", 1),
                                      ("ring-all-reduce", 2)}
    for key, (kw, probes) in port.items():
        assert kw == jax_[key][0]
        assert len(probes) == N and np.allclose(probes, jax_[key][1], rtol=0, atol=1e-6)
    assert port[("ring-reduce-scatter", 1)][0] == (
        "ring-reduce-scatter", "s8", 1, 1, chunk_wire_bytes(CHUNK, "int8", BLOCK))
    assert all(rank[kernels]["same"] for rank in port_hops)
    assert all(c["axis"] == "data" for rank in port_hops for c in rank[kernels]["calls"])


def test_two_ranks_write_their_own_traces_and_the_launcher_its_events(tmp_path):
    from tpu_ddp.telemetry.summarize import summarize

    run_dir = tmp_path / "tel"
    cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
           "--telemetry-dir", str(run_dir), "--", sys.executable, "-m",
           "tpu_ddp_torch.cli.train", "--device", "cpu", "--synthetic-data",
           "--synthetic-size", "64", "--batch-size", "8", "--epochs", "1", "--n-chans1", "8",
           "--n-blocks", "2", "--kernels", "--grad-compress", "int8",
           "--telemetry-dir", str(run_dir)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(os.listdir(run_dir))
    assert {"trace-p0.jsonl", "trace-p1.jsonl", "trace-p0.trace.json", "trace-p1.trace.json",
            "data-p0.jsonl", "data-p1.jsonl", "launch-n0.jsonl"} <= names
    # the summary sink prints from rank 0 alone
    assert sum(line.startswith("phase ") for line in proc.stdout.splitlines()) == 1
    text = summarize(str(run_dir))
    assert "per-host skew: compiled_step" in text
    for r in range(2):
        recs = [json.loads(line) for line in open(run_dir / f"trace-p{r}.jsonl")]
        assert recs[0]["pid"] == r and recs[0]["run_meta"]["n_devices"] == 2
        final = recs[-1]["attrs"]["counters"]
        assert final["train/steps"] == 4 and final["comm/grad_bytes_on_wire"] > 0
    events = [json.loads(line) for line in open(run_dir / "launch-n0.jsonl")]
    kinds = [e["name"] for e in events if e["type"] == "instant"]
    assert kinds[0] == "job_start" and kinds[-2:] == ["job_end", "run_end"]
    assert kinds.count("child_spawn") == kinds.count("child_exit") == 2
    assert sorted(e["attrs"]["process_id"] for e in events if e.get("name") == "child_spawn") \
        == [0, 1]
    assert all(e["attrs"]["code"] == 0 for e in events if e.get("name") == "child_exit")
