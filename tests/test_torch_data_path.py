"""The trainer's host data path: the native ring (``--prefetch-depth``, the
default 2), the staged background prefetcher (``--prefetch-batches``) and
the synchronous gather (both 0) give the same batches and the same per-step
losses, bit for bit, with and without fused ``--steps-per-call`` groups,
from any resume point, on one rank and on two gloo ranks. Batches the
consumer still holds are not overwritten when their ring slot is reused; a
stream closed early leaves the ring empty for the next epoch. Also
``--log-every-steps``, ``--n-devices`` and the prefetch flags' checks
(the JAX ``TrainConfig`` messages)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(device="cpu", synthetic_data=True, synthetic_size=150, per_shard_batch=8,
            n_chans1=8, n_blocks=2, epochs=2, kernels=True, log_every_epochs=1)
PATHS = {"ring": dict(prefetch_depth=2), "ring_depth_1": dict(prefetch_depth=1),
         "staged": dict(prefetch_batches=2), "sync": dict(prefetch_depth=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(**kw):
    t = Trainer(TrainConfig(**{**BASE, **kw}))
    try:
        return t, t.run()
    finally:
        t.close()


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_every_path_trains_bitwise_the_synchronous_one(steps_per_call):
    runs = {name: _run(steps_per_call=steps_per_call, **kw) for name, kw in PATHS.items()}
    want_t, want = runs["sync"]
    assert len(want["step_losses"]) == 2 * 19                  # 150 rows, batch 8
    sd = want_t.state.model.state_dict()
    for name, (t, got) in runs.items():
        assert got["step_losses"] == want["step_losses"], name
        assert all(torch.equal(v, t.state.model.state_dict()[k]) for k, v in sd.items()), name
        assert set(got["data_ms"]) == {"data_wait", "h2d"}
        assert all(v >= 0 for v in got["data_ms"].values())


def _stream(trainer, K, start, epoch=2):
    trainer.train_loader.set_epoch(epoch)
    out = []
    for kind, dev, n_real in trainer._epoch_stream(K, start):
        out.append((kind, {k: v.clone() for k, v in dev.items()}, n_real))
    return out


@pytest.mark.parametrize("K,start", [(1, 0), (1, 5), (4, 0), (4, 8), (4, 10)])
def test_streams_yield_the_same_batches(K, start):
    """Every path from index batch ``start``: kinds, shapes, rows, masks and
    the real-row counts equal; and the ring's batches, all held to the end,
    were not overwritten by the slot reuses after them (4 slots, 19 batches)."""
    streams = {}
    for name, kw in PATHS.items():
        t = Trainer(TrainConfig(**{**BASE, **kw}))
        streams[name] = _stream(t, K, start)
        t.close()
    want = streams["sync"]
    assert len(want) == len(range(start, 19)) // K + len(range(start, 19)) % K
    for name, got in streams.items():
        assert len(got) == len(want), name
        for (gk, gb, gn), (wk, wb, wn) in zip(got, want):
            assert (gk, gn) == (wk, wn), name
            for key in wb:
                assert gb[key].dtype == wb[key].dtype and gb[key].shape == wb[key].shape
                assert torch.equal(gb[key], wb[key]), (name, key)


def test_early_close_leaves_the_ring_empty():
    t = Trainer(TrainConfig(**{**BASE, "prefetch_depth": 3}))
    t.train_loader.set_epoch(1)
    stream = t._epoch_stream(1, 0)
    next(stream)
    next(stream)
    stream.close()                 # three submissions were still in flight
    got = _stream(t, 1, 0, epoch=2)
    t.close()
    ref = Trainer(TrainConfig(**{**BASE, "prefetch_depth": 0}))
    want = _stream(ref, 1, 0, epoch=2)
    ref.close()
    assert len(got) == len(want)
    assert all(torch.equal(g[1]["image"], w[1]["image"]) for g, w in zip(got, want))


def test_log_every_steps_lines(capsys):
    """One line every N steps of an epoch, "Epoch E, iter N, loss L", at the
    first group boundary that crosses a multiple of N (the JAX :2221-2233)."""
    _, m = _run(steps_per_call=4, log_every_steps=6, epochs=1)
    lines = re.findall(r"^Epoch 1, iter (\d+), loss (\S+)$", capsys.readouterr().out, re.M)
    # groups end at steps 4, 8, 12 and 16, then 17, 18 and 19 run single
    assert [int(n) for n, _ in lines] == [8, 12, 18]
    for n, loss in lines:
        assert float(loss) == pytest.approx(m["step_losses"][int(n) - 1], abs=5e-5)


@pytest.mark.parametrize("kw,msg", [
    (dict(prefetch_batches=-1), "prefetch_batches must be >= 0"),
    (dict(prefetch_depth=-1), "prefetch_depth must be >= 0"),
])
def test_prefetch_flags_checked(kw, msg):
    with pytest.raises(ValueError, match=msg):
        TrainConfig(**{**BASE, **kw})


def test_jax_refuses_negative_prefetch_batches_alike():
    from tpu_ddp.train.trainer import TrainConfig as JaxConfig

    with pytest.raises(ValueError, match="prefetch_batches must be >= 0"):
        JaxConfig(prefetch_batches=-1).validate()


def test_n_devices_must_match_the_world():
    Trainer(TrainConfig(**{**BASE, "n_devices": 1})).close()
    with pytest.raises(ValueError, match="--n-devices 2 but 1 rank"):
        Trainer(TrainConfig(**{**BASE, "n_devices": 2}))


def test_two_gloo_ranks_ring_and_staged_equal_synchronous():
    """Through the launcher, two ranks each gathering their own rows: the
    epoch losses rank 0 prints agree to the last digit on every path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2", "--",
           sys.executable, "-m", "tpu_ddp_torch.cli.train", "--device", "cpu",
           "--synthetic-data", "--synthetic-size", "200", "--epochs", "2", "--n-chans1", "8",
           "--n-blocks", "2", "--kernels", "--batch-size", "8", "--log-every-epochs", "1",
           "--n-devices", "2", "--steps-per-call", "3"]
    outs = {}
    for name, extra in (("sync", ["--prefetch-depth", "0"]), ("ring", []),
                        ("staged", ["--prefetch-batches", "2"])):
        proc = subprocess.run(cmd + extra, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[name] = re.findall(r"^Epoch \d+, Training loss \S+$", proc.stdout, re.M)
    assert len(outs["sync"]) == 2
    assert outs["ring"] == outs["sync"] == outs["staged"]


def test_background_prefetcher_order_errors_and_close():
    """The staged prefetcher yields its generator's items in order, raises a
    producer's exception at the consumer's next get, and closes mid-stream
    without hanging (its thread ends)."""
    from tpu_ddp_torch.datapath.prefetch import BackgroundPrefetcher

    assert list(BackgroundPrefetcher(lambda: iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise IndexError("bad row")

    pf = BackgroundPrefetcher(broken, depth=1)
    assert next(pf) == 1
    with pytest.raises(IndexError, match="bad row"):
        next(pf)
    pf = BackgroundPrefetcher(lambda: iter(range(1000)), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError, match="depth must be >= 1"):
        BackgroundPrefetcher(lambda: iter(()), depth=0)
