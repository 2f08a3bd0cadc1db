"""The comms hop monitor on the card: two gloo ranks sharing ``cuda:0`` run the
int8 gradient ring with K2/K3 under a ``HopMonitor`` installed as the hop
hook. The ring's results are bitwise those without the monitor, K2 and K3
launch as without it (n a call each), and each rank's
``comms-health-p<rank>.json`` names the ring as its last collective with the
hops' wire bytes in its window. Needs an NVIDIA GPU and nvcc and skips
without them; run it on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_comms_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os

import pytest
import torch

pytestmark = pytest.mark.cuda

N, LEAVES = 2, [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (10, 32)]


def _worker(rank, n, out_dir):
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.comms.forensics import HopMonitor
    from tpu_ddp_torch.parallel import collectives as c

    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(rank)
    sizes = [int(torch.tensor(s).prod()) for s in LEAVES]
    sizes = [s + (-s) % n for s in sizes]
    x = torch.randn(sum(sizes), device="cuda", generator=gen)
    layout = c.FlatLayout(sizes, n, 256)
    plain, _ = c.ring_all_reduce_flat(x, layout, mode="int8", kernels=True)
    mon = HopMonitor(out_dir, process_index=rank, min_write_interval_s=0.0)
    c.set_ring_hop_hook(mon.on_hop)
    ops.reset_launch_counts()
    try:
        got, _ = c.ring_all_reduce_flat(x, layout, mode="int8", kernels=True)
    finally:
        c.set_ring_hop_hook(None)
        mon.close()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"same": bool(torch.equal(got, plain)), "k2": launches["fused_quant"],
                   "k3": launches["fused_dequant"], "msg": layout.msg_bytes("int8")}, f)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_ddp_torch.ops import _build

    _build.build()


def test_hop_monitor_over_the_int8_ring_on_the_card(cuda, tmp_path):
    from tpu_ddp_torch.comms.forensics import read_health
    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(_worker, N, str(tmp_path), init_file=str(tmp_path / "rdzv"), timeout=300)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(N)]
    health = {h["process_index"]: h for h in read_health(str(tmp_path))}
    for r, res in enumerate(ranks):
        assert res["same"] and res["k2"] == res["k3"] == N
        h = health[r]
        assert h["last_collective"] == "ring-all-reduce/s8/data" and h["in_flight"] is None
        assert h["hops"] == N
        assert h["axis_bytes_window"]["data"] == res["msg"] * (N - 1) * 2
