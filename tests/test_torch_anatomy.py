"""The port's step anatomy (``analysis/anatomy.py``) and its strategy
programs (``analysis/explain.py``) against real steps and the JAX package.

- For every strategy of ``analyze``, the static anatomy of one process (rank
  0 against ``torch.distributed``'s fake group) has the inventory, program
  order and FLOPs of one real step of the same program on gloo ranks: two
  ranks for every family but fsdp_tp, whose data and model axes need four.
  One spawn a rank count serves every family of that count; the two spawns
  run side by side.
- ``check_fingerprint`` passes on each, and the port's fingerprint table is
  the JAX one but for ep, whose combine is an all-reduce (ROADMAP.md
  section 3).
- A port anatomy's JSON reads back through the JAX ``StepAnatomy.from_json``
  to the same record, and the port's ``bench compare`` gives the JAX
  verdicts on two port anatomies.
- The FLOPs of the one-device dp step of NetResDeep (``n_chans1=8,
  n_blocks=2``, batch 32) are within 10% of XLA's cost analysis of the JAX
  step at the same size: the port counts the matmuls and convolutions of
  the forward and backward, XLA also the elementwise work and the update
  (the gap measured on this step: 5.0% under XLA's).
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import copy
import json
import threading

import jax
import numpy as np
import pytest

from tpu_ddp.analysis.explain import EXPECTED_FINGERPRINTS as JAX_FINGERPRINTS
from tpu_ddp.analysis.hlo import StepAnatomy as JaxStepAnatomy
from tpu_ddp.analysis.regress import compare as jax_compare
from tpu_ddp_torch.analysis.explain import (
    EXPECTED_FINGERPRINTS,
    STRATEGIES,
    anatomy_for_strategy,
    check_fingerprint,
)
from tpu_ddp_torch.analysis.regress import compare as port_compare

#: gloo ranks of each family's real step (module docstring)
RANKS = {s: 4 if s == "fsdp_tp" else 2 for s in STRATEGIES}


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """Each family's real-step record, from one gloo spawn a rank count."""
    from torch_anatomy_worker import real_anatomies

    from tpu_ddp_torch.parallel.runtime import spawn

    root = tmp_path_factory.mktemp("anatomy")
    outs, errors = {}, []

    def run(n):
        families = [s for s in STRATEGIES if RANKS[s] == n]
        outs[n] = str(root / f"real{n}.json")
        try:
            spawn(real_anatomies, n, families, outs[n], init_file=str(root / f"init{n}"),
                  timeout=240)
        except Exception as e:  # reported by the test below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in sorted(set(RANKS.values()))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    got = {}
    for path in outs.values():
        with open(path) as f:
            got.update(json.load(f))
    return got


@pytest.fixture(scope="module")
def static():
    return {s: anatomy_for_strategy(s, n_devices=RANKS[s], device="cpu") for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_static_inventory_is_the_real_steps(strategy, static, real):
    a = static[strategy]
    assert a.collectives, "a multi-rank step issues collectives"
    assert a.inventory() == real[strategy]["inventory"]
    assert a.program_order == real[strategy]["program_order"]
    assert a.flops == real[strategy]["flops"] and a.flops > 0
    assert a.n_devices == RANKS[strategy] and a.device_kind == "cpu"
    assert a.fusion_count == 0 and a.generated_code_bytes is None
    assert a.argument_bytes is None and a.temp_bytes is None   # the CPU: no allocator
    assert a.bytes_accessed > 0 and sum(a.hlo_ops.values()) > 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fingerprint_holds(strategy, static):
    fp = check_fingerprint(static[strategy])
    assert fp == {"ok": True, "strategy": strategy, "missing": [], "unexpected": []}
    if strategy != "ep":
        assert EXPECTED_FINGERPRINTS[strategy] == JAX_FINGERPRINTS[strategy]


def test_fingerprint_trips_on_a_wrong_inventory(static):
    dp = copy.deepcopy(static["zero1"])
    dp.strategy = "dp"
    fp = check_fingerprint(dp)
    assert fp["ok"] is False and fp["unexpected"] == ["all-gather", "reduce-scatter"]
    ring = copy.deepcopy(static["dp"])
    ring.strategy = "grad_compress"
    assert check_fingerprint(ring)["missing"] == ["collective-permute[s8]"]
    assert check_fingerprint(ring, "warp")["ok"] is None


def test_anatomy_json_reads_back_through_jax(static):
    for a in (static["grad_compress"], static["fsdp_tp"]):
        rec = json.loads(json.dumps(a.to_json()))
        back = JaxStepAnatomy.from_json(rec)
        assert json.loads(json.dumps(back.to_json())) == rec


def test_compare_gives_the_jax_verdicts(static):
    def art(a):
        return {a.strategy: json.loads(json.dumps(a.to_json()))}

    dp, zero1 = static["dp"], static["zero1"]
    renamed = copy.deepcopy(zero1)
    renamed.strategy = "dp"
    for old, new in ((dp, dp), (dp, renamed), (renamed, dp)):
        got = port_compare(art(old), art(new))
        want = jax_compare(art(old), art(new))
        assert got == want
    assert port_compare(art(dp), art(renamed))["regressions"]


def _jax_flops(rows):
    import tpu_ddp.metrics.mfu as jax_mfu
    from tpu_ddp.models.resnet import NetResDeep
    from tpu_ddp.parallel import MeshSpec, create_mesh
    from tpu_ddp.train.optim import make_optimizer
    from tpu_ddp.train.state import create_train_state
    from tpu_ddp.train.steps import make_train_step

    model = NetResDeep(n_chans1=8, n_blocks=2)
    tx = make_optimizer(lr=1e-1, momentum=0.9)
    state = create_train_state(model, tx, jax.random.key(0))
    step = make_train_step(model, tx, create_mesh(MeshSpec(data=1), jax.devices()[:1]),
                           donate=False)
    batch = {"image": np.zeros((rows, 32, 32, 3), np.float32),
             "label": np.zeros(rows, np.int32), "mask": np.ones(rows, bool)}
    return jax_mfu.compiled_flops(step, state, batch)


def test_one_device_dp_flops_within_10pct_of_xla(devices):
    a = anatomy_for_strategy("dp", n_devices=1, device="cpu", per_shard_batch=32)
    assert a.collectives == [] and a.program_order == []
    want = _jax_flops(32)
    assert want and abs(a.flops / want - 1.0) < 0.10, (a.flops, want)
