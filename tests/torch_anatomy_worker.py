"""The real-step side of ``tests/test_torch_anatomy.py``: each gloo rank
builds every family's step as a run builds it and runs it once under the
collective recorder (``analysis/explain.py::anatomy_for_strategy`` on the
process group that is up); rank 0 writes each family's inventory, program
order and FLOPs to ``out``. Importable by name, as ``runtime.spawn``
needs, and free of the JAX package, so a rank starts quickly."""

import json


def real_anatomies(rank, world, strategies, out):
    from tpu_ddp_torch.analysis.explain import anatomy_for_strategy

    got = {}
    for strategy in strategies:
        a = anatomy_for_strategy(strategy, n_devices=world, device="cpu")
        got[strategy] = {"inventory": a.inventory(), "program_order": a.program_order,
                         "flops": a.flops}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)
