"""The graph lint (``tpu_ddp_torch/analysis/lint.py``) against the JAX one.

- The clean pass: every strategy's program (the ten of ``lint --strategy
  all``, the tiny per-family models as rank 0 of a fake group of eight on
  the CPU, one module-scoped audit each, as the JAX ``audits`` fixture) and
  the bf16 programs come back clean; ``tpu-ddp-torch lint --strategy all
  --device cpu --json`` exits 0.
- Each injected violation trips exactly its own rule: DON001 (an
  out-of-place update), DTY001 (an f32 program claimed bf16; a forced f32
  collective over the budget), SHD001 (dp's state relabelled zero1), COL001
  (a reordered zero1 schedule, a partial group, non-permutation pairs, a
  missing fingerprint kind, serialized or stray zero3 gathers), XFR001 (an
  ``.item()`` in the loss), RCP001 (the JAX tests' texts, and torch's
  compilers), KRN001 (a kernel whose build does not load on a card).
- The JAX functions on hand-built inputs are the oracles: the same source
  texts give the same RCP001 findings, the same schedules (the port's own,
  hand-edited) the same COL001 findings, ``rule_counts`` and
  ``render_findings`` agree, ``LintConfig``'s thresholds are the JAX
  defaults, and a port lint artifact gates the same under the JAX and the
  port ``bench compare``.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import dataclasses
import json

import pytest
import torch

import tpu_ddp.analysis.hlo as jax_hlo
import tpu_ddp.analysis.lint as jax_lint
import tpu_ddp_torch.analysis.lint as lint
from tpu_ddp.analysis.regress import compare as jax_compare
from tpu_ddp_torch.analysis.explain import STRATEGIES, prepare_strategy_program
from tpu_ddp_torch.analysis.anatomy import fake_world
from tpu_ddp_torch.analysis.regress import compare as port_compare
from tpu_ddp_torch.analysis.regress import load_artifact
from tpu_ddp_torch.train.losses import cross_entropy_loss

CFG = lint.LintConfig()
N = 8


@pytest.fixture(scope="module")
def audits():
    """(findings, audit) per strategy, shared module-wide."""
    return {s: lint.lint_strategy(s, device="cpu", n_devices=N) for s in STRATEGIES}


def _key(findings):
    return [(f.rule, f.severity, f.program, f.message, f.location) for f in findings]


def _jax_audit(audit, **over):
    """The JAX ``ProgramAudit`` of the port's audit: its anatomy read back
    through the JAX ``StepAnatomy.from_json``, no compiled program."""
    fields = dict(program=audit.program, strategy=audit.strategy,
                  compute_dtype=audit.compute_dtype, mesh_shape=audit.mesh_shape,
                  n_devices=audit.n_devices, device_kind=audit.device_kind,
                  compiled=None, jaxpr=None, hlo_text="",
                  anatomy=jax_hlo.StepAnatomy.from_json(audit.anatomy.to_json()),
                  state=None, batch={})
    fields.update(over)
    return jax_lint.ProgramAudit(**fields)


def _jax_schedule(schedule):
    return [jax_hlo.ScheduledCollective(**dataclasses.asdict(e)) for e in schedule]


def _both_col001(audit, schedule=None, **over):
    """COL001 from the port and from the JAX ``check_collective_order`` on
    the same audit and schedule."""
    port = lint.check_collective_order(dataclasses.replace(audit, **over), CFG,
                                       schedule=schedule)
    jax_ = jax_lint.check_collective_order(
        _jax_audit(audit, **over), jax_lint.LintConfig(),
        schedule=_jax_schedule(audit.schedule if schedule is None else schedule))
    return port, jax_


# -- the clean pass -------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_programs_lint_clean(audits, strategy):
    findings, audit = audits[strategy]
    assert findings == [], f"{strategy}: {[f.message for f in findings]}"
    assert audit.anatomy.program_order, "the recorder booked no collective"


@pytest.mark.parametrize("strategy", [s for s in STRATEGIES if s not in ("zero3", "ep")])
def test_clean_schedules_pass_the_jax_col001(audits, strategy):
    """The JAX COL001 over each program's recorded schedule (every group of
    each call's axis, its fingerprint) finds nothing, as the port's. zero3's
    schedule contract reads the JAX HLO's scopes, and ep's fingerprint row
    differs by design (the port's combine is one all-reduce, ROADMAP.md
    section 3)."""
    _, audit = audits[strategy]
    port, jax_ = _both_col001(audit)
    assert port == jax_ == []


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_don001_accounting_matches_batch(audits, strategy):
    """For an in-place step, argument_bytes − donated_bytes is the batch's
    bytes on the rank exactly (memplan's accounting convention)."""
    _, audit = audits[strategy]
    rep = lint.donation_report(audit)
    assert rep["donated_bytes"] > 0 and rep["undonated_output_bytes"] == 0
    assert rep["argument_bytes"] - rep["donated_bytes"] == rep["expected_non_donated_bytes"]
    assert rep["non_donated_bytes"] == rep["expected_non_donated_bytes"] > 0


@pytest.mark.parametrize("strategy", ("dp", "zero1", "fsdp"))
def test_bf16_programs_lint_clean(strategy):
    findings, _ = lint.lint_strategy(strategy, device="cpu", n_devices=N,
                                     compute_dtype="bfloat16")
    assert findings == [], [f.message for f in findings]


def test_ep_issues_no_host_read():
    """The MoE routing's one-hot rows are a comparison on the device:
    ``F.one_hot`` read its indices' range back to the host, six host reads
    a step (XFR001 on the ep program), with the same values."""
    import torch.nn.functional as F

    from tpu_ddp_torch.models.moe import one_hot

    idx = torch.tensor([[0, 3, 1], [2, 2, 4]])
    assert torch.equal(one_hot(idx, 4),
                       F.one_hot(idx.clamp(max=3), 4).float() * (idx < 4)[..., None].float())
    assert torch.equal(one_hot(torch.tensor([-1, 5]), 3), torch.zeros(2, 3))


def test_tiny_models_take_flash_attention():
    """``--attention flash`` reaches the tiny per-family models as
    ``build_model`` binds it (it was dropped for them), sp takes its flash
    ring, and NetResDeep refuses it."""
    from tpu_ddp_torch.analysis.explain import strategy_config
    from tpu_ddp_torch.ops.flash_attention import flash_attention

    with fake_world(N):
        prog = prepare_strategy_program("fsdp", n_devices=N, device="cpu", attention="flash")
        try:
            assert prog.step.__self__.trainer.state.model.attention_impl is flash_attention
        finally:
            prog.close()
        with pytest.raises(ValueError, match="needs an attention model"):
            prepare_strategy_program("dp", n_devices=N, device="cpu", attention="flash")
    cfg = dict(mesh={"data": 4, "sequence": 2}, model="vit_s4", per_shard_batch=8,
               compute_dtype="float32", device="cpu")
    assert strategy_config("sp", attention="flash", **cfg).sp_flash
    assert not strategy_config("sp", **cfg).sp_flash


def test_source_tree_clean():
    """RCP001 over the port's package, by the port's rule and the JAX one."""
    import os

    import tpu_ddp_torch

    assert lint.lint_source_tree() == []
    assert jax_lint.lint_source_tree(os.path.dirname(tpu_ddp_torch.__file__)) == []


def test_lint_config_is_the_jax_one():
    assert dataclasses.asdict(lint.LintConfig()) == dataclasses.asdict(jax_lint.LintConfig())


def test_rules_registry_as_jax():
    assert list(lint.RULES) == list(jax_lint.RULES)
    for rule, meta in lint.RULES.items():
        assert meta["title"] == jax_lint.RULES[rule]["title"] and meta["fix"], rule
    assert lint.LINT_SCHEMA_VERSION == jax_lint.LINT_SCHEMA_VERSION


# -- DON001 ----------------------------------------------------------------

def test_don001_out_of_place_update_trips():
    findings, audit = lint.lint_strategy("dp", device="cpu", n_devices=N, in_place=False)
    assert sorted({f.rule for f in findings}) == ["DON001"]
    (f,) = findings
    assert "not (fully) donated" in f.message and f.fix
    rep = lint.donation_report(audit)
    assert rep["donated_bytes"] == 8                  # the step counter alone
    assert rep["undonated_output_bytes"] == rep["output_bytes"] - 8


# -- DTY001 ----------------------------------------------------------------

def test_dty001_big_f32_op_trips():
    """An f32 program claiming bf16 compute — the accidental-upcast shape —
    trips on its big f32 convolutions (batch 64: a conv result of 2 MiB)."""
    with fake_world(N):
        prog = prepare_strategy_program("dp", n_devices=N, device="cpu", per_shard_batch=64)
        try:
            prog.compute_dtype = "bfloat16"
            findings, _ = lint.lint_program(prog)
        finally:
            prog.close()
    assert sorted({f.rule for f in findings}) == ["DTY001"]
    assert any("f32 tensor op" in f.message for f in findings)


def test_dty001_forced_f32_collective_trips():
    from tpu_ddp_torch.parallel.collectives import _all_reduce_flat

    def psum_loss(logits, labels, mask=None):
        big = _all_reduce_flat([torch.zeros(1 << 20, device=logits.device)])
        return cross_entropy_loss(logits, labels, mask) + big.sum() * 1e-30

    findings, _ = lint.lint_strategy("dp", device="cpu", n_devices=N,
                                     compute_dtype="bfloat16", loss_fn=psum_loss)
    assert sorted({f.rule for f in findings}) == ["DTY001"]
    assert "allowlist budget" in findings[0].message


def test_dty001_disarmed_for_f32_programs(audits):
    _, audit = audits["dp"]
    assert lint.check_dtype_widening(audit, CFG) == []


# -- SHD001 ----------------------------------------------------------------

def test_shd001_desharded_zero1_opt_state_trips(audits):
    """dp's replicated state relabelled zero1 is a zero1 builder that
    stopped scattering: the rule refuses it, naming opt_state."""
    _, dp_audit = audits["dp"]
    bad = dataclasses.replace(dp_audit, strategy="zero1", program="zero1")
    findings = lint.check_replication(bad, CFG)
    assert [f.rule for f in findings] == ["SHD001"]
    assert "opt_state" in findings[0].message


def test_shd001_leaf_held_whole_trips(audits):
    _, audit = audits["zero1"]
    leaves = [dataclasses.replace(leaf, held_bytes=leaf.global_bytes)
              if leaf.name == "trace/fc1.weight" else leaf for leaf in audit.leaves]
    findings = lint.check_replication(dataclasses.replace(audit, leaves=leaves), CFG)
    assert [f.rule for f in findings] == ["SHD001"] * 2     # the leaf, and the section
    assert "trace/fc1.weight" in findings[0].message


@pytest.mark.parametrize("strategy", ("zero1", "zero3", "fsdp", "fsdp_tp", "ep"))
def test_shd001_sharded_layouts_pass(audits, strategy):
    _, audit = audits[strategy]
    assert lint.check_replication(audit, CFG) == []
    assert any(leaf.cut for leaf in audit.leaves)


# -- COL001 ----------------------------------------------------------------

def test_col001_reordered_schedule_trips(audits):
    _, audit = audits["zero1"]
    reordered = sorted(audit.schedule, key=lambda e: 0 if e.kind == "all-gather" else 1)
    reordered = [dataclasses.replace(e, index=i) for i, e in enumerate(reordered)]
    port, jax_ = _both_col001(audit, reordered)
    assert [f.rule for f in port] == ["COL001"] and "reordered" in port[0].message
    assert _key(port) == _key(jax_)


def test_col001_partial_group_trips(audits):
    _, audit = audits["zero1"]
    poisoned = [dataclasses.replace(e, groups=[(0, 1, 2)]) for e in audit.schedule[:1]]
    port, jax_ = _both_col001(audit, poisoned)
    assert any("do not partition" in f.message for f in port)
    assert _key(port) == _key(jax_)


def test_col001_recorded_groups_partition_the_grid(audits):
    """The recorder books every group of a call's axis: sp's ring and
    data groups, tp's model groups each partition the eight ranks."""
    for strategy in ("sp", "tp", "fsdp_tp", "pp", "ep"):
        _, audit = audits[strategy]
        for e in audit.schedule:
            ranks = sorted(r for g in e.groups for r in g)
            assert ranks == list(range(N)) and len(e.groups) == N // e.group_size, (strategy, e)


def test_col001_non_permutation_pairs_trip(audits):
    _, audit = audits["sp"]
    perm = next(e for e in audit.schedule if e.pairs)
    dup = dataclasses.replace(perm, pairs=[(0, 1), (0, 2)])
    port, jax_ = _both_col001(audit, [dup])
    assert any("not a permutation" in f.message for f in port)
    assert _key(port) == _key(jax_)


def test_col001_missing_fingerprint_kind_trips(audits):
    """A dp (all-reduce only) program labelled zero1 lacks the required
    all-gather family."""
    _, dp_audit = audits["dp"]
    port, jax_ = _both_col001(dp_audit, strategy="zero1", program="zero1")
    assert any(f.rule == "COL001" and "missing" in f.message for f in port)
    assert _key(port) == _key(jax_)


def test_col001_serialized_zero3_gathers_trip():
    """zero3 with its gathers serialized just in time (``prefetch=False``,
    the JAX injection) fails closed: no block's successor was in flight at
    its first use."""
    with fake_world(N):
        prog = prepare_strategy_program("zero3", n_devices=N, device="cpu")
        try:
            prog.zero.prefetch = False
            findings, audit = lint.lint_program(prog)
        finally:
            prog.close()
    assert [f.rule for f in findings] == ["COL001"]
    assert "double-buffer chain broken" in findings[0].message
    assert [c["block"] for c in audit.calls if c["kind"] == "all-gather"] == list(
        range(audit.n_blocks))


def test_col001_zero3_stray_and_missing_gathers_trip(audits):
    _, audit = audits["zero3"]
    gathers = [c for c in audit.calls if c["kind"] == "all-gather"]
    assert [c["block"] for c in gathers] == list(range(audit.n_blocks)) and all(
        c["next_in_flight"] for c in gathers)
    stray = dict(gathers[0], block=None)
    bad = dataclasses.replace(audit, calls=audit.calls + [stray])
    assert any("re-gather" in f.message for f in lint.check_collective_order(bad, CFG))
    missing = [c for c in audit.calls if c.get("block") != 1]
    bad = dataclasses.replace(audit, calls=missing)
    assert any("incomplete" in f.message for f in lint.check_collective_order(bad, CFG))


# -- XFR001 ----------------------------------------------------------------

def test_xfr001_planted_item_trips_exactly():
    from tpu_ddp_torch.tools.lint_demo import chatty_loss

    findings, audit = lint.lint_strategy("dp", device="cpu", n_devices=N,
                                         loss_fn=chatty_loss)
    assert sorted({f.rule for f in findings}) == ["XFR001"]
    assert audit.host and "_local_scalar_dense" in audit.host[0]


# -- RCP001 ----------------------------------------------------------------

#: the JAX tests' texts (``tests/test_lint.py``), hazards and negatives
RCP_TEXTS = [
    "import jax\nfor i in range(3):\n    f = jax.jit(lambda x: x)\n",
    ("import jax, functools\n"
     "@functools.partial(jax.jit, static_argnames=('cfg',))\n"
     "def step(x, cfg={}):\n    return x\n"),
    ("import time\nimport jax\n"
     "def make_train_step(model):\n"
     "    def step(s, b):\n        return s, time.time()\n"
     "    return jax.jit(step)\n"),
    ("import jax\n"
     "def make_step(f):\n    return jax.jit(f)\n"
     "steps = [make_step(str) for _ in range(3)]\n"),
    ("from jax import random\n"
     "def make_init(shape):\n"
     "    def init(key):\n"
     "        return random.uniform(key, shape)\n"
     "    return init\n"),
    "import numpy as np\ndef build_step():\n    return np.random.rand()\n",
    "def broken(:\n",
]


@pytest.mark.parametrize("i", range(len(RCP_TEXTS)))
def test_rcp001_as_jax(i):
    port = lint.lint_source_text(RCP_TEXTS[i], "bad.py")
    jax_ = jax_lint.lint_source_text(RCP_TEXTS[i], "bad.py")
    assert _key(port) == _key(jax_)
    assert bool(port) == (i not in (3, 4))


@pytest.mark.parametrize("src,word", [
    ("import torch\nfor m in ms:\n    f = torch.compile(m)\n", "torch.compile"),
    ("import torch\nwhile True:\n    g = torch.jit.trace(f, x)\n", "torch.jit.trace"),
    ("import torch\n@torch.jit.script\ndef f(x, d=[]):\n    return x\n", "mutable"),
])
def test_rcp001_torch_compilers_trip(src, word):
    findings = lint.lint_source_text(src, "bad.py")
    assert [f.rule for f in findings] == ["RCP001"] and word in findings[0].message


# -- KRN001 ----------------------------------------------------------------

def test_krn001_cpu_and_off_switch_are_clean():
    assert lint.lint_kernels(True, device="cpu") == []
    assert lint.lint_kernels(False, device="cuda") == []


def test_krn001_unloadable_kernel_on_a_card_trips(monkeypatch):
    """On a CUDA device a switch-level kernel whose build does not load is
    one error each, naming its plain version; the model-level flash
    kernels are not behind the switch."""
    import tpu_ddp_torch.ops as ops

    monkeypatch.setattr(ops, "kernel_available", lambda name: name != "fused_quant")
    findings = lint.lint_kernels(True, device="cuda", program="dp")
    assert [f.rule for f in findings] == ["KRN001"]
    assert "'fused_quant'" in findings[0].message and "quantize_chunk" in findings[0].message
    monkeypatch.setattr(ops, "kernel_available", lambda name: False)
    assert len(lint.lint_kernels(True, device="cuda")) == 3


# -- rule counts, rendering, the CLI and the compare gate ------------------

def _as_jax_findings(findings):
    return [jax_lint.LintFinding(**dataclasses.asdict(f)) for f in findings]


def test_rule_counts_and_render_as_jax():
    findings = (lint.lint_source_text(RCP_TEXTS[0], "a.py")
                + lint.lint_source_text(RCP_TEXTS[2], "b.py")
                + lint.check_host_transfers(
                    lint.ProgramAudit("dp", "dp", "float32", {"data": 2}, 2, "cpu", None,
                                      host=["_local_scalar_dense on cpu"]), CFG))
    jax_findings = _as_jax_findings(findings)
    assert lint.rule_counts(findings) == jax_lint.rule_counts(jax_findings) == {
        "RCP001": 2, "XFR001": 1}
    for program in ("dp", "source"):
        port = lint.render_findings(program, findings, detail=" (x)")
        assert port.replace("tpu-ddp-torch", "tpu-ddp") == jax_lint.render_findings(
            program, jax_findings, detail=" (x)")
    assert lint.render_findings("dp", []) == "tpu-ddp-torch lint: dp: clean"


def test_cli_all_strategies_clean(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert lint.main(["--strategy", "all", "--device", "cpu", "--json", str(out)]) == 0
    assert "all programs clean" in capsys.readouterr().out
    art = json.loads(out.read_text())
    assert art["lint_schema_version"] == 1
    assert set(art["programs"]) == set(STRATEGIES) | {"source"}
    rec = art["programs"]["dp"]
    assert rec["rule_counts"] == {} and rec["findings"] == []
    assert rec["program_order"] and rec["inventory"] and rec["hlo_ops"]
    assert art["provenance"]["torch_version"] == torch.__version__


def test_cli_unknown_strategy_exits_2(capsys):
    assert lint.main(["--strategy", "nope", "--no-source", "--device", "cpu"]) == 2
    assert "unknown strategy" in capsys.readouterr().out


def test_new_lint_finding_gates_in_both_compares(tmp_path):
    out = tmp_path / "lint.json"
    assert lint.main(["--strategy", "dp", "--json", str(out), "--no-source",
                      "--device", "cpu"]) == 0
    base = load_artifact(str(out))
    poisoned = json.loads(json.dumps(base))
    poisoned["dp"]["rule_counts"] = {"XFR001": 1}
    for compare in (port_compare, jax_compare):
        result = compare(base, poisoned)
        assert any("lint/XFR001" in r for r in result["regressions"])
        result = compare(poisoned, base)
        assert not result["regressions"]
        assert any("lint/XFR001" in i for i in result["improvements"])
