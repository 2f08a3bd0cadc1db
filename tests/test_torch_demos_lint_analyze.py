"""The graph lint's and the step anatomy's gates, ``tools/lint_demo.py`` and
``tools/analyze_demo.py`` (the JAX ``make lint-demo`` and ``make
analyze-demo``), run on the CPU: each exits 0 only when every outcome of its
acts is there (the lint: every strategy and the source clean, the planted
DON001 and XFR001 trip exactly their rules, a new finding fails ``bench
compare``; the anatomy: a two-rank gloo run's dir analyzed and joined,
every strategy's fingerprint, ``bench compare`` failing on an extra
all-gather and on a widened payload)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os

from tpu_ddp_torch.tools import analyze_demo, lint_demo


def test_lint_demo(tmp_path, capsys):
    assert lint_demo.main(["--dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "injected out-of-place update -> ['DON001'] OK" in out
    assert "injected host read -> ['XFR001'] OK" in out
    with open(os.path.join(tmp_path, "lint_poisoned.json")) as f:
        assert json.load(f)["programs"]["dp"]["rule_counts"] == {"DON001": 1}


def test_analyze_demo(tmp_path, capsys):
    run_dir = tmp_path / "run"
    assert analyze_demo.main(["--dir", str(run_dir), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bench compare flags an extra all-gather OK" in out
    assert "widened to f32 OK" in out
    assert out.count("OK   kinds=") == 10
    with open(run_dir / "analyze.json") as f:
        assert json.load(f)["fingerprint"]["ok"] is True
