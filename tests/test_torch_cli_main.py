"""The port's umbrella CLI (``python -m tpu_ddp_torch.cli.main``, the
``tpu-ddp-torch`` script) against the JAX package's ``tpu-ddp``: the
subcommand set is the JAX one less ``tune``, whose module is not ported
yet; each shared subcommand gives the JAX exit code and, apart from the
command's name and the trace summary's version line, the JAX output on the
same run dirs; the read-back subcommands import neither torch nor numpy.

Run dirs (``tests/torch_readers.py``), two epochs each: ``--kernels``
killed at step 7 and resumed, and the same recipe uninterrupted without
``--kernels``. ``test_registry_and_compare_flow`` is the flow of
``chip_smoke.py`` phase 29 (d), and fixes its exit codes.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import re
import subprocess
import sys

import pytest
import torch
from torch_readers import incident, jax_names, port_run

from tpu_ddp.cli.main import main as jax_main
from tpu_ddp_torch.cli.main import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = {"tune"}
RECIPE = dict(epochs=2, eval_each_epoch=True)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("cli_main")
    try:
        out = {"incident": incident(str(root / "incident"), kernels=True, **RECIPE),
               "plain": str(root / "plain"), "root": str(root)}
        port_run(out["plain"], **RECIPE)
    finally:
        torch.set_num_threads(n)
    return out


def _subcommands(main, capsys):
    with pytest.raises(SystemExit) as exit_:
        main(["--help"])
    assert exit_.value.code == 0
    usage = capsys.readouterr().out
    return set(re.search(r"\{([a-z,]+)\}", usage).group(1).split(","))


def test_subcommands_are_the_jax_ones_less_the_unported(capsys):
    port, jax_ = _subcommands(port_main, capsys), _subcommands(jax_main, capsys)
    assert NOT_PORTED <= jax_
    assert port == jax_ - NOT_PORTED
    assert port == {"train", "launch", "elastic", "trace", "health", "goodput", "curves",
                    "registry", "bench", "watch", "profile", "mem", "diagnose", "comms", "data",
                    "analyze", "ops", "lint"}
    with pytest.raises(SystemExit) as exit_:
        port_main(["tune", "x"])
    assert exit_.value.code == 2


def _pyproject_scripts():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    return dict(re.findall(r'^([a-z-]+) = "([\w.:]+)"$', text, flags=re.M))


def test_the_script_is_registered():
    assert _pyproject_scripts()["tpu-ddp-torch"] == "tpu_ddp_torch.cli.main:main"


def _argv(case, dirs, tmp):
    inc, plain, missing = dirs["incident"], dirs["plain"], os.path.join(tmp, "missing")
    return {
        "trace_summarize": ["trace", "summarize", inc],
        "trace_summarize_json": ["trace", "summarize", plain, "--json"],
        "trace_summarize_missing": ["trace", "summarize", missing],
        "health": ["health", inc],
        "health_missing": ["health", missing],
        "goodput": ["goodput", inc],
        "goodput_json": ["goodput", inc, "--json"],
        "goodput_missing": ["goodput", missing],
        "curves": ["curves", inc],
        "curves_stride": ["curves", plain, "--stride", "3"],
        "curves_missing": ["curves", missing],
        "curves_diff": ["curves", "diff", inc, plain],
        "curves_diff_missing": ["curves", "diff", inc, missing],
        "registry_list_empty": ["registry", "--registry", missing, "list"],
        "registry_trend_empty": ["registry", "--registry", missing, "trend"],
        "bench_compare_one_path": ["bench", "compare", missing],
        "diagnose": ["diagnose", inc],
        "diagnose_json": ["diagnose", plain, "--json"],
        "diagnose_missing": ["diagnose", missing],
    }[case]


EXIT_CODES = {"trace_summarize": 0, "trace_summarize_json": 0, "trace_summarize_missing": 2,
              "health": 0, "health_missing": 2, "goodput": 0, "goodput_json": 0,
              "goodput_missing": 2, "curves": 0, "curves_stride": 0, "curves_missing": 2,
              "curves_diff": 0, "curves_diff_missing": 2, "registry_list_empty": 0,
              "registry_trend_empty": 0, "bench_compare_one_path": 2, "diagnose": 0,
              "diagnose_json": 0, "diagnose_missing": 2}


def _versionless(text):
    """The output without the trace summary's version field
    (``torch=...`` in the port's run line; the JAX label has none for a
    port run)."""
    return re.sub(r"  (torch|jax)=\S+", "", text)


@pytest.mark.parametrize("case", sorted(EXIT_CODES))
def test_exit_codes_and_output_equal_jax(dirs, tmp_path, capsys, case):
    argv = _argv(case, dirs, str(tmp_path))
    rp = port_main(argv)
    out_p = capsys.readouterr().out
    rj = jax_main(argv)
    out_j = capsys.readouterr().out
    assert rp == rj == EXIT_CODES[case]
    if case.endswith("_json"):
        port, jax_ = json.loads(out_p), json.loads(out_j)
        for art in (port, jax_):           # the one key, and the summary's stamp
            for node in (art.get("ledger", {}), art.get("run_meta", {}),
                         art.get("provenance", {})):
                node.pop("torch_version", None)
                node.pop("jax_version", None)
        assert jax_names(port) == jax_
    else:
        assert _versionless(jax_names(out_p)) == _versionless(out_j)


def test_train_and_launch_route_to_the_port(tmp_path, capsys):
    assert port_main(["train", "--device", "cpu", "--synthetic-data", "--synthetic-size",
                      "64", "--batch-size", "32", "--epochs", "1", "--n-chans1", "8",
                      "--n-blocks", "2", "--telemetry-dir", str(tmp_path / "run"),
                      "--health", "on"]) == 0
    assert "final test accuracy" in capsys.readouterr().out
    assert port_main(["goodput", str(tmp_path / "run")]) == 0
    with pytest.raises(SystemExit) as exit_:
        port_main(["launch", "--help"])
    assert exit_.value.code == 0
    assert "--nproc-per-node" in capsys.readouterr().out


READ_BACK = {
    "trace": ["trace", "summarize", "{inc}", "--json"],
    "health": ["health", "{inc}"],
    "goodput": ["goodput", "{inc}", "--json"],
    "curves": ["curves", "{inc}"],
    "curves_diff": ["curves", "diff", "{inc}", "{plain}"],
    "registry": ["registry", "--registry", "{tmp}/reg", "trend"],
    "bench_compare": ["bench", "compare", "{tmp}/a.json", "{tmp}/a.json"],
    "watch": ["watch", "{inc}", "--once", "--json", "--no-alerts-file"],
    "profile": ["profile", "{tmp}/prof", "--no-ops"],
    "mem": ["mem", "{inc}", "--json", "--no-plan"],
    "comms_calibrate": ["comms", "calibrate", "--chip", "cpu", "{tmp}/a.json"],
    "data_audit": ["data", "audit", "{inc}"],
    "data_report": ["data", "report", "{inc}", "--json"],
    "diagnose": ["diagnose", "{inc}", "--json"],
    "elastic_help": ["elastic", "--help"],
}

_PROBE = """
import json, sys
from tpu_ddp_torch.cli.main import main
try:
    rc = main(json.loads(sys.argv[1]))
except SystemExit as e:
    rc = e.code
sys.stdout.flush()
print("IMPORTED", [m for m in ("torch", "numpy") if m in sys.modules])
sys.exit(rc)
"""


@pytest.mark.parametrize("case", sorted(READ_BACK))
def test_read_back_commands_import_no_torch(dirs, tmp_path, case):
    from tpu_ddp_torch.profiler.capture import CaptureManager

    (tmp_path / "a.json").write_text(json.dumps({"metric": "m", "value": 1.0}))
    capture = CaptureManager(str(tmp_path / "prof"), device_trace=False)
    capture.arm_window(1, 2)
    for step in (1, 2):
        capture.on_step(step)
    argv = [a.format(inc=dirs["incident"], plain=dirs["plain"], tmp=tmp_path)
            for a in READ_BACK[case]]
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(argv)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "IMPORTED []"


def _both(argv, capsys):
    rp = port_main(argv)
    out = capsys.readouterr().out
    rj = jax_main(argv)
    capsys.readouterr()
    assert rp == rj, argv
    return rp, out


def test_registry_and_compare_flow(dirs, tmp_path, capsys):
    """``chip_smoke.py`` phase 29 (d): the ledger, curve and trace summary
    of the incident and of the plain run recorded into a registry, listed
    and trended (exit 0: each run is its own series, one entry long), the
    incident's ledger compared against the registry (its own entry, auto-
    selected: no regression, exit 0; ``--allow-dirty`` because a run's git
    identity is dirty or absent wherever it was not made from a clean
    checkout), and the plain run's ledger against the incident's (exit 1:
    the kill's restart gap, replayed steps and ``killed`` exit are fresh)."""
    reg = str(tmp_path / "reg")
    arts = {}
    for name in ("incident", "plain"):
        for kind, argv in (("goodput", ["goodput", dirs[name], "--json"]),
                           ("curves", ["curves", dirs[name], "--json"]),
                           ("trace", ["trace", "summarize", dirs[name], "--json"])):
            rc, out = _both(argv, capsys)
            assert rc == 0
            path = arts[name, kind] = str(tmp_path / f"{name}_{kind}.json")
            with open(path, "w") as f:
                f.write(out)
            assert port_main(["registry", "--registry", reg, "record", path]) == 0
            capsys.readouterr()
    assert _both(["registry", "--registry", reg, "list"], capsys)[0] == 0
    rc, out = _both(["registry", "--registry", reg, "trend"], capsys)
    assert rc == 0 and "no drift findings" in out
    rc, out = _both(["bench", "compare", "--against", reg, "--allow-dirty",
                     arts["incident", "goodput"]], capsys)
    assert rc == 0 and "no regressions" in out
    rc, out = _both(["bench", "compare", arts["plain", "goodput"],
                     arts["incident", "goodput"]], capsys)
    assert rc == 1
    for fresh in ("badput/restart_gap", "badput/replayed", "exits/killed"):
        assert fresh in out
