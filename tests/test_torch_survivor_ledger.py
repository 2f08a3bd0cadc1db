"""A rank that outlives its peer is booked ``killed``, not ``clean``.

Two gloo ranks of NetResDeep (``n_chans1=8, n_blocks=2``, 320 synthetic rows
at a global batch of 32, ten steps) under the port's launcher, with
``--telemetry-dir``:

- a chaos ``kill_host`` on rank 1 at step 6: rank 1 dies with no
  ``run_end``; rank 0 fails in gloo's next collective and closes its trace
  without ``run_end`` either, so ``tpu-ddp-torch goodput`` reads the life
  ``killed`` (rank 0's trace is the ledger's authority);
- the same two ranks with no fault: the life reads ``clean``.

The two jobs run side by side.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(run_dir, spec=None):
    cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
           "--", sys.executable, "-m", "tpu_ddp_torch.cli.train", "--device", "cpu",
           "--synthetic-data", "--synthetic-size", "320", "--epochs", "1",
           "--n-chans1", "8", "--n-blocks", "2", "--n-devices", "2",
           "--global-batch-size", "32", "--prefetch-depth", "0",
           "--telemetry-dir", run_dir, "--telemetry-sinks", "jsonl"]
    if spec:
        cmd += ["--chaos", spec]
    return subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _goodput(run_dir, capsys):
    from tpu_ddp_torch.ledger.report import main as goodput_main

    capsys.readouterr()
    assert goodput_main([run_dir, "--json"]) == 0
    return json.loads(capsys.readouterr().out)["ledger"]


def _names(path):
    with open(path) as f:
        return [json.loads(line).get("name") for line in f if line.strip()]


def test_survivor_of_a_lost_peer_books_killed_and_a_clean_run_clean(tmp_path, capsys):
    spec = str(tmp_path / "spec.json")
    with open(spec, "w") as f:
        json.dump({"chaos_schema_version": 1, "faults": [
            {"kind": "kill_host", "step": 6, "process_index": 1}]}, f)
    lost, clean = str(tmp_path / "lost"), str(tmp_path / "clean")
    jobs = [_job(lost, spec), _job(clean)]
    outs = [p.communicate(timeout=240)[0] for p in jobs]
    assert jobs[0].returncode != 0, outs[0][-3000:]
    assert jobs[1].returncode == 0, outs[1][-3000:]
    # rank 0 saw its peer go in a collective, and left its trace unended
    assert "Connection" in outs[0], outs[0][-3000:]
    assert "run_end" not in _names(os.path.join(lost, "trace-p0.jsonl"))
    assert "run_end" not in _names(os.path.join(lost, "trace-p1.jsonl"))
    assert "run_end" in _names(os.path.join(clean, "trace-p0.jsonl"))
    ledger = _goodput(lost, capsys)
    assert [i["exit"] for i in ledger["incarnations"]] == ["killed"]
    ledger = _goodput(clean, capsys)
    assert [i["exit"] for i in ledger["incarnations"]] == ["clean"]
