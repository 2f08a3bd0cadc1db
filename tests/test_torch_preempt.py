"""Preemption drain in the port's trainer, each case in a subprocess with a
watchdog (the port's forms of the JAX ``tests/test_capabilities.py::
test_preemption_checkpoints_and_resumes`` and ``tests/test_chaos.py::
test_second_sigterm_skips_final_checkpoint``).

(a) the CLI: SIGTERM once epoch 2 has started drains at the next batch
    boundary, saves a final checkpoint, skips the final eval and exits 0;
    ``--resume`` continues;
(b) a run of 50 steps an epoch that sends itself SIGTERM at its 60th batch
    (mid-epoch 2) drains with a final checkpoint at step 60, and the resumed
    run's per-step losses and final params are bitwise the uninterrupted
    run's; a second signal skips the final checkpoint, leaving the newest
    save before the signal (epoch 1's, step 50, after the ``--checkpoint-steps
    40`` one) as the verified latest;
(c) two gloo ranks under the launcher: SIGTERM to the launcher reaches both
    ranks, which drain at the same epoch boundary, save, and exit 0; the
    job resumes from that step.
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

from tpu_ddp_torch.checkpoint.manager import Checkpointer

ROOT = Path(__file__).resolve().parents[1]
#: one intra-op thread a process: the test workers share the host's cores
ENV = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
SMALL = ["--device", "cpu", "--synthetic-data", "--synthetic-size", "256",
         "--batch-size", "4", "--n-chans1", "8", "--n-blocks", "2",
         "--log-every-epochs", "1", "--checkpoint-every-epochs", "1"]


def _signal_after(cmd, marker, sig_count=1, timeout=240):
    """Start ``cmd``, send SIGTERM when a line of its output matches
    ``marker``, and return ``(rc, output)``; the watchdog kills a hung
    child."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if re.search(marker, line):
                break
        assert seen and re.search(marker, seen[-1]), "".join(seen)[-2000:]
        for _ in range(sig_count):
            proc.send_signal(signal.SIGTERM)
        out = "".join(seen) + proc.stdout.read()
        return proc.wait(timeout=timeout), out
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_sigterm_drains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.train", *SMALL,
           "--epochs", "200", "--checkpoint-dir", ck]
    rc, out = _signal_after(cmd, r"^Epoch 1, Training loss")
    assert rc == 0, out[-2000:]
    stopped = re.search(r"^preempted at step (\d+) \(epoch (\d+)\): saving final "
                        r"checkpoint$", out, re.M)
    assert stopped, out[-2000:]
    assert "preempted: skipping final eval" in out
    assert "final test accuracy" not in out
    step, epoch = int(stopped.group(1)), int(stopped.group(2))
    assert step >= 64 and Checkpointer(ck).latest_step() == step   # 64 steps an epoch
    resumed = subprocess.run(
        [sys.executable, "-m", "tpu_ddp_torch.cli.train", *SMALL,
         "--epochs", str(epoch + 1), "--checkpoint-dir", ck, "--resume"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert f"resumed from step {step}" in resumed.stdout
    assert re.search(r"^final test accuracy: [\d.]+, test loss: \d", resumed.stdout, re.M)


SIGNAL_AT = r'''
import json, os, signal, sys, time
import torch
from tpu_ddp_torch.checkpoint.manager import Checkpointer
from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

ck, count = sys.argv[1], int(sys.argv[2])
BASE = dict(device="cpu", synthetic_data=True, synthetic_size=200, per_shard_batch=4,
            n_chans1=8, n_blocks=2, seed=0, momentum=0.9, epochs=3,
            checkpoint_dir=ck, checkpoint_steps=40)


class SignalAt:
    """The loader, sending this process ``count`` SIGTERMs as it yields
    its 60th batch."""

    def __init__(self, inner):
        self._inner, self._seen = inner, 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, *args, **kwargs):
        for batch in self._inner.epoch_batches(*args, **kwargs):
            if self._seen == 60:
                for _ in range(count):
                    os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(0.05)
            self._seen += 1
            yield batch


def run(signal_at=False, **kw):
    if signal_at:   # the shim wraps epoch_batches: the synchronous data path
        kw["prefetch_depth"] = 0
    t = Trainer(TrainConfig(**{**BASE, **kw}))
    if signal_at:
        t.train_loader = SignalAt(t.train_loader)
    return t, t.run()


cut, metrics = run(signal_at=True)
cut.close()
ck_ = Checkpointer(ck)
out = {"preempted": metrics.get("preempted", False), "latest": ck_.latest_step(),
       "verified": ck_.verified_restore_step(), "cut": cut.history["step_loss"]}
if count == 1:
    full, _ = run(checkpoint_dir=None, checkpoint_steps=0)
    resumed, _ = run(resume=True)
    out["full"] = full.history["step_loss"]
    out["resumed"] = resumed.history["step_loss"]
    fs, rs = full.state.model.state_dict(), resumed.state.model.state_dict()
    out["same_params"] = all(torch.equal(fs[k], rs[k]) for k in fs)
print(json.dumps(out))
'''


def _signal_at(tmp_path, count):
    script = tmp_path / "signal_at.py"
    script.write_text(SIGNAL_AT)
    proc = subprocess.run([sys.executable, str(script), str(tmp_path / "ck"), str(count)],
                          cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sigterm_mid_epoch_drain_resumes_bitwise(tmp_path):
    out = _signal_at(tmp_path, 1)
    assert out["preempted"] and out["latest"] == 60 == out["verified"]
    assert len(out["cut"]) == 60
    assert out["cut"] + out["resumed"] == out["full"]
    assert out["same_params"]


def test_second_sigterm_skips_final_checkpoint(tmp_path):
    out = _signal_at(tmp_path, 2)
    assert out["preempted"]
    assert out["latest"] == 50 == out["verified"]   # epoch 1's save, nothing newer


def test_launcher_two_ranks_drain_at_one_epoch_boundary(tmp_path):
    ck = str(tmp_path / "ck")
    train = [sys.executable, "-m", "tpu_ddp_torch.cli.train", *SMALL,
             "--checkpoint-dir", ck, "--kernels", "--zero1", "--grad-compress", "int8",
             "--grad-compress-error-feedback"]
    launch = [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node", "2",
              "--"]
    rc, out = _signal_after(launch + train + ["--epochs", "200"],
                            r"^Epoch 1, Training loss")
    assert rc == 0, out[-3000:]
    stopped = re.findall(r"^preempted at step (\d+) \(epoch (\d+)\)", out, re.M)
    assert len(stopped) == 1, out[-3000:]                   # rank 0 alone prints
    step, epoch = map(int, stopped[0])
    assert step == 32 * epoch and epoch >= 2                # 32 steps an epoch a rank
    assert Checkpointer(ck).latest_step() == step
    resumed = subprocess.run(launch + train + ["--epochs", str(epoch + 1), "--resume"],
                             cwd=ROOT, env=ENV, capture_output=True, text=True,
                             timeout=240)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert f"resumed from step {step}" in resumed.stdout
