"""Shared by the tests of the port's live observatories
(``tests/test_torch_monitor.py``, ``test_torch_profiler.py``,
``test_torch_memtrack.py``): one small port run on the CPU with every
observatory on, and the HTTP calls it answered while it trained.

The run is NetResDeep at ``n_chans1=8, n_blocks=2`` on 160 synthetic rows at
batch 32 (5 steps an epoch), two epochs, one rank, ``--health on``, the
JSONL trace sink, ``--monitor-port -1 --monitor-bind 127.0.0.1``, a hang
watchdog, ``--profile-steps 1:3`` and ``--profile-dir``. The capture
manager's ``on_step`` is wrapped so that, inside ``run()``, the test's
requests reach the rank's exporter before the step's window work: at step
2, while the config window is open, ``/metrics``, ``/snapshot.json``,
``/healthz`` and a ``POST /profile`` (429: a window is active); at step 4,
the window closed, two bad ``steps`` (400), one from a remote peer (403),
one that arms (200: the window of step 4..5) and a second (429: armed). The
second epoch is ``--profile-dir``'s.
"""

import json
import os
import urllib.error
import urllib.request

BASE = dict(device="cpu", synthetic_data=True, synthetic_size=160, per_shard_batch=32,
            epochs=2, n_chans1=8, n_blocks=2, kernels=True, log_every_epochs=1,
            health="on", telemetry_sinks="jsonl", monitor_port=-1,
            monitor_bind="127.0.0.1", watchdog_deadline_seconds=60.0,
            profile_steps="1:3")


def http(method, url):
    """(status, body) of one request, with a timeout; an error status is a
    result, not an exception."""
    req = urllib.request.Request(url, data=b"" if method == "POST" else None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def observed_run(run_dir, **kw):
    """The module docstring's run into ``run_dir``: ``(trainer, calls,
    metrics)``, ``calls`` the requests' ``(status, body)`` by name."""
    from tpu_ddp_torch.telemetry import reset_default_registry
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    reset_default_registry()
    t = Trainer(TrainConfig(**{**BASE, "telemetry_dir": run_dir,
                               "profile_dir": os.path.join(run_dir, "epoch_trace"), **kw}))
    calls, inner = {}, t._capture.on_step

    def on_step(step):
        if step in (2, 4):
            with open(os.path.join(run_dir, "exporter-p0.json")) as f:
                base = f"http://127.0.0.1:{json.load(f)['port']}"
        if step == 2:
            for name in ("metrics", "snapshot.json", "healthz"):
                calls[name] = http("GET", f"{base}/{name}")
            calls["while_active"] = http("POST", f"{base}/profile?steps=1")
        if step == 4:
            calls["steps_zero"] = http("POST", f"{base}/profile?steps=0")
            calls["steps_text"] = http("POST", f"{base}/profile?steps=x")
            calls["remote"] = t._exporter.arm_profile("steps=1", "10.1.2.3")
            calls["arm"] = http("POST", f"{base}/profile?steps=1")
            calls["while_armed"] = http("POST", f"{base}/profile?steps=1")
        inner(step)

    t._capture.on_step = on_step
    try:
        metrics = t.run()
        t.record_final_eval(accuracy=metrics.get("test_accuracy"))
    finally:
        t.close()
    return t, calls, metrics


def drop_keys(obj, keys):
    """``obj`` through a JSON round trip without the dict keys ``keys`` at
    any depth."""
    if isinstance(obj, dict):
        return {k: drop_keys(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [drop_keys(v, keys) for v in obj]
    return obj
